"""Phi-3-vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct].

phi3-mini transformer backbone; CLIP vision frontend is a STUB per the
assignment: input_specs() provides precomputed patch embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    qkv_bias=False,
    act="swiglu",
    norm="rmsnorm",
    input_kind="embeddings",
)
