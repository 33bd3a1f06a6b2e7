"""MusicGen-large [arXiv:2306.05284] - decoder-only over EnCodec tokens.

The EnCodec frontend is a STUB per the assignment: input_specs() provides
precomputed frame embeddings, so input_kind='embeddings' and the backbone
projects to the 2048-entry codebook vocabulary.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="dense",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    qkv_bias=False,
    act="gelu",
    norm="layernorm",
    input_kind="embeddings",
    shard_2d=True,
)
