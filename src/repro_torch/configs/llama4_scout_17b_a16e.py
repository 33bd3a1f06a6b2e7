"""Llama4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

MoE 16 experts top-1, GQA, early fusion (text backbone only here).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    qkv_bias=False,
    rope_theta=5e5,
    act="swiglu",
    norm="rmsnorm",
    num_experts=16,
    top_k=1,
    shard_2d=True,
)
