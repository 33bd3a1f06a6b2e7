"""Zamba2-2.7B [arXiv:2411.15242] - Mamba2 trunk + shared attention blocks.

54 Mamba2 layers; ONE shared full transformer block (attn + MLP) applied
every 6 layers on concat(hidden, initial_embedding) -> 2d input.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    hybrid_attn_every=6,
    act="gelu",
    norm="rmsnorm",
)
