"""DBRX-132B [hf:databricks/dbrx-base; unverified] - MoE 16 experts top-4."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    qkv_bias=False,
    rope_theta=5e5,
    act="swiglu",
    norm="layernorm",
    num_experts=16,
    top_k=4,
    shard_2d=True,
)
