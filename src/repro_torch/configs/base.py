"""Model / shape configuration system (the port's own copy of
``repro/configs/base.py``, kept field-for-field identical; the port
imports nothing of the JAX package).

Every assigned architecture is a frozen ``ModelConfig``; every assigned
input shape is a ``ShapeConfig``.  The cross product (arch x shape) defines
the dry-run / roofline cells.  ``reduced()`` produces the small smoke-test
variant of the same family that runs a real forward/train step on CPU.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid
    num_layers: int
    d_model: int
    num_heads: int                 # query heads (0 for attention-free)
    num_kv_heads: int              # KV heads (GQA); == num_heads for MHA
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention details ---
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # --- block details ---
    act: str = "swiglu"            # swiglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / zamba2 trunk) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid (zamba2): shared attention block applied every N layers ---
    hybrid_attn_every: int = 0
    # --- modality frontend stub: tokens (ids) vs embeddings (precomputed) ---
    input_kind: str = "tokens"     # tokens | embeddings
    # --- numerics / distribution defaults ---
    dtype: str = "bfloat16"            # parameter dtype (f32 for training)
    compute_dtype: str = "bfloat16"    # activation/matmul dtype
    shard_2d: bool = False         # shard weights over (data, model) (FSDP-ish)
    remat: bool = True

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def attn_out_dim(self) -> int:
        return self.num_heads * self.head_dim

    def param_count(self) -> int:
        """Closed-form parameter count estimate (matmul weights only)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        n = 0
        if self.input_kind == "tokens":
            n += V * d
        n += V * d  # lm head (untied)
        L = self.num_layers
        if self.family in ("dense", "moe"):
            qd = self.num_heads * self.head_dim
            kvd = self.num_kv_heads * self.head_dim
            attn = d * qd + 2 * d * kvd + qd * d
            if self.family == "moe":
                mlp = self.num_experts * (3 * d * ff) + d * self.num_experts
            else:
                mlp = 3 * d * ff if self.act == "swiglu" else 2 * d * ff
            n += L * (attn + mlp)
        elif self.family in ("ssm", "hybrid"):
            din = self.d_inner
            H = self.ssm_heads
            # in_proj -> [z, x, B, C, dt], out_proj
            proj_out = 2 * din + 2 * self.ssm_state + H
            per = d * proj_out + din * d
            n += L * per
            if self.family == "hybrid":
                qd = self.num_heads * self.head_dim
                kvd = self.num_kv_heads * self.head_dim
                shared = (2 * d) * qd + 2 * (2 * d) * kvd + qd * d + 3 * d * ff
                n += shared  # one shared block, reused
        return n

    def size_mb_fp32(self) -> float:
        return self.param_count() * 4 / 1e6

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2 if self.hybrid_attn_every == 0 else 4,
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_heads else 0,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            num_experts=4 if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16,
            ssm_chunk=8,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            dtype="float32",
            compute_dtype="float32",
            shard_2d=False,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    # training microbatch (gradient accumulation): global_batch is split into
    # num_microbatches chunks of microbatch size each.
    microbatch: Optional[int] = None

    @property
    def num_microbatches(self) -> int:
        if self.kind != "train" or not self.microbatch:
            return 1
        assert self.global_batch % self.microbatch == 0
        return self.global_batch // self.microbatch


SHAPES = {
    # microbatch=64 (4 accumulation steps): §Perf P3 - fewer per-microbatch
    # FSDP gathers / TP all-reduces at the same global batch.
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256, microbatch=64),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention: SSM / hybrid only."""
    if shape.name == "long_500k":
        return cfg.family in ("ssm", "hybrid")
    return True
