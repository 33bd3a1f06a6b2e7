"""Optimizers of the port (counterpart of ``repro/optim``)."""
from .adamw import (AdamWState, apply_update, clip_by_global_norm, global_norm,
                    init_state, warmup_cosine)

__all__ = ["AdamWState", "init_state", "apply_update", "warmup_cosine", "global_norm",
           "clip_by_global_norm"]
