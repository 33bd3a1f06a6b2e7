"""The sharded stack of the port (counterpart of ``repro/distributed``):
logical-axis rules and parameter specs (``sharding``), the context that
model code reads (``ctx``), explicit collectives with byte counts
(``comm``), the sharded train / prefill / decode steps (``steps``) and
the error-feedback int8 gradient mean (``grad_compress``), all on
``torch.distributed``."""
from .ctx import logical_rules, shard_hint, to_pspec

__all__ = ["logical_rules", "shard_hint", "to_pspec"]
