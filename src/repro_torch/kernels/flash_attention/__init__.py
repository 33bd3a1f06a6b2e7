"""K5: causal GQA flash attention, forward (the long-prefill attention)."""
from .ops import flash_attention
