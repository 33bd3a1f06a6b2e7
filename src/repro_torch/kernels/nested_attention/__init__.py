"""K4: int32 QK^T over packed nested KV pages, and the nested-attention op."""
from .ops import ladder_qk_scores, nested_attention, quantize_q
