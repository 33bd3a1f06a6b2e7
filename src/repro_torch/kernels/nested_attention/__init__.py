"""K4: int32 QK^T over packed nested KV pages, and the nested-attention op."""
