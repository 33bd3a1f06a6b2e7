"""K5: causal GQA flash attention, forward (the long-prefill attention)."""
