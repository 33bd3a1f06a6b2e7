"""K1: matmul straight from one block-packed word stream."""
