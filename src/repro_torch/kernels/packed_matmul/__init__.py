"""K1: matmul straight from one block-packed word stream."""
from .ops import packed_matmul, prepare
