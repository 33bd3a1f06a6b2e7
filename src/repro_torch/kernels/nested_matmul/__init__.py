"""K2 and K3: matmuls recomposing the nesting ladder from 2..4 packed streams."""
from .ops import ladder_matmul, nested_matmul
