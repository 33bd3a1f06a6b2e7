"""K6: the page-in upgrade recompose of packed w_high + w_low into int8 codes."""
from .ops import nest_recompose
