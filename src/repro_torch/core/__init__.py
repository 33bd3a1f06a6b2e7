"""Quantization core of the port: packing, rounding, the nesting ladder,
recipes and the rung-switching store (counterparts of ``repro/core``)."""
from .decompose import (chain_decompose, chain_recompose, delta_bits,
                        normalize_bits, numerical_error_table)
from .nesting import (NestedTensor, materialize, nest_quantize, set_tree_rung,
                      tree_bytes, tree_ladder_bytes, tree_num_rungs)
from .quantizer import int_range
from .recipe import LayerOverride, QuantRecipe, exact_override, quantize, recipe_summary
from .search import LayerSensitivity, RungScore, SearchResult, search_recipe
from .switching import (NestQuantStore, RungAssignment, SwitchLedger,
                        diverse_bitwidth_bytes, diverse_ladder_bytes)

__all__ = [
    "LayerOverride", "LayerSensitivity", "NestQuantStore", "NestedTensor",
    "QuantRecipe", "RungAssignment", "RungScore", "SearchResult", "SwitchLedger",
    "chain_decompose", "chain_recompose", "delta_bits", "diverse_bitwidth_bytes",
    "diverse_ladder_bytes", "exact_override", "int_range", "materialize",
    "nest_quantize", "normalize_bits", "numerical_error_table", "quantize",
    "recipe_summary", "search_recipe", "set_tree_rung", "tree_bytes",
    "tree_ladder_bytes", "tree_num_rungs",
]
