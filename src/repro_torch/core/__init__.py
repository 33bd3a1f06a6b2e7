"""Quantization core of the port: packing, rounding, the nesting ladder,
recipes and the rung-switching store (counterparts of ``repro/core``)."""
from .decompose import (chain_decompose, chain_recompose, delta_bits,
                        normalize_bits, numerical_error_table)
from .nesting import (NestedTensor, materialize, nest_quantize, set_tree_rung,
                      tree_bytes, tree_ladder_bytes, tree_num_rungs)
from .quantizer import int_range
from .recipe import LayerOverride, QuantRecipe, exact_override, quantize
from .switching import NestQuantStore, RungAssignment, SwitchLedger

__all__ = [
    "LayerOverride", "NestQuantStore", "NestedTensor", "QuantRecipe",
    "RungAssignment", "SwitchLedger", "chain_decompose", "chain_recompose",
    "delta_bits", "exact_override", "int_range", "materialize",
    "nest_quantize", "normalize_bits", "numerical_error_table", "quantize",
    "set_tree_rung", "tree_bytes", "tree_ladder_bytes", "tree_num_rungs",
]
