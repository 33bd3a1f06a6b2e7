"""Quantization core of the port: packing, rounding, the nesting ladder,
recipes and the rung-switching store (counterparts of ``repro/core``, with
the same exported names)."""
from .quantizer import (compute_scale, quantize_rtn, dequantize, perturbation,
                        int_range, sqnr_db)
from .squant import (adaptive_round, case_metric, group_signed_error,
                     is_floor_ceil)
from .decompose import (split_high, split_low, recompose, decompose,
                        recompose_error, numerical_error_table, ROUNDINGS,
                        normalize_bits, ladder_gaps, delta_bits,
                        chain_decompose, chain_recompose)
from .packing import (pack, unpack, pack_blocked, unpack_blocked, per_word,
                      packed_rows, packed_nbytes, blocked_rows, choose_block,
                      unpack_words)
from .nesting import (NestedTensor, nest_quantize, nest_quantize_tree,
                      materialize, set_tree_mode, set_tree_rung, tree_bytes,
                      tree_ladder_bytes, tree_num_rungs, critical_nested_bits,
                      default_predicate, mode_to_rung, rung_to_mode)
from .switching import (NestQuantStore, RungAssignment, SwitchLedger,
                        diverse_bitwidth_bytes, diverse_ladder_bytes)
from .recipe import (LayerOverride, LeafSpec, QuantRecipe, exact_override,
                     quantize, recipe_summary)
from .search import (LayerSensitivity, RungScore, SearchResult,
                     calibration_batch, default_calibration, score_layer,
                     search_recipe)
from .similarity import quality_report

__all__ = [
    "compute_scale", "quantize_rtn", "dequantize", "perturbation", "int_range", "sqnr_db",
    "adaptive_round", "case_metric", "group_signed_error", "is_floor_ceil",
    "split_high", "split_low", "recompose", "decompose", "recompose_error",
    "numerical_error_table", "ROUNDINGS", "normalize_bits", "ladder_gaps", "delta_bits",
    "chain_decompose", "chain_recompose",
    "pack", "unpack", "pack_blocked", "unpack_blocked", "per_word", "packed_rows",
    "packed_nbytes", "blocked_rows", "choose_block", "unpack_words",
    "NestedTensor", "nest_quantize", "nest_quantize_tree", "materialize", "set_tree_mode",
    "set_tree_rung", "tree_bytes", "tree_ladder_bytes", "tree_num_rungs",
    "critical_nested_bits", "default_predicate", "mode_to_rung", "rung_to_mode",
    "NestQuantStore", "RungAssignment", "SwitchLedger", "diverse_bitwidth_bytes",
    "diverse_ladder_bytes",
    "LayerOverride", "LeafSpec", "QuantRecipe", "exact_override", "quantize",
    "recipe_summary",
    "LayerSensitivity", "RungScore", "SearchResult", "calibration_batch",
    "default_calibration", "score_layer", "search_recipe",
    "quality_report",
]
