"""Core A^3 algorithm: candidate selection, post-scoring, quantization."""
from repro_torch.core.a3_attention import (
    A3State,
    a3_attention_batch,
    a3_attention_single,
    a3_self_attention,
    candidate_block_map,
    flop_savings,
    preprocess,
)
from repro_torch.core.candidate_selection import (
    SortedKeys,
    quantize_sorted_keys,
    select_candidates,
    select_candidates_batch,
    select_candidates_oracle,
    sort_key_columns,
)
from repro_torch.core.post_scoring import (
    masked_softmax,
    post_scoring_mask,
    top_weight_stats,
)
from repro_torch.core.quantization import (
    LutExp,
    cached_lut_exp,
    dequantize_int8_block,
    make_lut_exp,
    quantize_fixed_point,
    quantize_int8_block,
    softmax_fixed_point,
)

__all__ = [
    "A3State", "a3_attention_batch", "a3_attention_single", "a3_self_attention",
    "candidate_block_map", "flop_savings", "preprocess",
    "SortedKeys", "quantize_sorted_keys", "select_candidates",
    "select_candidates_batch", "select_candidates_oracle",
    "sort_key_columns",
    "masked_softmax", "post_scoring_mask", "top_weight_stats",
    "LutExp", "cached_lut_exp", "make_lut_exp", "quantize_fixed_point",
    "softmax_fixed_point", "quantize_int8_block", "dequantize_int8_block",
]
