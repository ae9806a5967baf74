"""A^3 attention — the paper's full pipeline, PyTorch port of
``repro.core.a3_attention``.

Pipeline (paper Fig. 10):

    sorted keys --(candidate selection, SSIV-C)--> candidate mask
    q·Kᵀ on candidates --(post-scoring, SSIV-D)--> kept mask
    masked softmax (optionally the quantized 2-LUT path, SSIII) --> weights
    weights · V --> output

This is the semantic reference: dense masked math in plain torch ops, as
its reference is plain jnp. The block-sparse kernels in
``repro_torch.kernels.a3_attention`` consume the same candidate masks at
block granularity. The reference's ``vmap`` over queries is a leading
batch dimension here.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.config import A3Config, A3Mode
from repro_torch.core.candidate_selection import (
    SortedKeys,
    select_candidates,
    select_candidates_batch,
    sort_key_columns,
)
from repro_torch.core.post_scoring import masked_softmax, post_scoring_mask
from repro_torch.core.quantization import (
    LutExp,
    cached_lut_exp,
    quantize_fixed_point,
    softmax_fixed_point,
)


class A3State(NamedTuple):
    """Comprehension-time state: the preprocessed (sorted) key matrix."""
    sorted_keys: SortedKeys
    key: torch.Tensor
    value: torch.Tensor


def preprocess(key: torch.Tensor, value: torch.Tensor) -> A3State:
    """Comprehension-time preprocessing (off the critical path)."""
    return A3State(sorted_keys=sort_key_columns(key), key=key, value=value)


def _maybe_quantize(x: torch.Tensor, cfg: A3Config) -> torch.Tensor:
    if cfg.int_bits is not None and cfg.frac_bits is not None:
        return quantize_fixed_point(x, cfg.int_bits, cfg.frac_bits)
    return x


def a3_attention_single(state: A3State, query: torch.Tensor, cfg: A3Config,
                        lut: Optional[LutExp] = None
                        ) -> Tuple[torch.Tensor, dict]:
    """Queries ``[..., d]`` against one (key [n, d], value [n, dv]) memory
    — the accelerator's unit op, with leading query dimensions.

    Returns (output [..., dv], aux dict of masks/weights for analysis)."""
    key, value = state.key, state.value
    n = key.shape[0]
    q = _maybe_quantize(query, cfg)
    k = _maybe_quantize(key, cfg)
    lead = q.shape[:-1]

    if cfg.mode == A3Mode.OFF:
        cand = torch.ones((*lead, n), dtype=torch.bool, device=q.device)
        greedy = torch.zeros((*lead, n), dtype=torch.float32,
                             device=q.device)
    else:
        cand, greedy = select_candidates(state.sorted_keys, q, cfg.m_for(n))

    scores = torch.einsum("nd,...d->...n", k, q)                 # [..., n]
    if cfg.frac_bits is not None:
        scores = quantize_fixed_point(
            scores, 2 * (cfg.int_bits or 4)
            + int(math.ceil(math.log2(max(key.shape[1], 2)))),
            2 * cfg.frac_bits)

    if cfg.mode == A3Mode.OFF:
        keep = cand
    else:
        keep = post_scoring_mask(scores, cfg.threshold_nats, cand)

    if cfg.lut_exponent and cfg.frac_bits is not None:
        weights = softmax_fixed_point(scores, cfg.frac_bits, lut=lut,
                                      mask=keep)
    else:
        weights = masked_softmax(scores, keep)

    out = weights @ _maybe_quantize(value, cfg)
    aux = dict(candidates=cand, kept=keep, weights=weights,
               greedy_score=greedy, scores=scores)
    return out, aux


def a3_attention_batch(state: A3State, queries: torch.Tensor, cfg: A3Config
                       ) -> Tuple[torch.Tensor, dict]:
    """The unit op over a [q, d] query batch (pipelined queries), with the
    shared cached LUT pair."""
    lut = cached_lut_exp(2 * cfg.frac_bits, 2 * cfg.frac_bits + 5) if (
        cfg.lut_exponent and cfg.frac_bits is not None) else None
    return a3_attention_single(state, queries, cfg, lut)


# ---------------------------------------------------------------------------
# Self-attention integration (BERT/LM case, paper SSVI — n queries share K)
# ---------------------------------------------------------------------------

def candidate_block_map(cand_mask: torch.Tensor, block_q: int,
                        block_k: int) -> torch.Tensor:
    """Reduce a per-(query, key) candidate mask [q, n] to block
    granularity [q/block_q, n/block_k]: a block is live iff any pair
    within it is a candidate."""
    qlen, n = cand_mask.shape
    nq, nk = qlen // block_q, n // block_k
    m = cand_mask[: nq * block_q, : nk * block_k]
    return m.reshape(nq, block_q, nk, block_k).any(dim=3).any(dim=1)


def a3_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cfg: A3Config, causal: bool = False,
                      scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, dict]:
    """Self-attention (q [q, d], k [n, d], v [n, dv]) with the A^3
    pipeline per query, on the 1/sqrt(d)-scaled score space so that
    ``threshold_nats`` keeps its paper meaning."""
    qlen, d = q.shape
    n = k.shape[0]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qs = q * scale

    if cfg.mode == A3Mode.OFF:
        cand = torch.ones((qlen, n), dtype=torch.bool, device=q.device)
    else:
        cand, _ = select_candidates_batch(sort_key_columns(k), qs,
                                          cfg.m_for(n))

    scores = qs @ k.T                                      # [q, n]
    if causal:
        pos_q = torch.arange(qlen, device=q.device)[:, None]
        pos_k = torch.arange(n, device=q.device)[None, :]
        cand = cand & (pos_k <= pos_q + (n - qlen))

    if cfg.mode == A3Mode.OFF:
        keep = cand
    else:
        keep = post_scoring_mask(scores, cfg.threshold_nats, cand)

    weights = masked_softmax(scores, keep)
    out = weights @ v
    aux = dict(candidates=cand, kept=keep, weights=weights)
    return out, aux


def flop_savings(aux: dict, n: int, d: int) -> dict:
    """Accounting used by the Fig. 14 benchmark: avoided MACs per query."""
    c = aux["candidates"].sum(-1).float()
    kk = aux["kept"].sum(-1).float()
    full = float(2 * n * d)
    approx = 2.0 * c * d / full
    out_frac = kk * d / (n * d)
    return dict(
        mean_candidates=c.mean(),
        mean_kept=kk.mean(),
        score_flop_fraction=approx.mean(),
        output_flop_fraction=out_frac.mean(),
    )
