"""A^3 post-scoring selection (paper SSIV-D), PyTorch port of
``repro.core.post_scoring``.

After exact scores are computed for the candidate rows, drop any row
whose score trails the max by more than ``t`` nats — i.e. whose
post-softmax weight would be below ``T% = 100·e^{-t}`` of the top row's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.candidate_selection import top_k

_NEG = torch.finfo(torch.float32).min


def post_scoring_mask(scores: torch.Tensor, threshold_nats: float,
                      candidate_mask: Optional[torch.Tensor] = None,
                      axis: int = -1) -> torch.Tensor:
    """Boolean mask of rows kept by post-scoring selection; rows outside
    ``candidate_mask`` are ignored both for the max and the output."""
    s = scores.float()
    if candidate_mask is not None:
        s = torch.where(candidate_mask, s, _NEG)
    mx = s.amax(dim=axis, keepdim=True)
    keep = s >= (mx - threshold_nats)
    if candidate_mask is not None:
        keep = keep & candidate_mask
    return keep


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor],
                   axis: int = -1) -> torch.Tensor:
    """Numerically stable softmax over ``mask``-selected entries; a row
    with an all-False mask gets all-zero weights."""
    s = scores.float()
    if mask is not None:
        s = torch.where(mask, s, _NEG)
    mx = s.amax(dim=axis, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    e = torch.exp(s - mx)
    if mask is not None:
        e = torch.where(mask, e, 0.0)
    denom = e.sum(dim=axis, keepdim=True)
    return e / torch.clamp(denom, min=torch.finfo(torch.float32).tiny)


def top_weight_stats(weights: torch.Tensor, true_weights: torch.Tensor,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fig. 13b metric -> (recall of the true top-k entries, kept
    fraction)."""
    k = min(k, weights.shape[-1])
    _, true_top = top_k(true_weights, k)
    kept = torch.gather(weights, -1, true_top) > 0
    recall = kept.float().mean(-1)
    kept_fraction = (weights > 0).float().mean(-1)
    return recall, kept_fraction
