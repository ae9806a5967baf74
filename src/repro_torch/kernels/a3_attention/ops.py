"""Public entry point: A^3-approximate attention with block skipping
(port of ``repro.kernels.a3_attention.ops``).

Builds the candidate block map from the core greedy selection and runs
the block-sparse kernels (mode OFF: the flash kernel). The reference's
``use_kernel``/``interpret`` switch is gone: the tensors' device decides
(CUDA tensors -> the hand-written kernels, CPU tensors -> their plain
versions).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config import A3Config, A3Mode
from repro_torch.core.candidate_selection import SortedKeys, \
    select_candidates_batch, sort_key_columns
from repro_torch.kernels.a3_attention.kernel import a3_sparse_attention, \
    build_block_map
from repro_torch.kernels.flash_attention.ops import fused_attention
from repro_torch.models.common import round_to



def candidate_block_map_for_heads(
    q: torch.Tensor,                # [B, Hq, Sq, D]
    k: torch.Tensor,                # [B, Hkv, Sk, D]
    cfg: A3Config,
    k_scale: Optional[torch.Tensor] = None,   # [B, Hkv, D] fp32 (int8 k)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy candidate selection per (batch, head, query), reduced to
    kv-block granularity and unioned across each GQA group ->
    (kv_indices [B, Hkv, nq, maxb], kv_counts [B, Hkv, nq]), int32.

    The keys are sorted once per kv head (the reference sorts the
    group-repeated keys per query head; the sort is stable, so the two
    agree). With ``k_scale`` the keys may be int8: the positive
    per-column scale is folded into the query."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    group = hq // hkv
    scale = d ** -0.5
    m = cfg.m_for(sk)

    # the reference's weakly typed scale takes q's dtype first
    qs = q * round_to(scale, q.dtype)
    qs = qs.reshape(b, hkv, group, sq, d)
    if k_scale is not None:
        qs = qs.float() * k_scale[:, :, None, None, :]

    sk_sorted = sort_key_columns(k)                       # [B, Hkv, Sk, D]
    sks = SortedKeys(sk_sorted.values[:, :, None], sk_sorted.rows[:, :, None])
    masks, _ = select_candidates_batch(sks, qs, m)
    bq, bk = min(cfg.block_q, sq), min(cfg.block_k, sk)
    nq, nk = sq // bq, sk // bk
    bm = masks.reshape(b, hkv, group, nq, bq, nk, bk)
    bm = bm.any(dim=6).any(dim=4).any(dim=2)              # GQA union
    return build_block_map(bm)


def a3_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: A3Config,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # [B, Hkv, D] fp32 (int8 k)
    v_scale: Optional[torch.Tensor] = None,   # [B, Hkv, D] fp32 (int8 v)
) -> torch.Tensor:
    """A^3-approximate (or exact when cfg.mode == OFF) fused attention.

    ``k_scale``/``v_scale`` enable int8 K/V: candidate selection scores
    the int8 keys directly (scale folded into the query); only the
    softmax kernels see dequantized values."""

    def _dequant(x, s):
        return (x.float() * s[:, :, None, :]).to(q.dtype)

    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if cfg.mode == A3Mode.OFF:
        if k_scale is not None:
            k = _dequant(k, k_scale)
        if v_scale is not None:
            v = _dequant(v, v_scale)
        return fused_attention(q, k, v, causal=causal, window=window)

    kv_indices, kv_counts = candidate_block_map_for_heads(
        q, k, cfg, k_scale=k_scale)
    if k_scale is not None:
        k = _dequant(k, k_scale)
    if v_scale is not None:
        v = _dequant(v, v_scale)
    return a3_sparse_attention(q, k, v, kv_indices, kv_counts,
                               threshold=cfg.threshold_nats, causal=causal,
                               window=window, block_q=cfg.block_q,
                               block_k=cfg.block_k)
