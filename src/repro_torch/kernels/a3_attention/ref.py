"""Plain-torch oracle for the A^3 block-sparse attention kernels (port of
``repro.kernels.a3_attention.ref.a3_sparse_attention_ref``).

Block-dilated candidate semantics: a key position participates iff its
kv block is live for the query's block, the causal/window mask admits
it, and (optionally) its score is within ``threshold`` nats of the row
max over participating positions. Maps are per kv head; per-query-head
maps are unioned across each GQA group first, as the kernels do.
"""
from __future__ import annotations

from typing import Optional

import torch


def a3_sparse_attention_ref(
    q: torch.Tensor,                # [B, Hq, Sq, D]
    k: torch.Tensor,                # [B, Hkv, Sk, D]
    v: torch.Tensor,                # [B, Hkv, Sk, Dv]
    kv_indices: torch.Tensor,       # [B, Hkv|Hq, nq, maxb] int32
    kv_counts: torch.Tensor,        # [B, Hkv|Hq, nq] int32
    *,
    threshold: Optional[float] = None,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    from repro_torch.kernels.a3_attention.kernel import (
        block_map_to_mask,
        union_block_map_gqa,
    )

    b, hq, sq, d = q.shape
    _, hkv, sk, dv = v.shape
    group = hq // hkv
    bq, bk = min(block_q, sq), min(block_k, sk)
    nk = sk // bk
    if scale is None:
        scale = d ** -0.5

    if kv_indices.shape[1] == hq and group > 1:
        kv_indices, kv_counts = union_block_map_gqa(kv_indices, kv_counts,
                                                    group, nk)
    bm = block_map_to_mask(kv_indices, kv_counts, nk)      # [B, Hkv, nq, nk]
    bm = bm.repeat_interleave(group, dim=1)                # [B, Hq, nq, nk]

    # element-level mask
    elem = bm.repeat_interleave(bq, dim=2).repeat_interleave(bk, dim=3)
    rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    cols = torch.arange(sk, device=q.device)[None, :]
    if causal:
        elem = elem & (cols <= rows)
    if window is not None:
        elem = elem & (cols > rows - window)

    kq = k.repeat_interleave(group, dim=1).float()
    vq = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale
    s = torch.where(elem, s, float("-inf"))

    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    if threshold is not None:
        elem = elem & (s >= m - threshold)
        s = torch.where(elem, s, float("-inf"))
    p = torch.where(elem, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    w = p / torch.clamp(l, min=1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", w, vq).to(q.dtype)
