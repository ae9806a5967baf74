"""Plain-torch oracle for decode attention (port of
``repro.kernels.decode_attention.ref.decode_attention_ref``).

The exact post-scoring rule of the paper's SSIV-D: the threshold is
tested against the row's *final* max, a row with no kept entry outputs 0.
"""
from __future__ import annotations

from typing import Optional

import torch


def decode_attention_ref(
    q: torch.Tensor,                # [B, Hq, D]
    k: torch.Tensor,                # [B, Hkv, S, D]
    v: torch.Tensor,                # [B, Hkv, S, Dv]
    mask: torch.Tensor,             # [B, Hq, S] bool
    *,
    threshold: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, hq, d = q.shape
    _, hkv, s_len, dv = v.shape
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    kq = k.repeat_interleave(group, dim=1).float()
    vq = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kq) * scale
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    keep = mask
    if threshold is not None:
        keep = keep & (s >= m - threshold)
        s = torch.where(keep, s, float("-inf"))
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    w = p / torch.clamp(l, min=1e-30)
    return torch.einsum("bhk,bhkd->bhd", w, vq).to(q.dtype)
