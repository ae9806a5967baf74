"""Plain-torch oracle for the fused attention kernel (port of
``repro.kernels.flash_attention.ref.attention_ref``): dense causal /
sliding-window GQA softmax attention, query rows offset by
``seq_k - seq_q``."""
from __future__ import annotations

from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,                # [B, Hq, Sq, D]
    k: torch.Tensor,                # [B, Hkv, Sk, D]
    v: torch.Tensor,                # [B, Hkv, Sk, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, hq, sq, d = q.shape
    _, hkv, sk, dv = v.shape
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5

    kq = k.repeat_interleave(group, dim=1).float()
    vq = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq) * scale

    rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    cols = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    s = torch.where(mask, s, float("-inf"))

    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    w = p / torch.clamp(l, min=1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", w, vq).to(q.dtype)
