"""Plain-torch oracle for the chunkwise mLSTM kernel (port of
``repro.kernels.mlstm_chunk.ref.mlstm_chunk_ref``): the sequential
per-token recurrence, float32 throughout."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mlstm_chunk_ref(q, k, v, log_i, log_f, *, scale: float = 1.0
                    ) -> torch.Tensor:
    """q/k/v [B,H,S,D*], gates [B,H,S] -> h [B,H,S,Dv] in q's dtype. A
    loop over S, one token at a time: the exact oracle."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    qf, vf = q.float(), v.float()
    kf = k.float() * scale
    li, lf = log_i.float(), log_f.float()
    C = torch.zeros((b, h, dk, dv), device=q.device)
    n = torch.zeros((b, h, dk), device=q.device)
    m = torch.full((b, h), NEG_INF, device=q.device)
    hs = []
    for t in range(s):
        qt, kt, vt = qf[:, :, t], kf[:, :, t], vf[:, :, t]
        m_new = torch.maximum(lf[:, :, t] + m, li[:, :, t])
        f_eff = torch.exp(lf[:, :, t] + m - m_new)
        i_eff = torch.exp(li[:, :, t] - m_new)
        C = f_eff[..., None, None] * C + i_eff[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = f_eff[..., None] * n + i_eff[..., None] * kt
        num = torch.einsum("bhkv,bhk->bhv", C, qt)
        qn = torch.einsum("bhk,bhk->bh", n, qt)
        den = torch.maximum(qn.abs(), torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, 2).to(q.dtype)
