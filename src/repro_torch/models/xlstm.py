"""xLSTM blocks, mLSTM and sLSTM (PyTorch port of ``repro.models.xlstm``).

mLSTM (matrix memory): per head a d_k x d_v matrix memory C with
exponential input and forget gates in log space (stabiliser m). The
prefill runs chunkwise: quadratic gate-decay attention inside a chunk,
the (C, n, m) state carried between chunks. That chunk loop is kernel #7
(``kernels/mlstm_chunk``): on CUDA tensors it runs the hand-written
kernel, on CPU tensors its plain version. The one-token decode step is
plain torch, as it is jnp in the reference.

sLSTM (scalar memory): a per-channel recurrence with exponential gating,
a stabiliser and block-diagonal recurrent weights (one block per head).
Inherently sequential: a loop over time in plain torch, as the
reference's ``lax.scan``.

Parameters are ``nn.Module``s named as the reference's leaves. Dense
projections are ``nn.Linear`` weights ([d_out, d_in], the reference's
[d_in, d_out] transposed); the gate weights ``w_i``/``w_f`` [d_model, H],
the recurrent ``wr`` [H, dh, 4 dh], the biases and the norm scales keep
the reference's layout and float32. The math mirrors the reference's
cast points: gates, states and norms in float32, projections in the
model dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_kernel
from repro_torch.models.common import NEG_INF, _linear, dense_init_

State = Tuple[torch.Tensor, ...]


def _f32(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``wq``/``wk``/``wv``/``w_o`` (output gate) [H hd, d], ``w_out``
    [d, H hd]; scalar gates per head ``w_i``/``w_f`` [d, H] and
    ``b_i``/``b_f`` [H]; head-wise norm ``ln_scale`` [H, hd]."""

    def __init__(self, d_model: int, num_heads: int, head_dim: int, dtype,
                 device=None):
        super().__init__()
        dh = num_heads * head_dim
        self.wq = _linear(d_model, dh, dtype, device)
        self.wk = _linear(d_model, dh, dtype, device)
        self.wv = _linear(d_model, dh, dtype, device)
        self.w_o = _linear(d_model, dh, dtype, device)
        self.w_out = _linear(dh, d_model, dtype, device)
        self.w_i = _f32(d_model, num_heads, device=device)
        self.w_f = _f32(d_model, num_heads, device=device)
        self.b_i = _f32(num_heads, device=device)
        self.b_f = _f32(num_heads, device=device)
        self.ln_scale = _f32(num_heads, head_dim, device=device)


def mlstm_init_(p: MLSTM, generator: torch.Generator) -> None:
    """The reference's ``mlstm_init`` distributions: N(0, 1/d_in) dense
    and gate weights, b_i = 0, b_f = 3 (long memory at init), unit norm
    scale."""
    for lin in (p.wq, p.wk, p.wv, p.w_o, p.w_out):
        dense_init_(lin, generator)
    with torch.no_grad():
        for w in (p.w_i, p.w_f):
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=w.device) / math.sqrt(w.shape[0]))
        p.b_i.zero_()
        p.b_f.fill_(3.0)
        p.ln_scale.fill_(1.0)


def _mlstm_gates(p: MLSTM, x: torch.Tensor):
    """log input gate and log-sigmoid forget gate, [B, S, H] float32."""
    xf = x.float()
    log_i = xf @ p.w_i + p.b_i
    log_f = F.logsigmoid(xf @ p.w_f + p.b_f)
    return log_i, log_f


def _headwise_ln(h: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    mu = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, correction=0)
    return (h - mu) * torch.rsqrt(var + eps) * scale


def mlstm_init_state(batch: int, num_heads: int, head_dim: int,
                     device=None) -> State:
    C = torch.zeros((batch, num_heads, head_dim, head_dim), device=device)
    n = torch.zeros((batch, num_heads, head_dim), device=device)
    m = torch.full((batch, num_heads), NEG_INF, device=device)
    return C, n, m


def mlstm_chunkwise(p: MLSTM, x: torch.Tensor, num_heads: int,
                    head_dim: int, *, chunk: int = 256,
                    state: Optional[State] = None,
                    valid: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, State]:
    """Chunkwise-parallel mLSTM forward -> (out [B, S, D], final state).

    ``state`` resumes from a carried (C, n, m), the chunked-admission
    mid-prompt case. ``valid`` [B, S] masks ragged pad positions (i-gate
    -1e30: no state write; f-gate 0: the state carries through), so the
    returned state is the state after each lane's last valid token; a
    lane with no valid token is the caller's to reselect. The chunk loop
    runs in kernel #7, in chunks of L = min(chunk, S). Where the reference
    pads S to a multiple of L with the same gates and zero q/k/v, the
    kernel takes the short last chunk as it is: pad rows come after every
    real row and change neither their outputs nor the state."""
    b, s, _ = x.shape
    dh = num_heads * head_dim

    def heads(w: nn.Linear) -> torch.Tensor:        # -> [B, H, S, hd]
        return F.linear(x, w.weight).reshape(b, s, num_heads,
                                             head_dim).transpose(1, 2)

    q, k, v = heads(p.wq), heads(p.wk), heads(p.wv)
    log_i, log_f = (g.transpose(1, 2) for g in _mlstm_gates(p, x))
    if valid is not None:
        log_i = torch.where(valid[:, None, :], log_i, NEG_INF)
        log_f = torch.where(valid[:, None, :], log_f, 0.0)
    if state is None:
        state = mlstm_init_state(b, num_heads, head_dim, x.device)
    # streams stay in the model dtype; the kernel widens each tile
    hs, state = mlstm_chunk_kernel(
        *(t.contiguous() for t in (q, k, v, log_i, log_f)),
        chunk=min(chunk, s), scale=1.0 / math.sqrt(head_dim),
        state=tuple(t.contiguous() for t in state), return_state=True)
    h = _headwise_ln(hs, p.ln_scale[None, :, None, :])
    o = torch.sigmoid(F.linear(x, p.w_o.weight).float())
    h = h.transpose(1, 2).reshape(b, s, dh) * o
    return F.linear(h.to(x.dtype), p.w_out.weight), state


def mlstm_decode_step(p: MLSTM, x: torch.Tensor, state: State,
                      num_heads: int, head_dim: int
                      ) -> Tuple[torch.Tensor, State]:
    """One-token recurrent step. x: [B, 1, D] -> (out, new state)."""
    b = x.shape[0]
    C, n, m = state

    def heads(w: nn.Linear) -> torch.Tensor:        # -> [B, H, hd] f32
        return F.linear(x, w.weight).reshape(b, num_heads, head_dim).float()

    q, v = heads(p.wq), heads(p.wv)
    k = heads(p.wk) / math.sqrt(head_dim)
    log_i, log_f = (g[:, 0] for g in _mlstm_gates(p, x))     # [B, H]
    m_new = torch.maximum(log_f + m, log_i)
    f_eff = torch.exp(log_f + m - m_new)
    i_eff = torch.exp(log_i - m_new)
    C_new = f_eff[..., None, None] * C + i_eff[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = f_eff[..., None] * n + i_eff[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", C_new, q)
    qn = torch.einsum("bhk,bhk->bh", n_new, q)
    den = torch.maximum(qn.abs(), torch.exp(-m_new))
    h = _headwise_ln(num / den[..., None], p.ln_scale[None])
    o = torch.sigmoid(F.linear(x, p.w_o.weight).float())[:, 0]
    h = h.reshape(b, num_heads * head_dim) * o
    out = F.linear(h.to(x.dtype), p.w_out.weight)
    return out[:, None, :], (C_new, n_new, m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """``wx`` [4d, d] float32 (input contribution of the z, i, f, o
    gates), block-diagonal recurrent ``wr`` [H, dh, 4 dh] float32, bias
    ``b`` [4d], ``w_out`` [d, d], norm ``ln_scale`` [d]; hidden dim ==
    d_model."""

    def __init__(self, d_model: int, num_heads: int, dtype, device=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"{num_heads} heads")
        dh = d_model // num_heads
        self.wx = _linear(d_model, 4 * d_model, torch.float32, device)
        self.wr = _f32(num_heads, dh, 4 * dh, device=device)
        self.b = _f32(4 * d_model, device=device)
        self.w_out = _linear(d_model, d_model, dtype, device)
        self.ln_scale = _f32(d_model, device=device)


def slstm_init_(p: SLSTM, generator: torch.Generator) -> None:
    """The reference's ``slstm_init`` distributions: N(0, 1/d_in) dense
    weights, N(0, 1/dh) recurrent blocks, forget-gate bias 3, unit norm
    scale."""
    dense_init_(p.wx, generator)
    dense_init_(p.w_out, generator)
    d = p.ln_scale.shape[0]
    with torch.no_grad():
        p.wr.copy_(torch.randn(p.wr.shape, generator=generator,
                               device=p.wr.device)
                   / math.sqrt(p.wr.shape[1]))
        p.b.zero_()
        p.b[2 * d:3 * d] = 3.0
        p.ln_scale.fill_(1.0)


def slstm_init_state(batch: int, d_model: int, device=None) -> State:
    """(c, n, m, h), each [B, d] float32."""
    z = lambda: torch.zeros((batch, d_model), device=device)  # noqa: E731
    return (z(), z(), torch.full((batch, d_model), NEG_INF, device=device),
            z())


def _slstm_cell(p: SLSTM, xg: torch.Tensor, state: State,
                num_heads: int) -> State:
    """xg: [B, 4d] precomputed input contribution -> new (c, n, m, h)."""
    c, n, m, h = state
    b, d4 = xg.shape
    d = d4 // 4
    hb = h.reshape(b, num_heads, d // num_heads)
    rec = torch.einsum("bhd,hdf->bhf", hb, p.wr).reshape(b, d4)
    z, i_pre, f_pre, o_pre = torch.chunk(xg + rec + p.b, 4, dim=-1)
    log_i = i_pre
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m, log_i)
    i_eff = torch.exp(log_i - m_new)
    f_eff = torch.exp(log_f + m - m_new)
    c_new = f_eff * c + i_eff * torch.tanh(z)
    n_new = f_eff * n + i_eff
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, m_new, h_new


def _slstm_out(p: SLSTM, h: torch.Tensor, dtype) -> torch.Tensor:
    mu = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, correction=0)
    h = (h - mu) * torch.rsqrt(var + 1e-6) * p.ln_scale
    return F.linear(h.to(dtype), p.w_out.weight)


def slstm_apply_scan(p: SLSTM, x: torch.Tensor, num_heads: int,
                     state: Optional[State] = None,
                     valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, State]:
    """x: [B, S, D] -> ([B, S, D], final state), one step per token.

    ``valid`` [B, S] masks ragged pad positions (chunked admission): a pad
    step reselects the carried state bit-identically, so the final state
    is the state after each lane's last valid token."""
    b, s, d = x.shape
    xg = F.linear(x.float(), p.wx.weight)                   # [B, S, 4D]
    if state is None:
        state = slstm_init_state(b, d, x.device)
    hs = []
    for t in range(s):
        new = _slstm_cell(p, xg[:, t], state, num_heads)
        if valid is not None:
            vt = valid[:, t, None]
            new = tuple(torch.where(vt, a, o) for a, o in zip(new, state))
        state = new
        hs.append(state[3])
    return _slstm_out(p, torch.stack(hs, 1), x.dtype), state


def slstm_decode_step(p: SLSTM, x: torch.Tensor, state: State,
                      num_heads: int) -> Tuple[torch.Tensor, State]:
    """x: [B, 1, D] -> (out [B, 1, D], new state)."""
    xg = F.linear(x[:, 0].float(), p.wx.weight)
    new = _slstm_cell(p, xg, state, num_heads)
    return _slstm_out(p, new[3], x.dtype)[:, None], new
