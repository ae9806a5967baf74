"""xLSTM blocks, mLSTM and sLSTM (PyTorch port of ``repro.models.xlstm``).

mLSTM (matrix memory): per head a d_k x d_v matrix memory C with
exponential input and forget gates in log space (stabiliser m). The
prefill and the training forward run chunkwise: quadratic gate-decay
attention inside a chunk, the (C, n, m) state carried between chunks.
That chunk loop is kernel #7 (``kernels/mlstm_chunk``): on CUDA tensors it
runs the hand-written kernel, on CPU tensors its plain version. The
kernel writes its outputs through ctypes, outside autograd, so
:class:`MLSTMChunk` gives it a backward: the plain version recomputed on
the saved inputs and differentiated by autograd, the recurrence the
reference's ``value_and_grad`` differentiates (the JAX package has no
backward kernel). The one-token decode step is plain torch, as it is jnp
in the reference.

sLSTM (scalar memory): a per-channel recurrence with exponential gating,
a stabiliser and block-diagonal recurrent weights (one block per head).
Inherently sequential: a loop over time in plain torch, as the
reference's ``lax.scan``.

On a mesh (``models.common.ActShardings``) a split block computes this
rank's share of the model axis, its input entering with a backward sum
and its partial output leaving through a sum over the axis. The mLSTM
takes its heads: its columns of ``wq``/``wk``/``wv``/``w_o``, its
columns of the gate weights and of ``ln_scale``, kernel #7 launched on
those heads, and its rows of ``w_out``; its carried (C, n, m) are its
heads'. Where the axis's M ranks outnumber the H heads (H divides M),
the r = M / H ranks of a head (the plan's ``cols`` ring) each project
their block of its hd / r columns of q, k, v and the output gate: q and
k are gathered over the r ranks, so #7 runs on whole q and k against
the rank's value columns (C [B, H', Dk, Dv / r]); n and m come out the
same on the r ranks; the head-wise norm sums its mean and its centred
variance over them. The within-chunk q k^T, the n terms and the scalar
gates stay whole on each of the r ranks. The sLSTM takes its channels
of every gate (rows of ``wx`` and ``b`` and the recurrent weights that
feed them); its recurrent input
``h @ wr`` reads whole heads whose outputs land in the channels of other
ranks (the reference reshapes [H, 4 dh] to the four gates), so each step
gathers ``h`` over the axis, and the output norm reads every channel;
its carried (c, n, m, h) are its channels'.

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

from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_kernel, \
    mlstm_chunk_plain
from repro_torch.models.common import NEG_INF, _linear, dense_init_, \
    ring_gather, ring_sum, split_plan

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


def _heads_share(p: MLSTM, sh, num_heads: int, head_dim: int):
    """(heads, value columns of each, the ring that shares them, gate
    weights and biases [w_i, w_f, b_i, b_f], ln_scale) of this rank: all
    of them and no ring, or with a plan its block of the heads (and,
    where ``sh.cols`` shares them, its block of their columns; the
    replicated leaves entered, so their gradients sum over the axis)."""
    if sh is None:
        return num_heads, head_dim, None, (p.w_i, p.w_f, p.b_i, p.b_f), \
            p.ln_scale
    cols = sh.cols
    r = cols.size if cols is not None else 1
    h, dv = num_heads * r // sh.size, head_dim // r
    lo = sh.index // r * h
    gates = (sh.enter(p.w_i)[:, lo:lo + h], sh.enter(p.w_f)[:, lo:lo + h],
             sh.enter(p.b_i)[lo:lo + h], sh.enter(p.b_f)[lo:lo + h])
    c0 = cols.index * dv if cols is not None else 0
    ln_scale = sh.enter(p.ln_scale)[lo:lo + h, c0:c0 + dv]
    return h, dv, cols, gates, ln_scale


def _mlstm_gates(p: MLSTM, x: torch.Tensor, gates=None):
    """log input gate and log-sigmoid forget gate, [B, S, H] float32
    (``gates``: the [w_i, w_f, b_i, b_f] of the heads computed)."""
    w_i, w_f, b_i, b_f = gates or (p.w_i, p.w_f, p.b_i, p.b_f)
    xf = x.float()
    log_i = xf @ w_i + b_i
    log_f = F.logsigmoid(xf @ w_f + b_f)
    return log_i, log_f


def _headwise_ln(h: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
                 cols=None):
    """The norm over each head's columns; with ``cols`` this rank holds
    its block of them, and the mean, then the centred variance (the
    reference's two passes), are float32 sums over the ring."""
    if cols is None:
        mu = h.mean(-1, keepdim=True)
        var = h.var(-1, keepdim=True, correction=0)
        return (h - mu) * torch.rsqrt(var + eps) * scale
    n = h.shape[-1] * cols.size
    mu = ring_sum(h.sum(-1, keepdim=True), cols) / n
    c = h - mu
    var = ring_sum((c * c).sum(-1, keepdim=True), cols) / n
    return c * torch.rsqrt(var + eps) * scale


def mlstm_init_state(batch: int, num_heads: int, head_dim: int,
                     device=None, value_dim: Optional[int] = None) -> State:
    """Zero (C [B, H, hd, value_dim (hd)], n [B, H, hd]), m -1e30."""
    C = torch.zeros((batch, num_heads, head_dim, value_dim or head_dim),
                    device=device)
    n = torch.zeros((batch, num_heads, head_dim), device=device)
    m = torch.full((batch, num_heads), NEG_INF, device=device)
    return C, n, m


class MLSTMChunk(torch.autograd.Function):
    """Kernel #7 with a backward.

    Forward: ``mlstm_chunk_kernel`` (the kernel on CUDA tensors, its plain
    version on CPU tensors) -> h [B,H,S,Dv] float32, and with
    ``return_state`` the final (C, n, m), saving q, k, v, the log gates
    and the initial state. Without ``return_state`` the kernel skips the
    last chunk's state update, which nothing reads (a training forward).
    Backward: recompute ``mlstm_chunk_plain`` on the saved inputs under
    ``enable_grad`` (the final state only where it has a gradient) and
    return ``torch.autograd.grad`` of it; no kernel launches there.

    Memory: the recompute holds one chunk's autograd intermediates at a
    time per output chunk, the largest being the decay matrix ``dmat``
    and its exponent, [B, H, L, L] float32 each (4 MiB at xlstm-350m's
    B=4, H=4, L=256), beside [B, H, L, D] float32 copies of q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f, C, n, m, chunk: int,
                scale: float, return_state: bool = True):
        out = mlstm_chunk_kernel(
            q, k, v, log_i, log_f, chunk=chunk, scale=scale,
            state=(C, n, m), return_state=return_state)
        ctx.save_for_backward(q, k, v, log_i, log_f, C, n, m)
        ctx.chunk, ctx.scale = chunk, scale
        return (out[0], *out[1]) if return_state else out

    @staticmethod
    def backward(ctx, *grad_outs):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:len(saved)]
        inputs = [t.detach().requires_grad_(r) for t, r in zip(saved, need)]
        with_state = any(g is not None for g in grad_outs[1:])
        with torch.enable_grad():
            res = mlstm_chunk_plain(
                *inputs[:5], chunk=ctx.chunk, scale=ctx.scale,
                state=tuple(inputs[5:]), return_state=with_state)
        outs = (res[0], *res[1]) if with_state else (res,)
        outs = [(o, g) for o, g in zip(outs, grad_outs)
                if g is not None and o.requires_grad]
        wrt = [t for t, r in zip(inputs, need) if r]
        grads = torch.autograd.grad([o for o, _ in outs],
                                    wrt, [g for _, g in outs],
                                    allow_unused=True) if outs and wrt else \
            [None] * len(wrt)
        it = iter(grads)
        res = [next(it) if r else None for r in need]
        return (*res, None, None, None)


def mlstm_chunkwise(p: MLSTM, x: torch.Tensor, num_heads: int,
                    head_dim: int, *, chunk: int = 256,
                    state: Optional[State] = None,
                    valid: Optional[torch.Tensor] = None,
                    return_state: bool = True):
    """Chunkwise-parallel mLSTM forward -> (out [B, S, D], final state),
    or out alone without ``return_state``.

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
    sh = split_plan(p)
    if sh is not None:
        x = sh.enter(x)
    num_heads, dv, cols, gates, ln_scale = _heads_share(p, sh, num_heads,
                                                        head_dim)

    def heads(w: nn.Linear) -> torch.Tensor:        # -> [B, H, S, dv]
        return F.linear(x, w.weight).reshape(b, s, num_heads,
                                             dv).transpose(1, 2)

    q, k, v = heads(p.wq), heads(p.wk), heads(p.wv)
    if cols is not None:          # whole q and k of this rank's heads
        q, k = ring_gather(q, cols, 3), ring_gather(k, cols, 3)
    log_i, log_f = (g.transpose(1, 2) for g in _mlstm_gates(p, x, gates))
    if valid is not None:
        log_i = torch.where(valid[:, None, :], log_i, NEG_INF)
        log_f = torch.where(valid[:, None, :], log_f, 0.0)
    if state is None:
        state = mlstm_init_state(b, num_heads, head_dim, x.device, dv)
    # streams stay in the model dtype; the kernel widens each tile
    res = MLSTMChunk.apply(
        *(t.contiguous() for t in (q, k, v, log_i, log_f, *state)),
        min(chunk, s), 1.0 / math.sqrt(head_dim), return_state)
    hs, state = (res[0], tuple(res[1:])) if return_state else (res, None)
    h = _headwise_ln(hs, ln_scale[None, :, None, :], cols=cols)
    o = torch.sigmoid(F.linear(x, p.w_o.weight).float())
    h = h.transpose(1, 2).reshape(b, s, num_heads * dv) * o
    out = F.linear(h.to(x.dtype), p.w_out.weight)
    out = out if sh is None else sh.leave(out)
    return (out, state) if return_state else out


def mlstm_parallel(p: MLSTM, x: torch.Tensor, num_heads: int,
                   head_dim: int, chunk: int = 256,
                   state: Optional[State] = None) -> torch.Tensor:
    """Output-only view of :func:`mlstm_chunkwise` (train / forward): the
    final state is not computed."""
    return mlstm_chunkwise(p, x, num_heads, head_dim, chunk=chunk,
                           state=state, return_state=False)


def mlstm_decode_step(p: MLSTM, x: torch.Tensor, state: State,
                      num_heads: int, head_dim: int
                      ) -> Tuple[torch.Tensor, State]:
    """One-token recurrent step. x: [B, 1, D] -> (out, new state)."""
    b = x.shape[0]
    C, n, m = state
    sh = split_plan(p)
    if sh is not None:
        x = sh.enter(x)
    num_heads, dv, cols, gates, ln_scale = _heads_share(p, sh, num_heads,
                                                        head_dim)

    def heads(w: nn.Linear) -> torch.Tensor:        # -> [B, H, dv] f32
        return F.linear(x, w.weight).reshape(b, num_heads, dv).float()

    q, k, v = heads(p.wq), heads(p.wk), heads(p.wv)
    if cols is not None:          # whole q and k of this rank's heads
        q, k = ring_gather(q, cols, 2), ring_gather(k, cols, 2)
    k = k / math.sqrt(head_dim)
    log_i, log_f = (g[:, 0] for g in _mlstm_gates(p, x, gates))  # [B, H]
    m_new = torch.maximum(log_f + m, log_i)
    f_eff = torch.exp(log_f + m - m_new)
    i_eff = torch.exp(log_i - m_new)
    C_new = f_eff[..., None, None] * C + i_eff[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = f_eff[..., None] * n + i_eff[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", C_new, q)
    qn = torch.einsum("bhk,bhk->bh", n_new, q)
    den = torch.maximum(qn.abs(), torch.exp(-m_new))
    h = _headwise_ln(num / den[..., None], ln_scale[None], cols=cols)
    o = torch.sigmoid(F.linear(x, p.w_o.weight).float())[:, 0]
    h = h.reshape(b, num_heads * dv) * o
    out = F.linear(h.to(x.dtype), p.w_out.weight)
    if sh is not None:
        out = sh.leave(out)
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


class _SlstmShare:
    """What one rank of a split sLSTM computes: its channels [c0, c0 + n)
    of each of the 4 gates (``rows`` of ``wx`` and ``b``), and the
    recurrent weights that feed them: gate entry j reads head j // 4dh of
    ``h`` through column j % 4dh of that head's ``wr`` block. Without a
    plan: every channel, the recurrent product as the reference's
    ``einsum("bhd,hdf->bhf")``."""

    def __init__(self, p: SLSTM, sh, num_heads: int):
        d = p.ln_scale.shape[0]
        self.sh, self.num_heads, self.d = sh, num_heads, d
        if sh is None:
            self.wx, self.b, self.wr = p.wx.weight, p.b, p.wr
            self.ln_scale = p.ln_scale
            return
        n = d // sh.size
        self.c0, self.n = sh.index * n, n
        dev = p.b.device
        rows = torch.cat([g * d + self.c0 + torch.arange(n, device=dev)
                          for g in range(4)])
        dh = d // num_heads
        self.heads = torch.div(rows, 4 * dh, rounding_mode="floor")
        self.wx = sh.enter(p.wx.weight)[rows]
        self.b = sh.enter(p.b)[rows]
        self.wr = sh.enter(p.wr)[self.heads, :, rows % (4 * dh)]  # [4n, dh]
        self.ln_scale = sh.enter(p.ln_scale)

    def full_h(self, h: torch.Tensor) -> torch.Tensor:
        """The h the recurrence reads: this rank's channels gathered."""
        return h if self.sh is None else self.sh.gather(h, -1)

    def rec(self, h_full: torch.Tensor) -> torch.Tensor:
        """The recurrent input of this rank's gate entries, [B, 4 n]."""
        b = h_full.shape[0]
        hb = h_full.reshape(b, self.num_heads, self.d // self.num_heads)
        if self.sh is None:
            return torch.einsum("bhd,hdf->bhf", hb, self.wr).reshape(
                b, 4 * self.d)
        return torch.einsum("bje,je->bj", hb[:, self.heads], self.wr)


def _slstm_cell(xg: torch.Tensor, rec: torch.Tensor, bias: torch.Tensor,
                state: State) -> State:
    """xg: [B, 4d] precomputed input contribution, rec the recurrent one
    -> new (c, n, m, h)."""
    c, n, m, h = state
    z, i_pre, f_pre, o_pre = torch.chunk(xg + rec + bias, 4, dim=-1)
    log_i = i_pre
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m, log_i)
    i_eff = torch.exp(log_i - m_new)
    f_eff = torch.exp(log_f + m - m_new)
    c_new = f_eff * c + i_eff * torch.tanh(z)
    n_new = f_eff * n + i_eff
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, m_new, h_new


def _slstm_out(p: SLSTM, sp: _SlstmShare, h_full: torch.Tensor,
               dtype) -> torch.Tensor:
    """The norm over every channel, then this rank's rows of ``w_out``."""
    mu = h_full.mean(-1, keepdim=True)
    var = h_full.var(-1, keepdim=True, correction=0)
    h = (h_full - mu) * torch.rsqrt(var + 1e-6) * sp.ln_scale
    if sp.sh is None:
        return F.linear(h.to(dtype), p.w_out.weight)
    h = h[..., sp.c0:sp.c0 + sp.n]
    return sp.sh.leave(F.linear(h.to(dtype), p.w_out.weight))


def _slstm_share(p: SLSTM, x: torch.Tensor, num_heads: int):
    sh = split_plan(p)
    if sh is not None:
        x = sh.enter(x)
    return x, _SlstmShare(p, sh, num_heads)


def slstm_apply_scan(p: SLSTM, x: torch.Tensor, num_heads: int,
                     state: Optional[State] = None,
                     valid: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, State]:
    """x: [B, S, D] -> ([B, S, D], final state), one step per token.

    ``valid`` [B, S] masks ragged pad positions (chunked admission): a pad
    step reselects the carried state bit-identically, so the final state
    is the state after each lane's last valid token."""
    b, s, d = x.shape
    x, sp = _slstm_share(p, x, num_heads)
    xg = F.linear(x.float(), sp.wx)                    # [B, S, 4 d']
    if state is None:
        state = slstm_init_state(b, xg.shape[-1] // 4, x.device)
    hs = []
    h_full = sp.full_h(state[3])
    for t in range(s):
        new = _slstm_cell(xg[:, t], sp.rec(h_full), sp.b, state)
        if valid is not None:
            vt = valid[:, t, None]
            new = tuple(torch.where(vt, a, o) for a, o in zip(new, state))
        state = new
        h_full = sp.full_h(state[3])
        hs.append(h_full)
    return _slstm_out(p, sp, torch.stack(hs, 1), x.dtype), state


def slstm_decode_step(p: SLSTM, x: torch.Tensor, state: State,
                      num_heads: int) -> Tuple[torch.Tensor, State]:
    """x: [B, 1, D] -> (out [B, 1, D], new state)."""
    x, sp = _slstm_share(p, x, num_heads)
    xg = F.linear(x[:, 0].float(), sp.wx)
    new = _slstm_cell(xg, sp.rec(sp.full_h(state[3])), sp.b, state)
    return _slstm_out(p, sp, sp.full_h(new[3]), x.dtype)[:, None], new
