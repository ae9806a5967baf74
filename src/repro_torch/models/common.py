"""Common model building blocks (PyTorch port of ``repro.models.common``).

Layers are ``nn.Module``s holding the parameters; the math lives in
plain functions that mirror the reference's cast points exactly:
rmsnorm in float32 then cast back, RoPE angles and rotation in float32,
the SwiGLU gate and the GELU in float32 (the tanh form, ``jax.nn.gelu``'s
default ``approximate=True``). Dense weights are stored
``nn.Linear``-style as ``[d_out, d_in]`` (the JAX tree's ``[d_in, d_out]``
transposed), so ``F.linear(x, W)`` computes the reference's ``x @ W``.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# the batch a layer sees on a mesh
#
# The reference's train step runs one GSPMD program over the global batch
# (``activation_shardings`` / ``shard_act`` pin where its activations
# live). The port's sharded step runs each rank on its own rows instead,
# which is the same computation for every layer that treats rows apart,
# but not for the MoE: its capacity, its expert ranks and its
# load-balance loss are statistics of the whole batch. ``batch_rows``
# carries the step's plan of the rows to the layers; under it
# ``moe_apply`` routes the rows of every rank that shares its batch
# (``rows.gather``) and keeps its own rows of the output (``rows.own``).
# The step enters it inside each layer's computation (a remat recompute
# may run on autograd's device thread, which sees no context set around
# the step).
# ---------------------------------------------------------------------------

_BATCH_ROWS = contextvars.ContextVar("repro_torch_batch_rows", default=None)


@contextlib.contextmanager
def batch_rows(rows):
    """Layers inside see ``rows`` (see above; None: the whole batch is
    this rank's)."""
    token = _BATCH_ROWS.set(rows)
    try:
        yield
    finally:
        _BATCH_ROWS.reset(token)


def current_batch_rows():
    """The plan :func:`batch_rows` installed, or None."""
    return _BATCH_ROWS.get()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _linear(d_in: int, d_out: int, dtype, device) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=False, dtype=dtype, device=device)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))


class Attention(nn.Module):
    """GQA projections; ``wq``/``wk``/``wv``/``wo`` as in the reference."""

    def __init__(self, d_model: int, n_q: int, n_kv: int, head_dim: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.wq = _linear(d_model, n_q * head_dim, dtype, device)
        self.wk = _linear(d_model, n_kv * head_dim, dtype, device)
        self.wv = _linear(d_model, n_kv * head_dim, dtype, device)
        self.wo = _linear(n_q * head_dim, d_model, dtype, device)


class FFN(nn.Module):
    """SwiGLU FFN (``w_gate``/``w_up``/``w_down``) or, with
    ``act="gelu"``, GELU FFN (``w_up``/``w_down``; ``w_gate`` is None)."""

    def __init__(self, d_model: int, d_ff: int, dtype=torch.float32,
                 device=None, act: str = "swiglu"):
        super().__init__()
        self.w_gate = (_linear(d_model, d_ff, dtype, device)
                       if act == "swiglu" else None)
        self.w_up = _linear(d_model, d_ff, dtype, device)
        self.w_down = _linear(d_ff, d_model, dtype, device)


# ---------------------------------------------------------------------------
# initializers (same distributions as the reference, not the same numbers)
# ---------------------------------------------------------------------------

def dense_init_(linear: nn.Linear, generator: torch.Generator,
                scale: Optional[float] = None) -> None:
    """N(0, 1) * scale, drawn in float32 then cast (reference
    ``dense_init``; default scale 1/sqrt(d_in))."""
    d_out, d_in = linear.weight.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=linear.weight.device) * scale
    with torch.no_grad():
        linear.weight.copy_(w.t())


def embed_init_(embed: torch.Tensor, generator: torch.Generator) -> None:
    """N(0, 1) in float32, cast to the table's dtype."""
    with torch.no_grad():
        for lo in range(0, embed.shape[0], 8192):     # bounded fp32 scratch
            hi = min(lo + 8192, embed.shape[0])
            embed[lo:hi].copy_(torch.randn(
                (hi - lo, embed.shape[1]), generator=generator,
                dtype=torch.float32, device=embed.device))


def attention_init_(attn: Attention, generator: torch.Generator) -> None:
    dense_init_(attn.wq, generator)
    dense_init_(attn.wk, generator)
    dense_init_(attn.wv, generator)
    dense_init_(attn.wo, generator,
                scale=1.0 / math.sqrt(attn.wo.weight.shape[1]))


def ffn_init_(ffn: FFN, generator: torch.Generator) -> None:
    if ffn.w_gate is not None:
        dense_init_(ffn.w_gate, generator)
    dense_init_(ffn.w_up, generator)
    dense_init_(ffn.w_down, generator,
                scale=1.0 / math.sqrt(ffn.w_down.weight.shape[1]))


def round_to(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: a weakly typed jnp scalar takes the
    array's dtype before the multiply, so bf16 math must see the bf16
    value. Returned as a Python float (exact), so no device copy."""
    return torch.tensor(x, dtype=dtype).item()


# ---------------------------------------------------------------------------
# norms, RoPE
# ---------------------------------------------------------------------------

def rmsnorm(norm: RMSNorm, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return out.to(dtype) * norm.scale


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: [..., S] int. Half-split rotation
    with float32 angles (reference ``apply_rope``)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)
    angles = positions[..., None].float() * freqs          # [..., S, Dh/2]
    angles = angles[..., None, :]                          # [..., S, 1, Dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked online-softmax attention (prefill oracle)
# ---------------------------------------------------------------------------

def attention_xla_flash(
    q: torch.Tensor,                # [B, Hq, Sq, D]
    k: torch.Tensor,                # [B, Hkv, Sk, D]
    v: torch.Tensor,                # [B, Hkv, Sk, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    chunk: int = 1024,
    q_offset: Optional[int] = None,
) -> torch.Tensor:
    """Chunked flash attention in plain torch ops (reference
    ``attention_xla_flash``): an online softmax over KV chunks, float32
    scores and accumulators, masked scores at -1e30, l == 0 -> 0."""
    b, hq, sq, d = q.shape
    _, hkv, sk, dv = v.shape
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    chunk = min(chunk, sk)
    n_chunks = (sk + chunk - 1) // chunk
    qf = (q.float() * scale).reshape(b, hkv, group, sq, d)
    if q_offset is None:
        q_offset = sk - sq
    abs_rows = torch.arange(sq, dtype=torch.int32, device=q.device) + q_offset
    m = torch.full((b, hkv, group, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, group, sq, 1), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((b, hkv, group, sq, dv), dtype=torch.float32,
                      device=q.device)
    for ci in range(n_chunks):
        lo, hi = ci * chunk, min((ci + 1) * chunk, sk)
        kb = k[:, :, lo:hi].float()
        vb = v[:, :, lo:hi].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb)
        cols = torch.arange(lo, hi, dtype=torch.int32, device=q.device)
        mask = torch.ones((sq, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (cols[None, :] <= abs_rows[:, None])
        if window is not None:
            mask = mask & (cols[None, :] > abs_rows[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    safe = torch.where(l == 0.0, 1.0, l)
    out = torch.where(l == 0.0, 0.0, acc / safe)
    return out.reshape(b, hq, sq, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# attention block (GQA + RoPE), FFN, softcap
# ---------------------------------------------------------------------------

def attention_qkv(attn: Attention, x: torch.Tensor, positions: torch.Tensor,
                  n_q: int, n_kv: int, head_dim: int, rope_theta: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> q [B, Hq, S, Dh], k/v [B, Hkv, S, Dh]."""
    b, s, _ = x.shape
    q = F.linear(x, attn.wq.weight).reshape(b, s, n_q, head_dim)
    k = F.linear(x, attn.wk.weight).reshape(b, s, n_kv, head_dim)
    v = F.linear(x, attn.wv.weight).reshape(b, s, n_kv, head_dim)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def attention_out(attn: Attention, o: torch.Tensor) -> torch.Tensor:
    """o [B, H, S, Dh] -> [B, S, D]."""
    b, h, s, hd = o.shape
    return F.linear(o.transpose(1, 2).reshape(b, s, h * hd), attn.wo.weight)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form; the erf form differs by up to 5e-4)."""
    return F.gelu(x, approximate="tanh")


def ffn_apply(ffn: FFN, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU with the gate in float32, or GELU in float32 when the FFN
    has no gate (reference ``ffn_apply``)."""
    if ffn.w_gate is None:
        h = gelu(F.linear(x, ffn.w_up.weight).float())
        return F.linear(h.to(x.dtype), ffn.w_down.weight)
    g = F.silu(F.linear(x, ffn.w_gate.weight).float())
    u = F.linear(x, ffn.w_up.weight).float()
    return F.linear((g * u).to(x.dtype), ffn.w_down.weight)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return (torch.tanh(logits.float() / cap) * cap).to(logits.dtype)
