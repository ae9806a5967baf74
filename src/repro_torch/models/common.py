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
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# activation shardings: what a rank of a sharded train step computes
#
# The reference's train step runs one GSPMD program over the global batch:
# ``activation_shardings`` installs ``act_specs`` and ``shard_act`` pins
# the activations there, and the partitioner splits every product to
# match. The port's sharded step runs each rank on its own rows and its
# own share of the model axis instead, Megatron style, and
# :class:`ActShardings` is the plan that reaches the layers:
#
# * ``rows``: the ranks whose rows make up the batch (a :class:`Ring`;
#   ``rows_dim`` says whether each holds a block of the batch or of the
#   sequence). The MoE's capacity, expert ranks and load-balance loss are
#   statistics of the whole batch: ``moe_apply`` gathers the routing
#   integers over these ranks, never the hidden rows, and each rank runs
#   its block of the capacity buffer;
# * the model axis (``size`` ranks, this one the ``index``-th): a module
#   in ``split`` holds this rank's share of its weights (its heads, its
#   ``d_ff`` columns, its experts or its slice of each, its vocab rows)
#   and computes only that share. Its input enters through
#   :meth:`ActShardings.enter` (the backward sums the shares' input
#   gradients) and its partial output leaves through
#   :meth:`ActShardings.leave` (a sum over the axis), so between modules
#   the hidden state and its gradient are the same on every rank of the
#   axis. Where ``act_specs`` puts the q rows on the model axis (heads
#   that the axis does not divide), the attention cuts the sequence
#   instead (``shard_act(x, "q")``).
#
# The step enters the context inside each layer's computation (a remat
# recompute may run on autograd's device thread, which sees no context
# set around the step).
# ---------------------------------------------------------------------------

_ACT = contextvars.ContextVar("repro_torch_act_shardings", default=None)


def _c10d():
    return torch.ops._c10d_functional


def _wait(t: torch.Tensor) -> torch.Tensor:
    return _c10d().wait_tensor(t)


def _all_reduce(x: torch.Tensor, op: str, group: str) -> torch.Tensor:
    return _wait(_c10d().all_reduce(x.contiguous(), op, group))


def _all_gather(x: torch.Tensor, dim: int, size: int, group: str
                ) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    y = _wait(_c10d().all_gather_into_tensor(
        x.movedim(dim, 0).contiguous(), size, group))
    return y.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, size: int, group: str
                    ) -> torch.Tensor:
    """The sum over the ranks of ``x``, this rank's block of ``dim``."""
    y = _wait(_c10d().reduce_scatter_tensor(
        x.movedim(dim, 0).contiguous(), "sum", size, group))
    return y.movedim(0, dim)


def _block(x: torch.Tensor, dim: int, size: int, index: int
           ) -> torch.Tensor:
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n)


class _Enter(torch.autograd.Function):
    """Identity; the backward sums the gradient over the axis."""

    @staticmethod
    def forward(ctx, x, sh):
        ctx.sh = sh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.sh.group), None


class _Leave(torch.autograd.Function):
    """Sum over the axis; the gradient passes as it is (it is the same on
    every rank of the axis)."""

    @staticmethod
    def forward(ctx, x, sh):
        return _all_reduce(x, "sum", sh.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``. ``same``: the consumers of the result are
    the same on every rank, so the backward keeps this rank's block of
    the gradient; else they differ and the backward sums the blocks over
    the axis (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, sh, dim, same):
        ctx.sh, ctx.dim, ctx.same = sh, dim, same
        return _all_gather(x, dim, sh.size, sh.group)

    @staticmethod
    def backward(ctx, g):
        sh, dim = ctx.sh, ctx.dim
        if ctx.same:
            return _block(g, dim, sh.size, sh.index).contiguous(), \
                None, None, None
        return _reduce_scatter(g, dim, sh.size, sh.group), None, None, None


class _Scatter(torch.autograd.Function):
    """The sum over the axis of ``x``, this rank's block of ``dim`` (a
    reduce-scatter); the backward gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, sh, dim):
        ctx.sh, ctx.dim = sh, dim
        return _reduce_scatter(x, dim, sh.size, sh.group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.sh.size, ctx.sh.group), \
            None, None


class _Cut(torch.autograd.Function):
    """This rank's block of ``dim``; the backward gathers the blocks'
    gradients (the input is the same on every rank of the axis)."""

    @staticmethod
    def forward(ctx, x, sh, dim):
        ctx.sh, ctx.dim = sh, dim
        return _block(x, dim, sh.size, sh.index).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.sh.size, ctx.sh.group), \
            None, None


class Ring(NamedTuple):
    """The ranks a KV ring is split over (``sharding.rules.cache_specs``):
    a process group of ``size`` ranks named ``group``, this rank the
    ``index``-th, holding ring rows [index w / size, (index + 1) w / size)
    of a ring of ``w`` rows."""
    group: str
    size: int
    index: int

    def span(self, w: int) -> Tuple[int, int]:
        n = w // self.size
        return self.index * n, (self.index + 1) * n


class PoolShare(NamedTuple):
    """This rank's share of a prefix-cache page pool: pages [p0, p1) and
    page rows [r0, r1); ``group`` spans every rank holding a share."""
    group: str
    p0: int
    p1: int
    r0: int
    r1: int


class ActShardings:
    """The plan of one rank of a sharded train step or serving dispatch
    (see above; built by ``sharding.plan.MeshPlan``): ``specs``
    (``sharding.rules.act_specs``), ``rows`` (the :class:`Ring` of ranks
    whose rows make up the batch; ``rows_dim`` 0 where each holds a block
    of the batch, 1 where it holds a block of the sequence; None: this
    rank's rows are the batch), and the model axis ``axis`` of ``size``
    ranks over the process group named ``group``, this rank its
    ``index``-th; ``split`` holds the modules that keep their model-axis
    share of the weights.

    Serving adds: ``lanes`` ([lo, hi) of the batch this rank holds: its
    block over (pod, data); None for all), ``lane_group`` / ``lane_size``
    (the ranks holding the other blocks), ``ring`` (the :class:`Ring` the
    KV rings split over: ``model``, or (data, model) when the batch is
    smaller than the data axis), ``select_shards`` (A^3 selection blocks,
    a multiple of the ring's size), ``max_len`` (the rings are sized for
    it) and ``layer_hook`` (blk -> the context a layer runs in: its
    weights gathered, its own plan). A batch smaller than the data axis
    adds, as ``act_specs`` lays it out: ``sp`` (prefill: the ranks the
    sequence is split over, (data, model); each holds its block of the
    rows) or ``kdim`` (decode: the data axis, over which the dense
    weights keep their FSDP block of d_model, so each product takes its
    block of the contraction and sums over it, :func:`klinear`). A
    warm-admission copy adds ``pool`` (this rank's :class:`PoolShare`).
    Where the model axis does not divide the mLSTM's heads but their
    count divides it, ``cols`` is the :class:`Ring` of the model-axis
    ranks that share this rank's heads, each holding its block of their
    value columns (``models.xlstm``)."""

    def __init__(self, specs=None, rows: Optional[Ring] = None, *,
                 rows_dim: int = 0, axis: str = "model",
                 size: int = 1, index: int = 0, group: Optional[str] = None,
                 split=(), lanes: Optional[Tuple[int, int]] = None,
                 lane_group: Optional[str] = None, lane_size: int = 1,
                 ring: Optional[Ring] = None, select_shards: int = 1,
                 max_len: int = 0, sp: Optional[Ring] = None,
                 kdim: Optional[Ring] = None,
                 pool: Optional[PoolShare] = None, layer_hook=None,
                 cols: Optional[Ring] = None):
        self.specs = dict(specs or {})
        self.rows, self.rows_dim = rows, rows_dim
        self.axis, self.size, self.index, self.group = axis, size, index, \
            group
        self._split = frozenset(id(m) for m in split)
        self.lanes, self.lane_group, self.lane_size = lanes, lane_group, \
            lane_size
        self.ring, self.select_shards = ring, select_shards
        self.max_len, self.layer_hook = max_len, layer_hook
        self.sp, self.kdim, self.pool = sp, kdim, pool
        self.cols = cols

    def is_split(self, module) -> bool:
        """Whether ``module`` holds (and computes) this rank's share."""
        return self.size > 1 and id(module) in self._split

    def seq_split(self, kind: str = "q") -> bool:
        """Whether ``act_specs[kind]`` [B, H, S, D] puts the sequence on
        the model axis (heads that the axis does not divide)."""
        spec = self.specs.get(kind)
        return (self.size > 1 and spec is not None and len(spec) > 2
                and spec[1] is None and spec[2] == self.axis)

    def share(self, n: int) -> Tuple[int, int]:
        """This rank's block [lo, hi) of ``n`` items split evenly."""
        k = n // self.size
        return self.index * k, (self.index + 1) * k

    def ring_of(self, w: int) -> Optional[Ring]:
        """The ring a ``w``-row KV ring splits over, or None where the
        ring stays whole on every rank (``cache_specs``: the ring's
        ranks do not divide ``w``)."""
        r = self.ring
        return r if r is not None and w % r.size == 0 else None

    def cut_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's lanes of a global [B, ...] input."""
        return x if self.lanes is None else x[self.lanes[0]:self.lanes[1]]

    def gather_lanes(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's lanes of a [b, ...] output, in batch order."""
        if self.lane_size <= 1:
            return x
        return _all_gather(x, 0, self.lane_size, self.lane_group)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        return _Leave.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int, same: bool = False
               ) -> torch.Tensor:
        return _Gather.apply(x, self, dim % x.dim(), same)

    def cut(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Cut.apply(x, self, dim % x.dim())

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Scatter.apply(x, self, dim % x.dim())

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the axis, without a gradient."""
        return _all_reduce(x.detach(), "max", self.group)


def nan_max(x: torch.Tensor, group: str) -> torch.Tensor:
    """The elementwise max over the ranks of ``group``, NaN where any
    rank's is NaN (as ``torch.maximum``; an all-reduce ``max`` does not
    promise it): the max and a NaN flag go in one all-reduce."""
    nan = torch.isnan(x)
    packed = torch.stack([torch.where(nan, float("-inf"), x.float()),
                          nan.float()])
    packed = _all_reduce(packed, "max", group)
    return torch.where(packed[1] > 0, float("nan"), packed[0]).to(x.dtype)


def ring_sum(x: torch.Tensor, ring: Ring) -> torch.Tensor:
    """The sum over ``ring``'s ranks of ``x``, each rank using the sum
    its own way: the backward sums the gradients over them too."""
    return _Leave.apply(_Enter.apply(x, ring), ring)


def ring_gather(x: torch.Tensor, ring: Ring, dim: int) -> torch.Tensor:
    """``ring``'s ranks' ``x`` concatenated along ``dim``, each rank using
    the result its own way: the backward sums the gradients' blocks over
    them (a reduce-scatter)."""
    return _Gather.apply(x, ring, dim % x.dim(), False)


def all_reduce_sum(x: torch.Tensor, group: str) -> torch.Tensor:
    """The sum over the ranks of ``group`` (a NaN anywhere stays NaN)."""
    return _all_reduce(x, "sum", group)


def all_gather(x: torch.Tensor, dim: int, size: int, group: str
               ) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    return _all_gather(x, dim % x.dim(), size, group)


def klinear(x: torch.Tensor, w: torch.Tensor, sh=None) -> torch.Tensor:
    """``F.linear(x, w)``; where ``w`` holds this rank's block of its input
    dim over the plan's ``kdim`` ranks (a decode whose batch is smaller
    than the data axis), x's block of it, the products summed over them."""
    k = sh.kdim if sh is not None else None
    if k is None or w.shape[1] == x.shape[-1]:
        return F.linear(x, w)
    n = w.shape[1]
    return _all_reduce(F.linear(x[..., k.index * n:(k.index + 1) * n], w),
                       "sum", k.group)


def kfull(y: torch.Tensor, n: int, sh=None) -> torch.Tensor:
    """``y`` with all ``n`` of its last dim: gathered over the plan's
    ``kdim`` ranks where its weight kept a block of its output dim."""
    k = sh.kdim if sh is not None else None
    if k is None or y.shape[-1] == n:
        return y
    return _all_gather(y, y.dim() - 1, k.size, k.group)


def layer_scope(blk):
    """The context one layer of a serving dispatch runs in: the plan's
    ``layer_hook`` (its weights gathered, its own plan) on a mesh, else
    nothing."""
    sh = current_shardings()
    if sh is None or sh.layer_hook is None:
        return contextlib.nullcontext()
    return sh.layer_hook(blk)


@contextlib.contextmanager
def activation_shardings(shardings: Optional[ActShardings]):
    """Layers inside compute what ``shardings`` gives this rank (None:
    everything, on one device)."""
    token = _ACT.set(shardings)
    try:
        yield
    finally:
        _ACT.reset(token)


def current_shardings() -> Optional[ActShardings]:
    """The plan :func:`activation_shardings` installed, or None."""
    return _ACT.get()


def split_plan(module) -> Optional[ActShardings]:
    """The current plan when ``module`` computes this rank's share of the
    model axis, else None."""
    sh = current_shardings()
    return sh if sh is not None and sh.is_split(module) else None


def shard_act(x: torch.Tensor, kind: str, dim: int = 1) -> torch.Tensor:
    """``x`` as this rank computes it at the reference's constraint point
    ``kind``: its block of the sequence (``dim``) where ``act_specs``
    puts that kind's rows on the model axis, else ``x`` itself (the heads
    split is carried by the weights)."""
    sh = current_shardings()
    if sh is None or not sh.seq_split(kind):
        return x
    return sh.cut(x, dim)


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
    has no gate (reference ``ffn_apply``). Split on a mesh, this rank
    computes its ``d_ff`` columns and the outputs are summed over the
    model axis."""
    sh = current_shardings()
    split = sh is not None and sh.is_split(ffn)
    if split:
        x = sh.enter(x)
    if ffn.w_gate is None:
        h = gelu(klinear(x, ffn.w_up.weight, sh).float())
        y = F.linear(h.to(x.dtype), ffn.w_down.weight)
    else:
        g = F.silu(klinear(x, ffn.w_gate.weight, sh).float())
        u = klinear(x, ffn.w_up.weight, sh).float()
        y = F.linear((g * u).to(x.dtype), ffn.w_down.weight)
    return kfull(sh.leave(y) if split else y, x.shape[-1], sh)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return (torch.tanh(logits.float() / cap) * cap).to(logits.dtype)
