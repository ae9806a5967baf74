"""Mixture-of-Experts FFN, DeepSeekMoE / Grok style (PyTorch port of
``repro.models.moe``).

Routing: a float32 softmax router, top-k with the weights renormalised
over the chosen k, and a capacity per expert,
``cap = round_up(max(ceil(T k / E * 1.25), 4), 64)`` over every token of
the call (``T = B * S``, pad positions and idle lanes included, as in the
reference). Dispatch: a stable sort of the T*k choices by expert; a
choice's rank within its expert decides whether it keeps a slot
(rank < cap) or goes to the overflow bin. The routed experts run as
batched SwiGLUs over ``[E, cap, d]`` (``torch.bmm``); ``num_shared``
always-on shared experts are one dense SwiGLU of width
``num_shared * d_expert``.

The top-k is the port's tie-exact ``top_k`` (the lower expert index on
ties, as ``lax.top_k``). The combine is deterministic: the reference's
scatter-add of up to k contributions per token becomes an un-sort into
``[T, k]`` and a sum over k in a fixed order, so the card and the CPU add
the same floats in the same order (an atomic ``index_add_`` would not).

On a mesh (a plan from ``sharding.plan``) each rank computes its share of
what one device computes over the whole batch, as GSPMD splits the
reference's program: the router scores this rank's block of its rows
(the rows split over the model axis too), and only the routing integers
``top_e`` are gathered over the ranks that share the batch (``rows``), so
every rank runs one device's stable sort and each choice gets one
device's slot, capacity and drop. The ``[E, cap, d]`` buffer is laid out
as the rules lay out the expert weights: its experts over the model axis
(EP) or every expert with its ``d_expert`` columns there (TP), and in both
the ``cap`` slots in equal blocks over the batch's ranks. A fixed-size
reduce-scatter over those ranks takes each kept choice's token to the
rank holding its slot and an all-gather brings the expert outputs back
(no split size is read back to the host); each rank combines its rows'
choices in the fixed order and the partial sums are summed over the
model axis. No rank gathers the hidden rows. With no plan (or a plan of
one rank whose experts are whole) the same function runs one device's
ops.

Parameters keep the reference's layout: ``router`` [d, E] float32, the
expert stacks ``w_gate``/``w_up`` [E, d, d_e] and ``w_down`` [E, d_e, d]
(``bmm`` operands as they are), ``shared`` a SwiGLU :class:`FFN`.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.config import MoEConfig
from repro_torch.core.candidate_selection import top_k
from repro_torch.models.common import FFN, Ring, _Gather, _Scatter, \
    all_gather, all_reduce_sum, current_shardings, ffn_apply, ffn_init_

CAPACITY_FACTOR = 1.25


class MoE(nn.Module):
    def __init__(self, d_model: int, moe: MoEConfig, dtype, device=None):
        super().__init__()
        e, d_e = moe.num_experts, moe.d_expert
        if d_e <= 0:
            raise ValueError("MoEConfig.d_expert must be set")

        def stack(d_in, d_out):
            return nn.Parameter(torch.empty((e, d_in, d_out), dtype=dtype,
                                            device=device))
        self.router = nn.Parameter(torch.empty((d_model, e),
                                               dtype=torch.float32,
                                               device=device))
        self.w_gate = stack(d_model, d_e)
        self.w_up = stack(d_model, d_e)
        self.w_down = stack(d_e, d_model)
        self.shared = (FFN(d_model, moe.num_shared * d_e, dtype, device)
                       if moe.num_shared > 0 else None)


def moe_init_(p: MoE, generator: torch.Generator) -> None:
    """The reference's ``moe_init`` distributions: N(0, 1/d) router,
    N(0, 1/d_in) expert stacks, shared experts as a dense FFN."""
    with torch.no_grad():
        for w in (p.router, p.w_gate, p.w_up, p.w_down):
            w.copy_(torch.randn(w.shape, generator=generator,
                                device=w.device) / math.sqrt(w.shape[-2]))
    if p.shared is not None:
        ffn_init_(p.shared, generator)


def _counts(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Choices per expert; ``torch.bincount`` would read the input's max
    back to the host on a CUDA tensor."""
    return torch.zeros(e, dtype=torch.long, device=flat_e.device
                       ).scatter_add_(0, flat_e, torch.ones_like(flat_e))


def capacity(t: int, moe: MoEConfig,
             capacity_factor: float = CAPACITY_FACTOR) -> int:
    """Slots per expert for ``t`` routed tokens (a multiple of 64)."""
    cap = max(int(math.ceil(t * moe.top_k / moe.num_experts
                            * capacity_factor)), 4)
    return ((cap + 63) // 64) * 64


def _sorted_ranks(flat_e: torch.Tensor, e: int):
    """The choices ``flat_e`` [N] (token-major) in a stable sort by expert
    -> (``sort_idx``, the sorted experts, each sorted choice's rank
    within its expert)."""
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = _counts(flat_e, e)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(flat_e.shape[0], device=flat_e.device) \
        - starts[sorted_e]
    return sort_idx, sorted_e, rank


def router_probs(p: MoE, xt: torch.Tensor) -> torch.Tensor:
    """The router's float32 softmax [T, E] of tokens xt [T, d]."""
    return torch.softmax(xt.float() @ p.router, -1)


def _top(probs: torch.Tensor, k: int):
    """The ``k`` chosen experts of each row of ``probs`` -> (``top_p``,
    renormalised over the k, ``top_e``)."""
    top_p, top_e = top_k(probs, k)
    return top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9), top_e


def _slots(flat_e: torch.Tensor, e: int, cap: int):
    """One device's dispatch of the choices ``flat_e`` [N] (token-major) ->
    in expert order, (``sort_idx``, ``keep`` (rank < cap), ``slot``
    (expert * cap + rank, E * cap = the overflow bin))."""
    sort_idx, sorted_e, rank = _sorted_ranks(flat_e, e)
    keep = rank < cap
    return sort_idx, keep, torch.where(keep, sorted_e * cap + rank, e * cap)


def moe_route(p: MoE, xt: torch.Tensor, moe: MoEConfig,
              capacity_factor: float = CAPACITY_FACTOR
              ) -> Dict[str, torch.Tensor]:
    """Routing and dispatch plan of tokens xt [T, d]: ``probs`` [T, E],
    ``top_p``/``top_e`` [T, k], and over the T*k choices in expert order
    ``sort_idx``, ``keep`` and ``slot`` (:func:`_slots`); plus ``cap``."""
    probs = router_probs(p, xt)
    top_p, top_e = _top(probs, moe.top_k)
    cap = capacity(xt.shape[0], moe, capacity_factor)
    sort_idx, keep, slot = _slots(top_e.reshape(-1), moe.num_experts, cap)
    return dict(probs=probs, top_p=top_p, top_e=top_e, sort_idx=sort_idx,
                keep=keep, slot=slot, cap=cap)


def _swiglu(p: MoE, expert_in: torch.Tensor) -> torch.Tensor:
    """The routed experts' SwiGLUs over [E', c, d] (``torch.bmm``) with the
    expert stacks this rank holds."""
    g = F.silu(torch.bmm(expert_in, p.w_gate).float())
    u = torch.bmm(expert_in, p.w_up).float()
    return torch.bmm((g * u).to(expert_in.dtype), p.w_down)


class _RowSum(torch.autograd.Function):
    """The sum over the ranks that share the batch, of a statistic each
    rank's loss reads whole: the backward sums the gradients too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def _own(t: torch.Tensor, rows: Ring, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` of a tensor of every rank's rows."""
    n = t.shape[dim] // rows.size
    return t.narrow(dim, rows.index * n, n)


def moe_apply(p: MoE, x: torch.Tensor, moe: MoEConfig, *,
              capacity_factor: float = CAPACITY_FACTOR
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] -> (out [B, S, d], {"moe_aux_loss",
    "moe_drop_fraction"}). Under a plan (``common.activation_shardings``:
    a sharded train step or serving dispatch) ``x`` is this rank's rows,
    the routing is the whole batch's, as on one device, and the rank runs
    its block of the capacity buffer (module docstring)."""
    sh = current_shardings()
    rows = sh.rows if sh is not None and sh.rows is not None \
        else Ring(None, 1, 0)
    n = rows.size
    b, s, d = x.shape
    tl = b * s
    e, k = moe.num_experts, moe.top_k
    ep = p.w_gate.shape[0] < e
    split = ep or p.w_gate.shape[2] < moe.d_expert
    mm, mi = (sh.size, sh.index) if split else (1, 0)
    xt = x.reshape(tl, d)

    # routing: this rank's block of its rows where the model axis divides
    # them (the router's gradient summed over the axis), else all of them
    blk = split and tl % mm == 0
    if blk:
        probs = torch.softmax(sh.cut(xt, 0).float() @ sh.enter(p.router), -1)
    else:
        probs = router_probs(p, xt)
    top_p, top_e = _top(probs, k)
    if blk:       # every rank of the axis combines some of each row's k
        top_p = sh.gather(top_p, 0)
        top_e = all_gather(top_e, 0, mm, sh.group)
    elif split:
        top_p = sh.enter(top_p)

    # one device's routing of the whole batch, from every rank's integers
    every = top_e.view(b, s, k)
    if rows.group is not None:
        every = all_gather(every, sh.rows_dim, n, rows.group)
    t = tl * n
    cap = capacity(t, moe, capacity_factor)
    if cap % n:
        raise ValueError(f"capacity {cap} does not split over {n} ranks")
    flat_e = every.reshape(-1)
    # this rank's region of the [E, cap] slots of every batch rank's
    # block: its experts (EP) or its share of the flattened block (TP)
    cb = cap // n
    if (e * cb) % mm:
        raise ValueError(f"{e} x {cb} slots do not split over {mm} ranks")
    reg = e * cb // mm
    if n == 1 and not split:     # the whole buffer: one device's slots
        sort_idx, keep, slot = _slots(flat_e, e, cap)
        sent = keep
    else:
        order, _, rank = _sorted_ranks(flat_e, e)
        rank = torch.empty_like(rank).scatter_(0, order, rank)
        keep = rank < cap
        mine = _own(rank.view(every.shape), rows, sh.rows_dim
                    ).reshape(tl, k)
        c_in = mine % cb
        if ep:
            el = e // mm
            owner, pos = top_e // el, (top_e % el) * cb + c_in
        else:
            flat = top_e * cb + c_in
            owner, pos = flat // reg, flat % reg
        sent = ((mine < cap) & (owner == mi)).reshape(-1)
        slot = torch.where(sent, ((mine // cb) * reg + pos).reshape(-1),
                           n * reg)
        # this rank's choices in the whole batch's order (a stable sort by
        # expert), so that one rank runs one device's ops
        sort_idx = torch.argsort(top_e.reshape(-1), stable=True)
        slot, sent = slot[sort_idx], sent[sort_idx]

    # tokens to the ranks holding their slots: block i of every rank's
    # buffer summed on rank i (exact: each slot has one writer), and the
    # outputs back to every rank (the reverse exchange is each backward)
    xin = sh.enter(xt) if split else xt
    buf = xt.new_zeros((n * reg + 1, d))
    buf[slot] = xin[sort_idx // k]
    block = buf[:n * reg]
    if rows.group is not None:
        block = _Scatter.apply(block, rows, 0)              # [reg, d]
    if ep or not split:
        out = _swiglu(p, block.view(-1, cb, d))
    else:
        out = sh.scatter(_swiglu(p, sh.gather(block, 0).view(e, cb, d))
                         .reshape(e * cb, d), 0)
    out = out.reshape(reg, d)
    if rows.group is not None:
        out = _Gather.apply(out, rows, 0, False)            # [n reg, d]

    # combine: un-sort the weighted choices to [T, k], sum over k in
    # order; then the partial sums over the model axis
    flat_out = torch.cat([out, out.new_zeros((1, d))])
    w = torch.where(sent, top_p.reshape(-1)[sort_idx], 0.0)
    contrib = torch.empty((tl * k, d), dtype=torch.float32, device=x.device)
    contrib[sort_idx] = flat_out[slot].float() * w[:, None]
    contrib = contrib.reshape(tl, k, d)
    combined = contrib[:, 0]
    for j in range(1, k):
        combined = combined + contrib[:, j]
    if split:
        combined = sh.leave(combined)
    out = combined.to(x.dtype).reshape(b, s, d)
    if p.shared is not None:
        out = out + ffn_apply(p.shared, x)

    # Switch load-balance loss over the whole batch, and the drops
    frac_tokens = _counts(flat_e, e).float() / (t * k)
    frac_probs = probs.mean(0)
    if rows.group is not None:
        frac_probs = _RowSum.apply(frac_probs, rows.group)
    if blk:
        frac_probs = sh.leave(frac_probs)
    parts = n * (mm if blk else 1)
    if parts > 1:
        frac_probs = frac_probs / parts
    aux_loss = e * torch.sum(frac_tokens * frac_probs) \
        * moe.load_balance_coef
    dropped = 1.0 - keep.float().mean()
    return out, {"moe_aux_loss": aux_loss, "moe_drop_fraction": dropped}
