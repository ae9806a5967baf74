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
from repro_torch.models.common import FFN, current_batch_rows, \
    ffn_apply, ffn_init_

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


def moe_route(p: MoE, xt: torch.Tensor, moe: MoEConfig,
              capacity_factor: float = CAPACITY_FACTOR
              ) -> Dict[str, torch.Tensor]:
    """Routing and dispatch plan of tokens xt [T, d]: ``probs`` [T, E],
    ``top_p``/``top_e`` [T, k], and over the T*k choices in expert order
    ``sort_idx``, ``keep`` (rank < cap) and ``slot`` (expert * cap + rank,
    E * cap = the overflow bin); plus ``cap``."""
    t = xt.shape[0]
    e, k = moe.num_experts, moe.top_k
    probs = torch.softmax(xt.float() @ p.router, -1)
    top_p, top_e = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    cap = max(int(math.ceil(t * k / e * capacity_factor)), 4)
    cap = ((cap + 63) // 64) * 64
    flat_e = top_e.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = _counts(flat_e, e)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=xt.device) - starts[sorted_e]
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank, e * cap)
    return dict(probs=probs, top_p=top_p, top_e=top_e, sort_idx=sort_idx,
                keep=keep, slot=slot, cap=cap)


def moe_apply(p: MoE, x: torch.Tensor, moe: MoEConfig, *,
              capacity_factor: float = CAPACITY_FACTOR
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] -> (out [B, S, d], {"moe_aux_loss",
    "moe_drop_fraction"}). Under ``common.batch_rows`` (a sharded train
    step) the routing runs over the rows of every rank that shares the
    batch, as the single-device step routes the whole batch; ``out`` is
    this rank's rows."""
    rows = current_batch_rows()
    if rows is not None:
        x = rows.gather(x)
    b, s, d = x.shape
    t = b * s
    e, k = moe.num_experts, moe.top_k
    xt = x.reshape(t, d)
    r = moe_route(p, xt, moe, capacity_factor)
    cap, sort_idx, keep, slot = r["cap"], r["sort_idx"], r["keep"], r["slot"]
    token_of = sort_idx // k

    # gather tokens into [E * cap (+ overflow), d]
    buf = x.new_zeros((e * cap + 1, d))
    buf[slot] = xt[token_of]
    expert_in = buf[:e * cap].reshape(e, cap, d)

    # the routed experts, batched over the expert axis
    g = F.silu(torch.bmm(expert_in, p.w_gate).float())
    u = torch.bmm(expert_in, p.w_up).float()
    expert_out = torch.bmm((g * u).to(x.dtype), p.w_down)     # [E, cap, d]

    # combine: un-sort the weighted choices to [T, k], sum over k in order
    flat_out = torch.cat([expert_out.reshape(e * cap, d),
                          x.new_zeros((1, d))])
    w = torch.where(keep, r["top_p"].reshape(-1)[sort_idx], 0.0)
    contrib = torch.empty((t * k, d), dtype=torch.float32, device=x.device)
    contrib[sort_idx] = flat_out[slot].float() * w[:, None]
    contrib = contrib.reshape(t, k, d)
    combined = contrib[:, 0]
    for j in range(1, k):
        combined = combined + contrib[:, j]
    out = combined.to(x.dtype)
    if p.shared is not None:
        out = out + ffn_apply(p.shared, xt)

    # Switch load-balance loss, and the share of choices dropped
    frac_tokens = _counts(r["top_e"].reshape(-1), e).float() / (t * k)
    frac_probs = r["probs"].mean(0)
    aux_loss = e * torch.sum(frac_tokens * frac_probs) \
        * moe.load_balance_coef
    dropped = 1.0 - keep.float().mean()
    out = out.reshape(b, s, d)
    if rows is not None:
        out = rows.own(out)
    return out, {"moe_aux_loss": aux_loss, "moe_drop_fraction": dropped}
