"""A^3 greedy candidate selection (paper SSIV), PyTorch port of the
vectorised path of ``repro.core.candidate_selection``.

Every function takes leading batch dimensions: sorted keys
``[..., n, d]`` and queries ``[..., d]`` broadcast against each other,
which stands in for the reference's ``vmap``.

Ties are ordered exactly as in the reference: ``sort_key_columns`` is a
stable ascending argsort (as ``jnp.argsort``), and :func:`top_k`
reproduces ``jax.lax.top_k`` — descending in the IEEE total order
(``+0.0`` above ``-0.0``), the lower index first among equal values.
``torch.topk`` promises neither, so it is not used.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class SortedKeys(NamedTuple):
    """Per-column ascending sort of the key matrix (paper Fig. 8).

    values: [..., n, d] — column j holds sort(key[:, j]) ascending.
    rows:   [..., n, d] int32 — original row index of each sorted value.
    """
    values: torch.Tensor
    rows: torch.Tensor

    @property
    def n(self) -> int:
        return self.values.shape[-2]

    @property
    def d(self) -> int:
        return self.values.shape[-1]


def sort_key_columns(key: torch.Tensor) -> SortedKeys:
    """Preprocess: stable sort of each column of ``key`` [..., n, d]."""
    order = torch.argsort(key, dim=-2, stable=True)
    values = torch.gather(key, -2, order)
    return SortedKeys(values=values, rows=order.to(torch.int32))


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """Integer key whose order is the IEEE total order of ``x``."""
    if not x.is_floating_point():
        return x
    if x.dtype != torch.float64:
        bits = x.float().view(torch.int32)
        return bits ^ ((bits >> 31) & 0x7FFFFFFF)
    bits = x.view(torch.int64)
    return bits ^ ((bits >> 63) & 0x7FFFFFFFFFFFFFFF)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending total order, lower index first on ties."""
    order = torch.sort(_total_order_key(x), dim=-1, descending=True,
                       stable=True).indices[..., :k]
    return torch.gather(x, -1, order), order


def _prefix_products(sk: SortedKeys, query: torch.Tensor, length: int,
                     side: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column product prefix in pop order -> (products [..., L, d],
    rows [..., L, d]); "max" descending, "min" ascending per column."""
    n = sk.n
    top = sk.values[..., n - length:, :].flip(-2)
    bot = sk.values[..., :length, :]
    top_r = sk.rows[..., n - length:, :].flip(-2)
    bot_r = sk.rows[..., :length, :]
    qpos = (query > 0)[..., None, :]
    if side == "max":
        vals = torch.where(qpos, top, bot)
        rows = torch.where(qpos, top_r, bot_r)
    else:
        vals = torch.where(qpos, bot, top)
        rows = torch.where(qpos, bot_r, top_r)
    return vals * query[..., None, :], rows


def _heuristic_masks(a_vals: torch.Tensor, b_vals: torch.Tensor):
    """The paper's cumulative-sum heuristic, stepped over the M pops
    (the reference's ``lax.scan``). a_vals/b_vals: [..., M] ->
    (a_mask, b_mask) [..., M] bool."""
    m = a_vals.shape[-1]
    lead = a_vals.shape[:-1]
    cum = torch.zeros(lead, dtype=torch.float32, device=a_vals.device)
    j = torch.zeros(lead, dtype=torch.int64, device=a_vals.device)
    a_mask, do_min_s, b_add_s = [], [], []
    for kk in range(m):
        a = a_vals[..., kk]
        a_add = a > 0
        cum = cum + torch.where(a_add, a, 0.0)
        do_min = cum >= 0
        b = torch.gather(b_vals, -1, j.clamp(max=m - 1)[..., None])[..., 0]
        b_add = do_min & (b < 0)
        cum = cum + torch.where(b_add, b, 0.0)
        j = j + do_min.long()
        a_mask.append(a_add)
        do_min_s.append(do_min)
        b_add_s.append(b_add)
    a_mask = torch.stack(a_mask, -1)
    do_min = torch.stack(do_min_s, -1)
    b_add = torch.stack(b_add_s, -1)
    # the b element consumed at step k (when do_min) is cumsum(do_min)-1
    j_at_step = torch.cumsum(do_min.long(), -1) - 1
    b_mask = torch.zeros(a_vals.shape, dtype=torch.int32,
                         device=a_vals.device).scatter_reduce(
        -1, j_at_step.clamp(0, m - 1), (do_min & b_add).int(), "amax")
    return a_mask, b_mask > 0


def select_candidates(
    sorted_keys: SortedKeys,
    query: torch.Tensor,
    m_iters: int,
    use_heuristic: bool = True,
    prefix_cap: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorised greedy candidate selection -> (candidate mask [..., n]
    bool, greedy score [..., n] float32). ``prefix_cap`` bounds the
    scanned per-column prefix as in the reference."""
    n, d = sorted_keys.n, sorted_keys.d
    m = int(min(m_iters, n * d))
    length = int(min(m, n))
    if prefix_cap is not None:
        length = int(min(length, max(1, prefix_cap)))
        m = int(min(m, length * d))

    prod_max, rows_max = _prefix_products(sorted_keys, query, length, "max")
    prod_min, rows_min = _prefix_products(sorted_keys, query, length, "min")
    flat = lambda t: t.reshape(*t.shape[:-2], -1)  # noqa: E731

    a_vals, a_idx = top_k(flat(prod_max), m)                   # descending
    a_rows = torch.gather(flat(rows_max), -1, a_idx)
    nb_vals, b_idx = top_k(-flat(prod_min), m)
    b_vals = -nb_vals                                          # ascending
    b_rows = torch.gather(flat(rows_min), -1, b_idx)

    if use_heuristic:
        a_mask, b_mask = _heuristic_masks(a_vals, b_vals)
    else:
        a_mask = a_vals > 0
        b_mask = b_vals < 0

    greedy = torch.zeros((*a_vals.shape[:-1], n), dtype=torch.float32,
                         device=a_vals.device)
    greedy.scatter_add_(-1, a_rows.long(),
                        torch.where(a_mask, a_vals, 0.0).float())
    greedy.scatter_add_(-1, b_rows.long(),
                        torch.where(b_mask, b_vals, 0.0).float())
    return greedy > 0, greedy
