"""A^3 greedy candidate selection (paper SSIV), PyTorch port of
``repro.core.candidate_selection``: the numpy/heapq oracle of Figure 7
(:func:`select_candidates_oracle`) and its vectorised equivalent.

Every vectorised function takes leading batch dimensions: sorted keys
``[..., n, d]`` and queries ``[..., d]`` broadcast against each other,
which stands in for the reference's ``vmap``.

Ties are ordered exactly as in the reference: ``sort_key_columns`` is a
stable ascending argsort (as ``jnp.argsort``), and :func:`top_k`
reproduces ``jax.lax.top_k`` — descending in the IEEE total order
(``+0.0`` above ``-0.0``), the lower index first among equal values.
``torch.topk`` promises neither, so it is not used.
"""
from __future__ import annotations

import heapq
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# products of one side's prefix formed at once by select_candidates_batch
# (2^29 float32 = 2 GiB): bounds the selection's peak memory at full width
SELECT_CHUNK_ELEMS = 1 << 29


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


def quantize_sorted_keys(sk: SortedKeys) -> Tuple[SortedKeys, torch.Tensor]:
    """Sorted key columns to int8 with one float32 scale per column ->
    (int8 SortedKeys, scales [..., d]). Round-to-nearest is monotone, so
    the columns stay ascending; pass the scales to
    :func:`select_candidates`, which folds them into the query."""
    from repro_torch.core.quantization import quantize_int8_block
    q, scale = quantize_int8_block(sk.values, axes=(-2,))    # per column
    return SortedKeys(values=q, rows=sk.rows), scale[..., 0, :]


# ---------------------------------------------------------------------------
# Oracle: faithful priority-queue transcription of Figure 7 (numpy/heapq)
# ---------------------------------------------------------------------------

def select_candidates_oracle(
    key: np.ndarray,
    query: np.ndarray,
    m_iters: int,
    use_heuristic: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Paper Figure 7 (plus the symmetric minQ and SSIV-C heuristic) ->
    (candidate_mask [n] bool, greedy_score [n] float64)."""
    key = np.asarray(key, dtype=np.float64)
    query = np.asarray(query, dtype=np.float64)
    n, d = key.shape
    order = np.argsort(key, axis=0)
    svals = np.take_along_axis(key, order, axis=0)      # ascending per column

    greedy = np.zeros(n, dtype=np.float64)

    # max side: start at the end that makes products descending.
    max_ptr = np.where(query > 0, n - 1, 0)
    max_step = np.where(query > 0, -1, 1)
    # min side: the opposite end (products ascending).
    min_ptr = np.where(query > 0, 0, n - 1)
    min_step = np.where(query > 0, 1, -1)

    maxq: list = []   # (-product, col) so heapq pops the largest product
    minq: list = []   # (product, col)
    for j in range(d):
        maxq.append((-svals[max_ptr[j], j] * query[j], j))
        minq.append((svals[min_ptr[j], j] * query[j], j))
    heapq.heapify(maxq)
    heapq.heapify(minq)
    max_used = np.zeros(d, dtype=np.int64)   # pops consumed per column
    min_used = np.zeros(d, dtype=np.int64)

    cum = 0.0
    for _ in range(m_iters):
        # --- maxQ pop (always) ---
        if maxq:
            neg, j = heapq.heappop(maxq)
            val = -neg
            row = order[max_ptr[j], j]
            if val > 0:
                greedy[row] += val
                cum += val
            max_used[j] += 1
            if max_used[j] < n:
                max_ptr[j] += max_step[j]
                heapq.heappush(maxq, (-svals[max_ptr[j], j] * query[j], j))
        # --- minQ pop (skipped when cum < 0, per the paper's heuristic) ---
        if (not use_heuristic) or cum >= 0:
            if minq:
                val, j = heapq.heappop(minq)
                row = order[min_ptr[j], j]
                if val < 0:
                    greedy[row] += val
                    cum += val
                min_used[j] += 1
                if min_used[j] < n:
                    min_ptr[j] += min_step[j]
                    heapq.heappush(minq, (svals[min_ptr[j], j] * query[j], j))

    return greedy > 0, greedy


# ---------------------------------------------------------------------------
# Vectorised equivalent
# ---------------------------------------------------------------------------


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
    if not vals.is_floating_point():
        # int8 sorted keys (kv_quant): score the integer values directly,
        # the per-column scale is already folded into ``query``
        vals = vals.float()
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


def _walk_length(n: int, d: int, m_iters: int,
                 prefix_cap: Optional[int]) -> Tuple[int, int]:
    """(pops M, scanned per-column prefix L) of the greedy walk."""
    m = int(min(m_iters, n * d))
    length = int(min(m, n))
    if prefix_cap is not None:
        length = int(min(length, max(1, prefix_cap)))
        m = int(min(m, length * d))
    return m, length


def _pops(sk: SortedKeys, query: torch.Tensor, m: int, length: int):
    """The walk's M max-side pops (descending) and M min-side pops
    (ascending): (a_vals, a_rows, b_vals, b_rows), each [..., M]. One
    side at a time, so only one side's product prefix is alive."""
    flat = lambda t: t.reshape(*t.shape[:-2], -1)  # noqa: E731
    prod, rows = _prefix_products(sk, query, length, "max")
    a_vals, idx = top_k(flat(prod), m)                         # descending
    a_rows = torch.gather(flat(rows), -1, idx)
    del prod, rows, idx
    prod, rows = _prefix_products(sk, query, length, "min")
    nb_vals, idx = top_k(-flat(prod), m)
    b_rows = torch.gather(flat(rows), -1, idx)
    return a_vals, a_rows, -nb_vals, b_rows                    # b ascending


def _greedy(n: int, a_vals, a_rows, b_vals, b_rows, use_heuristic: bool):
    """Greedy scores [..., n] float32 from the pops -> (mask, score)."""
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


def select_candidates(
    sorted_keys: SortedKeys,
    query: torch.Tensor,
    m_iters: int,
    use_heuristic: bool = True,
    prefix_cap: Optional[int] = None,
    scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorised greedy candidate selection -> (candidate mask [..., n]
    bool, greedy score [..., n] float32). ``prefix_cap`` bounds the
    scanned per-column prefix as in the reference. ``scales`` [..., d]:
    per-column float32 scales of int8 ``sorted_keys``
    (:func:`quantize_sorted_keys`), folded into the query."""
    n, d = sorted_keys.n, sorted_keys.d
    if scales is not None:
        query = query.float() * scales
    m, length = _walk_length(n, d, m_iters, prefix_cap)
    return _greedy(n, *_pops(sorted_keys, query, m, length), use_heuristic)


def select_candidates_batch(
    sorted_keys: SortedKeys,
    queries: torch.Tensor,
    m_iters: int,
    use_heuristic: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`select_candidates` for a query batch ``[..., q, d]`` against
    sorted keys ``[..., n, d]`` -> ([..., q, n] mask, [..., q, n] score).

    Peak memory is bounded: the product prefixes and their top-M are
    formed for a chunk of queries (along ``q``) at a time, at most
    ``SELECT_CHUNK_ELEMS`` products per side, and the heuristic walk then
    runs once over all the kept pops. The result does not depend on the
    chunking."""
    sk = SortedKeys(sorted_keys.values.unsqueeze(-3),
                    sorted_keys.rows.unsqueeze(-3))
    n, d = sk.n, sk.d
    m, length = _walk_length(n, d, m_iters, None)
    lead = torch.broadcast_shapes(sk.values.shape[:-2], queries.shape[:-1])
    per_query = max(1, math.prod(lead) // queries.shape[-2]) * length * d
    step = max(1, SELECT_CHUNK_ELEMS // per_query)
    nq = queries.shape[-2]
    parts = [_pops(sk, queries[..., i:i + step, :], m, length)
             for i in range(0, nq, step)]
    pops = [torch.cat(p, dim=-2) if len(parts) > 1 else p[0]
            for p in zip(*parts)]
    del parts
    return _greedy(n, *pops, use_heuristic)
