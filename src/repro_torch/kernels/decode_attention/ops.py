"""Public entry: A^3 decode attention over a KV cache (PyTorch port of
``repro.kernels.decode_attention.ops``).

``a3_decode_attention`` merges cache validity with the A^3 candidate
mask (fresh-tail rows always candidates) and runs the decode-attention
kernel: on CUDA tensors the hand-written kernel, on CPU tensors its
plain version (the reference's ``use_kernel`` switch is gone — the
tensors' device decides). ``a3_decode_attention_compact`` is plain torch
ops, as its reference is plain jnp.

On a mesh the KV ring is split over ranks (``models.common.Ring``):
kernels #1 and #3 hand out partial softmaxes, and
:func:`combine_partials` merges them, over a process group or over a
list on one device; the compact path runs its selection blocks where
their rows are and combines the post-scored softmax over the ring.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import A3Config, A3Mode
from repro_torch.core.candidate_selection import SortedKeys, \
    select_candidates, top_k
from repro_torch.kernels.decode_attention.kernel import NEG_INF, \
    decode_attention
from repro_torch.models.common import Ring, all_reduce_sum, nan_max, \
    round_to


def combine_partials(outs, stats, *, stat: str = "lse",
                     group: Optional[str] = None, return_stat: bool = False):
    """Merge partial softmaxes of one query row set over disjoint slices
    of the keys -> the float32 output over all of them.

    ``outs`` [B, Hq, Dv] float32 (each slice's normalised output, 0 where
    it kept nothing) and ``stats`` [B, Hq]: with ``stat="lse"`` kernel
    #1's log-sum-exp (``M = max_r lse_r``, ``o = sum_r o_r e^(lse_r - M)
    / sum_r e^(lse_r - M)``), with ``stat="sum"`` kernel #3's row sums
    against a shared row max (``o = sum_r o_r l_r / sum_r l_r``, 0 where
    the sum is 0). Either lists of the slices' tensors on one device, or
    this rank's with ``group`` the process group (by name) whose ranks
    hold the other slices. A NaN in any slice makes its row NaN: the
    terms are summed (an all-reduce sum keeps NaN) and a NaN
    log-sum-exp weighs its slice NaN. Shapes broadcast: any leading dims
    before Dv. ``return_stat``: also the merged statistic (the log-sum-exp
    over every slice, NEG_INF where nothing was kept; or the summed row
    sum)."""
    local = isinstance(outs, (list, tuple))
    o = torch.stack(list(outs)) if local else outs[None]
    st = torch.stack(list(stats)) if local else stats[None]
    if stat not in ("lse", "sum"):
        raise ValueError(f"stat must be 'lse' or 'sum', got {stat!r}")
    # each slice weighed against the largest, whose weight is exactly 1:
    # one slice (a ring held whole) comes back bit for bit
    m = st.amax(0)
    if group is not None:
        m = nan_max(m, group)
    if stat == "lse":
        w = torch.exp(st - m)
    else:
        w = torch.where(m == 0.0, 0.0, st / torch.where(m == 0.0, 1.0, m))
    num = (o * w[..., None]).sum(0)
    den = w.sum(0)
    if group is not None:
        packed = all_reduce_sum(torch.cat([num, den[..., None]], -1), group)
        num, den = packed[..., :-1], packed[..., -1]
    out = torch.where(den[..., None] == 0.0, 0.0,
                      num / torch.where(den == 0.0, 1.0, den)[..., None])
    if not return_stat:
        return out
    if stat == "sum":
        return out, den * m
    lse = torch.where(den > 0.0, m + torch.log(den), NEG_INF)
    return out, torch.where(torch.isnan(den), den, lse)


def a3_decode_mask(
    q: torch.Tensor,                # [B, Hq, D]
    k: torch.Tensor,                # [B, Hkv, S, D]
    valid_mask: torch.Tensor,       # [B, S] cache validity
    cfg: A3Config,
    sorted_keys: Optional[SortedKeys] = None,   # [B, Hkv, S, D] if given
    fresh_from: Optional[torch.Tensor] = None,  # [B] first unsorted pos
):
    """(mask [B, Hq, S], threshold) of :func:`a3_decode_attention`: cache
    validity merged with the A^3 candidates (fresh-tail rows always
    candidates)."""
    b, hq, d = q.shape
    _, hkv, s_len, _ = k.shape
    group = hq // hkv
    scale = d ** -0.5

    if cfg.mode == A3Mode.OFF or sorted_keys is None:
        mask = valid_mask[:, None, :].expand(b, hq, s_len)
        thr = None if cfg.mode == A3Mode.OFF else cfg.threshold_nats
    else:
        m = cfg.m_for(s_len)
        # sorted keys are per (batch, kv head); the group's queries share
        sk = SortedKeys(sorted_keys.values[:, :, None],
                        sorted_keys.rows[:, :, None])
        qs = q.reshape(b, hkv, group, d) * round_to(scale, q.dtype)
        cand, _ = select_candidates(sk, qs, m)
        cand = cand.reshape(b, hq, s_len)
        if fresh_from is not None:
            pos = torch.arange(s_len, device=q.device)[None, None, :]
            cand = cand | (pos >= fresh_from[:, None, None])
        mask = cand & valid_mask[:, None, :]
        thr = cfg.threshold_nats
    return mask, thr


def a3_decode_attention(
    q: torch.Tensor,                # [B, Hq, D]
    k: torch.Tensor,                # [B, Hkv, S, D]
    v: torch.Tensor,                # [B, Hkv, S, Dv]
    valid_mask: torch.Tensor,       # [B, S] cache validity
    cfg: A3Config,
    sorted_keys: Optional[SortedKeys] = None,   # [B, Hkv, S, D] if given
    fresh_from: Optional[torch.Tensor] = None,  # [B] first unsorted pos
    *,
    exact_two_pass: bool = False,
) -> torch.Tensor:
    mask, thr = a3_decode_mask(q, k, valid_mask, cfg, sorted_keys,
                               fresh_from)
    return decode_attention(q.contiguous(), k, v, mask.contiguous(),
                            threshold=thr, exact_two_pass=exact_two_pass)


def a3_decode_attention_compact(
    q: torch.Tensor,                # [B, Hq, D]
    k: torch.Tensor,                # [B, Hkv, S, D]
    v: torch.Tensor,                # [B, Hkv, S, Dv]
    valid_mask: torch.Tensor,       # [B, S]
    cfg: A3Config,
    sorted_keys: SortedKeys,        # per (B, Hkv): [B, Hkv, S, D]
    fresh_mask: Optional[torch.Tensor] = None,   # [B, S] always-include
    budget: Optional[int] = None,
    sk_scale: Optional[torch.Tensor] = None,     # [B, Hkv, NS, D] float32
    k_scale: Optional[torch.Tensor] = None,      # [B, Hkv, S] float32
    v_scale: Optional[torch.Tensor] = None,      # [B, Hkv, S] float32
    return_probe: bool = False,
    ring: Optional[Ring] = None,
):
    """A^3 decode with sharded compaction (reference docstring): the
    ring splits into ``cfg.select_shards`` blocks, each runs the
    prefix-capped greedy walk and keeps its top-(C/NS) rows, and the
    post-scored softmax is exact over the gathered [C] candidates.
    Candidate sets are unioned across the GQA group; ``fresh_mask`` rows
    are force-included.

    Int8 scoring: with ``sk_scale`` the sorted values may be int8
    columns, and the per-(block, column) scale is folded into the query
    (a positive scale keeps the walk's order and sign split); with
    ``k_scale``/``v_scale`` (per ring row) K and V may be int8, and only
    the gathered candidates are dequantized, in float32.

    Quality probe (``return_probe=True``): also returns a ``[B, 2]``
    float32 tensor per lane: the mean candidate count per kv head, and
    the captured score mass (softmax mass over the kept candidates over
    the softmax mass over every valid ring row, both from the full-ring
    float32 scores against the full-ring max, ``k_scale`` applied; in
    [0, 1] by construction). It scores the whole ring once, so callers
    sample it. The attention output runs the identical ops either way.

    ``ring``: k, v, the sorted keys and the masks are this rank's slice
    of a ring split over ``ring.size`` ranks. The slice holds whole
    selection blocks (``select_shards`` must be a multiple of the ring's
    ranks and divide the ring), each block runs its walk and its top-k
    here, the post-scoring threshold is taken against the max over every
    rank's candidates, and the softmax over their union is summed over
    the ranks, as are the probe's masses and counts."""
    b, hq, d = q.shape
    _, hkv, s_len, dv = v.shape
    group = hq // hkv
    scale = d ** -0.5
    n_loc = 1
    if ring is not None:
        s_len *= ring.size
        ns = max(cfg.select_shards, 1)
        if ns % ring.size or s_len % ns:
            raise ValueError(
                f"select_shards {ns} must be a multiple of the {ring.size} "
                f"ranks the ring of {s_len} rows is split over, and divide "
                f"the ring")
        n_loc = ring.size
    else:
        ns = cfg.select_shards if s_len % max(cfg.select_shards, 1) == 0 \
            else 1
    sl = s_len // ns
    m = cfg.m_for(s_len)
    c_total = int(min(s_len, budget if budget is not None
                      else max(64, m // 2)))
    c_loc = min(sl, max(16, c_total // ns))
    m_loc = min(sl * d, max(c_loc, m // ns))
    thr = cfg.threshold_nats
    cap = min(sl, max(16, (4 * m_loc + d - 1) // d))

    nb = ns // n_loc                                  # blocks held here
    blk5 = lambda t: t.reshape(b, hkv, nb, sl, t.shape[-1])  # noqa: E731
    kb, vb = blk5(k), blk5(v)
    skv, skr = blk5(sorted_keys.values), blk5(sorted_keys.rows)
    qg = q.reshape(b, hkv, group, d).float() * scale
    valid_b = valid_mask.reshape(b, 1, nb, sl)
    fresh_b = (fresh_mask.reshape(b, 1, nb, sl) if fresh_mask is not None
               else torch.zeros_like(valid_b))

    # prefix slices per block (ascending sort -> bottom = min side)
    top_v = skv[..., sl - cap:, :].flip(-2)          # [B,Hkv,NS,cap,D]
    bot_v = skv[..., :cap, :]
    top_r = skr[..., sl - cap:, :].flip(-2)
    bot_r = skr[..., :cap, :]

    qpos = (qg > 0)[:, :, None, :, None, :]          # [B,Hkv,1,G,1,D]
    qexp = qg[:, :, None, :, None, :]
    if sk_scale is not None:
        qexp = qexp * sk_scale.reshape(b, hkv, nb, 1, 1, d)
    tv = top_v[:, :, :, None].float()                # [B,Hkv,NS,1,cap,D]
    bv = bot_v[:, :, :, None].float()
    prod_max = torch.where(qpos, tv, bv) * qexp      # [B,Hkv,NS,G,cap,D]
    prod_min = torch.where(qpos, bv, tv) * qexp
    rows_max = torch.where(qpos, top_r[:, :, :, None], bot_r[:, :, :, None])
    rows_min = torch.where(qpos, bot_r[:, :, :, None], top_r[:, :, :, None])

    # top-(m_loc) products per block, scatter-added into greedy scores
    flat = lambda t: t.reshape(*t.shape[:4], cap * d)  # noqa: E731
    a_vals, a_idx = top_k(flat(prod_max), m_loc)
    b_nvals, b_idx = top_k(-flat(prod_min), m_loc)
    b_vals = -b_nvals
    a_rows = torch.gather(flat(rows_max.expand(prod_max.shape)), -1, a_idx)
    b_rows = torch.gather(flat(rows_min.expand(prod_min.shape)), -1, b_idx)

    # a row id past its block (the whole ring's sort read as blocks, as
    # one device leaves it after a chunked prefill, a warm admission or a
    # re-sort with select_shards > 1) adds nothing: the reference's
    # scatter drops it
    greedy = torch.zeros((b, hkv, nb, group, sl), dtype=torch.float32,
                         device=q.device)
    a_in, b_in = a_rows < sl, b_rows < sl
    greedy.scatter_add_(-1, torch.where(a_in, a_rows, 0).long(),
                        torch.where(a_in & (a_vals > 0), a_vals, 0.0))
    greedy.scatter_add_(-1, torch.where(b_in, b_rows, 0).long(),
                        torch.where(b_in & (b_vals < 0), b_vals, 0.0))

    score_u = greedy.amax(3)                          # union over G
    score_u = torch.where(valid_b, score_u, float("-inf"))
    score_u = torch.where(fresh_b & valid_b, float("inf"), score_u)
    _, idx = top_k(score_u, c_loc)                    # [B,Hkv,NS,Cl]
    live = torch.gather(score_u, -1, idx) > 0
    kc = torch.gather(kb, 3, idx[..., None].expand(*idx.shape, d))
    vc = torch.gather(vb, 3, idx[..., None].expand(*idx.shape, dv))
    # int8 K/V: the per-row scales ride the same gather, so only the
    # compacted candidates widen to float32
    if k_scale is not None:
        kc = kc.float() * torch.gather(k_scale.reshape(b, hkv, nb, sl), 3,
                                       idx)[..., None]
    if v_scale is not None:
        vc = vc.float() * torch.gather(v_scale.reshape(b, hkv, nb, sl), 3,
                                       idx)[..., None]

    # score/output products take the cache dtype's values with float32
    # accumulation (the reference's bf16-in/f32-out einsums): upcasting
    # both operands is exact, so only the summation order differs
    kdt = kc.dtype if kc.is_floating_point() else torch.float32
    vdt = vc.dtype if vc.is_floating_point() else torch.float32
    scores = torch.einsum("bhgd,bhncd->bhgnc", qg.to(kdt).float(),
                          kc.float())
    scores = torch.where(live[:, :, None], scores, float("-inf"))
    scores = scores.reshape(b, hkv, group, nb * c_loc)
    mx = scores.amax(-1, keepdim=True)
    if ring is not None:
        mx = nan_max(mx, ring.group)
    keep = scores >= mx - thr                         # post-scoring SSIV-D
    w = torch.where(keep, torch.exp(scores - mx), 0.0)
    vcat = vc.reshape(b, hkv, nb * c_loc, dv)
    if ring is None:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-20)
        out = torch.einsum("bhgc,bhcd->bhgd", w.to(vdt).float(),
                           vcat.float())
    else:
        # normalised by the sum over every rank's candidates, then the
        # ranks' products summed: one rank is the single-device path
        den = all_reduce_sum(w.sum(-1, keepdim=True), ring.group)
        w = w / torch.clamp(den, min=1e-20)
        out = all_reduce_sum(torch.einsum("bhgc,bhcd->bhgd",
                                          w.to(vdt).float(), vcat.float()),
                             ring.group)
    out = out.reshape(b, hq, dv).to(vdt)
    if not return_probe:
        return out

    # captured score mass: the full ring scored once in float32; both
    # masses use those scores and their max, so the kept mass never
    # exceeds the full one (blocks are disjoint, top-k rows distinct)
    kbf = kb.float()
    if k_scale is not None:
        kbf = kbf * k_scale.reshape(b, hkv, nb, sl)[..., None]
    fs = torch.einsum("bhgd,bhnld->bhgnl", qg, kbf)
    fs = torch.where(valid_b[:, :, None], fs, float("-inf"))  # [B,Hkv,G,NS,SL]
    mxf = fs.amax((3, 4), keepdim=True)                        # [B,Hkv,G,1,1]
    if ring is not None:
        mxf = nan_max(mxf, ring.group)
    finite = torch.isfinite(mxf)
    full_mass = torch.where(finite & (fs > float("-inf")),
                            torch.exp(fs - mxf), 0.0).sum((3, 4))
    idx_g = idx[:, :, None].expand(b, hkv, group, nb, c_loc)
    fsel = torch.gather(fs, 4, idx_g)                          # [B,Hkv,G,NS,Cl]
    kept = keep.reshape(b, hkv, group, nb, c_loc) & live[:, :, None]
    sel_mass = torch.where(kept & finite & (fsel > float("-inf")),
                           torch.exp(fsel - mxf), 0.0).sum((3, 4))
    cand = live.sum((2, 3)).float()                             # [B,Hkv]
    if ring is not None:
        packed = all_reduce_sum(torch.cat([full_mass, sel_mass, cand],
                                          -1), ring.group)
        full_mass, sel_mass, cand = packed.split(
            [group, group, cand.shape[-1]], -1)
    ratio = torch.where(full_mass > 0.0,
                        sel_mass / torch.clamp(full_mass, min=1e-20), 0.0)
    return out, torch.stack([cand.mean(1), ratio.mean((1, 2))], 1)
