"""Public entry: A^3 decode attention over a KV cache (PyTorch port of
``repro.kernels.decode_attention.ops``).

``a3_decode_attention`` merges cache validity with the A^3 candidate
mask (fresh-tail rows always candidates) and runs the decode-attention
kernel: on CUDA tensors the hand-written kernel, on CPU tensors its
plain version (the reference's ``use_kernel`` switch is gone — the
tensors' device decides). ``a3_decode_attention_compact`` is plain torch
ops, as its reference is plain jnp.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import A3Config, A3Mode
from repro_torch.core.candidate_selection import SortedKeys, \
    select_candidates, top_k
from repro_torch.kernels.decode_attention.kernel import decode_attention
from repro_torch.models.common import round_to


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
) -> torch.Tensor:
    """A^3 decode with sharded compaction (reference docstring): the
    ring splits into ``cfg.select_shards`` blocks, each runs the
    prefix-capped greedy walk and keeps its top-(C/NS) rows, and the
    post-scored softmax is exact over the gathered [C] candidates.
    Candidate sets are unioned across the GQA group; ``fresh_mask`` rows
    are force-included. (The int8 scales and the quality probe of the
    reference are not ported yet.)"""
    b, hq, d = q.shape
    _, hkv, s_len, dv = v.shape
    group = hq // hkv
    scale = d ** -0.5
    ns = cfg.select_shards if s_len % max(cfg.select_shards, 1) == 0 else 1
    sl = s_len // ns
    m = cfg.m_for(s_len)
    c_total = int(min(s_len, budget if budget is not None
                      else max(64, m // 2)))
    c_loc = min(sl, max(16, c_total // ns))
    m_loc = min(sl * d, max(c_loc, m // ns))
    thr = cfg.threshold_nats
    cap = min(sl, max(16, (4 * m_loc + d - 1) // d))

    blk5 = lambda t: t.reshape(b, hkv, ns, sl, t.shape[-1])  # noqa: E731
    kb, vb = blk5(k), blk5(v)
    skv, skr = blk5(sorted_keys.values), blk5(sorted_keys.rows)
    qg = q.reshape(b, hkv, group, d).float() * scale
    valid_b = valid_mask.reshape(b, 1, ns, sl)
    fresh_b = (fresh_mask.reshape(b, 1, ns, sl) if fresh_mask is not None
               else torch.zeros_like(valid_b))

    # prefix slices per block (ascending sort -> bottom = min side)
    top_v = skv[..., sl - cap:, :].flip(-2)          # [B,Hkv,NS,cap,D]
    bot_v = skv[..., :cap, :]
    top_r = skr[..., sl - cap:, :].flip(-2)
    bot_r = skr[..., :cap, :]

    qpos = (qg > 0)[:, :, None, :, None, :]          # [B,Hkv,1,G,1,D]
    qexp = qg[:, :, None, :, None, :]
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

    greedy = torch.zeros((b, hkv, ns, group, sl), dtype=torch.float32,
                         device=q.device)
    greedy.scatter_add_(-1, a_rows.long(), torch.where(a_vals > 0, a_vals,
                                                       0.0))
    greedy.scatter_add_(-1, b_rows.long(), torch.where(b_vals < 0, b_vals,
                                                       0.0))

    score_u = greedy.amax(3)                          # union over G
    score_u = torch.where(valid_b, score_u, float("-inf"))
    score_u = torch.where(fresh_b & valid_b, float("inf"), score_u)
    _, idx = top_k(score_u, c_loc)                    # [B,Hkv,NS,Cl]
    live = torch.gather(score_u, -1, idx) > 0
    kc = torch.gather(kb, 3, idx[..., None].expand(*idx.shape, d))
    vc = torch.gather(vb, 3, idx[..., None].expand(*idx.shape, dv))

    # score/output products take the cache dtype's values with float32
    # accumulation (the reference's bf16-in/f32-out einsums): upcasting
    # both operands is exact, so only the summation order differs
    kdt, vdt = kc.dtype, vc.dtype
    scores = torch.einsum("bhgd,bhncd->bhgnc", qg.to(kdt).float(),
                          kc.float())
    scores = torch.where(live[:, :, None], scores, float("-inf"))
    scores = scores.reshape(b, hkv, group, ns * c_loc)
    mx = scores.amax(-1, keepdim=True)
    keep = scores >= mx - thr                         # post-scoring SSIV-D
    w = torch.where(keep, torch.exp(scores - mx), 0.0)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-20)
    vcat = vc.reshape(b, hkv, ns * c_loc, dv)
    out = torch.einsum("bhgc,bhcd->bhgd", w.to(vdt).float(), vcat.float())
    return out.reshape(b, hq, dv).to(vdt)
