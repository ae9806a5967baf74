"""Per-segment mixer-state interface (PyTorch port of
``repro.models.mixer``): the attention, RG-LRU, mLSTM and sLSTM kinds.

A model is a sequence of *segments* (maximal runs of layers sharing a
(block kind, ffn kind, attention window) signature). A
:class:`SegmentMixer` gives each kind five entry points — ``init_state``,
``forward``, ``prefill_full``, ``prefill_chunk``, ``decode_step`` — so the
decoder's execution paths are kind-agnostic loops.

Layout and semantics follow the reference: the attention state of a
segment is ``k``/``v`` rings ``[L, B, Hkv, w, hd]`` plus, with A^3 on a
global-window segment, the per-column sorted keys ``sk_vals``/``sk_rows``
and the ``sorted_upto`` watermark ``[L, B]``; a windowed segment (sliding,
or the local layers of a local/global pattern) keeps a ring of
``min(max_len, window)`` rows and no sort leaves. One difference in
style:
the reference returns new state arrays, while the port writes each
layer's state **in place** (``prefill_chunk`` and ``decode_step`` take
per-layer views and update them). Pad lanes — ``length == 0`` in a
chunk, ``pos < 0`` in a decode step — keep their state bit-identical:
torch has no ``mode="drop"`` scatter, so the writes select the old value
for those lanes instead of scattering out of bounds.

The recurrent kinds keep the reference's state leaves: RG-LRU ``h``
``[L, B, C]`` float32 and ``conv`` ``[L, B, 3, C]`` in the model dtype,
mLSTM ``C``/``n``/``m`` ``[L, B, H, hd, hd]``/``[L, B, H, hd]``/
``[L, B, H]`` and sLSTM ``c``/``n``/``m``/``h`` ``[L, B, d]``, float32. A
lane starting a fresh prompt (``pos == 0, length > 0``) reads its state as
the initial one (the slot may hold a finished request's state); lanes
with ``length == 0`` or ``pos < 0`` keep theirs by an explicit per-lane
select.

The paged prefix cache (``serve/prefix_cache.py``) reaches the state
through five more hooks of each kind: ``init_pages`` (attention's K/V
pages, int8 with per-page scales under ``kv_quant="int8"``; the
recurrent kinds keep none), ``write_page`` / ``gather_pages`` (a page of
a lane's ring to the pool, and a matched prefix back into a lane, with
the A^3 sorted columns sliced to the boundary) and ``snapshot_state`` /
``restore_state`` (a lane's recurrent carry, copied, at a page
boundary). The pool is only written by ``write_page``; every snapshot is
a copy, never a view of the live state.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import A3Config, A3Mode, AttentionKind, BlockKind, \
    ModelConfig
from repro_torch.core.candidate_selection import SortedKeys, \
    slice_sorted_keys, sort_key_columns
from repro_torch.core.quantization import dequantize_int8_block, \
    quantize_int8_block
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention.ops import a3_decode_attention, \
    a3_decode_attention_compact, a3_decode_mask, combine_partials
from repro_torch.models import xlstm as xl
from repro_torch.models.rglru import CONV_WIDTH, rglru_apply_scan, \
    rglru_chunk_step, rglru_decode_step
from repro_torch.models.common import NEG_INF, all_gather, \
    all_reduce_sum, apply_rope, attention_out, attention_qkv, \
    attention_xla_flash, current_shardings, kfull, klinear, nan_max, \
    shard_act

FULL_WINDOW = 1 << 30


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    kind: BlockKind
    ffn: str                 # "dense" | "moe" | "none"
    window: int              # FULL_WINDOW for global attention
    layers: Tuple[int, ...]  # absolute layer indices

    @property
    def count(self) -> int:
        return len(self.layers)

    def uses_a3(self, a3_on: bool) -> bool:
        """Whether A^3 applies to this segment's layers when it is on:
        global attention only (windowed layers attend exactly)."""
        return (a3_on and self.kind == BlockKind.ATTENTION
                and self.window >= FULL_WINDOW)


def _layer_signature(cfg: ModelConfig, i: int) -> Tuple:
    kind = cfg.block_kind(i)
    if kind in (BlockKind.MLSTM, BlockKind.SLSTM):
        ffn = "dense" if cfg.d_ff else "none"
    elif cfg.moe is not None and i >= cfg.moe.num_dense_layers:
        ffn = "moe"
    else:
        ffn = "dense"
    window = FULL_WINDOW
    if kind == BlockKind.ATTENTION:
        if cfg.attention_kind == AttentionKind.SLIDING:
            window = cfg.window_size
        elif cfg.attention_kind == AttentionKind.LOCAL_GLOBAL:
            window = FULL_WINDOW if cfg.layer_is_global(i) \
                else cfg.window_size
    return (kind, ffn, window)


def build_segments(cfg: ModelConfig) -> List[SegmentSpec]:
    segs: List[SegmentSpec] = []
    cur: List[int] = []
    cur_sig = None
    for i in range(cfg.num_layers):
        sig = _layer_signature(cfg, i)
        if sig != cur_sig and cur:
            segs.append(SegmentSpec(*cur_sig, tuple(cur)))
            cur = []
        cur_sig = sig
        cur.append(i)
    if cur:
        segs.append(SegmentSpec(*cur_sig, tuple(cur)))
    return segs


def cache_len_for(seg: SegmentSpec, max_len: int) -> int:
    if seg.kind != BlockKind.ATTENTION:
        return 0
    return min(max_len, seg.window)


# ---------------------------------------------------------------------------
# ring-buffer geometry
# ---------------------------------------------------------------------------

def _ring_slot_positions(w: int, pos: torch.Tensor) -> torch.Tensor:
    """Position held by each ring slot after writing position ``pos``
    (slot s holds the largest p' <= pos with p' % w == s); pos [B] ->
    [B, w]."""
    slots = torch.arange(w, dtype=torch.int32, device=pos.device)
    pos = pos.to(torch.int32)[..., None]
    return pos - torch.remainder(pos - slots, w)


def _ring_valid_mask(w: int, pos: torch.Tensor, window: int) -> torch.Tensor:
    """Ring slots written (p(s) >= 0) and inside the window after
    writing ``pos`` -> [B, w] bool."""
    slot_pos = _ring_slot_positions(w, pos)
    pos = pos.to(torch.int32)[..., None]
    return (slot_pos >= 0) & (slot_pos > pos - window)


def _write_token(ring: torch.Tensor, new: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """In place: lane b writes ``new[b]`` [H, hd] at ring slot
    ``pos[b] % w``; lanes with ``pos < 0`` rewrite slot 0 with its own
    value, so their rows stay bit-identical (the reference's dropped
    out-of-bounds scatter)."""
    w = ring.shape[2]
    live = pos >= 0
    slot = torch.where(live, torch.remainder(pos, w), 0).long()
    bidx = torch.arange(ring.shape[0], device=ring.device)
    old = ring[bidx, :, slot]                               # [B, H, hd]
    ring[bidx, :, slot] = torch.where(live[:, None, None], new, old)


# ---------------------------------------------------------------------------
# ATTENTION mixer
# ---------------------------------------------------------------------------

def _attn_init_state(cfg: ModelConfig, seg: SegmentSpec, batch: int,
                     max_len: int, dtype, a3: bool,
                     device) -> Dict[str, torch.Tensor]:
    L, hd = seg.count, cfg.resolved_head_dim
    w = cache_len_for(seg, max_len)
    shape = (L, batch, cfg.num_kv_heads, w, hd)
    state = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if seg.uses_a3(a3):
        state["sk_vals"] = torch.zeros(shape, dtype=dtype, device=device)
        state["sk_rows"] = torch.zeros(shape, dtype=torch.int32,
                                       device=device)
        state["sorted_upto"] = torch.zeros((L, batch), dtype=torch.int32,
                                           device=device)
    return state


def _window_arg(seg: SegmentSpec):
    return None if seg.window >= FULL_WINDOW else seg.window


def _attn_forward(layer, hn: torch.Tensor, *, cfg: ModelConfig,
                  seg: SegmentSpec, positions: torch.Tensor,
                  attn_chunk: int, **_) -> torch.Tensor:
    sh = current_shardings()
    if sh is not None and sh.is_split(layer.attn):
        return _attn_forward_heads(layer.attn, hn, sh, cfg=cfg, seg=seg,
                                   positions=positions,
                                   attn_chunk=attn_chunk)
    if sh is not None and sh.seq_split("q"):
        return _attn_forward_rows(layer.attn, hn, sh, cfg=cfg, seg=seg,
                                  positions=positions, attn_chunk=attn_chunk)
    q, k, v = attention_qkv(layer.attn, hn, positions, cfg.num_heads,
                            cfg.num_kv_heads, cfg.resolved_head_dim,
                            cfg.rope_theta)
    o = attention_xla_flash(q, k, v, causal=True, window=_window_arg(seg),
                            chunk=attn_chunk)
    return attention_out(layer.attn, o)


def _kv_of_heads(t: torch.Tensor, q0: int, nq: int, group: int,
                 kv0: int) -> torch.Tensor:
    """The kv heads [B, S, Hkv', D] that q heads ``q0 .. q0 + nq`` read,
    ``t`` holding kv heads from ``kv0`` on: a slice when those q heads
    are whole groups, else one kv head per q head (GQA group 1)."""
    if q0 % group == 0 and nq % group == 0:
        return t[:, :, q0 // group - kv0:(q0 + nq) // group - kv0]
    idx = torch.arange(q0, q0 + nq, device=t.device) // group - kv0
    return t[:, :, idx]


def _attn_forward_heads(attn, hn: torch.Tensor, sh, *, cfg: ModelConfig,
                        seg: SegmentSpec, positions: torch.Tensor,
                        attn_chunk: int, want_kv: bool = False):
    """Training attention on a mesh where the model axis divides the q
    heads (``act_specs["q"]``): this rank's q heads, the k/v heads they
    read (its own kv heads, or its columns of k and v gathered over the
    axis when the axis does not divide the kv heads), its rows of ``wo``,
    and the partial outputs summed over the axis. ``want_kv`` (prefill):
    also every kv head's k (roped) and v, [B, S, Hkv, D]."""
    b, s, _ = hn.shape
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    group = cfg.num_heads // hkv
    x = sh.enter(hn)
    nq = attn.wq.weight.shape[0] // hd
    q0 = sh.index * nq
    q = F.linear(x, attn.wq.weight).reshape(b, s, nq, hd)
    kv, whole = [], []
    for w in (attn.wk.weight, attn.wv.weight):
        if w.shape[0] == hkv * hd:        # whole: its gradient is partial
            t, kv0 = F.linear(x, sh.enter(w)), 0
            full = t
        elif hkv % sh.size == 0:          # this rank's kv heads
            t, kv0 = F.linear(x, w), sh.index * (hkv // sh.size)
            full = sh.gather(t, -1) if want_kv else None
        else:                             # its columns, gathered
            t, kv0 = sh.gather(F.linear(x, w), -1), 0
            full = t
        kv.append(_kv_of_heads(t.reshape(b, s, -1, hd), q0, nq, group, kv0))
        whole.append(full)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(kv[0], positions, cfg.rope_theta)
    o = attention_xla_flash(q.transpose(1, 2), k.transpose(1, 2),
                            kv[1].transpose(1, 2), causal=True,
                            window=_window_arg(seg), chunk=attn_chunk)
    out = sh.leave(attention_out(attn, o))
    if not want_kv:
        return out
    return out, apply_rope(whole[0].reshape(b, s, hkv, hd), positions,
                           cfg.rope_theta), whole[1].reshape(b, s, hkv, hd)


def _attn_forward_rows(attn, hn: torch.Tensor, sh, *, cfg: ModelConfig,
                       seg: SegmentSpec, positions: torch.Tensor,
                       attn_chunk: int, want_kv: bool = False):
    """Training attention on a mesh where the model axis does not divide
    the q heads: ``act_specs["q"]`` puts the q rows on the axis. This
    rank projects its block of the sequence with the whole weights
    (their gradients summed over the axis), gathers k and v over the
    axis, attends from its rows to every key, and the output rows are
    gathered back. ``want_kv``: also k and v, [B, S, Hkv, D]."""
    b, s, _ = hn.shape
    hd, theta = cfg.resolved_head_dim, cfg.rope_theta
    lo, hi = sh.share(s)
    x, pos = shard_act(hn, "q"), positions[:, lo:hi]
    w = {n: sh.enter(getattr(attn, n).weight)
         for n in ("wq", "wk", "wv", "wo")}

    def heads(name, n):
        return F.linear(x, w[name]).reshape(b, hi - lo, n, hd)

    q = apply_rope(heads("wq", cfg.num_heads), pos, theta)
    k = sh.gather(apply_rope(heads("wk", cfg.num_kv_heads), pos, theta), 1)
    v = sh.gather(heads("wv", cfg.num_kv_heads), 1)
    o = attention_xla_flash(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=True,
                            window=_window_arg(seg), chunk=attn_chunk,
                            q_offset=lo)
    o = F.linear(o.transpose(1, 2).reshape(b, hi - lo, -1), w["wo"])
    out = sh.gather(o, 1, same=True)
    return (out, k, v) if want_kv else out


# ---------------------------------------------------------------------------
# serving attention, on one device or on a mesh whose KV ring is split
# ---------------------------------------------------------------------------

def _serving_plan():
    """The rank's plan where the serving dispatch runs on a mesh (the KV
    rings laid out over ranks), else None: one device."""
    sh = current_shardings()
    return sh if sh is not None and sh.ring is not None else None


def _ring_span(sh, seg: SegmentSpec, w: int):
    """(ring, lo, hi, w): the :class:`~models.common.Ring` this segment's
    ring splits over (None: whole here) and this rank's rows [lo, hi) of
    it; ``w`` is the ring's rows on one device, the plan's ``max_len``
    sizes it on a mesh."""
    if sh is None:
        return None, 0, w, w
    w = cache_len_for(seg, sh.max_len)
    ring = sh.ring_of(w)
    lo, hi = ring.span(w) if ring is not None else (0, w)
    return ring, lo, hi, w


def _sort_blocks(k: torch.Tensor, blocks: int) -> SortedKeys:
    """The per-column sort of each of ``blocks`` contiguous blocks of the
    ring rows of k [..., w, D] (block-local rows)."""
    w, d = k.shape[-2:]
    sk = sort_key_columns(k.reshape(*k.shape[:-2], blocks, w // blocks, d))
    return SortedKeys(sk.values.reshape(k.shape), sk.rows.reshape(k.shape))


def sort_ring(k: torch.Tensor, sh=None) -> SortedKeys:
    """The A^3 sort of global-attention rings k [..., w, D] that a chunked
    prefill and a re-sort (``resort_sorted_keys``) fold the ring into:
    the whole ring's columns, global row ids. On a mesh whose ring is
    split the rings are gathered over its ranks (a layer at a time) and
    this rank keeps its rows [lo, hi) of each sorted column, the slice
    one device's sort has there: the compact decode reads each slice as
    its selection blocks, as one device reads the whole sort."""
    ring = sh.ring_of(sh.max_len) if sh is not None and sh.ring is not None \
        else None
    if ring is None:
        return sort_key_columns(k)
    lo, hi = ring.span(k.shape[-2] * ring.size)
    if k.dim() > 4:                      # [L, ...]: one layer at a time
        parts = [sort_ring(kl, sh) for kl in k]
        return SortedKeys(torch.stack([p.values for p in parts]),
                          torch.stack([p.rows for p in parts]))
    sk = sort_key_columns(all_gather(k, k.dim() - 2, ring.size, ring.group))
    return SortedKeys(sk.values[..., lo:hi, :].contiguous(),
                      sk.rows[..., lo:hi, :].contiguous())


def _prefill_sort_blocks(ns: int, ring, w: int) -> int:
    """The selection blocks a whole-prompt prefill sorts in this rank's
    ring rows: ``ns`` (the ``select_shards``) over the ring's ranks, which
    must divide it (the compact decode reads the slice as whole blocks);
    on a ring held whole, ``ns`` where it divides the ring, else 1."""
    if ring is None:
        return ns if ns > 0 and w % ns == 0 else 1
    if ns <= 0 or ns % ring.size or w % ns:
        raise ValueError(f"select_shards {ns} must be a multiple of the "
                         f"{ring.size} ranks the ring of {w} rows is split "
                         f"over, and divide the ring")
    return ns // ring.size


def _proj_cols(x: torch.Tensor, w: torch.Tensor, n: int, sh) -> torch.Tensor:
    """``x @ w.T`` with all ``n`` output columns: a split attention holds
    its columns of ``w``, and the products are gathered over the axis."""
    y = klinear(x, w, sh)
    return y if y.shape[-1] == n else sh.gather(y, -1)


def _out_cols(attn, o: torch.Tensor, h0: int, sh, d: int) -> torch.Tensor:
    """``wo`` on the attention output o [B, nh, S, D] of the q heads from
    ``h0`` on: with all of ``wo``, or with this rank's rows of it (a
    split attention: its columns of o, a partial output summed over the
    axis), back to all ``d`` columns of the hidden state."""
    b, nh, s, hd = o.shape
    flat = o.transpose(1, 2).reshape(b, s, nh * hd)
    wo = attn.wo.weight
    if sh is None or not sh.is_split(attn):            # o holds every head
        return kfull(F.linear(flat, wo), d, sh)
    cols = wo.shape[1]
    lo = sh.index * cols - h0 * hd
    return kfull(sh.leave(F.linear(flat[..., lo:lo + cols], wo)), d, sh)


def _serve_qkv(attn, hn: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, sh):
    """q [B, Hq, S, D], k/v [B, Hkv, S, D] of every head (on a mesh from
    this rank's columns of the projections, gathered over the axis)."""
    b, s, _ = hn.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    q = _proj_cols(hn, attn.wq.weight, hq * hd, sh).reshape(b, s, hq, hd)
    k = _proj_cols(hn, attn.wk.weight, hkv * hd, sh).reshape(b, s, hkv, hd)
    v = _proj_cols(hn, attn.wv.weight, hkv * hd, sh).reshape(b, s, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _ring_rows(s: int, w: int, lo: int, hi: int, device):
    """(positions, slots): the last min(s, w) of ``s`` prompt positions
    that land in ring slots [lo, hi) (slot p % w), and their slots less
    ``lo``. They span at most w positions, so at most two runs, whose
    bounds the shapes decide, not the data."""
    start = s - min(s, w)
    base = start - start % w
    runs = [(max(start, b + lo), min(s, b + hi)) for b in (base, base + w)]
    rows = torch.cat([torch.arange(a, e, device=device)
                      for a, e in runs if a < e] or
                     [torch.zeros(0, dtype=torch.long, device=device)])
    return rows, torch.remainder(rows, w) - lo


def _attn_prefill_full(layer, hn: torch.Tensor, *, cfg: ModelConfig,
                       seg: SegmentSpec, positions: torch.Tensor,
                       attn_chunk: int, max_len: int, a3: bool,
                       select_shards: int, **_
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Whole-prompt prefill of one layer -> (output, this layer's
    state: rings holding the last min(s, w) positions, A^3 sort of each
    selection block). On a mesh the output splits as in training (this
    rank's q heads where the axis divides them, else its q rows, or at a
    batch smaller than the data axis its block of the sequence), and
    each rank keeps its lanes' ring rows of every kv head (the heads
    gathered over the axis, its rows cut) and sorts its blocks."""
    sh = _serving_plan()
    b = hn.shape[0]
    hd = cfg.resolved_head_dim
    kw = dict(cfg=cfg, seg=seg, positions=positions, attn_chunk=attn_chunk,
              want_kv=True)
    if sh is not None and sh.sp is not None:
        # this rank's block of the rows, the whole weights; k and v
        # gathered over the sequence's ranks
        sp = sh.sp
        q, k, v = attention_qkv(layer.attn, hn, positions, cfg.num_heads,
                                cfg.num_kv_heads, hd, cfg.rope_theta)
        k, v = (all_gather(t, 2, sp.size, sp.group) for t in (k, v))
        o = attention_xla_flash(q, k, v, causal=True,
                                window=_window_arg(seg), chunk=attn_chunk,
                                q_offset=sp.index * hn.shape[1])
        out = attention_out(layer.attn, o)
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    elif sh is not None and sh.is_split(layer.attn):
        out, k, v = _attn_forward_heads(layer.attn, hn, sh, **kw)
    elif sh is not None and sh.seq_split("q"):
        out, k, v = _attn_forward_rows(layer.attn, hn, sh, **kw)
    else:
        q, k, v = attention_qkv(layer.attn, hn, positions, cfg.num_heads,
                                cfg.num_kv_heads, hd, cfg.rope_theta)
        o = attention_xla_flash(q, k, v, causal=True,
                                window=_window_arg(seg), chunk=attn_chunk)
        out = attention_out(layer.attn, o)
        k, v = k.transpose(1, 2), v.transpose(1, 2)        # [B, S, H, D]
    s = k.shape[1]
    ring, lo, hi, w = _ring_span(sh, seg, cache_len_for(seg, max_len))
    rows, dst = _ring_rows(s, w, lo, hi, hn.device)
    kc = torch.zeros((b, k.shape[2], hi - lo, hd), dtype=k.dtype,
                     device=k.device)
    vc = torch.zeros_like(kc)
    kc[:, :, dst] = k[:, rows].transpose(1, 2)
    vc[:, :, dst] = v[:, rows].transpose(1, 2)
    state = {"k": kc, "v": vc}
    if seg.uses_a3(a3):
        sk = _sort_blocks(kc, _prefill_sort_blocks(select_shards, ring, w))
        state["sk_vals"], state["sk_rows"] = sk.values, sk.rows  # block-local
        state["sorted_upto"] = torch.full((b,), s, dtype=torch.int32,
                                          device=hn.device)
    return out, state


def _chunk_softmax(qf, ck, cv, k, v, ring_mask, chunk_mask):
    """One softmax of the chunk's queries qf [B, Hkv, G, C, D] (scaled,
    float32) over the ring ck/cv [B, Hkv, w, D] (before this chunk's
    write) and the chunk's own keys k/v [B, Hkv, C, D], under ring_mask
    [B, C, w] and chunk_mask [B, C, C] -> float32 [B, Hkv, G, C, D]."""
    mask = torch.cat([ring_mask, chunk_mask], -1)[:, None, None]
    s = torch.cat([torch.einsum("bhgqd,bhkd->bhgqk", qf, ck.float()),
                   torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())], -1)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    vcat = torch.cat([cv, v], 2).float()                       # [B,Hkv,w+C,D]
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, vcat)
    return torch.where(l == 0.0, 0.0, acc / torch.where(l == 0.0, 1.0, l))


def _chunk_partial(qf, keys, vals, mask):
    """(output, log-sum-exp) of qf [B, Hkv, G, C, D] (scaled, float32)
    against keys/vals [B, Hkv, K, D] under mask [B, 1, 1, C, K]."""
    sc = torch.where(mask, torch.einsum("bhgqd,bhkd->bhgqk", qf,
                                        keys.float()), NEG_INF)
    m = sc.amax(-1)
    p = torch.where(mask, torch.exp(sc - m[..., None]), 0.0)
    lsum = p.sum(-1)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, vals.float())
    o = torch.where(lsum[..., None] == 0.0, 0.0,
                    acc / torch.where(lsum == 0.0, 1.0, lsum)[..., None])
    return o, torch.where(lsum == 0.0, NEG_INF, m + torch.log(lsum))


def _attn_prefill_chunk(layer, state: Dict[str, torch.Tensor],
                        hn: torch.Tensor, *, cfg: ModelConfig,
                        seg: SegmentSpec, positions: torch.Tensor,
                        valid_tok: torch.Tensor, pos: torch.Tensor,
                        length: torch.Tensor, sort_lanes: torch.Tensor,
                        sort_any: bool, a3: bool, **_) -> torch.Tensor:
    """One ragged prompt chunk through one layer; updates the layer's
    state views in place and returns the mixer output. On a mesh each
    rank scores every q head against its ring rows (a partial softmax,
    combined over the ring's ranks) and its q heads against the chunk's
    own keys (all heads where the axis does not divide them), merges the
    two, and writes the ring rows it holds."""
    sh = _serving_plan()
    attn = layer.attn
    b, c, _ = hn.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    group = hq // hkv
    q, k, v = _serve_qkv(attn, hn, positions, cfg, sh)        # [B, H, C, D]
    # a lane starting a new prompt (pos 0) reads its ring as zeros: the
    # slot may hold a finished request's rows
    fresh = ((pos == 0) & (length > 0))[:, None, None, None]
    ck = torch.where(fresh, 0, state["k"])
    cv = torch.where(fresh, 0, state["v"])
    ring, lo, hi, w = _ring_span(sh, seg, ck.shape[2])
    window = seg.window

    # attention BEFORE the ring write: chunk queries see the ring as it
    # stood before this chunk plus the in-chunk keys
    scale = hd ** -0.5
    qf = (q.float() * scale).reshape(b, hkv, group, c, hd)
    offs = torch.arange(c, dtype=torch.int32, device=hn.device)
    slots = torch.arange(lo, hi, dtype=torch.int32, device=hn.device)
    last_prev = (pos - 1)[:, None]
    slot_pos = last_prev - torch.remainder(last_prev - slots[None, :], w)
    ring_mask = (slot_pos[:, None, :] >= 0) & \
        (slot_pos[:, None, :] > positions[:, :, None] - window)   # [B,C,w']
    chunk_mask = (offs[None, :, None] >= offs[None, None, :]) & \
        (offs[None, :, None] - offs[None, None, :] < window) & \
        valid_tok[:, None, :]                                      # [B,C,C]
    # the chunk's own keys: this rank's q heads where the axis divides them
    h0, h1 = sh.share(hq) if (sh is not None and sh.is_split(attn)
                              and hq % sh.size == 0) else (0, hq)
    if (ring is None or ring.size == 1) and (h0, h1) == (0, hq):
        # the whole ring and every head here: one softmax
        o = _chunk_softmax(qf, ck, cv, k, v, ring_mask, chunk_mask)
        o = o.reshape(b, hq, c, hd)
    else:
        o_r, lse_r = _chunk_partial(qf, ck, cv, ring_mask[:, None, None])
        o_r, lse_r = combine_partials(
            o_r, lse_r, group=ring.group if ring is not None else None,
            return_stat=True)
        kv_of = torch.arange(h0, h1, device=hn.device) // group
        o_c, lse_c = _chunk_partial(
            qf.reshape(b, hq, 1, c, hd)[:, h0:h1], k[:, kv_of], v[:, kv_of],
            chunk_mask[:, None, None])
        o_r = o_r.reshape(b, hq, c, hd)[:, h0:h1]
        lse_r = lse_r.reshape(b, hq, c)[:, h0:h1]
        o = combine_partials([o_r, o_c[:, :, 0]], [lse_r, lse_c[:, :, 0]])
    out = _out_cols(attn, o.to(hn.dtype), h0, sh, hn.shape[-1])

    # ragged ring write: slot s takes the chunk position p_s in
    # (last - w, last] with p_s % w == s when that position lies in this
    # lane's chunk; every other slot (and every row of a length-0 lane)
    # keeps its value. A rank writes the slots it holds.
    last = (pos + length - 1)[:, None]
    p_s = last - torch.remainder(last - slots[None, :], w)     # [B, w']
    written = (length[:, None] > 0) & (p_s >= pos[:, None])
    src = (p_s - pos[:, None]).clamp(0, c - 1).long()
    src = src[:, None, :, None].expand(b, hkv, hi - lo, hd)
    sel = written[:, None, :, None]
    state["k"].copy_(torch.where(sel, torch.gather(k, 2, src), ck))
    state["v"].copy_(torch.where(sel, torch.gather(v, 2, src), cv))

    if a3 and "sk_vals" in state and sort_any:
        # incremental comprehension-time preprocessing: lanes on their
        # final chunk fold the ring into the per-column sort (the caller
        # decides sort_any on the host: no device read here)
        sk = sort_ring(state["k"], sh)
        l4 = sort_lanes[:, None, None, None]
        state["sk_vals"].copy_(torch.where(l4, sk.values, state["sk_vals"]))
        state["sk_rows"].copy_(torch.where(l4, sk.rows, state["sk_rows"]))
        state["sorted_upto"].copy_(torch.where(
            sort_lanes, (pos + length).to(torch.int32),
            state["sorted_upto"]))
    return out


def _attn_decode_step(layer, state: Dict[str, torch.Tensor],
                      hn: torch.Tensor, *, cfg: ModelConfig,
                      seg: SegmentSpec, pos: torch.Tensor, a3: A3Config,
                      probe: bool = False, **_) -> torch.Tensor:
    """One ragged decode step through one layer: writes the token's K/V
    into the ring in place and attends over it. With ``probe`` an A^3
    layer with a cached sort also leaves its quality probe, ``[B, 2]``
    (mean candidates, captured score mass), in ``state["_probe"]``; the
    output runs the identical ops either way. On a mesh every q head
    (this rank's projection columns gathered over the axis) attends over
    this rank's ring rows, the rank holding slot ``pos % w`` writes the
    token there, the partials combine over the ring's ranks (#1's
    log-sum-exp, or #3's row sums against the max over the ring), and
    ``wo`` runs on this rank's columns, summed over the axis."""
    sh = _serving_plan()
    attn = layer.attn
    b = hn.shape[0]
    q, k, v = _serve_qkv(attn, hn, pos[:, None], cfg, sh)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]
    kc, vc = state["k"], state["v"]
    ring, lo, hi, w = _ring_span(sh, seg, kc.shape[2])
    at = pos
    if sh is not None:               # the rank holding slot pos % w writes
        slot = torch.remainder(pos, w)
        at = torch.where((pos >= 0) & (slot >= lo) & (slot < hi),
                         slot - lo, -1)
    _write_token(kc, k, at)
    _write_token(vc, v, at)
    valid = _ring_valid_mask(w, pos, seg.window)[:, lo:hi]     # [B, w']
    grp = ring.group if ring is not None else None
    use_a3 = seg.uses_a3(a3.mode != A3Mode.OFF)
    if use_a3 and "sk_vals" in state:
        # sorted keys cached at prefill; rows written since the last
        # re-sort get exact treatment
        fresh = (_ring_slot_positions(w, pos)
                 >= state["sorted_upto"][:, None])[:, lo:hi]
        o = a3_decode_attention_compact(
            q, kc, vc, valid, a3,
            SortedKeys(state["sk_vals"], state["sk_rows"]),
            fresh_mask=fresh, return_probe=probe, ring=ring)
        if probe:
            o, state["_probe"] = o
    elif use_a3 and ring is None:
        # no cached sort: build one inline (single-shot use). The two-pass
        # pair tests every score against the whole ring's max, the exact
        # threshold rule of the oracle the reference's models decode
        # through; #1 advances its max a block_k tile at a time
        o = a3_decode_attention(q, kc, vc, valid, a3,
                                sorted_keys=sort_key_columns(kc),
                                exact_two_pass=True)
    elif use_a3:
        # the same on a split ring: the candidates of the whole ring
        # (gathered over its ranks), #2 on this rank's rows, the max over
        # the ring and #3 against it, so each rank keeps the one-device set
        k_all = all_gather(kc, 2, ring.size, grp)
        mask, thr = a3_decode_mask(q, k_all,
                                   _ring_valid_mask(w, pos, seg.window), a3,
                                   sorted_keys=sort_key_columns(k_all))
        mask = mask[..., lo:hi].contiguous()
        q = q.contiguous()
        rm = nan_max(dk.rowmax(q, kc, mask), grp)
        o, lsum = dk.attend(q, kc, vc, mask, rm, threshold=thr, partial=True)
        o = combine_partials(o, lsum, stat="sum", group=grp)
    elif ring is None:
        o = a3_decode_attention(q, kc, vc, valid, A3Config())
    else:
        mask = valid[:, None, :].expand(b, cfg.num_heads, hi - lo)
        o, lse = dk.fused(q.contiguous(), kc, vc, mask.contiguous(),
                          partial=True)
        o = combine_partials(o, lse, group=grp)
    return _out_cols(attn, o.to(hn.dtype)[:, :, None, :], 0, sh,
                     hn.shape[-1])


def _attn_init_pages(cfg: ModelConfig, seg: SegmentSpec, pages: int,
                     page_size: int, dtype, a3: bool, device,
                     kv_quant: str = "none") -> Dict[str, torch.Tensor]:
    """Attention's share of the prefix-cache pool: K/V rows per page,
    ``[L, pages, Hkv, page_size, hd]`` (a logical page spans
    ``page_size`` positions of every segment). With ``kv_quant="int8"``
    the pages are int8 with one float32 scale per (layer, page, kv head),
    ``k_scale``/``v_scale`` ``[L, pages, Hkv, 1, 1]``. Sorted-key state
    is not paged: it is restored at gather time."""
    shape = (seg.count, pages, cfg.num_kv_heads, page_size,
             cfg.resolved_head_dim)
    if kv_quant == "int8":
        scale = (seg.count, pages, cfg.num_kv_heads, 1, 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale, device=device),
                "v_scale": torch.zeros(scale, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _attn_write_page(pool_seg: Dict[str, torch.Tensor],
                     state: Dict[str, torch.Tensor], si: int, page_id: int,
                     rows: torch.Tensor, valid: torch.Tensor) -> None:
    """In place: copy one page of lane ``si``'s ring into pool page
    ``page_id``. ``rows`` [ps] maps page offsets to ring rows (``pos %
    w``); offsets whose position left the ring (``valid`` False) store
    zeros, what an unwritten ring row reads as. An int8 pool quantizes
    the page in the same pass, one scale per (layer, kv head)."""
    v4 = valid[None, None, :, None]
    for name in ("k", "v"):
        src = state[name][:, si][:, :, rows]             # [L, H, ps, hd]
        src = torch.where(v4, src, torch.zeros((), dtype=src.dtype,
                                                device=src.device))
        if f"{name}_scale" in pool_seg:
            q, scale = quantize_int8_block(src, axes=(2, 3), reciprocal=True)
            pool_seg[name][:, page_id] = q
            pool_seg[f"{name}_scale"][:, page_id] = scale
        else:
            pool_seg[name][:, page_id] = src


def _attn_gather_pages(state: Dict[str, torch.Tensor],
                       pool_seg: Dict[str, torch.Tensor], si: int, t: int,
                       page_idx: torch.Tensor, row_off: torch.Tensor,
                       valid: torch.Tensor, *, a3: bool,
                       sk_snap=None) -> None:
    """In place: restore lane ``si``'s ring for a matched prefix of
    length ``t`` from pool pages (the warm-admission copy; the pool is
    only read). ``page_idx``/``row_off`` [w] give each ring row's source
    page and offset; rows with ``valid`` False (unwritten at ``t``) are
    zeroed, so the ring equals a cold chunked prefill of the prefix. An
    int8 pool dequantizes in the same pass, back to the ring's dtype.
    With ``a3`` the sorted key columns come back too: sliced out of a
    donor prompt's leaf snapshot (:func:`slice_sorted_keys`; an int8
    snapshot is dequantized first) when there is one, else re-sorted
    from the gathered ring; either way ``sorted_upto`` becomes ``t``."""
    sh = current_shardings()
    if sh is not None and sh.pool is not None:
        return _gather_pages_mesh(state, pool_seg, si, t, page_idx, row_off,
                                  valid, sh, a3=a3, sk_snap=sk_snap)
    v4 = valid[None, None, :, None]
    out_dtype = state["k"].dtype

    def take(name):
        # [L, P, H, ps, hd] -> [P, ps, L, H, hd] -> [w, L, H, hd]
        g = pool_seg[name].permute(1, 3, 0, 2, 4)[page_idx, row_off]
        g = g.permute(1, 2, 0, 3)                         # [L, H, w, hd]
        if f"{name}_scale" in pool_seg:
            sc = pool_seg[f"{name}_scale"][:, :, :, 0, 0][:, page_idx]
            g = (g.float() * sc.permute(0, 2, 1)[..., None]).to(out_dtype)
        return torch.where(v4, g, torch.zeros((), dtype=g.dtype,
                                              device=g.device))

    k_slot = take("k")
    state["k"][:, si] = k_slot
    state["v"][:, si] = take("v")
    if a3 and "sk_vals" in state:
        if sk_snap is not None:
            vals = sk_snap["vals"]
            if "scale" in sk_snap:
                vals = dequantize_int8_block(vals, sk_snap["scale"],
                                             dtype=out_dtype)
            sk = slice_sorted_keys(SortedKeys(vals, sk_snap["rows"]), valid)
        else:
            sk = sort_key_columns(k_slot)
        state["sk_vals"][:, si] = sk.values
        state["sk_rows"][:, si] = sk.rows
        state["sorted_upto"][:, si] = t


def _gather_pages_mesh(state, pool_seg, si, t, page_idx, row_off, valid,
                       sh, *, a3, sk_snap=None) -> None:
    """:func:`_attn_gather_pages` on a mesh: the pool is laid out as the
    rings (this rank's pages and page rows, ``sh.pool``), so a slot's
    source row may sit on any rank. Each rank reads (and dequantizes) the
    matched rows it holds, zeros elsewhere, one all-reduce over the
    pool's ranks gives every rank the lane's whole ring, and the rank
    holding the lane keeps its ring rows and its rows of the whole ring's
    sorted columns, as one device sorts them (a donor's sorted-key
    snapshot on a split ring is refused)."""
    pool = sh.pool
    out_dtype = state["k"].dtype
    w = page_idx.shape[0]
    n_pages = pool_seg["k"].shape[1]
    mine = valid & (page_idx >= pool.p0) & (page_idx < pool.p1) & \
        (row_off >= pool.r0) & (row_off < pool.r1)
    pg = (page_idx - pool.p0).clamp(0, n_pages - 1)
    off = (row_off - pool.r0).clamp(0, pool.r1 - pool.r0 - 1)

    def take(name):
        g = pool_seg[name].permute(1, 3, 0, 2, 4)[pg, off]   # [w, L, H, hd]
        g = g.permute(1, 2, 0, 3)                           # [L, H, w, hd]
        if f"{name}_scale" in pool_seg:
            sc = pool_seg[f"{name}_scale"][:, :, :, 0, 0][:, pg]
            g = g.float() * sc.permute(0, 2, 1)[..., None]
        g = torch.where(mine[None, None, :, None], g.to(out_dtype),
                        torch.zeros((), dtype=out_dtype, device=g.device))
        return all_reduce_sum(g, pool.group)

    k_all, v_all = take("k"), take("v")
    lanes = sh.lanes or (0, state["k"].shape[1])
    if not lanes[0] <= si < lanes[1]:
        return
    ring = sh.ring_of(w)
    lo, hi = ring.span(w) if ring is not None else (0, w)
    li = si - lanes[0]
    state["k"][:, li] = k_all[:, :, lo:hi]
    state["v"][:, li] = v_all[:, :, lo:hi]
    if a3 and "sk_vals" in state:
        if sk_snap is not None and ring is not None:
            raise NotImplementedError(
                "a donor's sorted-key snapshot on a KV ring split over "
                "ranks: the warm admission re-sorts instead")
        sk = sort_key_columns(k_all)
        state["sk_vals"][:, li] = sk.values[:, :, lo:hi]
        state["sk_rows"][:, li] = sk.rows[:, :, lo:hi]
        state["sorted_upto"][:, li] = t


def _attn_snapshot(state: Dict[str, torch.Tensor], si: int
                   ) -> Dict[str, torch.Tensor]:
    """Attention's per-token state lives in pages: the boundary snapshot
    is empty (sorted-key leaf snapshots are the prefix cache's)."""
    return {}


def _attn_restore(state: Dict[str, torch.Tensor],
                  snap: Dict[str, torch.Tensor], si: int) -> None:
    """Nothing to restore: the pages carry it all."""


# ---------------------------------------------------------------------------
# recurrent kinds (RG-LRU, mLSTM, sLSTM)
# ---------------------------------------------------------------------------

def _lane_select(new: torch.Tensor, old: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
    """Per-lane select: inactive lanes keep ``old`` bit-identically.
    ``active`` is [B]; leaves are [B, ...]."""
    return torch.where(active.reshape((-1,) + (1,) * (old.dim() - 1)), new,
                       old)


def _fresh_state(state: Dict[str, torch.Tensor], init: Dict[str, float],
                 fresh: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The carried state with fresh lanes reset to the initial values."""
    return tuple(_lane_select(torch.full_like(state[name], v), state[name],
                              fresh) for name, v in init.items())


def _commit(state: Dict[str, torch.Tensor], names,
            new: Tuple[torch.Tensor, ...], active: torch.Tensor) -> None:
    """In place: active lanes take the new state (leaves in the order of
    ``names``), the rest keep theirs."""
    for name, t in zip(names, new):
        state[name].copy_(_lane_select(t, state[name], active))


_RGLRU_INIT = {"h": 0.0, "conv": 0.0}
_MLSTM_INIT = {"C": 0.0, "n": 0.0, "m": NEG_INF}
_SLSTM_INIT = {"c": 0.0, "n": 0.0, "m": NEG_INF, "h": 0.0}


def _rglru_init_state(cfg: ModelConfig, seg: SegmentSpec, batch: int,
                      max_len: int, dtype, a3: bool,
                      device) -> Dict[str, torch.Tensor]:
    L, d_rnn = seg.count, cfg.num_heads * cfg.resolved_head_dim
    return {"h": torch.zeros((L, batch, d_rnn), device=device),
            "conv": torch.zeros((L, batch, CONV_WIDTH - 1, d_rnn),
                                dtype=dtype, device=device)}


def _rglru_forward(layer, hn: torch.Tensor, **_) -> torch.Tensor:
    return rglru_apply_scan(layer.rnn, hn)[0]


def _rglru_prefill_full(layer, hn: torch.Tensor, **_
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    o, h, conv = rglru_apply_scan(layer.rnn, hn)
    return o, {"h": h, "conv": conv}


def _rglru_prefill_chunk(layer, state: Dict[str, torch.Tensor],
                         hn: torch.Tensor, *, pos: torch.Tensor,
                         length: torch.Tensor, valid_tok: torch.Tensor,
                         **_) -> torch.Tensor:
    h0, conv = _fresh_state(state, _RGLRU_INIT, (pos == 0) & (length > 0))
    o, *new = rglru_chunk_step(layer.rnn, hn, h0, conv, valid_tok)
    _commit(state, _RGLRU_INIT, new, length > 0)
    return o


def _rglru_decode_step(layer, state: Dict[str, torch.Tensor],
                       hn: torch.Tensor, *, pos: torch.Tensor,
                       **_) -> torch.Tensor:
    o, *new = rglru_decode_step(layer.rnn, hn, state["h"], state["conv"])
    _commit(state, _RGLRU_INIT, new, pos >= 0)
    return o


def _mlstm_init_state(cfg: ModelConfig, seg: SegmentSpec, batch: int,
                      max_len: int, dtype, a3: bool,
                      device) -> Dict[str, torch.Tensor]:
    L, hd = seg.count, cfg.resolved_head_dim
    C, n, m = xl.mlstm_init_state(L * batch, cfg.num_heads, hd, device)
    return {"C": C.reshape(L, batch, *C.shape[1:]),
            "n": n.reshape(L, batch, *n.shape[1:]),
            "m": m.reshape(L, batch, *m.shape[1:])}


def _mlstm_forward(layer, hn: torch.Tensor, *, cfg: ModelConfig,
                   **_) -> torch.Tensor:
    return xl.mlstm_parallel(layer.mlstm, hn, cfg.num_heads,
                             cfg.resolved_head_dim)


def _mlstm_prefill_full(layer, hn: torch.Tensor, *, cfg: ModelConfig, **_
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    o, st = xl.mlstm_chunkwise(layer.mlstm, hn, cfg.num_heads,
                               cfg.resolved_head_dim)
    return o, dict(zip(_MLSTM_INIT, st))


def _mlstm_prefill_chunk(layer, state: Dict[str, torch.Tensor],
                         hn: torch.Tensor, *, cfg: ModelConfig,
                         pos: torch.Tensor, length: torch.Tensor,
                         valid_tok: torch.Tensor, **_) -> torch.Tensor:
    st = _fresh_state(state, _MLSTM_INIT, (pos == 0) & (length > 0))
    o, new = xl.mlstm_chunkwise(layer.mlstm, hn, cfg.num_heads,
                                cfg.resolved_head_dim, state=st,
                                valid=valid_tok)
    _commit(state, _MLSTM_INIT, new, length > 0)
    return o


def _mlstm_decode_step(layer, state: Dict[str, torch.Tensor],
                       hn: torch.Tensor, *, cfg: ModelConfig,
                       pos: torch.Tensor, **_) -> torch.Tensor:
    o, new = xl.mlstm_decode_step(layer.mlstm, hn,
                                  tuple(state[k] for k in _MLSTM_INIT),
                                  cfg.num_heads, cfg.resolved_head_dim)
    _commit(state, _MLSTM_INIT, new, pos >= 0)
    return o


def _slstm_init_state(cfg: ModelConfig, seg: SegmentSpec, batch: int,
                      max_len: int, dtype, a3: bool,
                      device) -> Dict[str, torch.Tensor]:
    st = xl.slstm_init_state(seg.count * batch, cfg.d_model, device)
    return {name: t.reshape(seg.count, batch, cfg.d_model)
            for name, t in zip(_SLSTM_INIT, st)}


def _slstm_forward(layer, hn: torch.Tensor, *, cfg: ModelConfig,
                   **_) -> torch.Tensor:
    return xl.slstm_apply_scan(layer.slstm, hn, cfg.num_heads)[0]


def _slstm_prefill_full(layer, hn: torch.Tensor, *, cfg: ModelConfig, **_
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    o, st = xl.slstm_apply_scan(layer.slstm, hn, cfg.num_heads)
    return o, dict(zip(_SLSTM_INIT, st))


def _slstm_prefill_chunk(layer, state: Dict[str, torch.Tensor],
                         hn: torch.Tensor, *, cfg: ModelConfig,
                         pos: torch.Tensor, length: torch.Tensor,
                         valid_tok: torch.Tensor, **_) -> torch.Tensor:
    st = _fresh_state(state, _SLSTM_INIT, (pos == 0) & (length > 0))
    # pad positions reselect the carried state inside the scan, so a
    # zero-length lane is bit-identical by construction
    o, new = xl.slstm_apply_scan(layer.slstm, hn, cfg.num_heads, state=st,
                                 valid=valid_tok)
    _commit(state, _SLSTM_INIT, new, length > 0)
    return o


def _slstm_decode_step(layer, state: Dict[str, torch.Tensor],
                       hn: torch.Tensor, *, cfg: ModelConfig,
                       pos: torch.Tensor, **_) -> torch.Tensor:
    o, new = xl.slstm_decode_step(layer.slstm, hn,
                                  tuple(state[k] for k in _SLSTM_INIT),
                                  cfg.num_heads)
    _commit(state, _SLSTM_INIT, new, pos >= 0)
    return o


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _no_pages(cfg: ModelConfig, seg: SegmentSpec, pages: int,
              page_size: int, dtype, a3: bool, device,
              kv_quant: str = "none") -> None:
    """Recurrent kinds keep no per-token pages: their state is a carry,
    snapshotted at page boundaries instead."""
    return None


def _carry_snapshot(state: Dict[str, torch.Tensor], si: int
                    ) -> Dict[str, torch.Tensor]:
    """Lane ``si``'s boundary snapshot, the chunked-prefill carry itself:
    a copy of every ``[L, B, ...]`` leaf's lane, kept ``[L, 1, ...]`` (a
    view would follow the lane as it goes on prefilling)."""
    return {k: v[:, si:si + 1].clone() for k, v in state.items()}


def _carry_restore(state: Dict[str, torch.Tensor],
                   snap: Dict[str, torch.Tensor], si: int) -> None:
    """In place: replay a boundary snapshot into lane ``si`` (on a mesh:
    this rank's share of the snapshot, by the rank holding the lane)."""
    sh = current_shardings()
    if sh is not None and sh.lanes is not None:
        if not sh.lanes[0] <= si < sh.lanes[1]:
            return
        si -= sh.lanes[0]
    for k, v in state.items():
        v[:, si] = snap[k][:, 0]


def _snapshot_dump(snap: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """A boundary snapshot on the host, for the L2 page store and the
    engine checkpoint: every leaf copied to the CPU with its dtype and
    bits, so a promoted or restored carry replays the same tokens."""
    return {k: v.detach().to("cpu", copy=True) for k, v in snap.items()}


def _snapshot_load(host: Dict[str, torch.Tensor], device
                   ) -> Dict[str, torch.Tensor]:
    """A dumped snapshot back on ``device`` (L2 promotion, checkpoint
    restore); leaves already there are kept as they are."""
    return {k: v.to(device) for k, v in host.items()}


@dataclasses.dataclass(frozen=True)
class SegmentMixer:
    """The per-kind mixer-state interface (see module docstring), and
    the paged prefix cache's hooks (``repro_torch.serve.prefix_cache``):
    ``init_pages`` (the kind's pool leaves, or None), ``write_page`` and
    ``gather_pages`` (attention's ring rows to and from pool pages),
    ``snapshot_state``/``restore_state`` (a lane's boundary state), and
    the durable-state pair ``dump_snapshot``/``load_snapshot`` (a
    snapshot to host tensors and back, for ``serve.page_store``)."""
    init_state: Callable[..., Dict[str, torch.Tensor]]
    forward: Callable[..., torch.Tensor]
    prefill_full: Callable[..., Tuple[torch.Tensor,
                                      Dict[str, torch.Tensor]]]
    prefill_chunk: Callable[..., torch.Tensor]
    decode_step: Callable[..., torch.Tensor]
    init_pages: Callable[..., Optional[Dict[str, torch.Tensor]]] = _no_pages
    write_page: Optional[Callable[..., None]] = None
    gather_pages: Optional[Callable[..., None]] = None
    snapshot_state: Callable[..., Dict[str, torch.Tensor]] = _carry_snapshot
    restore_state: Callable[..., None] = _carry_restore
    dump_snapshot: Callable[..., Dict[str, torch.Tensor]] = _snapshot_dump
    load_snapshot: Callable[..., Dict[str, torch.Tensor]] = _snapshot_load


MIXERS: Dict[BlockKind, SegmentMixer] = {
    BlockKind.ATTENTION: SegmentMixer(
        _attn_init_state, _attn_forward, _attn_prefill_full,
        _attn_prefill_chunk, _attn_decode_step,
        init_pages=_attn_init_pages, write_page=_attn_write_page,
        gather_pages=_attn_gather_pages, snapshot_state=_attn_snapshot,
        restore_state=_attn_restore),
    BlockKind.RGLRU: SegmentMixer(
        _rglru_init_state, _rglru_forward, _rglru_prefill_full,
        _rglru_prefill_chunk, _rglru_decode_step),
    BlockKind.MLSTM: SegmentMixer(
        _mlstm_init_state, _mlstm_forward, _mlstm_prefill_full,
        _mlstm_prefill_chunk, _mlstm_decode_step),
    BlockKind.SLSTM: SegmentMixer(
        _slstm_init_state, _slstm_forward, _slstm_prefill_full,
        _slstm_prefill_chunk, _slstm_decode_step),
}


def mixer_for(seg: SegmentSpec, cfg: ModelConfig) -> SegmentMixer:
    """The segment's mixer. Its FFN half (dense SwiGLU or GELU, MoE, or
    none for xLSTM's blocks) is the decoder's ``_ffn_block``."""
    return MIXERS[seg.kind]
