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

from repro_torch.config import A3Config, A3Mode, AttentionKind, BlockKind, \
    ModelConfig
from repro_torch.core.candidate_selection import SortedKeys, \
    slice_sorted_keys, sort_key_columns
from repro_torch.core.quantization import dequantize_int8_block, \
    quantize_int8_block
from repro_torch.kernels.decode_attention.ops import a3_decode_attention, \
    a3_decode_attention_compact
from repro_torch.models import xlstm as xl
from repro_torch.models.rglru import CONV_WIDTH, rglru_apply_scan, \
    rglru_chunk_step, rglru_decode_step
from repro_torch.models.common import NEG_INF, attention_out, \
    attention_qkv, attention_xla_flash

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
    q, k, v = attention_qkv(layer.attn, hn, positions, cfg.num_heads,
                            cfg.num_kv_heads, cfg.resolved_head_dim,
                            cfg.rope_theta)
    o = attention_xla_flash(q, k, v, causal=True, window=_window_arg(seg),
                            chunk=attn_chunk)
    return attention_out(layer.attn, o)


def _attn_prefill_full(layer, hn: torch.Tensor, *, cfg: ModelConfig,
                       seg: SegmentSpec, positions: torch.Tensor,
                       attn_chunk: int, max_len: int, a3: bool,
                       select_shards: int, **_
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Whole-prompt prefill of one layer -> (output, this layer's
    state: rings holding the last min(s, w) positions, A^3 sort)."""
    b, s, _ = hn.shape
    hd = cfg.resolved_head_dim
    w = cache_len_for(seg, max_len)
    q, k, v = attention_qkv(layer.attn, hn, positions, cfg.num_heads,
                            cfg.num_kv_heads, hd, cfg.rope_theta)
    o = attention_xla_flash(q, k, v, causal=True, window=_window_arg(seg),
                            chunk=attn_chunk)
    kc = torch.zeros((b, k.shape[1], w, hd), dtype=k.dtype, device=k.device)
    vc = torch.zeros_like(kc)
    take = min(s, w)
    slots = torch.remainder(torch.arange(s - take, s, device=k.device), w)
    kc[:, :, slots] = k[:, :, s - take:]
    vc[:, :, slots] = v[:, :, s - take:]
    state = {"k": kc, "v": vc}
    if seg.uses_a3(a3):
        ns = select_shards if w % max(select_shards, 1) == 0 else 1
        sk = sort_key_columns(kc.reshape(b, kc.shape[1], ns, w // ns, hd))
        state["sk_vals"] = sk.values.reshape(kc.shape)
        state["sk_rows"] = sk.rows.reshape(kc.shape)       # block-local
        state["sorted_upto"] = torch.full((b,), s, dtype=torch.int32,
                                          device=k.device)
    return attention_out(layer.attn, o), state


def _attn_prefill_chunk(layer, state: Dict[str, torch.Tensor],
                        hn: torch.Tensor, *, cfg: ModelConfig,
                        seg: SegmentSpec, positions: torch.Tensor,
                        valid_tok: torch.Tensor, pos: torch.Tensor,
                        length: torch.Tensor, sort_lanes: torch.Tensor,
                        sort_any: bool, a3: bool, **_) -> torch.Tensor:
    """One ragged prompt chunk through one layer; updates the layer's
    state views in place and returns the mixer output."""
    b, c, _ = hn.shape
    hd = cfg.resolved_head_dim
    hkv, group = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    q, k, v = attention_qkv(layer.attn, hn, positions, cfg.num_heads, hkv,
                            hd, cfg.rope_theta)                # [B, H, C, D]
    # a lane starting a new prompt (pos 0) reads its ring as zeros: the
    # slot may hold a finished request's rows
    fresh = ((pos == 0) & (length > 0))[:, None, None, None]
    ck = torch.where(fresh, 0, state["k"])
    cv = torch.where(fresh, 0, state["v"])
    w = ck.shape[2]
    window = seg.window

    # attention BEFORE the ring write: chunk queries see the ring as it
    # stood before this chunk plus the in-chunk keys
    scale = hd ** -0.5
    qf = (q.float() * scale).reshape(b, hkv, group, c, hd)
    offs = torch.arange(c, dtype=torch.int32, device=hn.device)
    slots = torch.arange(w, dtype=torch.int32, device=hn.device)
    last_prev = (pos - 1)[:, None]
    slot_pos = last_prev - torch.remainder(last_prev - slots[None, :], w)
    ring_mask = (slot_pos[:, None, :] >= 0) & \
        (slot_pos[:, None, :] > positions[:, :, None] - window)   # [B,C,w]
    chunk_mask = (offs[None, :, None] >= offs[None, None, :]) & \
        (offs[None, :, None] - offs[None, None, :] < window) & \
        valid_tok[:, None, :]                                      # [B,C,C]
    mask = torch.cat([ring_mask, chunk_mask], -1)[:, None, None]
    s = torch.cat([torch.einsum("bhgqd,bhkd->bhgqk", qf, ck.float()),
                   torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())], -1)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    vcat = torch.cat([cv, v], 2).float()                       # [B,Hkv,w+C,D]
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, vcat)
    o = torch.where(l == 0.0, 0.0, acc / torch.where(l == 0.0, 1.0, l))
    o = o.reshape(b, cfg.num_heads, c, hd).to(hn.dtype)

    # ragged ring write: slot s takes the chunk position p_s in
    # (last - w, last] with p_s % w == s when that position lies in this
    # lane's chunk; every other slot (and every row of a length-0 lane)
    # keeps its value
    last = (pos + length - 1)[:, None]
    p_s = last - torch.remainder(last - slots[None, :], w)     # [B, w]
    written = (length[:, None] > 0) & (p_s >= pos[:, None])
    src = (p_s - pos[:, None]).clamp(0, c - 1).long()
    src = src[:, None, :, None].expand(b, hkv, w, hd)
    sel = written[:, None, :, None]
    state["k"].copy_(torch.where(sel, torch.gather(k, 2, src), ck))
    state["v"].copy_(torch.where(sel, torch.gather(v, 2, src), cv))

    if a3 and "sk_vals" in state and sort_any:
        # incremental comprehension-time preprocessing: lanes on their
        # final chunk fold the whole ring into the per-column sort (the
        # caller decides sort_any on the host: no device read here)
        sk = sort_key_columns(state["k"])
        l4 = sort_lanes[:, None, None, None]
        state["sk_vals"].copy_(torch.where(l4, sk.values, state["sk_vals"]))
        state["sk_rows"].copy_(torch.where(l4, sk.rows, state["sk_rows"]))
        state["sorted_upto"].copy_(torch.where(
            sort_lanes, (pos + length).to(torch.int32),
            state["sorted_upto"]))
    return attention_out(layer.attn, o)


def _attn_decode_step(layer, state: Dict[str, torch.Tensor],
                      hn: torch.Tensor, *, cfg: ModelConfig,
                      seg: SegmentSpec, pos: torch.Tensor, a3: A3Config,
                      probe: bool = False, **_) -> torch.Tensor:
    """One ragged decode step through one layer: writes the token's K/V
    into the ring in place and attends over it. With ``probe`` an A^3
    layer with a cached sort also leaves its quality probe, ``[B, 2]``
    (mean candidates, captured score mass), in ``state["_probe"]``; the
    output runs the identical ops either way."""
    hd = cfg.resolved_head_dim
    q, k, v = attention_qkv(layer.attn, hn, pos[:, None], cfg.num_heads,
                            cfg.num_kv_heads, hd, cfg.rope_theta)
    kc, vc = state["k"], state["v"]
    _write_token(kc, k[:, :, 0], pos)
    _write_token(vc, v[:, :, 0], pos)
    w = kc.shape[2]
    valid = _ring_valid_mask(w, pos, seg.window)               # [B, w]
    use_a3 = seg.uses_a3(a3.mode != A3Mode.OFF)
    if use_a3 and "sk_vals" in state:
        # sorted keys cached at prefill; rows written since the last
        # re-sort get exact treatment
        fresh = _ring_slot_positions(w, pos) >= state["sorted_upto"][:, None]
        o = a3_decode_attention_compact(
            q[:, :, 0], kc, vc, valid, a3,
            SortedKeys(state["sk_vals"], state["sk_rows"]),
            fresh_mask=fresh, return_probe=probe)
        if probe:
            o, state["_probe"] = o
    elif use_a3:
        # no cached sort: build one inline (single-shot use). The two-pass
        # pair tests every score against the whole ring's max, the exact
        # threshold rule of the oracle the reference's models decode
        # through; #1 advances its max a block_k tile at a time
        o = a3_decode_attention(q[:, :, 0], kc, vc, valid, a3,
                                sorted_keys=sort_key_columns(kc),
                                exact_two_pass=True)
    else:
        o = a3_decode_attention(q[:, :, 0], kc, vc, valid, A3Config())
    return attention_out(layer.attn, o[:, :, None, :])


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
    """In place: replay a boundary snapshot into lane ``si``."""
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
