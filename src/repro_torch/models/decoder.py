"""Decoder stack of the port (PyTorch port of ``repro.models.decoder``):
parameters as ``nn.Module``s, and the serving paths — whole-prompt
``prefill``, ragged chunked ``prefill_chunk``, ragged ``decode_step``,
the in-dispatch A^3 re-sort and the multi-step ``decode_block``.

The caches keep the reference layout: per segment ``seg{i}`` a dict of
``[L, B, ...]`` tensors (``k``/``v`` rings ``[L, B, Hkv, w, hd]``, the A^3
sorted keys and ``sorted_upto`` watermark; the RG-LRU, mLSTM and sLSTM
states),
so they compare leaf for leaf with the JAX caches. Unlike the reference,
which returns new arrays, ``prefill_chunk``, ``decode_step``,
``resort_sorted_keys`` and ``decode_block`` update the cache **in
place** and return the same dict.

Where the reference branches on a device value inside the graph
(``lax.cond``), the port decides on the host: ``prefill_chunk`` takes
``sort_any`` and ``resort_sorted_keys`` takes ``any_due`` from the
caller (the engine derives both from host state); when they are not
given, the function reads the device value, a blocking read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.config import A3Config, A3Mode, BlockKind, ModelConfig
from repro_torch.core.candidate_selection import sort_key_columns
from repro_torch.models.common import NEG_INF, FFN, Attention, RMSNorm, \
    attention_init_, embed_init_, dense_init_, ffn_apply, ffn_init_, \
    rmsnorm, round_to, softcap
from repro_torch.models import sampling
from repro_torch.models import xlstm as xl
from repro_torch.models.mixer import SegmentSpec, build_segments, mixer_for
from repro_torch.models.moe import MoE, moe_apply, moe_init_
from repro_torch.models.rglru import RGLRU, rglru_init_

# Poison-quarantine sentinel of the decode token ring: emitted once by a
# lane whose logits went non-finite, then the lane freezes (reference
# ``decoder.POISON``).
POISON = -2

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def padded_vocab(v: int) -> int:
    """Pad vocab to a multiple of 128 (as the reference)."""
    return ((v + 127) // 128) * 128


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def moe_config(cfg: ModelConfig):
    """The config's MoE with ``d_expert`` 0 resolved to ``d_ff``."""
    m = cfg.moe
    if m is not None and (m.d_expert or 0) == 0:
        m = dataclasses.replace(m, d_expert=cfg.d_ff)
    return m


class Block(nn.Module):
    """One layer: ``ln1`` and the segment kind's mixer (``attn``,
    ``rnn``, ``mlstm`` or ``slstm``), then ``ln2`` and the FFN half: the
    dense ``ffn`` (SwiGLU or GELU) or the ``moe``, unless the segment has
    none (``ffn`` and ``moe`` are then None)."""

    def __init__(self, cfg: ModelConfig, seg: SegmentSpec, dtype,
                 device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.ln1 = RMSNorm(d, dtype, device)
        if seg.kind == BlockKind.ATTENTION:
            self.attn = Attention(d, cfg.num_heads, cfg.num_kv_heads, hd,
                                  dtype, device)
        elif seg.kind == BlockKind.RGLRU:
            self.rnn = RGLRU(d, cfg.num_heads * hd, dtype, device)
        elif seg.kind == BlockKind.MLSTM:
            self.mlstm = xl.MLSTM(d, cfg.num_heads, hd, dtype, device)
        elif seg.kind == BlockKind.SLSTM:
            self.slstm = xl.SLSTM(d, cfg.num_heads, dtype, device)
        self.ffn = self.moe = None
        if seg.ffn != "none":
            self.ln2 = RMSNorm(d, dtype, device)
        if seg.ffn == "dense":
            self.ffn = FFN(d, cfg.d_ff, dtype, device, act=cfg.act)
        elif seg.ffn == "moe":
            self.moe = MoE(d, moe_config(cfg), dtype, device)


class Decoder(nn.Module):
    """Parameters of a decoder: ``embed`` [Vp, d], ``final_norm``,
    ``lm_head`` (untied configs) and ``segs[i].layers[l]`` blocks — the
    reference tree's ``seg{i}`` stacks unstacked into modules."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dtype = DTYPES[cfg.dtype]
        d, vp = cfg.d_model, padded_vocab(cfg.vocab_size)
        self.embed = nn.Parameter(torch.empty((vp, d), dtype=dtype,
                                              device=device))
        self.final_norm = RMSNorm(d, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Linear(d, vp, bias=False, dtype=dtype,
                                     device=device)
        self.segs = nn.ModuleList()
        for seg in build_segments(cfg):
            seg_mod = nn.Module()
            seg_mod.layers = nn.ModuleList(
                Block(cfg, seg, dtype, device) for _ in range(seg.count))
            self.segs.append(seg_mod)
        self.requires_grad_(False)            # inference only

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Decoder:
    """Random weights with the reference's distributions (N(0,1)
    embeddings, N(0,1)/sqrt(d_in) dense weights, unit norms), drawn from
    ``generator`` — the same distributions as ``decoder.init_params``,
    not the same numbers."""
    model = Decoder(cfg, device=resolve_device(device))
    embed_init_(model.embed, generator)
    if not cfg.tie_embeddings:
        dense_init_(model.lm_head, generator)
    for seg, seg_mod in zip(build_segments(cfg), model.segs):
        for blk in seg_mod.layers:
            if seg.kind == BlockKind.ATTENTION:
                attention_init_(blk.attn, generator)
            elif seg.kind == BlockKind.RGLRU:
                rglru_init_(blk.rnn, generator)
            elif seg.kind == BlockKind.MLSTM:
                xl.mlstm_init_(blk.mlstm, generator)
            else:
                xl.slstm_init_(blk.slstm, generator)
            if blk.ffn is not None:
                ffn_init_(blk.ffn, generator)
            if blk.moe is not None:
                moe_init_(blk.moe, generator)
    return model


# ---------------------------------------------------------------------------
# embed / unembed / FFN half
# ---------------------------------------------------------------------------

def embed_tokens(model: Decoder, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    h = model.embed[tokens.long()]
    # the sqrt(d) factor rounds to the model dtype first, as in the
    # reference (a dtype-typed scalar, multiplied in the dtype)
    return h * round_to(math.sqrt(cfg.d_model), h.dtype)


def unembed(model: Decoder, cfg: ModelConfig, h: torch.Tensor
            ) -> torch.Tensor:
    h = rmsnorm(model.final_norm, h, cfg.norm_eps)
    w = model.embed if cfg.tie_embeddings else model.lm_head.weight
    logits = softcap(F.linear(h, w), cfg.logit_softcap)
    vp = logits.shape[-1]
    if vp != cfg.vocab_size:       # mask the vocab-padding columns
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, NEG_INF, logits)
    return logits


def _ffn_block(blk: Block, h: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Any]:
    """The kind-independent FFN half of a block -> (h, moe_aux_loss; 0.0
    without an MoE). An MoE routes every row of ``h``, pad positions
    included."""
    aux = 0.0
    if blk.ffn is not None:
        h = h + ffn_apply(blk.ffn, rmsnorm(blk.ln2, h, cfg.norm_eps))
    elif blk.moe is not None:
        o, moe_aux = moe_apply(blk.moe, rmsnorm(blk.ln2, h, cfg.norm_eps),
                               moe_config(cfg))
        h, aux = h + o, moe_aux["moe_aux_loss"]
    return h, aux


def _layer_state(seg_cache: Dict[str, torch.Tensor], l: int
                 ) -> Dict[str, torch.Tensor]:
    """Per-layer views into a segment's ``[L, ...]`` state tensors."""
    return {name: t[l] for name, t in seg_cache.items()}


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               a3: bool = False, device="cuda") -> Dict[str, Any]:
    """Per-segment decode state: ring-buffer K/V sized
    min(max_len, window); ``a3=True`` adds the sorted key matrix and the
    ``sorted_upto`` watermark on global-attention segments."""
    device = resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    return {f"seg{si}": mixer_for(seg, cfg).init_state(
                cfg, seg, batch, max_len, dtype, a3, device)
            for si, seg in enumerate(build_segments(cfg))}


# ---------------------------------------------------------------------------
# forward, prefill
# ---------------------------------------------------------------------------

def forward(model: Decoder, cfg: ModelConfig, tokens: torch.Tensor, *,
            attn_chunk: int = 1024
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward, no state -> (logits [B, S, Vp],
    {"moe_aux_loss"}), as the reference's ``forward``."""
    b, s = tokens.shape
    h = embed_tokens(model, cfg, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device).expand(b, s)
    aux = 0.0
    for si, seg in enumerate(build_segments(cfg)):
        mixer = mixer_for(seg, cfg)
        for blk in model.segs[si].layers:
            hn = rmsnorm(blk.ln1, h, cfg.norm_eps)
            o = mixer.forward(blk, hn, cfg=cfg, seg=seg,
                              positions=positions, attn_chunk=attn_chunk)
            h, a = _ffn_block(blk, h + o, cfg)
            aux = aux + a
    return unembed(model, cfg, h), {
        "moe_aux_loss": torch.as_tensor(aux, device=h.device)}


def prefill(model: Decoder, cfg: ModelConfig, tokens: torch.Tensor, *,
            max_len: Optional[int] = None, attn_chunk: int = 1024,
            a3: bool = False, select_shards: int = 1
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process a prompt -> (last-token logits [B, Vp], filled cache)."""
    b, s = tokens.shape
    h = embed_tokens(model, cfg, tokens)
    max_len = max_len or s
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device).expand(b, s)
    cache: Dict[str, Any] = {}
    for si, seg in enumerate(build_segments(cfg)):
        mixer = mixer_for(seg, cfg)
        states = []
        for blk in model.segs[si].layers:
            hn = rmsnorm(blk.ln1, h, cfg.norm_eps)
            o, st = mixer.prefill_full(
                blk, hn, cfg=cfg, seg=seg, positions=positions,
                attn_chunk=attn_chunk, max_len=max_len, a3=a3,
                select_shards=select_shards)
            h, _ = _ffn_block(blk, h + o, cfg)
            states.append(st)
        cache[f"seg{si}"] = {name: torch.stack([st[name] for st in states])
                             for name in states[0]}
    return unembed(model, cfg, h[:, -1:])[:, 0], cache


def prefill_chunk(
    model: Decoder,
    cfg: ModelConfig,
    cache: Dict[str, Any],
    tokens: torch.Tensor,               # [B, C] (ragged, zero-padded)
    pos: torch.Tensor,                  # [B] per-lane chunk start
    length: torch.Tensor,               # [B] valid tokens; 0 = skip lane
    *,
    a3: bool = False,
    sort_lanes: Optional[torch.Tensor] = None,   # [B] bool
    sort_any: Optional[bool] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Extend per-slot caches in place with one ragged batch of prompt
    chunks -> (logits [B, Vp] at each lane's last valid position, cache).

    Lanes with ``length == 0`` keep their cache bit-identical; a lane at
    ``pos == 0`` resets its ring first. With ``a3=True`` the lanes in
    ``sort_lanes`` (default: ``length > 0``) fold the ring into the
    sorted key columns; ``sort_any`` says on the host whether any lane
    does (read from the device when not given)."""
    b, c = tokens.shape
    h = embed_tokens(model, cfg, tokens)
    dev = h.device
    pos = torch.as_tensor(pos, device=dev).to(torch.int32)
    length = torch.as_tensor(length, device=dev).to(torch.int32)
    if sort_lanes is None:
        sort_lanes = length > 0
    sort_lanes = torch.as_tensor(sort_lanes, device=dev).bool()
    if sort_any is None:
        sort_any = bool(sort_lanes.any())
    offs = torch.arange(c, dtype=torch.int32, device=dev)
    positions = pos[:, None] + offs[None, :]
    valid_tok = offs[None, :] < length[:, None]
    for si, seg in enumerate(build_segments(cfg)):
        mixer = mixer_for(seg, cfg)
        for l, blk in enumerate(model.segs[si].layers):
            hn = rmsnorm(blk.ln1, h, cfg.norm_eps)
            o = mixer.prefill_chunk(
                blk, _layer_state(cache[f"seg{si}"], l), hn, cfg=cfg,
                seg=seg, positions=positions, valid_tok=valid_tok, pos=pos,
                length=length, sort_lanes=sort_lanes, sort_any=sort_any,
                a3=a3)
            h, _ = _ffn_block(blk, h + o, cfg)
    last = torch.clamp(length - 1, 0, c - 1).long()
    hl = h[torch.arange(b, device=dev), last][:, None]
    return unembed(model, cfg, hl)[:, 0], cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(model: Decoder, cfg: ModelConfig, cache: Dict[str, Any],
                token: torch.Tensor, pos, *, a3: A3Config = A3Config()
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One ragged autoregressive step -> (logits [B, Vp], cache updated
    in place). ``pos`` is a scalar or a per-lane vector [B]; lanes with
    ``pos < 0`` leave the cache bit-identical."""
    h = embed_tokens(model, cfg, token[:, None])
    pos = torch.as_tensor(pos, device=h.device).to(torch.int32).expand(
        h.shape[0])
    for si, seg in enumerate(build_segments(cfg)):
        mixer = mixer_for(seg, cfg)
        for l, blk in enumerate(model.segs[si].layers):
            hn = rmsnorm(blk.ln1, h, cfg.norm_eps)
            o = mixer.decode_step(blk, _layer_state(cache[f"seg{si}"], l),
                                  hn, cfg=cfg, seg=seg, pos=pos, a3=a3)
            h, _ = _ffn_block(blk, h + o, cfg)
    return unembed(model, cfg, h)[:, 0], cache


def resort_sorted_keys(cache: Dict[str, Any], pos: torch.Tensor,
                       resort_every: int,
                       any_due: Optional[bool] = None) -> Dict[str, Any]:
    """A^3 re-sort, in place: each lane whose exact tail outgrew
    ``resort_every`` (``pos - sorted_upto >= resort_every``, pos >= 0)
    folds its ring into the sorted key columns and advances its
    watermark; other lanes keep theirs bit-identically. ``any_due``
    False skips the sort — the caller's host-side watermark mirror
    decides; None reads the due mask from the device."""
    for sc in cache.values():
        if "sk_vals" not in sc:
            continue
        due = (pos >= 0) & (pos - sc["sorted_upto"][0] >= resort_every)
        if not (bool(due.any()) if any_due is None else any_due):
            continue
        sk = sort_key_columns(sc["k"])
        d5 = due[None, :, None, None, None]
        sc["sk_vals"].copy_(torch.where(d5, sk.values, sc["sk_vals"]))
        sc["sk_rows"].copy_(torch.where(d5, sk.rows, sc["sk_rows"]))
        sc["sorted_upto"].copy_(torch.where(due[None, :], pos[None, :],
                                            sc["sorted_upto"]))
    return cache


def sample_logits(logits: torch.Tensor, *, temperature: float = 0.0,
                  key: Optional[torch.Tensor] = None,
                  pos: Optional[torch.Tensor] = None,
                  ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token sampling on the device -> token ids [B] int32.

    ``temperature <= 0`` (or no ``key``) is greedy argmax (the first
    maximal index, as ``jnp.argmax``). Otherwise lane b draws
    ``categorical(fold_in(fold_in(key, ids[b]), pos[b]), logits[b] /
    temperature)`` over the padded vocab with the reference's threefry
    keys (:mod:`repro_torch.models.sampling`), so a draw depends only on
    (seed, request uid, position): not on blocking or on the slot."""
    if temperature <= 0.0 or key is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    b = logits.shape[0]
    zeros = torch.zeros((b,), dtype=torch.int32, device=logits.device)
    pos = zeros if pos is None else pos
    ids = zeros if ids is None else ids
    keys = sampling.fold_in(sampling.fold_in(key, ids), pos)
    return sampling.categorical(keys, logits.float() / temperature).to(
        torch.int32)


def decode_block(
    model: Decoder,
    cfg: ModelConfig,
    cache: Dict[str, Any],
    token: torch.Tensor,              # [B] last emitted token per lane
    pos: torch.Tensor,                # [B] next position; -1 = ride-along
    steps_left: torch.Tensor,         # [B] steps this lane may advance
    *,
    steps: int,
    a3: A3Config = A3Config(),
    resort_every: int = 0,
    resort_plan: Optional[Sequence[bool]] = None,
    temperature: float = 0.0,
    key: Optional[torch.Tensor] = None,
    sample_ids: Optional[torch.Tensor] = None,   # [B] per-request uids
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
    """Run ``steps`` decode steps with sampling on the device ->
    (token ring [B, steps] int32, token carry [B] int32, cache).

    Per step: re-sort due lanes' A^3 columns (``resort_plan[t]`` is the
    host's may-any-lane-be-due answer for step t; None reads it from
    the device), one :func:`decode_step`, then :func:`sample_logits` at
    the step's position (greedy unless ``temperature > 0`` and a ``key``
    is given; ``sample_ids`` are the lanes' request uids). A lane is
    active while ``pos >= 0`` and its budget is unspent; inactive lanes
    ride along at ``pos = -1`` (ring entries -1, cache untouched). A lane
    whose logits go non-finite emits :data:`POISON` once and freezes."""
    dev = token.device
    b = token.shape[0]
    pos = torch.as_tensor(pos, device=dev).to(torch.int32).expand(b)
    remaining = torch.as_tensor(steps_left, device=dev).to(
        torch.int32).expand(b)
    token = token.to(torch.int32)
    do_resort = resort_every > 0 and a3.mode != A3Mode.OFF
    ring = []
    for t in range(steps):
        active = (pos >= 0) & (remaining > 0)
        eff_pos = torch.where(active, pos, -1)
        if do_resort:
            resort_sorted_keys(cache, eff_pos, resort_every,
                               None if resort_plan is None
                               else resort_plan[t])
        logits, cache = decode_step(model, cfg, cache, token, eff_pos,
                                    a3=a3)
        nxt = sample_logits(logits, temperature=temperature, key=key,
                            pos=eff_pos, ids=sample_ids)
        ok = torch.isfinite(logits).all(-1) & (token != POISON)
        advance = active & ok
        poisoned = active & ~ok
        ring.append(torch.where(advance, nxt,
                                torch.where(poisoned, POISON, -1)))
        token = torch.where(advance, nxt, token)
        pos = torch.where(advance, pos + 1, pos)
        remaining = torch.where(poisoned, 0,
                                torch.where(advance, remaining - 1,
                                            remaining))
    return torch.stack(ring, 1).to(torch.int32), token, cache
