"""Decoder stack of the port (PyTorch port of ``repro.models.decoder``):
parameters as ``nn.Module``s; the training forward (``forward_hidden``
with per-layer remat, ``chunked_ce``, ``lm_loss``); the serving paths —
whole-prompt ``prefill``, ragged chunked ``prefill_chunk``, ragged
``decode_step``, the in-dispatch A^3 re-sort and the multi-step
``decode_block``; and the prefix cache's page pool (``init_page_pool``).

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

import contextlib
import dataclasses
import functools
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
        # inference by default; the trainer turns gradients on for its
        # own model (train.step.init_train_state)
        self.requires_grad_(False)

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


def init_page_pool(cfg: ModelConfig, pages: int, page_size: int,
                   dtype=None, a3: bool = False, kv_quant: str = "none",
                   device="cuda") -> Dict[str, Any]:
    """The paged prefix cache's pool (``serve.prefix_cache``): per
    attention segment ``seg{i}`` its K/V pages ``[L, pages, Hkv,
    page_size, hd]`` (int8 with per-page float32 ``k_scale``/``v_scale``
    under ``kv_quant="int8"``); recurrent segments add nothing, their
    carries are snapshotted at page boundaries. ``device`` is the
    cache's (the model's)."""
    device = resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    pool: Dict[str, Any] = {}
    for si, seg in enumerate(build_segments(cfg)):
        pages_seg = mixer_for(seg, cfg).init_pages(
            cfg, seg, pages, page_size, dtype, a3, device,
            kv_quant=kv_quant)
        if pages_seg is not None:
            pool[f"seg{si}"] = pages_seg
    return pool


# ---------------------------------------------------------------------------
# forward, prefill
# ---------------------------------------------------------------------------

def _block_forward(blk: Block, h: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, seg: SegmentSpec, attn_chunk: int,
                   layer_context=None) -> Tuple[torch.Tensor, Any]:
    """One layer, full sequence -> (h, moe_aux_loss). ``layer_context``
    (blk -> context manager), when given, is entered around the layer's
    computation, its remat recompute included: a sharded train step
    gathers the layer's weights there."""
    with (layer_context(blk) if layer_context is not None
          else contextlib.nullcontext()):
        hn = rmsnorm(blk.ln1, h, cfg.norm_eps)
        o = mixer_for(seg, cfg).forward(blk, hn, cfg=cfg, seg=seg,
                                        positions=positions,
                                        attn_chunk=attn_chunk)
        return _ffn_block(blk, h + o, cfg)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of matrix products without a
    batch dimension (``mm``, ``addmm``) and recompute everything else,
    ``bmm`` and batched einsums included (the counterpart of
    ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``)."""
    from torch.utils.checkpoint import CheckpointPolicy
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _run_layer(blk: Block, h: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, seg: SegmentSpec, remat: str,
               attn_chunk: int, layer_context=None
               ) -> Tuple[torch.Tensor, Any]:
    """One layer under the reference's per-layer remat: ``"full"`` keeps
    only the layer's input and recomputes the layer in the backward,
    ``"dots"`` keeps its unbatched matrix products as well. Remat changes
    what the backward keeps, never a number."""
    if remat == "none":
        return _block_forward(blk, h, positions, cfg, seg, attn_chunk,
                              layer_context)
    from torch.utils.checkpoint import checkpoint, \
        create_selective_checkpoint_contexts
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    elif remat != "full":
        raise ValueError(f"remat must be none, full or dots, got {remat!r}")
    return checkpoint(_block_forward, blk, h, positions, cfg, seg,
                      attn_chunk, layer_context, use_reentrant=False, **kw)


def _embed_input(model: Decoder, cfg: ModelConfig,
                 tokens: Optional[torch.Tensor],
                 inputs_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The stack's input [B, S, D]: precomputed embeddings (the frontend
    archs) cast to ``cfg.dtype`` as they are, without ``embed_tokens``'
    sqrt(d_model) factor, as in the reference; else the tokens' rows."""
    if inputs_embeds is not None:
        return inputs_embeds.to(device=model.device, dtype=DTYPES[cfg.dtype])
    return embed_tokens(model, cfg, tokens)


def forward_hidden(model: Decoder, cfg: ModelConfig,
                   tokens: Optional[torch.Tensor] = None,
                   inputs_embeds: Optional[torch.Tensor] = None, *,
                   positions: Optional[torch.Tensor] = None,
                   remat: str = "none", attn_chunk: int = 1024,
                   layer_context=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward up to (not including) the unembed ->
    (hidden [B, S, D], {"moe_aux_loss"}), as the reference's
    ``forward_hidden``; ``remat`` applies per layer (:func:`_run_layer`).
    ``inputs_embeds`` [B, S, D] takes the place of ``tokens``.
    ``layer_context`` is entered around each layer (:func:`_block_forward`)."""
    h = _embed_input(model, cfg, tokens, inputs_embeds)
    b, s = h.shape[:2]
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=h.device).expand(b, s)
    aux = 0.0
    for si, seg in enumerate(build_segments(cfg)):
        for blk in model.segs[si].layers:
            h, a = _run_layer(blk, h, positions, cfg, seg, remat,
                              attn_chunk, layer_context)
            aux = aux + a
    return h, {"moe_aux_loss": torch.as_tensor(aux, dtype=torch.float32,
                                               device=h.device)}


def forward(model: Decoder, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None, *,
            positions: Optional[torch.Tensor] = None, remat: str = "none",
            attn_chunk: int = 1024
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward, no state -> (logits [B, S, Vp],
    {"moe_aux_loss"}), as the reference's ``forward``."""
    h, aux = forward_hidden(model, cfg, tokens, inputs_embeds,
                            positions=positions, remat=remat,
                            attn_chunk=attn_chunk)
    return unembed(model, cfg, h), aux


def _chunk_nll(model: Decoder, cfg: ModelConfig, hc: torch.Tensor,
               lc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL, count of labels != -1) of one sequence chunk."""
    lf = unembed(model, cfg, hc).float()                  # [B, c, Vp]
    m = lf.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    safe = torch.clamp(lc, min=0).long()
    gold = torch.gather(lf, -1, safe[..., None])[..., 0]
    valid = (lc != -1).float()
    return ((lse - gold) * valid).sum(), valid.sum()


def chunked_ce(model: Decoder, cfg: ModelConfig, h: torch.Tensor,
               labels: torch.Tensor, ce_chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over labels != -1 without materializing the
    [B, S, Vp] logits (reference ``chunked_ce``; :func:`chunked_nll`)."""
    nll, cnt = chunked_nll(model, cfg, h, labels, ce_chunk)
    return nll / torch.clamp(cnt, min=1.0)


def chunked_nll(model: Decoder, cfg: ModelConfig, h: torch.Tensor,
                labels: torch.Tensor, ce_chunk: int = 512
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL, count) over labels != -1: the unembed and the
    log-sum-exp run per sequence chunk of ``ce_chunk`` tokens under
    ``torch.utils.checkpoint``, so the backward recomputes each chunk's
    logits instead of keeping them. S not a multiple of the chunk falls
    back to one chunk, as in the reference."""
    from torch.utils.checkpoint import checkpoint
    s = h.shape[1]
    c = min(ce_chunk, s)
    if s % c != 0:
        c = s                                # fallback: single chunk
    labels = labels.to(h.device)
    nll = cnt = 0.0
    for lo in range(0, s, c):
        n_c, k_c = checkpoint(_chunk_nll, model, cfg, h[:, lo:lo + c],
                              labels[:, lo:lo + c], use_reentrant=False)
        nll, cnt = nll + n_c, cnt + k_c
    return nll, cnt


def lm_loss(model: Decoder, cfg: ModelConfig,
            tokens: Optional[torch.Tensor], labels: torch.Tensor, *,
            inputs_embeds: Optional[torch.Tensor] = None,
            remat: str = "none", attn_chunk: int = 1024,
            ce_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss -> (lm loss + moe_aux_loss, {"lm_loss",
    "moe_aux_loss"}), as the reference's ``lm_loss``."""
    h, aux = forward_hidden(model, cfg, tokens, inputs_embeds, remat=remat,
                            attn_chunk=attn_chunk)
    loss = chunked_ce(model, cfg, h, labels, ce_chunk)
    return loss + aux["moe_aux_loss"], {"lm_loss": loss, **aux}


def prefill(model: Decoder, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None, *,
            max_len: Optional[int] = None, attn_chunk: int = 1024,
            a3: bool = False, select_shards: int = 1
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process a prompt (``tokens`` [B, S] or ``inputs_embeds``
    [B, S, D]) -> (last-token logits [B, Vp], filled cache)."""
    h = _embed_input(model, cfg, tokens, inputs_embeds)
    b, s = h.shape[:2]
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
                token: Optional[torch.Tensor] = None, pos=None, *,
                input_embed: Optional[torch.Tensor] = None,
                a3: A3Config = A3Config(), probe: bool = False):
    """One ragged autoregressive step -> (logits [B, Vp], cache updated
    in place). ``pos`` is a scalar or a per-lane vector [B]; lanes with
    ``pos < 0`` leave the cache bit-identical. ``input_embed`` [B, D]
    (the frontend archs) takes the place of ``token``.

    ``probe=True`` returns ``(logits, cache, (probe_sum [B, 2],
    n_probed_layers))``: the A^3 quality probes (mean candidates,
    captured score mass) of the global-attention layers with a cached
    sort, summed over each segment's layers and then over segments, as
    the reference sums them. The logits and cache come from the
    identical ops either way."""
    h = _embed_input(model, cfg, None if token is None else token[:, None],
                     None if input_embed is None else input_embed[:, None])
    pos = torch.as_tensor(pos, device=h.device).to(torch.int32).expand(
        h.shape[0])
    probe_sum, probe_layers = None, 0
    for si, seg in enumerate(build_segments(cfg)):
        mixer = mixer_for(seg, cfg)
        seg_probe = []
        for l, blk in enumerate(model.segs[si].layers):
            hn = rmsnorm(blk.ln1, h, cfg.norm_eps)
            state = _layer_state(cache[f"seg{si}"], l)
            o = mixer.decode_step(blk, state, hn, cfg=cfg, seg=seg, pos=pos,
                                  a3=a3, probe=probe)
            if "_probe" in state:
                seg_probe.append(state["_probe"])
            h, _ = _ffn_block(blk, h + o, cfg)
        if seg_probe:
            pr = torch.stack(seg_probe).sum(0)
            probe_sum = pr if probe_sum is None else probe_sum + pr
            probe_layers += len(seg_probe)
    logits = unembed(model, cfg, h)[:, 0]
    if probe:
        if probe_sum is None:
            probe_sum = torch.zeros((h.shape[0], 2), device=h.device)
        return logits, cache, (probe_sum, probe_layers)
    return logits, cache


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
    probe: bool = False,
):
    """Run ``steps`` decode steps with sampling on the device ->
    (token ring [B, steps] int32, token carry [B] int32, cache).

    Per step: re-sort due lanes' A^3 columns (``resort_plan[t]`` is the
    host's may-any-lane-be-due answer for step t; None reads it from
    the device), one :func:`decode_step`, then :func:`sample_logits` at
    the step's position (greedy unless ``temperature > 0`` and a ``key``
    is given; ``sample_ids`` are the lanes' request uids). A lane is
    active while ``pos >= 0`` and its budget is unspent; inactive lanes
    ride along at ``pos = -1`` (ring entries -1, cache untouched). A lane
    whose logits go non-finite emits :data:`POISON` once and freezes.

    ``probe=True`` (A^3 telemetry) returns ``(ring, carry, cache, probe
    [B, 3])``: per lane, over the block's advanced steps only, (samples,
    sum of the step's mean candidate count, sum of its captured score
    mass), each step's layer sum divided by ``max(layers, 1)`` and the
    mass clipped to [0, 1]. It stays on the device with the ring; the
    token and cache path runs the identical ops."""
    dev = token.device
    b = token.shape[0]
    pos = torch.as_tensor(pos, device=dev).to(torch.int32).expand(b)
    remaining = torch.as_tensor(steps_left, device=dev).to(
        torch.int32).expand(b)
    token = token.to(torch.int32)
    do_resort = resort_every > 0 and a3.mode != A3Mode.OFF
    ring = []
    acc = torch.zeros((b, 3), device=dev) if probe else None
    for t in range(steps):
        active = (pos >= 0) & (remaining > 0)
        eff_pos = torch.where(active, pos, -1)
        if do_resort:
            resort_sorted_keys(cache, eff_pos, resort_every,
                               None if resort_plan is None
                               else resort_plan[t])
        if probe:
            logits, cache, (psum, players) = decode_step(
                model, cfg, cache, token, eff_pos, a3=a3, probe=True)
        else:
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
        if probe:
            nl = max(players, 1)
            row = torch.stack([torch.ones((b,), device=dev),
                               psum[:, 0] / nl,
                               torch.clamp(psum[:, 1] / nl, 0.0, 1.0)], 1)
            acc = acc + torch.where(advance[:, None], row, 0.0)
    ring = torch.stack(ring, 1).to(torch.int32)
    if probe:
        return ring, token, cache, acc
    return ring, token, cache
