"""Serving engine of the port: ``repro.serve.engine.ServeEngine`` in
PyTorch, with its paged prefix cache and host-RAM L2 page tier, its
crash-consistent checkpoint and restore, its deterministic chaos
injection and its telemetry plane.

Slot-based continuous batching with the reference's tick loop::

    expire -> admit -> chunked prefill ------> blocked decode -> harvest
              (queued   (one ragged dispatch    (T x [resort -> step
               request   per tick, in-graph      -> sample] per
               claims a  first-token handoff)    dispatch)
               slot)

* **Chunked ragged prefill.** Every PREFILLING slot advances by at most
  ``prefill_chunk`` prompt tokens in ONE ``decoder.prefill_chunk`` call;
  other lanes ride along with length 0 and keep their cache rows. With
  ``prefill_chunk_min`` the chunk shrinks to that floor on ticks where a
  slot is decoding (``stats["adaptive_shrink_ticks"]``).
* **Device-resident handoff.** The prefill dispatch samples each
  finishing lane's first token on the device; the same tick's decode
  block takes it in place of the lane's input token, and the host learns
  it from the decode harvest. Only a prompt that finishes with no decode
  block to ride reads it directly (``stats["handoff_syncs"]``).
* **Blocked decode.** ``decoder.decode_block`` runs ``decode_block`` = T
  steps per dispatch with on-device sampling (greedy, or tempered draws
  keyed by (``sample_seed``, request uid, position) as the reference
  keys them); the ``[slots, 1+T]`` harvest is read once per block. The
  last token of each lane stays on the device as the next block's input
  (the token carry).
* **Pipelined harvest.** Each harvest is copied to a pinned host buffer
  with ``non_blocking=True`` and a CUDA event is recorded after the
  copy. At ``pipeline_depth`` = d > 0 the harvest is deferred: before
  each tick's dispatch the loop lands only the blocks beyond the newest
  d, plus any newer ones whose event has completed (an opportunistic
  sweep), so d blocks stay in flight behind the device. ``pos`` and
  ``budget`` advance at dispatch (the schedule is deterministic in the
  control words); tokens, finishes and poison land at harvest, guarded by
  the uid each lane held at dispatch and a per-slot ``pending`` count, so
  a slot finishes only once all its blocks have landed. Depth 0 lands
  every block the tick that dispatched it. ``host_syncs`` counts drain
  events, ``host_sync_stalls`` the drains whose forced block had not yet
  finished, ``tick_ns_{prefill,decode,harvest,host}`` the wall time of
  each phase; ``virtual_device_latency_s`` holds each block unreadable
  for that long after dispatch. A read waits on its block's event, never
  on the whole device; on CPU tensors the block is computed already.
* **Paged prefix cache** (``cache_pages > 0``,
  ``serve/prefix_cache.py``). Admission walks a radix trie over the
  prompt's ``page_size``-token pages; every slot with a hit is restored
  in one ``gather_into`` call a tick (ring rows from pool pages,
  recurrent carries and the A^3 sorted columns at the matched boundary,
  both watermarks set to it) and prefills only its suffix. A recorded
  prompt's chunks are clamped to ``record_span`` and land on page
  boundaries; after each chunk the crossed pages are recorded, and after
  the final one the A^3 leaf snapshot. ``prefix_hits``,
  ``prefix_tokens_reused``, ``gather_dispatches``, ``pages_recorded``
  and ``pages_evicted`` count it; ``kv_quant="int8"`` keeps the pool in
  int8. With ``l2_bytes > 0`` evicted pages are demoted to checksummed
  host blobs and promoted back by a later lookup (``l2_spills``,
  ``l2_hits``, ``l2_evictions``, ``l2_integrity_drops``).
* **Packed control.** All per-tick lane scalars ride one int32
  ``[slots, CTRL_COLS]`` upload that both dispatches slice.
* **A^3 re-sort.** Due lanes re-sort their key columns inside the
  decode block. The host hands the block a per-step may-any-lane-be-due
  plan instead of reading the device, computed from a watermark that
  advances when a block is *dispatched* (``SlotState.planned_upto``): the
  harvest-time mirror ``sorted_upto`` lags by the blocks in flight, and a
  stale watermark would mark different steps due, not only more. A
  poisoned lane stops early on the device, so the plan can only err
  towards "due"; the device then selects by its exact per-lane mask.
  ``stats["resorts"]`` is counted from ``sorted_upto`` at harvest, as in
  the reference.

Request lifecycle (the reference's): ``submit`` -> QUEUED -> PREFILLING
-> DECODING -> FINISHED, and the other terminal states REJECTED (queue
full under ``max_queue``/``shed_policy``, or draining), CANCELLED
(``cancel``, ``drain``), EXPIRED (``deadline_ticks`` elapsed) and FAILED
(non-finite logits: the lane emits ``decoder.POISON``). After every tick

    submitted == finished + rejected + cancelled + expired + failed
                 + in_flight

``retain_results`` > 0 bounds the status/result maps and pops a result
on its first read.

Durability: ``checkpoint(path)`` lands every harvest in flight, resolves
any handoff token, and writes the whole serving state (slots, queue,
statuses, results, stats, the device cache, the trie, pool and L2 blobs)
into ``path + ".tmp"`` (``state.json`` behind its crc32 line,
``arrays.bin`` and ``l2.bin`` as ``serve.page_store`` blobs), then
commits it with one rename (an interrupted commit leaves ``path +
".old"``, which ``restore`` falls back to). ``ServeEngine.restore``
copies the arrays into a fresh engine's cache and pool on its device,
rebuilds the token carry cold and re-pins the recording anchors; ticking
it on yields the uninterrupted run's tokens. A torn or mismatched
checkpoint raises ``CheckpointError``.

Chaos (``serve.chaos``): with a ``ChaosInjector`` the engine consults it
at the tick phases ``tick_start`` (virtual delay, spill), ``pre_prefill``
and ``pre_advance`` (abort, crash), corrupts one decoding lane before the
decode dispatch (the lane emits POISON and FAILS), fails warm gathers at
admission (the request FAILS, the next one takes the slot) and corrupts
L2 blobs before their restore. ``run_to_completion`` absorbs an aborted
tick (``chaos_aborted_ticks``) and lets ``EngineCrash`` through; a tick
aborted between the prefill dispatch and the decode harvest leaves
handoff tokens that the next prefilling tick flushes with one direct
read (``_flush_stale_handoff``).

Telemetry (``telemetry=True``, ``serve.telemetry``; off by default, and
then every hook is one ``is not None`` test and the engine is the
telemetry-less one, tokens and stats alike): the reference's metrics
registry (TTFT and queue sojourn keyed by terminal state, TPOT,
decode-block and prefill-chunk latency, the ``stats`` dict as
``serve_*`` counters), its request trace (submit, queued, admit,
prefill chunks, first token, decode blocks from dispatch to harvest,
terminal, and the engine's and the prefix cache's events; Chrome-trace
export) and the A^3 quality probe: with A^3 and sorted-key state every
``telemetry_every``-th decode dispatch runs ``decode_block(probe=True)``,
whose ``[slots, 3]`` probe is copied to pinned memory before the ring's
CUDA event is recorded and lands in the same drain, so telemetry adds
no host sync (``host_syncs`` and ``host_sync_stalls`` are the
telemetry-off serve's). A checkpoint carries the registry; one without
it restores with fresh histograms.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import shutil
import time
import zlib
from typing import Any, Callable, Deque, Dict, List, NamedTuple, Optional, \
    Tuple

import numpy as np
import torch

from repro_torch.config import KV_QUANTS, SHED_POLICIES, A3Config, \
    A3Mode, ModelConfig, ServeConfig
from repro_torch.models import decoder, sampling
from repro_torch.serve.chaos import ChaosError, ChaosInjector, EngineCrash, \
    corrupt_cache_lane
from repro_torch.serve.page_store import CheckpointError, IntegrityError, \
    copy_into, deserialize_tree, serialize_tree
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.telemetry import Telemetry

# packed control-word layout (the reference's CTRL_* columns)
CTRL_P_POS = 0        # prefill: per-lane chunk start position
CTRL_P_LEN = 1        # prefill: per-lane chunk length (0 = ride-along)
CTRL_P_SORT = 2       # prefill: 1 = final chunk (fold the A^3 sort)
CTRL_P_SPOS = 3       # prefill: sampling position of the handoff draw
CTRL_P_SIDS = 4       # prefill: sampling uid of the handoff draw
CTRL_D_POS = 5        # decode: per-lane next position (-1 = ride-along)
CTRL_D_STEPS = 6      # decode: per-lane steps_left budget for the block
CTRL_D_IDS = 7        # decode: per-request sampling uid
CTRL_D_HMASK = 8      # decode: 1 = take the handoff first-token lane
CTRL_COLS = 9

# admission chunk when prefill_chunk is None
_DEFAULT_ADMIT_CHUNK = 512

IDLE = "idle"
PREFILLING = "prefilling"
DECODING = "decoding"
QUEUED = "queued"
FINISHED = "finished"
REJECTED = "rejected"
CANCELLED = "cancelled"
EXPIRED = "expired"
FAILED = "failed"

# terminal status -> stats counter (the conservation identity's terms)
_TERMINAL = {FINISHED: "finished", REJECTED: "rejected",
             CANCELLED: "cancelled", EXPIRED: "expired", FAILED: "failed"}


def prefill_chunk_step(model, cfg: ModelConfig, cache, tokens, ctrl, *,
                       a3: bool, sort_any: bool, temperature: float = 0.0,
                       key: Optional[torch.Tensor] = None):
    """The ragged chunked-prefill dispatch with the on-device handoff:
    -> (first_tok [B] int32, cache). Each lane draws at its
    ``CTRL_P_SPOS`` position under its ``CTRL_P_SIDS`` uid. A finishing
    lane whose prompt logits are non-finite hands POISON instead."""
    logits, cache = decoder.prefill_chunk(
        model, cfg, cache, tokens, ctrl[:, CTRL_P_POS], ctrl[:, CTRL_P_LEN],
        a3=a3, sort_lanes=ctrl[:, CTRL_P_SORT] > 0, sort_any=sort_any)
    tok = decoder.sample_logits(logits, temperature=temperature, key=key,
                                pos=ctrl[:, CTRL_P_SPOS],
                                ids=ctrl[:, CTRL_P_SIDS])
    finite = torch.isfinite(logits).all(-1)
    return torch.where(finite, tok, decoder.POISON).to(torch.int32), cache


def decode_block_step(model, cfg: ModelConfig, cache, token, first_tok,
                      ctrl, *, steps: int, a3: A3Config, resort_every: int,
                      resort_plan=None, temperature: float = 0.0,
                      key: Optional[torch.Tensor] = None,
                      probe: bool = False):
    """The blocked-decode dispatch -> (harvest [B, 1+steps], carry [B],
    cache), and with ``probe`` a fourth item, the A^3 quality probe
    [B, 3] of ``decoder.decode_block``. Lanes with the handoff bit take
    ``first_tok`` as input; the harvest prepends the effective input
    column to the token ring."""
    token = torch.where(ctrl[:, CTRL_D_HMASK] > 0, first_tok, token)
    ring, carry, cache, *pr = decoder.decode_block(
        model, cfg, cache, token, ctrl[:, CTRL_D_POS], ctrl[:, CTRL_D_STEPS],
        steps=steps, a3=a3, resort_every=resort_every,
        resort_plan=resort_plan, temperature=temperature, key=key,
        sample_ids=ctrl[:, CTRL_D_IDS], probe=probe)
    return (torch.cat([token[:, None], ring], 1), carry, cache, *pr)


def _mesh_step(run, cfg: ModelConfig, a3: A3Config, mesh, sharding_cfg,
               max_len: Optional[int], logits=()):
    """``run(model, cache, token, *rest)`` under the serving plan of
    ``mesh`` (one plan a batch size, made at its first call): the model
    holds DTensors laid out by the rules, the cache is this rank's share
    (``step.plan(batch).init_cache`` / ``cut_cache``), and every output
    comes back whole: this rank's lanes gathered with the others', and
    the outputs at the indices ``logits`` over the vocab too."""
    from repro_torch.config import ShardingConfig
    from repro_torch.models.common import current_shardings
    from repro_torch.sharding.plan import serving_plan
    if max_len is None:
        raise ValueError("a serving step on a mesh needs max_len (the "
                         "rings' rows)")
    sharding_cfg = sharding_cfg or ShardingConfig(remat="none")
    plans: Dict[int, Any] = {}

    def plan(batch: int):
        if batch not in plans:
            plans[batch] = serving_plan(
                cfg, mesh, sharding_cfg, batch=batch, max_len=max_len,
                dispatch="decode",
                select_shards=a3.select_shards if a3.mode != A3Mode.OFF
                else 0)
        return plans[batch]

    def step(model, cache, token, *rest):
        with plan(token.shape[0]).dispatch_context(model):
            outs = run(model, cache, token, *rest)
            sh = current_shardings()
            whole = []
            for i, o in enumerate(outs):
                if isinstance(o, torch.Tensor):
                    if i in logits and sh.is_split(model):
                        o = sh.gather(o, -1)
                    o = sh.gather_lanes(o)
                whole.append(o)
            return tuple(whole)

    step.plan = plan
    return step


def make_serve_step(cfg: ModelConfig, a3: A3Config = A3Config(), *,
                    mesh=None, sharding_cfg=None,
                    max_len: Optional[int] = None) -> Callable:
    """-> step(model, cache, token [B], pos scalar or [B]) -> (logits
    [B, Vp], cache): one ``decoder.decode_step`` (the reference's
    ``make_serve_step``; the cache is updated in place, and the tensors'
    device picks the kernel route, so there is no ``use_kernel``). With a
    ``mesh`` (and ``sharding_cfg``, ``max_len``) the dispatch runs this
    rank's share under the serving plan (``sharding.plan``) and the
    logits come back whole; ``step.plan(batch)`` is the plan, whose
    ``init_cache`` makes this rank's cache."""

    def step(model, cache, token, pos):
        logits, cache = decoder.decode_step(model, cfg, cache, token, pos,
                                            a3=a3)
        return logits, cache

    if mesh is None:
        return step
    return _mesh_step(step, cfg, a3, mesh, sharding_cfg, max_len,
                      logits=(0,))


def make_decode_block_step(cfg: ModelConfig, a3: A3Config = A3Config(), *,
                           steps: int = 1, resort_every: int = 0,
                           temperature: float = 0.0, probe: bool = False,
                           mesh=None, sharding_cfg=None,
                           max_len: Optional[int] = None) -> Callable:
    """-> the blocked-decode dispatch (the reference's
    ``make_decode_block_step``): step(model, cache, token [B], first_tok
    [B], ctrl [B, CTRL_COLS][, key]) -> (harvest [B, 1+steps], carry [B],
    cache), or with ``probe`` (harvest, probe [B, 3], carry, cache). It
    wraps :func:`decode_block_step`; the ``key`` argument exists only
    when ``temperature > 0``. With a ``mesh``, as
    :func:`make_serve_step`: this rank's share under the serving plan,
    the harvest and carry of every lane."""

    def _run(model, cache, token, first_tok, ctrl, key=None):
        harvest, carry, cache, *pr = decode_block_step(
            model, cfg, cache, token, first_tok, ctrl, steps=steps, a3=a3,
            resort_every=resort_every, temperature=temperature, key=key,
            probe=probe)
        return (harvest, pr[0], carry, cache) if probe else \
            (harvest, carry, cache)

    if mesh is not None:
        _run = _mesh_step(_run, cfg, a3, mesh, sharding_cfg, max_len)
    if temperature > 0.0:
        def step(model, cache, token, first_tok, ctrl, key):
            return _run(model, cache, token, first_tok, ctrl, key)
    else:
        def step(model, cache, token, first_tok, ctrl):
            return _run(model, cache, token, first_tok, ctrl)
    if mesh is not None:
        step.plan = _run.plan
    return step


class Request(NamedTuple):
    uid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int
    deadline: Optional[int] = None   # absolute tick, None = no deadline


@dataclasses.dataclass
class SlotState:
    uid: int = -1
    pos: int = 0                  # next position to write
    generated: List[int] = dataclasses.field(default_factory=list)
    budget: int = 0
    phase: str = IDLE
    prompt: Optional[np.ndarray] = None
    cursor: int = 0               # prompt tokens prefilled so far
    # host mirror of the A^3 ``sorted_upto`` watermark, as of the last
    # harvested block (keeps stats["resorts"])
    sorted_upto: int = 0
    # the same watermark as of the last dispatched block (drives the
    # resort plan)
    planned_upto: int = 0
    # absolute tick by which the request must finish (None = never)
    deadline: Optional[int] = None
    # dispatched blocks of this lane whose harvest has not landed
    pending: int = 0
    # prefix-cache recording anchor: the trie node of the last recorded
    # page boundary, pinned while the slot prefills (None = no cache)
    rec_node: Any = None

    @property
    def active(self) -> bool:
        return self.phase != IDLE

    @property
    def decoding(self) -> bool:
        return self.phase == DECODING


@dataclasses.dataclass
class _PendingHarvest:
    """One dispatched decode block whose harvest has not landed: ``host``
    is its ``[slots, 1+T]`` harvest on the host (a pinned buffer the copy
    fills once ``done`` completes; the tensor itself on the CPU, where
    ``done`` is None). The bookkeeping is frozen at dispatch: ``handoff``
    (slot, uid) lanes take column 0, ``lanes`` (slot, uid, steps,
    position before the block) the ring, and ``refs`` maps each slot it
    references to the uid it held then."""
    host: torch.Tensor
    done: Optional[Any]
    handoff: List[Tuple[int, int]]
    lanes: List[Tuple[int, int, int, int]]
    refs: Dict[int, int]
    # earliest monotonic time the block may be read (0.0 = no emulation)
    ready_at: float = 0.0
    # telemetry: the A^3 probe [slots, 3] on the host, copied behind the
    # same event as ``host`` (None on unprobed dispatches), and the
    # dispatch's monotonic ns (the trace span's start)
    probe: Optional[torch.Tensor] = None
    t_dispatch: int = 0


def _block_done(e: _PendingHarvest) -> bool:
    """Has the block's harvest reached the host? Never waits."""
    return e.done is None or e.done.query()


class ServeEngine:
    """Slot-based batched serving on the model's device."""

    def __init__(self, model: decoder.Decoder, cfg: ModelConfig, *,
                 slots: int = 4, max_len: int = 2048,
                 a3: A3Config = A3Config(), resort_every: int = 64,
                 prefill_chunk: Optional[int] = None,
                 prefill_chunk_min: Optional[int] = None,
                 decode_block: int = 1, temperature: float = 0.0,
                 sample_seed: int = 0, page_size: int = 64,
                 cache_pages: int = 0, kv_quant: str = "none",
                 l2_bytes: int = 0, max_queue: int = 0,
                 shed_policy: str = "reject-new",
                 deadline_ticks: Optional[int] = None,
                 pipeline_depth: int = 0,
                 virtual_device_latency_s: float = 0.0,
                 telemetry: bool = False, telemetry_every: int = 8,
                 trace_events: int = 4096, retain_results: int = 0,
                 chaos: Optional[ChaosInjector] = None):
        if cfg.frontend:
            # token prompts only, as the reference engine: frontend archs
            # (audio / vision) serve from precomputed embeddings
            raise ValueError(
                f"{cfg.name}: frontend archs serve from precomputed "
                f"embeddings; the token-prompt ServeEngine does not "
                f"support them")
        if prefill_chunk is not None and int(prefill_chunk) <= 0:
            raise ValueError(f"prefill_chunk must be positive, got "
                             f"{prefill_chunk} (use None for the default)")
        self.model, self.cfg, self.a3 = model, cfg, a3
        self.device = model.device
        self.max_len = max_len
        self._use_a3 = a3.mode != A3Mode.OFF
        # clamped to >= 1 as in the reference (0 meant "every step")
        self.resort_every = max(1, int(resort_every))
        self.prefill_chunk = (int(prefill_chunk)
                              if prefill_chunk is not None else None)
        self._chunk = (int(prefill_chunk) if prefill_chunk is not None
                       else min(int(max_len), _DEFAULT_ADMIT_CHUNK))
        if prefill_chunk_min is not None:
            if int(prefill_chunk_min) <= 0:
                raise ValueError(f"prefill_chunk_min must be positive, "
                                 f"got {prefill_chunk_min} (use None to "
                                 f"disable the adaptive policy)")
            if int(prefill_chunk_min) > self._chunk:
                raise ValueError(f"prefill_chunk_min ({prefill_chunk_min})"
                                 f" must not exceed the effective prefill "
                                 f"chunk ({self._chunk})")
        self._chunk_min = (int(prefill_chunk_min)
                           if prefill_chunk_min is not None else None)
        if int(page_size) < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if int(cache_pages) < 0:
            raise ValueError(f"cache_pages must be >= 0, got "
                             f"{cache_pages} (0 disables the prefix "
                             f"cache)")
        if kv_quant not in KV_QUANTS:
            raise ValueError(f"kv_quant must be 'none' or 'int8', got "
                             f"{kv_quant!r}")
        if int(l2_bytes) < 0:
            raise ValueError(f"l2_bytes must be >= 0, got {l2_bytes} "
                             f"(0 disables the host-RAM L2 tier)")
        if int(max_queue) < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue} "
                             f"(0 = unbounded queue)")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of "
                             f"{SHED_POLICIES}, got {shed_policy!r}")
        if deadline_ticks is not None and int(deadline_ticks) < 1:
            raise ValueError(f"deadline_ticks must be >= 1, got "
                             f"{deadline_ticks} (use None for no "
                             f"deadline)")
        if int(pipeline_depth) < 0:
            raise ValueError(f"pipeline_depth must be >= 0, got "
                             f"{pipeline_depth} (0 = synchronous "
                             f"harvest)")
        if float(virtual_device_latency_s) < 0.0:
            raise ValueError(f"virtual_device_latency_s must be >= 0, "
                             f"got {virtual_device_latency_s}")
        if int(telemetry_every) < 1:
            raise ValueError(f"telemetry_every must be >= 1, got "
                             f"{telemetry_every}")
        if int(trace_events) < 1:
            raise ValueError(f"trace_events must be >= 1, got "
                             f"{trace_events}")
        if int(retain_results) < 0:
            raise ValueError(f"retain_results must be >= 0, got "
                             f"{retain_results} (0 = unbounded "
                             f"retention)")
        self.telemetry = bool(telemetry)
        self.telemetry_every = int(telemetry_every)
        self.trace_events = int(trace_events)
        self._tm: Optional[Telemetry] = (
            Telemetry(trace_events=self.trace_events,
                      telemetry_every=self.telemetry_every)
            if self.telemetry else None)
        self.page_size = int(page_size)
        self.cache_pages = int(cache_pages)
        self.kv_quant = kv_quant
        self.l2_bytes = int(l2_bytes)
        self._chaos = chaos
        self.max_queue = int(max_queue)
        self.shed_policy = shed_policy
        self.deadline_ticks = (int(deadline_ticks)
                               if deadline_ticks is not None else None)
        self.pipeline_depth = int(pipeline_depth)
        self.virtual_device_latency_s = float(virtual_device_latency_s)
        self.retain_results = int(retain_results)
        self.decode_block = max(1, int(decode_block))
        # temperature > 0 is the sampling switch; the key never changes
        # (each draw folds the request uid and position into it)
        self.temperature = max(0.0, float(temperature))
        self.sample_seed = int(sample_seed)
        self._sample_key = (sampling.prng_key(self.sample_seed, self.device)
                            if self.temperature > 0.0 else None)
        self._draining = False
        self.slots = [SlotState() for _ in range(slots)]
        self.cache = decoder.init_cache(cfg, slots, max_len, a3=self._use_a3,
                                        device=self.device)
        self._n_a3_segs = sum(1 for sc in self.cache.values()
                              if "sk_vals" in sc)
        # the A^3 quality probe: only with telemetry and sorted-key state
        self._probe = (self._tm is not None and self._use_a3
                       and self._n_a3_segs > 0)
        self._handoff: set = set()
        self._first_tok: Optional[torch.Tensor] = None
        self._pending: Deque[_PendingHarvest] = collections.deque()
        self._token_carry: Optional[torch.Tensor] = None
        self._carry_ok = np.zeros((slots,), bool)
        self._zero_tok = torch.zeros((slots,), dtype=torch.int32,
                                     device=self.device)
        self._queue: Deque[Request] = collections.deque()
        self._done: Dict[int, List[int]] = {}
        self._status: Dict[int, str] = {}
        self._terminal_order: Deque[int] = collections.deque()
        self._uid = 0
        self.stats = {"prefill_tokens": 0, "decode_steps": 0,
                      "decode_steps_advanced": 0, "decode_dispatches": 0,
                      "decode_blocks": 0, "prefill_dispatches": 0,
                      "host_syncs": 0, "handoff_syncs": 0, "ticks": 0,
                      "resorts": 0, "prefix_hits": 0,
                      "prefix_tokens_reused": 0, "gather_dispatches": 0,
                      "pages_recorded": 0, "pages_evicted": 0,
                      "adaptive_shrink_ticks": 0,
                      "submitted": 0, "finished": 0, "rejected": 0,
                      "cancelled": 0, "expired": 0, "failed": 0,
                      "chaos_aborted_ticks": 0, "max_ticks_exhausted": 0,
                      "chaos_delayed_ticks": 0,
                      "l2_spills": 0, "l2_hits": 0, "l2_evictions": 0,
                      "l2_integrity_drops": 0, "checkpoints": 0,
                      "restores": 0,
                      "tick_ns_prefill": 0, "tick_ns_decode": 0,
                      "tick_ns_harvest": 0, "tick_ns_host": 0,
                      "host_sync_stalls": 0}
        if self._tm is not None:
            # the stats dict, read by reference at exposition time
            self._tm.registry.attach_stats("serve_", self.stats)
        # the paged prefix cache (cache_pages 0: none, no pool memory)
        self._pc: Optional[PrefixCache] = None
        if self.cache_pages > 0:
            self._pc = PrefixCache(cfg, max_len=max_len,
                                   page_size=self.page_size,
                                   cache_pages=self.cache_pages,
                                   a3=self._use_a3, kv_quant=kv_quant,
                                   l2_bytes=self.l2_bytes,
                                   stats=self.stats, device=self.device)
            self._pc.tm = self._tm
            if self._pc.l2 is not None and chaos is not None:
                # the restore_corrupt site: flip a blob byte right before
                # its verified restore (the checksum must catch it)
                self._pc.l2_fault_hook = (
                    lambda key: self._chaos.l2_restore_corrupt(
                        self.stats["ticks"], key))

    @classmethod
    def from_config(cls, model: decoder.Decoder, cfg: ModelConfig,
                    serve: ServeConfig, a3: A3Config = A3Config(),
                    chaos: Optional[ChaosInjector] = None
                    ) -> "ServeEngine":
        return cls(model, cfg, slots=serve.slots, max_len=serve.max_len,
                   a3=a3, resort_every=serve.resort_every,
                   prefill_chunk=serve.prefill_chunk,
                   prefill_chunk_min=serve.prefill_chunk_min,
                   decode_block=serve.decode_block,
                   temperature=serve.temperature,
                   sample_seed=serve.sample_seed,
                   page_size=serve.page_size,
                   cache_pages=serve.cache_pages, kv_quant=serve.kv_quant,
                   l2_bytes=serve.l2_bytes, max_queue=serve.max_queue,
                   shed_policy=serve.shed_policy,
                   deadline_ticks=serve.deadline_ticks,
                   pipeline_depth=serve.pipeline_depth,
                   telemetry=serve.telemetry,
                   telemetry_every=serve.telemetry_every,
                   trace_events=serve.trace_events,
                   retain_results=serve.retain_results, chaos=chaos)

    # -- public API ---------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32,
               deadline_ticks: Optional[int] = None) -> int:
        """Queue a prompt (1-D integer token ids in [0, vocab), length
        <= max_len) -> request uid. Invalid inputs raise without taking a
        uid; a shed request gets its uid back with status "rejected".
        ``deadline_ticks`` (default: the engine's) expires the request if
        it has not finished within that many ticks of submission."""
        arr = np.asarray(prompt)
        if arr.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got shape {arr.shape}")
        if arr.size == 0:
            raise ValueError("empty prompt")
        if not np.issubdtype(arr.dtype, np.integer):
            raise TypeError(f"prompt must be an integer token array, got "
                            f"dtype {arr.dtype}")
        if arr.size > self.max_len:
            raise ValueError(f"prompt length {arr.size} exceeds max_len "
                             f"{self.max_len}")
        if (arr < 0).any() or (arr >= self.cfg.vocab_size).any():
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.cfg.vocab_size})")
        if int(max_new_tokens) < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if deadline_ticks is None:
            deadline_ticks = self.deadline_ticks
        deadline = None
        if deadline_ticks is not None:
            if int(deadline_ticks) < 1:
                raise ValueError(f"deadline_ticks must be >= 1, got "
                                 f"{deadline_ticks}")
            deadline = self.stats["ticks"] + int(deadline_ticks)
        uid = self._uid
        self._uid += 1
        self.stats["submitted"] += 1
        if self._tm is not None:
            self._tm.on_submit(uid)
        if self._draining:
            self._terminal(uid, REJECTED)
            return uid
        if self.max_queue and len(self._queue) >= self.max_queue:
            if self.shed_policy == "evict-oldest-queued":
                self._terminal(self._queue.popleft().uid, REJECTED)
            else:
                self._terminal(uid, REJECTED)
                return uid
        self._status[uid] = QUEUED
        self._queue.append(Request(uid, arr.astype(np.int32),
                                   int(max_new_tokens), deadline))
        return uid

    def result(self, uid: int) -> Optional[List[int]]:
        """Generated tokens of a FINISHED request, else None. With
        ``retain_results > 0`` the first read pops the result."""
        if self.retain_results > 0:
            return self._done.pop(uid, None)
        return self._done.get(uid)

    def status(self, uid: int) -> str:
        try:
            return self._status[uid]
        except KeyError:
            raise KeyError(f"unknown request uid {uid}") from None

    def cancel(self, uid: int) -> bool:
        """Cancel a queued or on-slot request (its slot is free at once;
        a harvest still in flight for it is dropped by the uid guard).
        False if the request is terminal or unknown."""
        st = self._status.get(uid)
        if st == QUEUED:
            self._queue = collections.deque(
                r for r in self._queue if r.uid != uid)
            self._terminal(uid, CANCELLED)
            return True
        if st in (PREFILLING, DECODING):
            for si, s in enumerate(self.slots):
                if s.active and s.uid == uid:
                    self._release_slot(si, CANCELLED)
                    return True
        return False

    def drain(self):
        """Graceful shutdown: cancel queued work, let on-slot work
        finish, reject every later submit. Idempotent."""
        self._draining = True
        while self._queue:
            self._terminal(self._queue.popleft().uid, CANCELLED)

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def tm(self) -> Optional[Telemetry]:
        """The telemetry bundle (None unless ``telemetry=True``)."""
        return self._tm

    @property
    def in_flight(self) -> int:
        return len(self._queue) + sum(1 for s in self.slots if s.active)

    def step(self):
        """One tick: expire -> admit -> plan + pack -> chunked prefill ->
        blocked decode -> harvest of the blocks beyond
        ``pipeline_depth``. With a chaos injector the tick may stall,
        spill, corrupt a lane, or abort with ``ChaosError`` at a phase
        boundary; every phase leaves the engine consistent, so the next
        tick resumes."""
        self.stats["ticks"] += 1
        tick = self.stats["ticks"]
        t0 = time.monotonic_ns()
        h0 = self.stats["tick_ns_harvest"]
        ch = self._chaos
        if ch is not None:
            ch.phase(tick, "tick_start")
            if ch.consume_delay():
                # a virtual stall: the tick does no work (deadlines still
                # elapse)
                self.stats["chaos_delayed_ticks"] += 1
                if self._tm is not None:
                    self._tm.event("chaos_delay", tick=tick)
                self.stats["tick_ns_host"] += time.monotonic_ns() - t0
                return
            spill = ch.pick_spill(tick)
            if spill and self._pc is not None:
                if self._tm is not None:
                    self._tm.event("chaos_spill", tick=tick, pages=spill)
                self._pc.spill(spill)
        self._expire_tick()
        self._admit()
        if ch is not None:
            ch.phase(tick, "pre_prefill")
        if any(s.phase == PREFILLING for s in self.slots):
            # an aborted tick can leave handoff tokens unharvested: read
            # them before the prefill dispatch overwrites ``_first_tok``
            self._flush_stale_handoff()
        ctrl = np.zeros((len(self.slots), CTRL_COLS), np.int32)
        ctrl[:, CTRL_D_POS] = -1
        plan_p = self._plan_prefill(ctrl)
        plan_d = self._plan_decode(plan_p, ctrl)
        ctrl_dev = (self._upload(ctrl)
                    if plan_p is not None or plan_d is not None else None)
        tp = time.monotonic_ns()
        self._prefill_tick(plan_p, ctrl_dev)
        p_ns = time.monotonic_ns() - tp
        if ch is not None:
            ch.phase(tick, "pre_advance")
        self._corrupt_tick()
        hd = self.stats["tick_ns_harvest"]
        td = time.monotonic_ns()
        self._advance(plan_d, ctrl_dev)
        d_ns = max(0, time.monotonic_ns() - td
                   - (self.stats["tick_ns_harvest"] - hd))
        self.stats["tick_ns_prefill"] += p_ns
        self.stats["tick_ns_decode"] += d_ns
        self.stats["tick_ns_host"] += max(
            0, time.monotonic_ns() - t0 - p_ns - d_ns
            - (self.stats["tick_ns_harvest"] - h0))

    def run_to_completion(self, max_ticks: int = 10_000):
        """Tick until no work remains. An injected tick abort
        (``ChaosError``) is absorbed and counted in
        ``chaos_aborted_ticks``; ``EngineCrash`` propagates. Raises
        RuntimeError (and counts ``max_ticks_exhausted``) if ``max_ticks``
        leave work in flight."""
        ticks = 0
        while self.in_flight and ticks < max_ticks:
            try:
                self.step()
            except EngineCrash:
                # injected process death: recovery is restore()
                raise
            except ChaosError:
                self.stats["chaos_aborted_ticks"] += 1
                if self._tm is not None:
                    self._tm.event("chaos_abort", tick=self.stats["ticks"])
            ticks += 1
        if self.in_flight:
            self.stats["max_ticks_exhausted"] += 1
            queued = [r.uid for r in self._queue]
            on_slot = [s.uid for s in self.slots if s.active]
            raise RuntimeError(
                f"run_to_completion exhausted max_ticks={max_ticks} "
                f"with {self.in_flight} requests still in flight "
                f"(queued uids {queued}, on-slot uids {on_slot}) — "
                f"raise max_ticks or investigate a stalled lane")

    # -- crash-consistent checkpoint / restore --------------------------------
    def _ckpt_kwargs(self) -> Dict[str, Any]:
        """The JSON-serializable constructor arguments a restore rebuilds
        the engine from (the model, its config, A^3 and chaos come from
        the caller; the config's name and the A^3 mode are checked)."""
        return {"slots": len(self.slots), "max_len": self.max_len,
                "resort_every": self.resort_every,
                "prefill_chunk": self.prefill_chunk,
                "prefill_chunk_min": self._chunk_min,
                "decode_block": self.decode_block,
                "temperature": self.temperature,
                "sample_seed": self.sample_seed,
                "page_size": self.page_size,
                "cache_pages": self.cache_pages,
                "kv_quant": self.kv_quant,
                "l2_bytes": self.l2_bytes,
                "max_queue": self.max_queue,
                "shed_policy": self.shed_policy,
                "deadline_ticks": self.deadline_ticks,
                "pipeline_depth": self.pipeline_depth,
                "virtual_device_latency_s": self.virtual_device_latency_s,
                "telemetry": self.telemetry,
                "telemetry_every": self.telemetry_every,
                "trace_events": self.trace_events,
                "retain_results": self.retain_results}

    def checkpoint(self, path: str) -> None:
        """Snapshot the whole serving state into directory ``path`` with
        an atomic rename commit: slots (prefill cursors, generated
        tokens, budgets), queue, statuses and results, the sampling seed
        (the key is never mutated), stats, the device cache, and the
        prefix trie, pool and L2 blobs. Everything goes into ``path +
        ".tmp"`` first; one ``os.rename`` commits it (an interrupted
        commit leaves ``path + ".old"``, which :meth:`restore` falls back
        to). ``state.json`` carries a crc32 and the arrays are one
        checksummed blob, so a torn checkpoint fails restore loudly. With
        telemetry the registry's counters and histograms go with it."""
        # the snapshot must be host-consistent at a tick boundary: land
        # every harvest in flight and resolve any handoff token
        t_ck = time.monotonic_ns()
        self._drain_harvests()
        self._flush_stale_handoff()
        self._finish_done_slots()
        slots_meta = []
        for s in self.slots:
            rec = None
            if s.rec_node is not None and self._pc is not None:
                rec = [int(x) for x in self._pc._path_of(s.rec_node)]
            slots_meta.append({
                "uid": s.uid, "pos": s.pos,
                "generated": [int(x) for x in s.generated],
                "budget": s.budget, "phase": s.phase,
                "prompt": (None if s.prompt is None
                           else [int(x) for x in s.prompt]),
                "cursor": s.cursor, "sorted_upto": s.sorted_upto,
                "rec": rec, "has_rec": s.rec_node is not None,
                "deadline": s.deadline})
        state: Dict[str, Any] = {
            "version": 1, "cfg_name": self.cfg.name,
            "a3_mode": self.a3.mode.value,
            "engine": self._ckpt_kwargs(),
            "uid": self._uid, "draining": self._draining,
            "stats": dict(self.stats),
            "status": {str(k): v for k, v in self._status.items()},
            "done": {str(k): [int(t) for t in v]
                     for k, v in self._done.items()},
            "queue": [{"uid": r.uid,
                       "prompt": [int(x) for x in r.prompt],
                       "max_new": r.max_new_tokens,
                       "deadline": r.deadline} for r in self._queue],
            "slots": slots_meta}
        if self._tm is not None:
            # optional key: a checkpoint without it restores with fresh
            # histograms
            state["telemetry"] = self._tm.dump_state()
        arrays: Dict[str, Any] = {"cache": self.cache}
        l2_blobs: List[bytes] = []
        if self._pc is not None:
            pc_meta, pc_arrays = self._pc.dump_state()
            state["pc"] = pc_meta
            arrays["pc"] = pc_arrays
            if self._pc.l2 is not None:
                index, off = [], 0
                for key, blob in self._pc.l2.raw_items():
                    index.append({"key": list(key), "off": off,
                                  "len": len(blob)})
                    l2_blobs.append(blob)
                    off += len(blob)
                state["l2_index"] = index
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        payload = json.dumps(state, sort_keys=True).encode()
        with open(os.path.join(tmp, "state.json"), "wb") as f:
            f.write(b"%d\n" % zlib.crc32(payload) + payload)
        with open(os.path.join(tmp, "arrays.bin"), "wb") as f:
            f.write(serialize_tree(arrays))
        with open(os.path.join(tmp, "l2.bin"), "wb") as f:
            f.write(b"".join(l2_blobs))
        # the atomic commit: the rename below is the durability point
        old = path + ".old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(path):
            os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
        self.stats["checkpoints"] += 1
        if self._tm is not None:
            self._tm.span("checkpoint", ts_ns=t_ck,
                          dur_ns=time.monotonic_ns() - t_ck, path=path)

    @classmethod
    def restore(cls, path: str, model: decoder.Decoder, cfg: ModelConfig,
                a3: A3Config = A3Config(),
                chaos: Optional[ChaosInjector] = None) -> "ServeEngine":
        """Rebuild an engine from a :meth:`checkpoint` directory on the
        model's device and resume where it left off: ticking it on yields
        the uninterrupted run's tokens for every queued, prefilling and
        decoding request. The caller supplies what a checkpoint does not
        own (the model, its config, the A^3 config, optionally a fresh
        chaos injector); the saved config name and A^3 mode are checked
        against them. Raises :class:`CheckpointError` on any
        verification failure."""
        if not os.path.isdir(path) and os.path.isdir(path + ".old"):
            # a crash between the commit's renames leaves only .old: the
            # previous complete checkpoint is still durable
            path = path + ".old"
        try:
            with open(os.path.join(path, "state.json"), "rb") as f:
                raw = f.read()
            crc_s, payload = raw.split(b"\n", 1)
            if zlib.crc32(payload) != int(crc_s):
                raise CheckpointError(
                    f"{path}: state.json checksum mismatch")
            state = json.loads(payload.decode())
            with open(os.path.join(path, "arrays.bin"), "rb") as f:
                arrays = deserialize_tree(f.read())
            with open(os.path.join(path, "l2.bin"), "rb") as f:
                l2_raw = f.read()
        except CheckpointError:
            raise
        except (OSError, ValueError, IntegrityError) as e:
            raise CheckpointError(
                f"unreadable checkpoint {path}: {e}") from None
        if state.get("version") != 1:
            raise CheckpointError(f"unsupported checkpoint version "
                                  f"{state.get('version')!r}")
        if state["cfg_name"] != cfg.name:
            raise CheckpointError(
                f"checkpoint was taken with model {state['cfg_name']!r}; "
                f"restoring with {cfg.name!r}")
        if state["a3_mode"] != a3.mode.value:
            raise CheckpointError(
                f"checkpoint A^3 mode {state['a3_mode']!r} does not match "
                f"{a3.mode.value!r}")
        eng = cls(model, cfg, a3=a3, chaos=chaos, **state["engine"])
        # stats is shared with the prefix cache: update in place
        eng.stats.update({k: int(v) for k, v in state["stats"].items()})
        eng._uid = int(state["uid"])
        eng._draining = bool(state["draining"])
        eng._status = {int(k): v for k, v in state["status"].items()}
        eng._done = {int(k): [int(t) for t in v]
                     for k, v in state["done"].items()}
        eng._queue = collections.deque(
            Request(int(q["uid"]), np.asarray(q["prompt"], np.int32),
                    int(q["max_new"]),
                    None if q["deadline"] is None else int(q["deadline"]))
            for q in state["queue"])
        copy_into(eng.cache, arrays.get("cache", {}), "cache")
        if eng._pc is not None and "pc" in state:
            eng._pc.load_state(state["pc"], arrays.get("pc", {}))
            if eng._pc.l2 is not None:
                for entry in state.get("l2_index", []):
                    off, n = int(entry["off"]), int(entry["len"])
                    eng._pc.l2.put_raw(tuple(int(x) for x in entry["key"]),
                                       l2_raw[off:off + n])
        for si, sm in enumerate(state["slots"]):
            # every harvest landed at checkpoint time, so the dispatch
            # watermark is the harvested one and nothing is pending; the
            # token carry is rebuilt cold from ``generated``
            s = SlotState(
                uid=int(sm["uid"]), pos=int(sm["pos"]),
                generated=[int(x) for x in sm["generated"]],
                budget=int(sm["budget"]), phase=sm["phase"],
                prompt=(None if sm["prompt"] is None
                        else np.asarray(sm["prompt"], np.int32)),
                cursor=int(sm["cursor"]),
                sorted_upto=int(sm["sorted_upto"]),
                planned_upto=int(sm["sorted_upto"]),
                deadline=(None if sm["deadline"] is None
                          else int(sm["deadline"])))
            if sm["has_rec"] and eng._pc is not None:
                # re-pin the recording anchor from its token path (refs
                # are not saved: they come back from the slots holding
                # them)
                node: Any = eng._pc.root
                toks = [int(x) for x in sm["rec"]]
                ps = eng.page_size
                for b in range(0, len(toks), ps):
                    node = node.children.get(tuple(toks[b:b + ps]))
                    if node is None:
                        break
                if node is not None:
                    s.rec_node = node
                    eng._pc.ref(node)
            eng.slots[si] = s
        eng.stats["restores"] += 1
        if eng._tm is not None:
            if "telemetry" in state:
                eng._tm.load_state(state["telemetry"])
            eng._tm.event("restore", tick=int(eng.stats["ticks"]))
        return eng

    # -- internals ------------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> the engine's device, without a blocking copy (a
        pinned staging buffer on the card)."""
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _terminal(self, uid: int, status: str):
        self._status[uid] = status
        self.stats[_TERMINAL[status]] += 1
        if self._tm is not None:
            self._tm.on_terminal(uid, status)
        if self.retain_results > 0:
            self._terminal_order.append(uid)
            while len(self._terminal_order) > self.retain_results:
                old = self._terminal_order.popleft()
                self._status.pop(old, None)
                self._done.pop(old, None)

    def _release_slot(self, si: int, status: str):
        """Free a slot from any phase; its recording pin is dropped, so
        the trie's refcounts return to baseline."""
        s = self.slots[si]
        if s.rec_node is not None and self._pc is not None:
            self._pc.unref(s.rec_node)
        self._handoff.discard(si)
        self._carry_ok[si] = False
        self._terminal(s.uid, status)
        self.slots[si] = SlotState()

    def _expire_tick(self):
        """A request submitted at tick T with deadline d expires at the
        start of tick T + d + 1 unless it has finished."""
        now = self.stats["ticks"]
        if any(r.deadline is not None for r in self._queue):
            kept: Deque[Request] = collections.deque()
            for req in self._queue:
                if req.deadline is not None and now > req.deadline:
                    self._terminal(req.uid, EXPIRED)
                else:
                    kept.append(req)
            self._queue = kept
        for si, s in enumerate(self.slots):
            if s.active and s.deadline is not None and now > s.deadline:
                self._release_slot(si, EXPIRED)

    def _corrupt_tick(self):
        """Chaos site: NaN one decoding lane's mixer state (the victim
        drawn by the injector); the lane's next logits go non-finite and
        the decode block emits POISON on the harvest."""
        if self._chaos is None:
            return
        decoding = {s.uid: si for si, s in enumerate(self.slots)
                    if s.decoding}
        if not decoding:
            return
        victim = self._chaos.pick_corrupt_victim(self.stats["ticks"],
                                                 sorted(decoding))
        if victim is not None:
            if self._tm is not None:
                self._tm.event("chaos_corrupt", uid=victim,
                               track=decoding[victim])
            corrupt_cache_lane(self.cache, decoding[victim])

    def _admit(self):
        """Queued requests claim free slots. With the prefix cache each
        one walks the trie (promoting demoted pages from L2) and pins its
        matched node (a later eviction in this tick cannot take it); then
        one ``gather_into`` restores every slot with a hit, and its
        cursor and both A^3 watermarks start at the matched length. A
        miss (or no cache) starts at 0: the first chunk resets the lane's
        state on the device. A warm request whose gather the chaos
        injector fails ends FAILED before any copy, and the next queued
        request takes the slot."""
        assigned: List[Tuple[int, Request, int, Any]] = []
        for si, slot in enumerate(self.slots):
            if slot.active:
                continue
            while self._queue:
                req = self._queue.popleft()
                t, node = 0, None
                if self._pc is not None:
                    t, node = self._pc.lookup(req.prompt)
                    if t > 0 and self._chaos is not None:
                        try:
                            self._chaos.gather_fail(self.stats["ticks"],
                                                    req.uid, t)
                        except ChaosError:
                            if self._tm is not None:
                                self._tm.event("chaos_gather_fail",
                                               uid=req.uid)
                            self._terminal(req.uid, FAILED)
                            continue
                    self._pc.ref(node)      # the recording anchor's pin
                assigned.append((si, req, t, node))
                break
        warm = [(si, t, node) for si, _, t, node in assigned if t > 0]
        if warm:
            self._pc.gather_into(self.cache, warm)
        for si, req, t, node in assigned:
            self.slots[si] = SlotState(uid=req.uid, pos=t, generated=[],
                                       budget=req.max_new_tokens,
                                       phase=PREFILLING, prompt=req.prompt,
                                       cursor=t, sorted_upto=t,
                                       planned_upto=t, rec_node=node,
                                       deadline=req.deadline)
            self._status[req.uid] = PREFILLING
            if self._tm is not None:
                self._tm.on_admit(req.uid, si, reused_tokens=t)

    def _plan_prefill(self, ctrl: np.ndarray) -> Optional[Dict[str, Any]]:
        pre = [si for si, s in enumerate(self.slots)
               if s.phase == PREFILLING]
        if not pre:
            return None
        n, c = len(self.slots), self._chunk
        if self._chunk_min is not None \
                and any(s.decoding for s in self.slots):
            c = self._chunk_min
            self.stats["adaptive_shrink_ticks"] += 1
        ps = self.page_size
        tokens = np.zeros((n, c), np.int32)
        sort_any = False
        takes = {}
        for si in pre:
            s = self.slots[si]
            take = min(c, len(s.prompt) - s.cursor)
            if s.rec_node is not None:
                # a recorded prompt's chunk advances at most record_span
                # and ends on its last crossed page boundary (an
                # unaligned tail follows in the next chunk): pages are
                # read from the rings once at the chunk's end, so every
                # recorded position must still be in the ring then. An
                # unaligned start realigns at the first boundary.
                take = min(take, self._pc.record_span)
                if s.cursor % ps:
                    take = min(take, ps - s.cursor % ps)
                else:
                    aligned = ((s.cursor + take) // ps) * ps
                    if aligned > s.cursor:
                        take = aligned - s.cursor
            tokens[si, :take] = s.prompt[s.cursor:s.cursor + take]
            ctrl[si, CTRL_P_POS] = s.cursor
            ctrl[si, CTRL_P_LEN] = take
            takes[si] = take
            # fold the A^3 sort only on the prompt's final chunk
            if s.cursor + take >= len(s.prompt):
                ctrl[si, CTRL_P_SORT] = 1
                sort_any = True
            ctrl[si, CTRL_P_SPOS] = s.cursor + take - 1
            ctrl[si, CTRL_P_SIDS] = s.uid
        return {"pre": pre, "takes": takes, "tokens": tokens,
                "sort_any": sort_any}

    def _prefill_tick(self, plan: Optional[Dict[str, Any]], ctrl_dev):
        if plan is None:
            return
        t_disp = time.monotonic_ns() if self._tm is not None else 0
        first_tok, self.cache = prefill_chunk_step(
            self.model, self.cfg, self.cache, self._upload(plan["tokens"]),
            ctrl_dev, a3=self._use_a3,
            sort_any=plan["sort_any"] and self._use_a3,
            temperature=self.temperature, key=self._sample_key)
        self.stats["prefill_dispatches"] += 1
        if self._tm is not None:
            # one ragged dispatch serves every prefilling lane: each lane
            # gets a span of its wall time
            dur = time.monotonic_ns() - t_disp
            for si in plan["pre"]:
                self._tm.on_prefill_chunk(
                    self.slots[si].uid, si, ts_ns=t_disp, dur_ns=dur,
                    pos=self.slots[si].cursor, chunk=plan["takes"][si])
        ps = self.page_size
        for si in plan["pre"]:
            s = self.slots[si]
            s.cursor += plan["takes"][si]
            s.pos = s.cursor
            self.stats["prefill_tokens"] += plan["takes"][si]
            if s.rec_node is not None and s.cursor > s.rec_node.end:
                # record every page boundary the chunk crossed, reading
                # the cache the dispatch just wrote (same stream, no
                # sync); only the chunk's end carries the recurrent
                # snapshot. None: the budget is spent with nothing
                # evictable, so the lane stops recording
                prev = s.cursor - plan["takes"][si]
                for b in range((prev // ps + 1) * ps, s.cursor + 1, ps):
                    child = self._pc.record_boundary(
                        self.cache, si, s.prompt, b, s.rec_node,
                        carry=(b == s.cursor))
                    self._pc.unref(s.rec_node)
                    self._pc.ref(child)
                    s.rec_node = child
                    if child is None:
                        break
            if s.cursor >= len(s.prompt):
                # the first token lives only in ``first_tok`` until the
                # decode harvest resolves it
                s.phase = DECODING
                self._status[s.uid] = DECODING
                s.generated = []
                s.budget -= 1
                # the final chunk folded the sort
                s.sorted_upto = s.planned_upto = len(s.prompt)
                self._handoff.add(si)
                if s.rec_node is not None:
                    # the leaf's A^3 sorted columns, then the pin goes
                    self._pc.record_final(self.cache, si, s.rec_node,
                                          len(s.prompt))
                    self._pc.unref(s.rec_node)
                    s.rec_node = None
        if self._handoff:
            self._first_tok = first_tok

    def _plan_decode(self, plan_p: Optional[Dict[str, Any]],
                     ctrl: np.ndarray) -> Optional[Dict[str, Any]]:
        """Plan the decode block against the slot table as it will be
        after the planned prefill lands (lanes on their final chunk join
        with pos = len(prompt) and one budget unit spent)."""
        handoff = set(self._handoff)
        state: Dict[int, Tuple[int, int]] = {}
        for si, s in enumerate(self.slots):
            if s.decoding:
                state[si] = (s.pos, s.budget)
            elif plan_p is not None and si in plan_p["takes"]:
                if s.cursor + plan_p["takes"][si] >= len(s.prompt):
                    state[si] = (len(s.prompt), s.budget - 1)
                    handoff.add(si)
        active = [si for si in sorted(state)
                  if state[si][1] > 0 and state[si][0] < self.max_len - 1]
        for si in handoff:
            ctrl[si, CTRL_D_HMASK] = 1
        if not active:
            return None
        steps_left = np.zeros((len(self.slots),), np.int32)
        pos0 = {}
        for si in active:
            p, b = state[si]
            steps_left[si] = min(b, self.max_len - 1 - p)
            pos0[si] = p
            ctrl[si, CTRL_D_POS] = p
            ctrl[si, CTRL_D_STEPS] = steps_left[si]
            ctrl[si, CTRL_D_IDS] = self.slots[si].uid
        return {"active": active, "steps_left": steps_left, "pos0": pos0}

    def _resort_plan(self, plan: Dict[str, Any]) -> Optional[List[bool]]:
        """Per step of the block: may any lane be due for its A^3
        re-sort? Simulated from the dispatch-time watermark, which it
        advances past this block (no device read)."""
        if not self._use_a3:
            return None
        upto = {si: self.slots[si].planned_upto for si in plan["active"]}
        due_at = []
        for t in range(self.decode_block):
            due = False
            for si in plan["active"]:
                p = plan["pos0"][si] + t
                if t < plan["steps_left"][si] \
                        and p - upto[si] >= self.resort_every:
                    upto[si] = p
                    due = True
            due_at.append(due)
        for si, u in upto.items():
            self.slots[si].planned_upto = u
        return due_at

    def _flush_stale_handoff(self):
        """Resolve handoff tokens left over by a tick aborted between the
        prefill dispatch and the decode harvest, with one direct read
        (in normal operation the same tick's decode consumes them and
        this does nothing). Harvests in flight land first."""
        if not self._handoff:
            return
        self._drain_harvests()
        handoff, self._handoff = self._handoff, set()
        self._read_first_tokens(handoff)
        self._first_tok = None
        self._finish_done_slots()

    def _read_first_tokens(self, handoff) -> None:
        """Direct read of handoff first tokens (no decode block rides)."""
        th = time.monotonic_ns()
        first = self._first_tok.cpu().numpy()
        self.stats["host_syncs"] += 1
        self.stats["handoff_syncs"] += 1
        for si in sorted(handoff):
            s = self.slots[si]
            if not s.decoding:
                continue
            tok = int(first[si])
            if tok == decoder.POISON:
                self._release_slot(si, FAILED)
            else:
                s.generated.append(tok)
                if self._tm is not None:
                    self._tm.on_first_token(s.uid)
            self._carry_ok[si] = False
        self.stats["tick_ns_harvest"] += time.monotonic_ns() - th

    def _advance(self, plan: Optional[Dict[str, Any]], ctrl_dev) -> None:
        handoff = self._handoff
        self._handoff = set()
        if plan is None:
            self._drain_harvests()
            if handoff:
                self._read_first_tokens(handoff)
            self._finish_done_slots()
            return
        n, t = len(self.slots), self.decode_block
        active, steps_left = plan["active"], plan["steps_left"]
        # depth >= 1: land the blocks beyond the newest ``depth`` before
        # this dispatch (depth 0 lands its block right after it)
        if self.pipeline_depth > 0:
            self._drain_harvests(keep=self.pipeline_depth)
        # input tokens: the previous block's device-resident carry; the
        # cold path (engine start, or a lane whose carry a direct read
        # invalidated) lands every harvest and rebuilds the vector from
        # host state
        if self._token_carry is None or \
                any(not self._carry_ok[si] for si in active
                    if si not in handoff):
            self._drain_harvests()
            tokens = np.zeros((n,), np.int32)
            for si in active:
                s = self.slots[si]
                if s.decoding and s.generated:
                    tokens[si] = s.generated[-1]
            token_dev = self._upload(tokens)
        else:
            token_dev = self._token_carry
        first = self._first_tok if handoff else self._zero_tok
        # A^3 telemetry: every telemetry_every-th dispatch also returns
        # the quality probe (identical token and cache ops)
        probe = self._probe and \
            self.stats["decode_dispatches"] % self.telemetry_every == 0
        t_disp = time.monotonic_ns() if self._tm is not None else 0
        full, carry, self.cache, *pr = decode_block_step(
            self.model, self.cfg, self.cache, token_dev, first, ctrl_dev,
            steps=t, a3=self.a3,
            resort_every=self.resort_every if self._use_a3 else 0,
            resort_plan=self._resort_plan(plan),
            temperature=self.temperature, key=self._sample_key, probe=probe)
        self.stats["decode_steps"] += t
        self.stats["decode_steps_advanced"] += int(min(t, steps_left.max()))
        self.stats["decode_dispatches"] += 1
        self.stats["decode_blocks"] += 1
        self._token_carry = carry
        for si in list(active) + list(handoff):
            self._carry_ok[si] = True
        host, done, host_pr = self._copy_to_host(full, *pr)
        entry = _PendingHarvest(
            host, done,
            handoff=[(si, self.slots[si].uid) for si in sorted(handoff)
                     if self.slots[si].decoding],
            lanes=[(si, self.slots[si].uid, int(min(t, steps_left[si])),
                    plan["pos0"][si])
                   for si in active if self.slots[si].decoding],
            refs={},
            ready_at=(time.monotonic() + self.virtual_device_latency_s
                      if self.virtual_device_latency_s > 0.0 else 0.0),
            probe=host_pr, t_dispatch=t_disp)
        for si, uid in entry.handoff:
            entry.refs[si] = uid
        # pos / budget advance at dispatch: the device runs exactly this
        # schedule unless a lane poisons, and then the lane is released
        for si, uid, nb, _pos0 in entry.lanes:
            entry.refs[si] = uid
            self.slots[si].pos += nb
            self.slots[si].budget -= nb
        for si in entry.refs:
            self.slots[si].pending += 1
        self._pending.append(entry)
        if self.pipeline_depth == 0:
            self._drain_harvests()
        self._finish_done_slots()

    @staticmethod
    def _copy_to_host(full: torch.Tensor, probe=None):
        """Start the harvest's copy (and the probe's, if any) to pinned
        host buffers behind the block on the current stream -> (host
        harvest, CUDA event recorded after both copies, host probe or
        None). On the CPU the tensors are the host copies and the event
        is None."""
        if not full.is_cuda:
            return full, None, probe
        copies = []
        for t in (full, probe):
            if t is not None:
                t = torch.empty(t.shape, dtype=t.dtype,
                                pin_memory=True).copy_(t, non_blocking=True)
            copies.append(t)
        done = torch.cuda.Event()
        done.record()
        return copies[0], done, copies[1]

    def _drain_harvests(self, keep: int = 0):
        """Land queued harvests oldest-first at one sync point, leaving
        up to ``keep`` of the newest in flight; newer blocks that are
        already on the host ride along. Counts one ``host_syncs`` per
        drain, and a ``host_sync_stalls`` when a forced block had not
        arrived."""
        if len(self._pending) <= keep:
            return
        th = time.monotonic_ns()
        now = time.monotonic()
        entries = [self._pending.popleft()
                   for _ in range(len(self._pending) - keep)]
        if any(not _block_done(e) or e.ready_at > now for e in entries):
            self.stats["host_sync_stalls"] += 1
            if self._tm is not None:
                self._tm.event("host_sync_stall",
                               forced_blocks=len(entries),
                               in_flight=len(self._pending))
        while self._pending and _block_done(self._pending[0]) \
                and self._pending[0].ready_at <= now:
            entries.append(self._pending.popleft())
        self.stats["host_syncs"] += 1
        for e in entries:
            wait = e.ready_at - time.monotonic()
            if wait > 0.0:
                time.sleep(wait)
            if e.done is not None:
                e.done.synchronize()          # this block's copy only
            self._apply_harvest(e, e.host.numpy())
        self.stats["tick_ns_harvest"] += time.monotonic_ns() - th

    def _apply_harvest(self, e: _PendingHarvest, h: np.ndarray):
        """One block's host bookkeeping, every row guarded by the uid its
        lane held at dispatch."""
        tm = self._tm
        if tm is not None:
            now = time.monotonic_ns()
            tm.on_decode_block(
                [(si, uid) for si, uid, _nb, _p0 in e.lanes],
                ts_ns=e.t_dispatch or now,
                dur_ns=now - e.t_dispatch if e.t_dispatch else 0,
                steps=max((nb for _si, _u, nb, _p0 in e.lanes), default=0),
                deferred=self.pipeline_depth > 0)
            if e.probe is not None:
                # landed behind the ring's event: no extra sync
                tm.on_a3_probe(e.probe.numpy())
        for si, uid in e.handoff:
            s = self.slots[si]
            if s.uid != uid or not s.decoding:
                continue
            tok = int(h[si, 0])
            if tok == decoder.POISON:
                self._release_slot(si, FAILED)
            else:
                s.generated.append(tok)
                if tm is not None:
                    tm.on_first_token(s.uid)
        for si, uid, nb, pos0 in e.lanes:
            s = self.slots[si]
            if s.uid != uid or not s.decoding:
                continue
            row = h[si, 1:1 + nb]
            if (row == decoder.POISON).any():
                self._release_slot(si, FAILED)
                continue
            s.generated.extend(int(tok) for tok in row)
            if tm is not None and nb > 0:
                tm.on_decode_steps(s.uid, nb)
            if self._use_a3:
                # mirror the device watermark (checked before each
                # step's ring write, as resort_sorted_keys does)
                for p in range(pos0, pos0 + nb):
                    if p - s.sorted_upto >= self.resort_every:
                        s.sorted_upto = p
                        self.stats["resorts"] += self._n_a3_segs
        for si, uid in e.refs.items():
            s = self.slots[si]
            if s.uid == uid:
                s.pending = max(0, s.pending - 1)

    def _finish_done_slots(self):
        for si, s in enumerate(self.slots):
            if s.decoding and s.pending == 0 \
                    and (s.budget <= 0 or s.pos >= self.max_len - 1):
                self._done[s.uid] = s.generated
                self._terminal(s.uid, FINISHED)
                self._carry_ok[si] = False
                self.slots[si] = SlotState()
