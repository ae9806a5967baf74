"""Serving engine of the port: ``repro.serve.engine.ServeEngine`` in
PyTorch, without its prefix cache, L2 tier, checkpoints, chaos and
telemetry.

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
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import SHED_POLICIES, A3Config, A3Mode, \
    ModelConfig, ServeConfig
from repro_torch.models import decoder, sampling

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
                      key: Optional[torch.Tensor] = None):
    """The blocked-decode dispatch -> (harvest [B, 1+steps], carry [B],
    cache). Lanes with the handoff bit take ``first_tok`` as input; the
    harvest prepends the effective input column to the token ring."""
    token = torch.where(ctrl[:, CTRL_D_HMASK] > 0, first_tok, token)
    ring, carry, cache = decoder.decode_block(
        model, cfg, cache, token, ctrl[:, CTRL_D_POS], ctrl[:, CTRL_D_STEPS],
        steps=steps, a3=a3, resort_every=resort_every,
        resort_plan=resort_plan, temperature=temperature, key=key,
        sample_ids=ctrl[:, CTRL_D_IDS])
    return torch.cat([token[:, None], ring], 1), carry, cache


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
                 sample_seed: int = 0, max_queue: int = 0,
                 shed_policy: str = "reject-new",
                 deadline_ticks: Optional[int] = None,
                 pipeline_depth: int = 0,
                 virtual_device_latency_s: float = 0.0,
                 retain_results: int = 0):
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
        if int(retain_results) < 0:
            raise ValueError(f"retain_results must be >= 0, got "
                             f"{retain_results} (0 = unbounded "
                             f"retention)")
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
                      "resorts": 0, "adaptive_shrink_ticks": 0,
                      "submitted": 0, "finished": 0, "rejected": 0,
                      "cancelled": 0, "expired": 0, "failed": 0,
                      "max_ticks_exhausted": 0,
                      "tick_ns_prefill": 0, "tick_ns_decode": 0,
                      "tick_ns_harvest": 0, "tick_ns_host": 0,
                      "host_sync_stalls": 0}

    @classmethod
    def from_config(cls, model: decoder.Decoder, cfg: ModelConfig,
                    serve: ServeConfig,
                    a3: A3Config = A3Config()) -> "ServeEngine":
        return cls(model, cfg, slots=serve.slots, max_len=serve.max_len,
                   a3=a3, resort_every=serve.resort_every,
                   prefill_chunk=serve.prefill_chunk,
                   prefill_chunk_min=serve.prefill_chunk_min,
                   decode_block=serve.decode_block,
                   temperature=serve.temperature,
                   sample_seed=serve.sample_seed,
                   max_queue=serve.max_queue, shed_policy=serve.shed_policy,
                   deadline_ticks=serve.deadline_ticks,
                   pipeline_depth=serve.pipeline_depth,
                   retain_results=serve.retain_results)

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
    def in_flight(self) -> int:
        return len(self._queue) + sum(1 for s in self.slots if s.active)

    def step(self):
        """One tick: expire -> admit -> plan + pack -> chunked prefill ->
        blocked decode -> harvest of the blocks beyond
        ``pipeline_depth``."""
        self.stats["ticks"] += 1
        t0 = time.monotonic_ns()
        h0 = self.stats["tick_ns_harvest"]
        self._expire_tick()
        self._admit()
        ctrl = np.zeros((len(self.slots), CTRL_COLS), np.int32)
        ctrl[:, CTRL_D_POS] = -1
        plan_p = self._plan_prefill(ctrl)
        plan_d = self._plan_decode(plan_p, ctrl)
        ctrl_dev = (self._upload(ctrl)
                    if plan_p is not None or plan_d is not None else None)
        tp = time.monotonic_ns()
        self._prefill_tick(plan_p, ctrl_dev)
        p_ns = time.monotonic_ns() - tp
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
        """Tick until no work remains; raises RuntimeError (and counts
        ``max_ticks_exhausted``) if ``max_ticks`` leave work in flight."""
        ticks = 0
        while self.in_flight and ticks < max_ticks:
            self.step()
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
        if self.retain_results > 0:
            self._terminal_order.append(uid)
            while len(self._terminal_order) > self.retain_results:
                old = self._terminal_order.popleft()
                self._status.pop(old, None)
                self._done.pop(old, None)

    def _release_slot(self, si: int, status: str):
        self._handoff.discard(si)
        self._carry_ok[si] = False
        self._terminal(self.slots[si].uid, status)
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

    def _admit(self):
        for si, slot in enumerate(self.slots):
            if slot.active or not self._queue:
                continue
            req = self._queue.popleft()
            self.slots[si] = SlotState(uid=req.uid, pos=0, generated=[],
                                       budget=req.max_new_tokens,
                                       phase=PREFILLING, prompt=req.prompt,
                                       deadline=req.deadline)
            self._status[req.uid] = PREFILLING

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
        tokens = np.zeros((n, c), np.int32)
        sort_any = False
        takes = {}
        for si in pre:
            s = self.slots[si]
            take = min(c, len(s.prompt) - s.cursor)
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
        first_tok, self.cache = prefill_chunk_step(
            self.model, self.cfg, self.cache, self._upload(plan["tokens"]),
            ctrl_dev, a3=self._use_a3,
            sort_any=plan["sort_any"] and self._use_a3,
            temperature=self.temperature, key=self._sample_key)
        self.stats["prefill_dispatches"] += 1
        for si in plan["pre"]:
            s = self.slots[si]
            s.cursor += plan["takes"][si]
            s.pos = s.cursor
            self.stats["prefill_tokens"] += plan["takes"][si]
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
        full, carry, self.cache = decode_block_step(
            self.model, self.cfg, self.cache, token_dev, first, ctrl_dev,
            steps=t, a3=self.a3,
            resort_every=self.resort_every if self._use_a3 else 0,
            resort_plan=self._resort_plan(plan),
            temperature=self.temperature, key=self._sample_key)
        self.stats["decode_steps"] += t
        self.stats["decode_steps_advanced"] += int(min(t, steps_left.max()))
        self.stats["decode_dispatches"] += 1
        self.stats["decode_blocks"] += 1
        self._token_carry = carry
        for si in list(active) + list(handoff):
            self._carry_ok[si] = True
        host, done = self._copy_to_host(full)
        entry = _PendingHarvest(
            host, done,
            handoff=[(si, self.slots[si].uid) for si in sorted(handoff)
                     if self.slots[si].decoding],
            lanes=[(si, self.slots[si].uid, int(min(t, steps_left[si])),
                    plan["pos0"][si])
                   for si in active if self.slots[si].decoding],
            refs={},
            ready_at=(time.monotonic() + self.virtual_device_latency_s
                      if self.virtual_device_latency_s > 0.0 else 0.0))
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
    def _copy_to_host(full: torch.Tensor):
        """Start the harvest's copy to a pinned host buffer behind the
        block on the current stream -> (host tensor, CUDA event recorded
        after the copy; None on the CPU, where ``full`` is the host
        tensor)."""
        if not full.is_cuda:
            return full, None
        host = torch.empty(full.shape, dtype=full.dtype, pin_memory=True)
        host.copy_(full, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

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
        for si, uid in e.handoff:
            s = self.slots[si]
            if s.uid != uid or not s.decoding:
                continue
            tok = int(h[si, 0])
            if tok == decoder.POISON:
                self._release_slot(si, FAILED)
            else:
                s.generated.append(tok)
        for si, uid, nb, pos0 in e.lanes:
            s = self.slots[si]
            if s.uid != uid or not s.decoding:
                continue
            row = h[si, 1:1 + nb]
            if (row == decoder.POISON).any():
                self._release_slot(si, FAILED)
                continue
            s.generated.extend(int(tok) for tok in row)
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
