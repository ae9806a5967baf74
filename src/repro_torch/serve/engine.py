"""Serving engine of the port (PyTorch port of the core of
``repro.serve.engine.ServeEngine``).

Slot-based continuous batching with the reference's tick loop::

    admit -----------> chunked prefill ------> blocked decode
    (queued request     (one ragged dispatch     (T x [resort -> step
     claims a slot)      per tick, in-graph       -> sample] per
                         first-token handoff)     dispatch)

* **Chunked ragged prefill.** Every PREFILLING slot advances by at most
  ``prefill_chunk`` prompt tokens in ONE ``decoder.prefill_chunk`` call;
  other lanes ride along with length 0 and keep their cache rows.
* **Device-resident handoff.** The prefill dispatch samples each
  finishing lane's first token on the device; the same tick's decode
  block takes it in place of the lane's input token, and the host learns
  it from the decode harvest. Only a prompt that finishes with no decode
  block to ride reads it directly (``stats["handoff_syncs"]``).
* **Blocked decode.** ``decoder.decode_block`` runs ``decode_block`` = T
  steps per dispatch with on-device sampling; the host reads the
  ``[slots, 1+T]`` harvest (input column + token ring) once per block.
  The last token of each lane stays on the device as the next block's
  input (the token carry).
* **Packed control.** All per-tick lane scalars ride one int32
  ``[slots, CTRL_COLS]`` upload that both dispatches slice.
* **A^3 re-sort.** Due lanes re-sort their key columns inside the
  decode block. The host mirrors the ``sorted_upto`` watermark (it is
  deterministic in the positions), so it hands the block a per-step
  may-any-lane-be-due plan instead of reading the device, and keeps
  ``stats["resorts"]`` from the same mirror. The plan can only err
  towards "due" (a poisoned lane stops early on the device); the device
  then selects by its exact per-lane due mask, so the result is the
  reference's either way.

Stats keep the reference's meaning: ``prefill_dispatches``,
``decode_dispatches``, ``decode_steps`` (T per dispatch),
``decode_steps_advanced``, ``host_syncs`` (one per harvest plus direct
handoff reads), ``handoff_syncs``, ``resorts``, ``prefill_tokens``,
``ticks`` and the lifecycle counters. Synchronous harvest only (the
reference's ``pipeline_depth = 0``); the prefix cache, L2 tier,
checkpoints, chaos, telemetry, load shedding and deadlines are not
ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Deque, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import A3Config, A3Mode, ModelConfig, ServeConfig
from repro_torch.models import decoder

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
FAILED = "failed"


def prefill_chunk_step(model, cfg: ModelConfig, cache, tokens, ctrl, *,
                       a3: bool, sort_any: bool):
    """The ragged chunked-prefill dispatch with the on-device handoff:
    -> (first_tok [B] int32, cache). A finishing lane whose prompt logits
    are non-finite hands POISON instead of a token."""
    logits, cache = decoder.prefill_chunk(
        model, cfg, cache, tokens, ctrl[:, CTRL_P_POS], ctrl[:, CTRL_P_LEN],
        a3=a3, sort_lanes=ctrl[:, CTRL_P_SORT] > 0, sort_any=sort_any)
    tok = decoder.sample_logits(logits)
    finite = torch.isfinite(logits).all(-1)
    return torch.where(finite, tok, decoder.POISON).to(torch.int32), cache


def decode_block_step(model, cfg: ModelConfig, cache, token, first_tok,
                      ctrl, *, steps: int, a3: A3Config, resort_every: int,
                      resort_plan=None):
    """The blocked-decode dispatch -> (harvest [B, 1+steps], carry [B],
    cache). Lanes with the handoff bit take ``first_tok`` as input; the
    harvest prepends the effective input column to the token ring."""
    token = torch.where(ctrl[:, CTRL_D_HMASK] > 0, first_tok, token)
    ring, carry, cache = decoder.decode_block(
        model, cfg, cache, token, ctrl[:, CTRL_D_POS], ctrl[:, CTRL_D_STEPS],
        steps=steps, a3=a3, resort_every=resort_every,
        resort_plan=resort_plan)
    return torch.cat([token[:, None], ring], 1), carry, cache


class Request(NamedTuple):
    uid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int


@dataclasses.dataclass
class SlotState:
    uid: int = -1
    pos: int = 0                  # next position to write
    generated: List[int] = dataclasses.field(default_factory=list)
    budget: int = 0
    phase: str = IDLE
    prompt: Optional[np.ndarray] = None
    cursor: int = 0               # prompt tokens prefilled so far
    # host mirror of the A^3 ``sorted_upto`` watermark
    sorted_upto: int = 0

    @property
    def active(self) -> bool:
        return self.phase != IDLE

    @property
    def decoding(self) -> bool:
        return self.phase == DECODING


class ServeEngine:
    """Slot-based batched serving on the model's device."""

    def __init__(self, model: decoder.Decoder, cfg: ModelConfig, *,
                 slots: int = 4, max_len: int = 2048,
                 a3: A3Config = A3Config(), resort_every: int = 64,
                 prefill_chunk: Optional[int] = None,
                 decode_block: int = 1):
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
        self.decode_block = max(1, int(decode_block))
        self.slots = [SlotState() for _ in range(slots)]
        self.cache = decoder.init_cache(cfg, slots, max_len, a3=self._use_a3,
                                        device=self.device)
        self._n_a3_segs = sum(1 for sc in self.cache.values()
                              if "sk_vals" in sc)
        self._handoff: set = set()
        self._first_tok: Optional[torch.Tensor] = None
        self._token_carry: Optional[torch.Tensor] = None
        self._carry_ok = np.zeros((slots,), bool)
        self._zero_tok = torch.zeros((slots,), dtype=torch.int32,
                                     device=self.device)
        self._queue: Deque[Request] = collections.deque()
        self._done: Dict[int, List[int]] = {}
        self._status: Dict[int, str] = {}
        self._uid = 0
        self.stats = {"prefill_tokens": 0, "decode_steps": 0,
                      "decode_steps_advanced": 0, "decode_dispatches": 0,
                      "decode_blocks": 0, "prefill_dispatches": 0,
                      "host_syncs": 0, "handoff_syncs": 0, "ticks": 0,
                      "resorts": 0, "submitted": 0, "finished": 0,
                      "failed": 0}

    @classmethod
    def from_config(cls, model: decoder.Decoder, cfg: ModelConfig,
                    serve: ServeConfig,
                    a3: A3Config = A3Config()) -> "ServeEngine":
        return cls(model, cfg, slots=serve.slots, max_len=serve.max_len,
                   a3=a3, resort_every=serve.resort_every,
                   prefill_chunk=serve.prefill_chunk,
                   decode_block=serve.decode_block)

    # -- public API ---------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> int:
        """Queue a prompt (1-D integer token ids in [0, vocab), length
        <= max_len) -> request uid."""
        arr = np.asarray(prompt)
        if arr.ndim != 1 or arr.size == 0:
            raise ValueError(f"prompt must be a non-empty 1-D array, got "
                             f"shape {arr.shape}")
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
        uid = self._uid
        self._uid += 1
        self.stats["submitted"] += 1
        self._status[uid] = QUEUED
        self._queue.append(Request(uid, arr.astype(np.int32),
                                   int(max_new_tokens)))
        return uid

    def result(self, uid: int) -> Optional[List[int]]:
        """Generated tokens of a FINISHED request, else None."""
        return self._done.get(uid)

    def status(self, uid: int) -> str:
        try:
            return self._status[uid]
        except KeyError:
            raise KeyError(f"unknown request uid {uid}") from None

    @property
    def in_flight(self) -> int:
        return len(self._queue) + sum(1 for s in self.slots if s.active)

    def step(self):
        """One tick: admit -> plan + pack -> chunked prefill -> blocked
        decode -> harvest."""
        self.stats["ticks"] += 1
        self._admit()
        ctrl = np.zeros((len(self.slots), CTRL_COLS), np.int32)
        ctrl[:, CTRL_D_POS] = -1
        plan_p = self._plan_prefill(ctrl)
        plan_d = self._plan_decode(plan_p, ctrl)
        ctrl_dev = (torch.from_numpy(ctrl).to(self.device)
                    if plan_p is not None or plan_d is not None else None)
        self._prefill_tick(plan_p, ctrl_dev)
        self._advance(plan_d, ctrl_dev)

    def run_to_completion(self, max_ticks: int = 10_000):
        ticks = 0
        while self.in_flight and ticks < max_ticks:
            self.step()
            ticks += 1
        if self.in_flight:
            raise RuntimeError(
                f"run_to_completion exhausted max_ticks={max_ticks} with "
                f"{self.in_flight} requests still in flight")

    # -- internals ------------------------------------------------------------
    def _terminal(self, uid: int, status: str):
        self._status[uid] = status
        self.stats[status] += 1

    def _release_slot(self, si: int, status: str):
        self._handoff.discard(si)
        self._carry_ok[si] = False
        self._terminal(self.slots[si].uid, status)
        self.slots[si] = SlotState()

    def _admit(self):
        for si, slot in enumerate(self.slots):
            if slot.active or not self._queue:
                continue
            req = self._queue.popleft()
            self.slots[si] = SlotState(uid=req.uid, pos=0, generated=[],
                                       budget=req.max_new_tokens,
                                       phase=PREFILLING, prompt=req.prompt)
            self._status[req.uid] = PREFILLING

    def _plan_prefill(self, ctrl: np.ndarray) -> Optional[Dict[str, Any]]:
        pre = [si for si, s in enumerate(self.slots)
               if s.phase == PREFILLING]
        if not pre:
            return None
        n, c = len(self.slots), self._chunk
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
            self.model, self.cfg, self.cache,
            torch.from_numpy(plan["tokens"]).to(self.device), ctrl_dev,
            a3=self._use_a3, sort_any=plan["sort_any"] and self._use_a3)
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
                s.sorted_upto = len(s.prompt)   # final chunk folded the sort
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
        re-sort? From the host watermark mirror, without a device read."""
        if not self._use_a3:
            return None
        upto = {si: self.slots[si].sorted_upto for si in plan["active"]}
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
        return due_at

    def _read_first_tokens(self, handoff) -> None:
        """Direct read of handoff first tokens (no decode block rides)."""
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

    def _advance(self, plan: Optional[Dict[str, Any]], ctrl_dev) -> None:
        handoff = self._handoff
        self._handoff = set()
        if plan is None:
            if handoff:
                self._read_first_tokens(handoff)
            self._finish_done_slots()
            return
        n, t = len(self.slots), self.decode_block
        active, steps_left = plan["active"], plan["steps_left"]
        # input tokens: the previous block's device-resident carry; the
        # cold path (engine start, or a lane whose carry a direct read
        # invalidated) rebuilds the vector from host state
        if self._token_carry is None or \
                any(not self._carry_ok[si] for si in active
                    if si not in handoff):
            tokens = np.zeros((n,), np.int32)
            for si in active:
                s = self.slots[si]
                if s.decoding and s.generated:
                    tokens[si] = s.generated[-1]
            token_dev = torch.from_numpy(tokens).to(self.device)
        else:
            token_dev = self._token_carry
        first = self._first_tok if handoff else self._zero_tok
        full, carry, self.cache = decode_block_step(
            self.model, self.cfg, self.cache, token_dev, first, ctrl_dev,
            steps=t, a3=self.a3,
            resort_every=self.resort_every if self._use_a3 else 0,
            resort_plan=self._resort_plan(plan))
        self.stats["decode_steps"] += t
        self.stats["decode_steps_advanced"] += int(min(t, steps_left.max()))
        self.stats["decode_dispatches"] += 1
        self.stats["decode_blocks"] += 1
        self._token_carry = carry
        for si in list(active) + list(handoff):
            self._carry_ok[si] = True
        handoff_lanes = [(si, self.slots[si].uid) for si in sorted(handoff)
                         if self.slots[si].decoding]
        lanes = [(si, self.slots[si].uid, int(min(t, steps_left[si])),
                  plan["pos0"][si])
                 for si in active if self.slots[si].decoding]
        for si, _uid, nb, _p0 in lanes:
            self.slots[si].pos += nb
            self.slots[si].budget -= nb
        h = full.cpu().numpy()                   # the one sync per block
        self.stats["host_syncs"] += 1
        self._apply_harvest(h, handoff_lanes, lanes)
        self._finish_done_slots()

    def _apply_harvest(self, h: np.ndarray, handoff_lanes, lanes):
        for si, uid in handoff_lanes:
            s = self.slots[si]
            if s.uid != uid or not s.decoding:
                continue
            tok = int(h[si, 0])
            if tok == decoder.POISON:
                self._release_slot(si, FAILED)
            else:
                s.generated.append(tok)
        for si, uid, nb, pos0 in lanes:
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

    def _finish_done_slots(self):
        for si, s in enumerate(self.slots):
            if s.decoding and (s.budget <= 0 or s.pos >= self.max_len - 1):
                self._done[s.uid] = s.generated
                self._terminal(s.uid, FINISHED)
                self._carry_ok[si] = False
                self.slots[si] = SlotState()
