"""Deterministic chaos injection for the port's serving engine (PyTorch
port of ``repro.serve.chaos``).

A seeded injector the engine consults at fixed tick phases, so a chaos
run is exactly reproducible from ``(seed, rate)``: the tests replay the
same fault schedule against the same workload and assert fault
isolation (requests no fault touched are token for token those of a
chaos-free run). The schedule is numpy only and the reference's, so both
engines fire the same faults on the same ticks.

Injection sites, each decided per tick from a counter-based generator
keyed on ``(seed, tick, site)`` (no shared stream: adding or removing a
site never reshuffles the others):

* ``corrupt`` — NaN one DECODING lane's mixer state
  (:func:`corrupt_cache_lane`); its next logits go non-finite, the decode
  block emits ``decoder.POISON`` and the engine fails the request off
  the harvest it already reads.
* ``gather`` — fail a warm admission's page gather (:class:`ChaosError`
  before any copy, so the device cache is untouched and no trie ref
  leaks).
* ``raise`` / ``delay`` — abort or stall a tick at a phase boundary
  (``tick_start`` / ``pre_prefill`` / ``pre_advance``). A ``delay`` adds
  ``delay_ticks`` to a virtual stall counter the engine consumes at tick
  starts (:meth:`ChaosInjector.consume_delay`): no wall clock.
* ``spill`` — force-evict LRU prefix-cache pages at a tick start
  (:meth:`ChaosInjector.pick_spill`), demoting them to the L2 tier.
* ``restore_corrupt`` — flip a byte of an L2 blob just before its
  verified restore (the prefix cache's ``l2_fault_hook``): the checksum
  must catch it and the node degrades to cold prefill.
* ``crash`` — kill the engine at a phase boundary (:class:`EngineCrash`,
  not absorbed by ``run_to_completion``); recovery is
  ``ServeEngine.checkpoint`` / ``ServeEngine.restore``.

``max_injections`` caps the fault sites (corrupt + gather +
restore_corrupt), so a test can pin exactly N injections.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ChaosConfig", "ChaosError", "ChaosInjector", "EngineCrash",
           "corrupt_cache_lane"]


class ChaosError(RuntimeError):
    """A deliberately injected fault (stands in for a device error, a
    preempted host or a corrupted transfer mid-tick)."""


class EngineCrash(ChaosError):
    """An injected process death mid-tick. Unlike a plain ChaosError it
    propagates out of ``run_to_completion``: recovery means restoring a
    fresh engine from the last checkpoint."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Injection schedule knobs. ``rate`` is the per-site, per-tick
    firing probability; every decision is a pure function of
    ``(seed, tick, site)``."""
    seed: int = 0
    rate: float = 0.0
    # fault sites (terminal for the victim request)
    corrupt_logits: bool = True
    fail_gather: bool = True
    # durable-state fault site: corrupt an L2 blob before its restore
    # (not terminal: the node degrades to cold prefill)
    restore_corrupt: bool = False
    # disruption sites (abort or stall a tick; no request is a victim)
    raise_mid_tick: bool = True
    delay_mid_tick: bool = False
    # virtual ticks a fired delay stalls the engine for
    delay_ticks: int = 1
    # force-evict up to this many LRU prefix-cache pages when the spill
    # site fires (0 disables the site)
    spill_pages: int = 0
    # kill the engine at a phase boundary (EngineCrash)
    crash_mid_tick: bool = False
    # cap on corrupt + gather + restore_corrupt injections (None = none)
    max_injections: Optional[int] = None

    def __post_init__(self):
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.delay_ticks < 0:
            raise ValueError(f"delay_ticks must be >= 0, got "
                             f"{self.delay_ticks}")
        if self.spill_pages < 0:
            raise ValueError(f"spill_pages must be >= 0, got "
                             f"{self.spill_pages}")
        if self.max_injections is not None and self.max_injections < 0:
            raise ValueError(f"max_injections must be >= 0, got "
                             f"{self.max_injections}")


def corrupt_cache_lane(cache: Dict[str, Any], si: int) -> Dict[str, Any]:
    """In place: NaN every floating-point leaf of lane ``si`` across all
    segment states (every cache leaf is ``[L, B, ...]``, batch axis 1).
    Integer leaves (sorted rows, watermarks) are left intact: the fault
    model is corrupted values, and the poison detector keys on
    non-finite logits."""
    for sc in cache.values():
        for leaf in sc.values():
            if leaf.is_floating_point():
                leaf[:, si] = float("nan")
    return cache


class ChaosInjector:
    """Engine-facing injector. The engine calls :meth:`phase` at tick
    phase boundaries, :meth:`pick_corrupt_victim` before each decode
    dispatch and :meth:`gather_fail` on warm admissions. ``events``
    records every injection as ``(kind, tick, detail)``;
    :attr:`injected_uids` is the set of request uids a fault site made
    victims."""

    def __init__(self, config: ChaosConfig = ChaosConfig()):
        self.config = config
        self.events: List[Tuple[str, int, Any]] = []
        self._faults = 0
        self._delay_pending = 0

    # -- determinism core ----------------------------------------------------
    def _rng(self, tick: int, site: str) -> np.random.Generator:
        # counter-based: an independent generator per (seed, tick, site)
        key = [int(self.config.seed), int(tick)] + [ord(c) for c in site]
        return np.random.default_rng(key)

    def _fault_budget_left(self) -> bool:
        mi = self.config.max_injections
        return mi is None or self._faults < mi

    @property
    def injected_uids(self) -> set:
        """Uids made victims by a fault site (corrupt / gather_fail)."""
        return {d for k, _, d in self.events
                if k in ("corrupt", "gather_fail")}

    # -- engine hooks --------------------------------------------------------
    def phase(self, tick: int, name: str) -> None:
        """At a tick phase boundary: may accrue a virtual stall
        (``delay``), kill the engine (``crash``) or abort the tick
        (``raise``)."""
        c = self.config
        if c.delay_mid_tick \
                and self._rng(tick, "delay:" + name).random() < c.rate:
            self.events.append(("delay", tick, name))
            self._delay_pending += c.delay_ticks
        if c.crash_mid_tick \
                and self._rng(tick, "crash:" + name).random() < c.rate:
            self.events.append(("crash", tick, name))
            raise EngineCrash(f"injected engine crash at {name} "
                              f"(tick {tick})")
        if c.raise_mid_tick \
                and self._rng(tick, "raise:" + name).random() < c.rate:
            self.events.append(("raise", tick, name))
            raise ChaosError(f"injected tick abort at {name} "
                             f"(tick {tick})")

    def consume_delay(self) -> bool:
        """Tick-start hook of the virtual delay counter: True means this
        tick is a stall (the engine does no work and counts
        ``stats["chaos_delayed_ticks"]``)."""
        if self._delay_pending <= 0:
            return False
        self._delay_pending -= 1
        return True

    def pick_spill(self, tick: int) -> int:
        """How many prefix-cache pages to force-evict this tick."""
        c = self.config
        if c.spill_pages <= 0:
            return 0
        rng = self._rng(tick, "spill")
        if rng.random() >= c.rate:
            return 0
        n = int(rng.integers(1, c.spill_pages + 1))
        self.events.append(("spill", tick, n))
        return n

    def l2_restore_corrupt(self, tick: int, key: Sequence[int]) -> bool:
        """The prefix cache's ``l2_fault_hook``: called with the blob key
        before each L2 restore; True corrupts the blob first. Keyed on
        the key's contents, so promotions in one tick draw
        independently."""
        c = self.config
        if not c.restore_corrupt or not self._fault_budget_left():
            return False
        site = f"l2corrupt:{len(key)}:{sum(key) % 65536}"
        if self._rng(tick, site).random() >= c.rate:
            return False
        self._faults += 1
        self.events.append(("restore_corrupt", tick, tuple(key)))
        return True

    def pick_corrupt_victim(self, tick: int,
                            uids: Sequence[int]) -> Optional[int]:
        """Maybe pick one decoding request whose lane the engine should
        corrupt this tick -> its uid or None."""
        if not self.config.corrupt_logits or not uids \
                or not self._fault_budget_left():
            return None
        rng = self._rng(tick, "corrupt")
        if rng.random() >= self.config.rate:
            return None
        uid = int(sorted(uids)[int(rng.integers(len(uids)))])
        self._faults += 1
        self.events.append(("corrupt", tick, uid))
        return uid

    def gather_fail(self, tick: int, uid: int, matched: int) -> None:
        """Warm-admission hook (``matched`` > 0 reused tokens), called
        before the gather: raises :class:`ChaosError` to fail it."""
        if not self.config.fail_gather or not self._fault_budget_left():
            return
        if self._rng(tick, f"gather:{uid}").random() < self.config.rate:
            self._faults += 1
            self.events.append(("gather_fail", tick, uid))
            raise ChaosError(f"injected page-gather failure for uid "
                             f"{uid} ({matched} matched tokens, tick "
                             f"{tick})")
