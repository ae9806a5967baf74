"""Serving telemetry plane of the port (``repro.serve.telemetry``, the
same schema and metric names): metrics registry, per-request tracing,
Chrome-trace export, and A^3 approximation-quality probe aggregation.

Three pillars, all host-side and allocation-free on the hot path:

* ``MetricsRegistry`` — named counters, gauges, and fixed-bucket
  histograms.  Histograms use log-spaced nanosecond buckets whose
  bounds are precomputed at construction; ``observe`` is a single
  binary search into a preallocated int64 bucket array.  The engine's
  ``stats`` dict is exported through a view at exposition time, so the
  dict itself stays a plain dict (checkpointing and the PrefixCache
  shared-reference contract are untouched).

* ``Tracer`` — a ring buffer (``deque(maxlen=...)``) of structured
  span/instant events keyed by request uid and slot, exportable as
  Chrome-trace JSON (``chrome://tracing`` / Perfetto).  Decode-block
  spans run dispatch->harvest, so a deferred-harvest pipeline stall is
  a visible gap on the slot's timeline rather than a bare counter.

* A^3 probe aggregation — the engine hands over per-dispatch probe
  rows (samples, candidate-count sum, captured-score-mass sum) that
  were computed on the device in the decode block and copied to the
  host behind the same event as the token ring; this module only
  accumulates and exposes them.

Plain Python + numpy: a metrics JSON of this engine and one of the
reference engine diff cleanly (``SCHEMA``, names, bucket bounds).
"""
from __future__ import annotations

import bisect
import collections
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# Log-spaced latency buckets: powers of two from 1us to ~1100s.  30
# buckets + overflow covers everything from a sub-tick host op to a
# stalled multi-minute drain without per-histogram tuning.
_NS_BUCKET_BOUNDS: Tuple[int, ...] = tuple(1 << s for s in range(10, 41))

# Dimensionless buckets for count-like histograms (candidate counts,
# token counts): powers of two from 1 to 2^20.
_COUNT_BUCKET_BOUNDS: Tuple[int, ...] = tuple(1 << s for s in range(0, 21))

# Unit-interval buckets for ratio histograms (captured score mass):
# dense near 1.0 where a healthy A^3 config lives.
_RATIO_BUCKET_BOUNDS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 0.75, 0.9, 0.95, 0.99, 0.999, 1.0)

SCHEMA = "a3-serve-metrics/v1"


class Counter:
    """Monotone counter. ``inc`` is one float add."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-write-wins gauge."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with zero-allocation recording.

    ``bounds`` are upper-inclusive bucket edges; one extra overflow
    bucket catches values above the last edge.  ``observe`` does a
    binary search over the precomputed edge list and a single int64
    increment into a preallocated numpy array — no allocation, no
    resizing, on the hot path.
    """

    __slots__ = ("name", "help", "bounds", "counts", "total", "sum")

    def __init__(self, name: str, bounds: Tuple[float, ...], help: str = "") \
            -> None:
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = np.zeros(len(self.bounds) + 1, dtype=np.int64)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.total += 1
        self.sum += v

    # -- exposition / checkpoint -------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {"bounds": list(self.bounds),
                "counts": [int(c) for c in self.counts],
                "total": int(self.total), "sum": float(self.sum)}

    def load(self, snap: Dict[str, Any]) -> None:
        if list(snap.get("bounds", [])) != list(self.bounds):
            return  # bucket layout changed across versions: start fresh
        self.counts[:] = np.asarray(snap["counts"], dtype=np.int64)
        self.total = int(snap["total"])
        self.sum = float(snap["sum"])

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper edge of the q-bucket)."""
        if self.total == 0:
            return 0.0
        target = q * self.total
        run = 0
        for i, c in enumerate(self.counts):
            run += int(c)
            if run >= target:
                return self.bounds[i] if i < len(self.bounds) \
                    else float("inf")
        return float("inf")


class MetricsRegistry:
    """Named instruments plus a compatibility view over legacy stats.

    ``attach_stats`` registers a live reference to the engine's plain
    ``stats`` dict; exposition renders each entry as a counter named
    ``serve_<key>``.  The dict is read, never copied, at exposition
    time — the hot path never touches the registry for those.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._stats_views: List[Tuple[str, Dict[str, int]]] = []

    # -- instrument construction (idempotent by name) ----------------
    def counter(self, name: str, help: str = "") -> Counter:
        if name not in self._counters:
            self._counters[name] = Counter(name, help)
        return self._counters[name]

    def gauge(self, name: str, help: str = "") -> Gauge:
        if name not in self._gauges:
            self._gauges[name] = Gauge(name, help)
        return self._gauges[name]

    def histogram(self, name: str,
                  bounds: Tuple[float, ...] = _NS_BUCKET_BOUNDS,
                  help: str = "") -> Histogram:
        if name not in self._histograms:
            self._histograms[name] = Histogram(name, bounds, help)
        return self._histograms[name]

    def attach_stats(self, prefix: str, stats: Dict[str, int]) -> None:
        self._stats_views.append((prefix, stats))

    # -- exposition --------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "schema": SCHEMA,
            "counters": {n: c.value for n, c in sorted(
                self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.snapshot() for n, h in sorted(
                self._histograms.items())},
        }
        for prefix, stats in self._stats_views:
            for k in sorted(stats):
                out["counters"][f"{prefix}{k}"] = float(stats[k])
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (untyped stats render as counters)."""
        lines: List[str] = []
        snap = self.snapshot()
        for name, v in snap["counters"].items():
            base, labels = _split_labels(name)
            lines.append(f"# TYPE {base} counter")
            lines.append(f"{base}{labels} {_fmt(v)}")
        for name, v in snap["gauges"].items():
            base, labels = _split_labels(name)
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base}{labels} {_fmt(v)}")
        for name, h in snap["histograms"].items():
            base, labels = _split_labels(name)
            lines.append(f"# TYPE {base} histogram")
            run = 0
            for bound, c in zip(h["bounds"], h["counts"]):
                run += c
                le = _merge_labels(labels, f'le="{_fmt(bound)}"')
                lines.append(f"{base}_bucket{le} {run}")
            le = _merge_labels(labels, 'le="+Inf"')
            lines.append(f"{base}_bucket{le} {h['total']}")
            lines.append(f"{base}_sum{labels} {_fmt(h['sum'])}")
            lines.append(f"{base}_count{labels} {h['total']}")
        return "\n".join(lines) + "\n"

    # -- checkpoint --------------------------------------------------
    def dump_state(self) -> Dict[str, Any]:
        return {"counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()},
                "histograms": {n: h.snapshot()
                               for n, h in self._histograms.items()}}

    def load_state(self, state: Dict[str, Any]) -> None:
        for n, v in state.get("counters", {}).items():
            self.counter(n).value = float(v)
        for n, v in state.get("gauges", {}).items():
            self.gauge(n).value = float(v)
        for n, snap in state.get("histograms", {}).items():
            bounds = tuple(snap.get("bounds", _NS_BUCKET_BOUNDS))
            self.histogram(n, bounds).load(snap)


def _split_labels(name: str) -> Tuple[str, str]:
    """``ttft_ns{terminal=finished}`` -> (``ttft_ns``,
    ``{terminal="finished"}``) — label values are quoted on the way
    out so registry keys stay terse but the exposition is valid
    Prometheus text format."""
    if "{" not in name:
        return name, ""
    base, rest = name.split("{", 1)
    pairs = []
    for part in rest.rstrip("}").split(","):
        k, _, v = part.partition("=")
        v = v.strip()
        if not v.startswith('"'):
            v = f'"{v}"'
        pairs.append(f"{k.strip()}={v}")
    return base, "{" + ",".join(pairs) + "}"


def _merge_labels(labels: str, extra: str) -> str:
    if not labels:
        return "{" + extra + "}"
    return labels[:-1] + "," + extra + "}"


def _fmt(v: float) -> str:
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


# ---------------------------------------------------------------------------
# Tracing


class Tracer:
    """Ring-buffered structured event log with Chrome-trace export.

    Events are tuples ``(ts_ns, kind, name, uid, track, dur_ns, args)``
    where ``kind`` is ``"X"`` (complete span) or ``"i"`` (instant) in
    Chrome-trace phase terms, and ``track`` maps to a ``tid`` in the
    export (slot index, or a named lane like ``"queue"``/``"engine"``).
    Appending to a bounded deque is O(1) and drops the oldest event —
    the log is a flight recorder, not an archive.
    """

    def __init__(self, max_events: int = 4096) -> None:
        self.events: collections.deque = collections.deque(
            maxlen=max(1, int(max_events)))
        self.dropped = 0
        self._t0_ns = time.monotonic_ns()

    def now_ns(self) -> int:
        return time.monotonic_ns()

    def span(self, name: str, *, ts_ns: int, dur_ns: int,
             uid: int = -1, track: Any = "engine",
             args: Optional[Dict[str, Any]] = None) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append((ts_ns, "X", name, uid, track, max(0, dur_ns),
                            args))

    def instant(self, name: str, *, uid: int = -1, track: Any = "engine",
                ts_ns: Optional[int] = None,
                args: Optional[Dict[str, Any]] = None) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append((ts_ns if ts_ns is not None
                            else time.monotonic_ns(),
                            "i", name, uid, track, 0, args))

    # -- export ------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """chrome://tracing JSON object (``ts``/``dur`` in microseconds)."""
        t0 = self._t0_ns
        out: List[Dict[str, Any]] = []
        for ts, ph, name, uid, track, dur, args in self.events:
            ev: Dict[str, Any] = {
                "name": name, "ph": ph, "pid": 0,
                "tid": track if isinstance(track, int) else str(track),
                "ts": (ts - t0) / 1e3,
            }
            if ph == "X":
                ev["dur"] = dur / 1e3
            if ph == "i":
                ev["s"] = "t"
            a = dict(args) if args else {}
            if uid >= 0:
                a["uid"] = uid
            if a:
                ev["args"] = a
            out.append(ev)
        return {"traceEvents": out,
                "displayTimeUnit": "ms",
                "otherData": {"schema": "a3-serve-trace/v1",
                              "dropped_events": self.dropped}}


# ---------------------------------------------------------------------------
# Per-request lifecycle tracking


class _ReqTrack:
    __slots__ = ("submit_ns", "admit_ns", "first_tok_ns", "slot",
                 "decode_steps")

    def __init__(self, submit_ns: int) -> None:
        self.submit_ns = submit_ns
        self.admit_ns = -1
        self.first_tok_ns = -1
        self.slot = -1
        self.decode_steps = 0


class Telemetry:
    """Bundle the engine owns when telemetry is enabled.

    One instance per engine; every hook is a plain method call so the
    engine's guard is a single ``is not None`` check and the off-path
    stays byte-for-byte the pre-telemetry code.
    """

    def __init__(self, *, trace_events: int = 4096,
                 telemetry_every: int = 8) -> None:
        self.registry = MetricsRegistry()
        self.tracer = Tracer(trace_events)
        self.telemetry_every = max(1, int(telemetry_every))
        r = self.registry
        self._h_ttft: Dict[str, Histogram] = {}
        self._h_sojourn: Dict[str, Histogram] = {}
        self.h_tpot = r.histogram(
            "serve_tpot_ns",
            help="per-token decode latency (finished requests; "
                 "decode wall time / decoded tokens)")
        self.h_decode_block = r.histogram(
            "serve_decode_block_ns",
            help="decode-block dispatch->harvest wall time")
        self.h_prefill_chunk = r.histogram(
            "serve_prefill_chunk_ns",
            help="prefill chunk dispatch wall time")
        self.h_a3_cand = r.histogram(
            "serve_a3_candidates", _COUNT_BUCKET_BOUNDS,
            help="A^3 mean candidate count per probed decode step")
        self.h_a3_mass = r.histogram(
            "serve_a3_captured_mass", _RATIO_BUCKET_BOUNDS,
            help="A^3 captured score mass: selected softmax mass / "
                 "full softmax mass, per probed decode step")
        self.c_probe_dispatches = r.counter(
            "serve_a3_probe_dispatches",
            help="decode dispatches that carried the in-graph probe")
        self.c_probe_samples = r.counter(
            "serve_a3_probe_samples",
            help="probed (slot, step) samples harvested")
        self.c_trace_dropped = r.counter(
            "serve_trace_events_dropped",
            help="ring-buffer evictions in the trace log")
        self._reqs: Dict[int, _ReqTrack] = {}

    # -- lazy labeled histograms -------------------------------------
    def _ttft(self, terminal: str) -> Histogram:
        h = self._h_ttft.get(terminal)
        if h is None:
            h = self.registry.histogram(
                "serve_ttft_ns{terminal=%s}" % terminal,
                help="submit -> first emitted token")
            self._h_ttft[terminal] = h
        return h

    def _sojourn(self, terminal: str) -> Histogram:
        h = self._h_sojourn.get(terminal)
        if h is None:
            h = self.registry.histogram(
                "serve_queue_sojourn_ns{terminal=%s}" % terminal,
                help="submit -> slot admission")
            self._h_sojourn[terminal] = h
        return h

    # -- request lifecycle hooks -------------------------------------
    def on_submit(self, uid: int) -> None:
        now = self.tracer.now_ns()
        self._reqs[uid] = _ReqTrack(now)
        self.tracer.instant("submit", uid=uid, track="queue", ts_ns=now)

    def on_admit(self, uid: int, slot: int, *, reused_tokens: int = 0) \
            -> None:
        t = self._reqs.get(uid)
        now = self.tracer.now_ns()
        if t is not None:
            t.admit_ns = now
            t.slot = slot
            self.tracer.span("queued", ts_ns=t.submit_ns,
                             dur_ns=now - t.submit_ns, uid=uid,
                             track="queue")
        args = {"slot": slot}
        if reused_tokens:
            args["prefix_tokens_reused"] = reused_tokens
        self.tracer.instant("admit", uid=uid, track=slot, args=args)

    def on_prefill_chunk(self, uid: int, slot: int, *, ts_ns: int,
                         dur_ns: int, pos: int, chunk: int) -> None:
        self.h_prefill_chunk.observe(dur_ns)
        self.tracer.span("prefill", ts_ns=ts_ns, dur_ns=dur_ns, uid=uid,
                         track=slot, args={"pos": pos, "chunk": chunk})

    def on_first_token(self, uid: int) -> None:
        t = self._reqs.get(uid)
        if t is not None and t.first_tok_ns < 0:
            t.first_tok_ns = self.tracer.now_ns()
            self.tracer.instant("first_token", uid=uid,
                                track=t.slot if t.slot >= 0 else "engine")

    def on_decode_steps(self, uid: int, steps: int) -> None:
        t = self._reqs.get(uid)
        if t is not None:
            t.decode_steps += steps

    def on_decode_block(self, slot_uids: List[Tuple[int, int]], *,
                        ts_ns: int, dur_ns: int, steps: int,
                        deferred: bool) -> None:
        self.h_decode_block.observe(dur_ns)
        for slot, uid in slot_uids:
            self.tracer.span("decode_block", ts_ns=ts_ns, dur_ns=dur_ns,
                             uid=uid, track=slot,
                             args={"steps": steps,
                                   "deferred": bool(deferred)})

    def on_terminal(self, uid: int, terminal: str) -> None:
        t = self._reqs.pop(uid, None)
        now = self.tracer.now_ns()
        if t is None:
            return
        if t.admit_ns >= 0:
            self._sojourn(terminal).observe(t.admit_ns - t.submit_ns)
        if t.first_tok_ns >= 0:
            self._ttft(terminal).observe(t.first_tok_ns - t.submit_ns)
            if terminal == "finished" and t.decode_steps > 0:
                self.h_tpot.observe(
                    (now - t.first_tok_ns) / t.decode_steps)
        self.tracer.instant("terminal", uid=uid,
                            track=t.slot if t.slot >= 0 else "queue",
                            args={"state": terminal})

    # -- subsystem events --------------------------------------------
    def event(self, name: str, *, uid: int = -1, track: Any = "engine",
              **args: Any) -> None:
        self.tracer.instant(name, uid=uid, track=track,
                            args=args or None)

    def span(self, name: str, *, ts_ns: int, dur_ns: int, uid: int = -1,
             track: Any = "engine", **args: Any) -> None:
        self.tracer.span(name, ts_ns=ts_ns, dur_ns=dur_ns, uid=uid,
                         track=track, args=args or None)

    # -- A^3 probe ----------------------------------------------------
    def on_a3_probe(self, probe: np.ndarray) -> None:
        """``probe`` is ``[B, 3]`` float32: per-lane (samples,
        sum(candidates), sum(captured-mass ratio)) accumulated over the
        dispatched block's advanced steps."""
        self.c_probe_dispatches.inc()
        samples = probe[:, 0]
        live = samples > 0
        n = float(samples[live].sum())
        if n <= 0:
            return
        self.c_probe_samples.inc(n)
        for cand, mass in zip(probe[live, 1] / samples[live],
                              probe[live, 2] / samples[live]):
            self.h_a3_cand.observe(float(cand))
            self.h_a3_mass.observe(float(mass))

    # -- exposition / checkpoint -------------------------------------
    def metrics_snapshot(self) -> Dict[str, Any]:
        self.c_trace_dropped.value = float(self.tracer.dropped)
        return self.registry.snapshot()

    def dump_state(self) -> Dict[str, Any]:
        self.c_trace_dropped.value = float(self.tracer.dropped)
        return {"registry": self.registry.dump_state()}

    def load_state(self, state: Dict[str, Any]) -> None:
        self.registry.load_state(state.get("registry", {}))
        # Re-resolve labeled handles that load_state may have created.
        for name, h in self.registry._histograms.items():
            if name.startswith("serve_ttft_ns{terminal="):
                self._h_ttft[name.split("=")[1].rstrip("}")] = h
            elif name.startswith("serve_queue_sojourn_ns{terminal="):
                self._h_sojourn[name.split("=")[1].rstrip("}")] = h

    def write_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.tracer.chrome_trace(), f)

    def write_metrics(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.metrics_snapshot(), f, indent=2, sort_keys=True)
