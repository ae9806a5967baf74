"""The port's serving telemetry plane: the cases of
``tests/test_serve_telemetry.py`` on the port's engine, and the port held
against the JAX engine with telemetry on (the same weights converted
through numpy, the same prompts, float32).

Coverage: the registry, histogram and tracer units (and the port's
module against the reference's on the same calls); telemetry off
bit-identical to on (tokens and every clock-free stat, ``host_syncs``
included) for each mixer kind at ``pipeline_depth`` 0 and 1; TTFT and
decode-step reconciliation; terminal-keyed histograms; probe dispatches
at every 1 and 3; no probe without A^3; the trace's JSON round trip and
per-slot monotone timelines; the bounded trace ring; the checkpoint round
trip with and without telemetry; ``from_config``; parity with the JAX
engine on TINY (A^3 conservative), TINY_RG and TINY_XL: equal tokens,
counters, histogram counts (every bucket of the count and ratio
histograms, the totals of the clock ones), trace events in order per
request, and probe rows within 2e-5; ``a3_decode_attention_compact(
return_probe=True)`` against the JAX op on fp and int8 sorted keys.
Histograms of nanoseconds are never compared by value.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import A3Config  # noqa: E402
from repro.core import candidate_selection as jcs  # noqa: E402
from repro.core.quantization import quantize_int8_block as jquant  # noqa: E402,E501
from repro.kernels.decode_attention import ops as jops  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serve import telemetry as jtel  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.config import ServeConfig  # noqa: E402
from repro_torch.core import candidate_selection as tcs  # noqa: E402
from repro_torch.core.quantization import quantize_int8_block  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tops  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import telemetry as ttel  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

from test_torch_helpers import ENGINE_STATS, F32_TOL, T, TINY, TINY_RG, \
    TINY_XL, jax_blocks_ready, port_a3, port_cfg  # noqa: E402

torch.set_num_threads(1)

MAX_LEN = 96
MAX_NEW = 6
PROMPT_LENS = (5, 12, 23, 9)
CONFIGS = {"tiny": (TINY, 0), "tiny-rg": (TINY_RG, 1),
           "tiny-xl": (TINY_XL, 2)}
KINDS = {"attention": ("tiny", "off"), "a3": ("tiny", "conservative"),
         "rglru": ("tiny-rg", "off"), "xlstm": ("tiny-xl", "off")}
# the stats that time real work: they differ between any two runs
WALL_STATS = ("tick_ns_prefill", "tick_ns_decode", "tick_ns_harvest",
              "tick_ns_host", "host_sync_stalls")
NS_HISTOGRAMS = ("serve_ttft_ns", "serve_queue_sojourn_ns", "serve_tpot_ns",
                 "serve_decode_block_ns", "serve_prefill_chunk_ns")


@functools.lru_cache(maxsize=None)
def _models(name):
    cfg, seed = CONFIGS[name]
    params = jdec.init_params(jax.random.PRNGKey(seed), cfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(cfg), device="cpu")
    return cfg, params, model


def _a3(mode):
    return A3Config() if mode == "off" else A3Config.conservative()


def _prompts(vocab, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n) for n in PROMPT_LENS]


def _det_stats(eng):
    return {k: v for k, v in eng.stats.items() if k not in WALL_STATS}


def _port(name="tiny", a3="off", **kw):
    cfg, _, model = _models(name)
    knobs = dict(slots=2, max_len=MAX_LEN, prefill_chunk=8, decode_block=2)
    return ServeEngine(model, port_cfg(cfg), a3=port_a3(_a3(a3)),
                       **(knobs | kw))


def _run(name="tiny", a3="off", prompts=None, max_new=MAX_NEW, **kw):
    eng = _port(name, a3, **kw)
    prompts = prompts or _prompts(_models(name)[0].vocab_size)
    uids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_to_completion()
    return [eng.result(u) for u in uids], eng


# ---------------------------------------------------------------------------
# registry / histogram / tracer units (no device work)
# ---------------------------------------------------------------------------

def test_histogram_buckets_total_sum_quantile():
    h = ttel.Histogram("h", (10.0, 100.0, 1000.0))
    for v in (1, 10, 11, 100, 5000):
        h.observe(v)
    assert list(h.counts) == [2, 2, 0, 1]
    assert h.total == 5 and h.sum == 5122.0
    assert h.quantile(0.5) == 100.0
    assert h.quantile(1.0) == float("inf")
    assert ttel.Histogram("e", (1.0,)).quantile(0.99) == 0.0


def test_histogram_snapshot_load_roundtrip():
    h = ttel.Histogram("h", ttel._COUNT_BUCKET_BOUNDS)
    for v in (1, 7, 300, 10 ** 9):
        h.observe(v)
    snap = json.loads(json.dumps(h.snapshot()))
    h2 = ttel.Histogram("h", ttel._COUNT_BUCKET_BOUNDS)
    h2.load(snap)
    assert h2.snapshot() == h.snapshot()
    h3 = ttel.Histogram("h", (1.0, 2.0))
    h3.load(snap)                       # other bounds: refused
    assert h3.total == 0


def test_registry_idempotent_handles_and_stats_view():
    r = ttel.MetricsRegistry()
    c = r.counter("reqs")
    assert r.counter("reqs") is c
    c.inc()
    c.inc(2.5)
    stats = {"ticks": 3}
    r.attach_stats("serve_", stats)
    stats["ticks"] = 7                  # a live reference, not a copy
    snap = r.snapshot()
    assert snap["counters"]["reqs"] == 3.5
    assert snap["counters"]["serve_ticks"] == 7.0
    assert snap["schema"] == "a3-serve-metrics/v1"


def test_prometheus_exposition_format():
    r = ttel.MetricsRegistry()
    r.counter("reqs").inc(2)
    r.gauge("depth").set(1.5)
    h = r.histogram("lat_ns{terminal=finished}", (10.0, 100.0))
    for v in (5, 50, 5000):
        h.observe(v)
    lines = r.to_prometheus().splitlines()
    assert "# TYPE reqs counter" in lines and "reqs 2" in lines
    assert "depth 1.5" in lines
    assert 'lat_ns_bucket{terminal="finished",le="10"} 1' in lines
    assert 'lat_ns_bucket{terminal="finished",le="100"} 2' in lines
    assert 'lat_ns_bucket{terminal="finished",le="+Inf"} 3' in lines
    assert 'lat_ns_count{terminal="finished"} 3' in lines


def test_tracer_ring_drops_oldest_and_counts():
    tr = ttel.Tracer(max_events=4)
    for i in range(7):
        tr.instant(f"e{i}", ts_ns=i)
    assert tr.dropped == 3
    ct = tr.chrome_trace()
    assert [e["name"] for e in ct["traceEvents"]] == ["e3", "e4", "e5", "e6"]
    assert ct["otherData"]["dropped_events"] == 3
    json.dumps(ct)


def test_module_matches_reference_module():
    """The same calls on the port's module and the reference's: equal
    schema and bucket bounds, equal snapshots (histograms of clock
    values by their totals) and the same trace events in order."""
    assert ttel.SCHEMA == jtel.SCHEMA
    for name in ("_NS_BUCKET_BOUNDS", "_COUNT_BUCKET_BOUNDS",
                 "_RATIO_BUCKET_BOUNDS"):
        assert getattr(ttel, name) == getattr(jtel, name), name
    out = []
    for mod in (ttel, jtel):
        tm = mod.Telemetry(trace_events=8, telemetry_every=2)
        stats = {"ticks": 5, "host_syncs": 2}
        tm.registry.attach_stats("serve_", stats)
        tm.on_submit(0)
        tm.on_admit(0, 1, reused_tokens=16)
        tm.on_prefill_chunk(0, 1, ts_ns=10, dur_ns=5, pos=0, chunk=8)
        tm.on_first_token(0)
        tm.on_decode_block([(1, 0)], ts_ns=20, dur_ns=7, steps=2,
                           deferred=True)
        tm.on_a3_probe(np.array([[2, 128, 1.9], [0, 0, 0]], np.float32))
        tm.on_decode_steps(0, 2)
        tm.event("chaos_abort", tick=3)
        tm.on_terminal(0, "finished")
        snap = tm.metrics_snapshot()
        for h in snap["histograms"]:
            if h.startswith(NS_HISTOGRAMS):     # clock values
                snap["histograms"][h] = snap["histograms"][h]["total"]
        ct = tm.tracer.chrome_trace()
        out.append((snap, [(e["name"], e["ph"], e["tid"], e.get("args"))
                           for e in ct["traceEvents"]],
                    ct["otherData"]))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# the pure-observer contract: telemetry on == off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("kind", list(KINDS))
def test_telemetry_off_bit_identity(kind, depth):
    name, a3 = KINDS[kind]
    toks_off, off = _run(name, a3, pipeline_depth=depth)
    toks_on, on = _run(name, a3, pipeline_depth=depth, telemetry=True,
                       telemetry_every=2)
    assert toks_on == toks_off
    assert _det_stats(on) == _det_stats(off)
    # no blocking read added, and no stall on the CPU either way
    assert on.stats["host_syncs"] == off.stats["host_syncs"]
    assert on.stats["host_sync_stalls"] == off.stats["host_sync_stalls"]
    assert on.tm is not None and off.tm is None
    assert on._probe == (kind == "a3")


def test_telemetry_off_is_default_and_hookless():
    eng = ServeEngine(_models("tiny")[2], port_cfg(TINY), slots=1,
                      max_len=MAX_LEN)
    assert eng.tm is None and not eng._probe
    with pytest.raises(ValueError, match="telemetry_every"):
        _port(telemetry=True, telemetry_every=0)
    with pytest.raises(ValueError, match="trace_events"):
        _port(telemetry=True, trace_events=0)


def test_from_config_honours_telemetry():
    cfg, _, model = _models("tiny")
    eng = ServeEngine.from_config(
        model, port_cfg(cfg), ServeConfig(slots=2, max_len=MAX_LEN,
                                          telemetry=True, telemetry_every=3,
                                          trace_events=64),
        a3=port_a3(A3Config.conservative()))
    assert eng.tm is not None and eng._probe
    assert eng.tm.telemetry_every == 3 and eng.tm.tracer.events.maxlen == 64
    eng = ServeEngine.from_config(model, port_cfg(cfg),
                                  ServeConfig(slots=2, max_len=MAX_LEN))
    assert eng.tm is None


# ---------------------------------------------------------------------------
# reconciliation: reported metrics against the engine's counters
# ---------------------------------------------------------------------------

def test_ttft_and_decode_step_reconciliation():
    # one slot: per-request decode steps sum to decode_steps_advanced
    eng = _port(slots=1, decode_block=3, telemetry=True)
    attributed = {}
    orig = eng.tm.on_decode_steps

    def record(uid, steps):
        attributed[uid] = attributed.get(uid, 0) + steps
        orig(uid, steps)

    eng.tm.on_decode_steps = record
    prompts = _prompts(TINY.vocab_size)
    uids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run_to_completion()
    assert all(eng.status(u) == "finished" for u in uids)
    assert sum(attributed.values()) == eng.stats["decode_steps_advanced"]
    h = eng.tm.metrics_snapshot()["histograms"]
    assert h["serve_ttft_ns{terminal=finished}"]["total"] \
        == eng.stats["finished"] == len(prompts)
    assert h["serve_tpot_ns"]["total"] == len(prompts)
    assert h["serve_queue_sojourn_ns{terminal=finished}"]["total"] \
        == len(prompts)
    assert not eng.tm._reqs             # the tracking map drains


def test_terminal_keyed_histograms_split_states():
    eng = _port(slots=1, telemetry=True)
    u1 = eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=2)
    u2 = eng.submit(np.arange(7, dtype=np.int32), max_new_tokens=2)
    eng.cancel(u2)
    eng.run_to_completion()
    assert eng.status(u1) == "finished" and eng.status(u2) == "cancelled"
    h = eng.tm.metrics_snapshot()["histograms"]
    assert h["serve_ttft_ns{terminal=finished}"]["total"] == 1
    assert "serve_ttft_ns{terminal=cancelled}" not in h
    assert "serve_queue_sojourn_ns{terminal=cancelled}" not in h


@pytest.mark.parametrize("every", [1, 3])
def test_a3_probe_dispatch_reconciliation(every):
    _, eng = _run("tiny", "conservative", telemetry=True,
                  telemetry_every=every)
    snap = eng.tm.metrics_snapshot()
    nd = eng.stats["decode_dispatches"]
    assert nd > 0
    assert snap["counters"]["serve_a3_probe_dispatches"] \
        == math.ceil(nd / every)
    samples = snap["counters"]["serve_a3_probe_samples"]
    assert 0 < samples <= len(eng.slots) * eng.stats["decode_steps"]
    if every == 1:
        assert samples >= eng.stats["decode_steps_advanced"]
    mass = snap["histograms"]["serve_a3_captured_mass"]
    cand = snap["histograms"]["serve_a3_candidates"]
    assert mass["total"] == cand["total"] > 0
    assert 0.0 < mass["sum"] / mass["total"] <= 1.0
    assert cand["sum"] / cand["total"] >= 1.0


def test_probe_absent_without_a3():
    _, eng = _run("tiny", "off", telemetry=True, telemetry_every=1)
    assert not eng._probe
    snap = eng.tm.metrics_snapshot()
    assert snap["counters"]["serve_a3_probe_dispatches"] == 0
    assert snap["histograms"]["serve_a3_captured_mass"]["total"] == 0


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def test_trace_export_roundtrip_and_slot_monotonicity(tmp_path):
    _, eng = _run("tiny", "conservative", telemetry=True, telemetry_every=2,
                  page_size=8, cache_pages=16)
    path = tmp_path / "trace.json"
    eng.tm.write_trace(str(path))
    tr = json.loads(path.read_text())
    assert tr["otherData"]["schema"] == "a3-serve-trace/v1"
    evs = tr["traceEvents"]
    names = {e["name"] for e in evs}
    for must in ("submit", "queued", "admit", "prefill", "first_token",
                 "decode_block", "terminal"):
        assert must in names, (must, sorted(names))
    by_slot = {}
    for e in evs:
        assert e["ts"] >= 0.0
        if isinstance(e["tid"], int):
            by_slot.setdefault(e["tid"], []).append(e["ts"])
    assert by_slot
    for tid, ts in by_slot.items():
        assert ts == sorted(ts), f"slot {tid} timeline not monotone"
    assert all("uid" in e["args"] for e in evs
               if e["name"] in ("submit", "terminal"))


def test_trace_ring_bounded_under_pressure():
    _, eng = _run("tiny", "off", prompts=_prompts(TINY.vocab_size) * 3,
                  telemetry=True, trace_events=16)
    assert len(eng.tm.tracer.events) == 16
    snap = eng.tm.metrics_snapshot()
    assert snap["counters"]["serve_trace_events_dropped"] > 0


# ---------------------------------------------------------------------------
# metrics through checkpoint / restore
# ---------------------------------------------------------------------------

def test_telemetry_checkpoint_roundtrip(tmp_path):
    eng = _port(a3="conservative", telemetry=True, telemetry_every=2)
    uids = [eng.submit(p, max_new_tokens=MAX_NEW)
            for p in _prompts(TINY.vocab_size)]
    for _ in range(6):                  # mid-flight state in the histograms
        eng.step()
    eng.checkpoint(str(tmp_path))
    before = eng.tm.metrics_snapshot()["histograms"]
    assert any(h["total"] > 0 for h in before.values())
    cfg, _, model = _models("tiny")
    eng2 = ServeEngine.restore(str(tmp_path), model, port_cfg(cfg),
                               a3=port_a3(A3Config.conservative()))
    assert eng2.tm is not None and eng2._probe
    assert eng2.tm.metrics_snapshot()["histograms"] == before
    # requests in flight at the checkpoint get no TTFT (their clocks died
    # with the old engine); requests submitted after the restore do
    key = "serve_ttft_ns{terminal=finished}"
    ttft_before = before.get(key, {"total": 0})["total"]
    fresh = [eng2.submit(p, max_new_tokens=2)
             for p in _prompts(TINY.vocab_size, seed=11)[:2]]
    eng2.run_to_completion()
    final = eng2.tm.metrics_snapshot()["histograms"]
    assert final[key]["total"] == ttft_before + len(fresh)
    assert all(eng2.status(u) == "finished" for u in uids + fresh)
    names = [e[2] for e in eng2.tm.tracer.events]
    assert names[0] == "restore"


def test_old_checkpoint_without_telemetry_restores(tmp_path):
    eng = _port(slots=1)
    eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=3)
    eng.step()
    eng.checkpoint(str(tmp_path))
    state = json.loads((tmp_path / "state.json").read_bytes().split(
        b"\n", 1)[1])
    assert "telemetry" not in state
    # a checkpoint written before the engine had telemetry: no such keys
    for key in ("telemetry", "telemetry_every", "trace_events"):
        del state["engine"][key]
    payload = json.dumps(state, sort_keys=True).encode()
    import zlib
    (tmp_path / "state.json").write_bytes(b"%d\n" % zlib.crc32(payload)
                                          + payload)
    cfg, _, model = _models("tiny")
    eng2 = ServeEngine.restore(str(tmp_path), model, port_cfg(cfg))
    assert eng2.tm is None
    eng2.run_to_completion()
    assert eng2.stats["finished"] == 1


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------

def _recording(eng):
    """Keep a copy of every probe block the engine's telemetry takes."""
    rows = []
    orig = eng.tm.on_a3_probe

    def record(probe):
        rows.append(np.array(probe, np.float32))
        orig(probe)

    eng.tm.on_a3_probe = record
    return rows


def _trace_by_uid(tm):
    out = {}
    for _ts, _ph, name, uid, _track, _dur, _args in tm.tracer.events:
        out.setdefault(uid, []).append(name)
    return out


def _clock_free_metrics(snap):
    counters = {k: v for k, v in snap["counters"].items()
                if k[len("serve_"):] not in WALL_STATS}
    hists = {}
    for name, h in snap["histograms"].items():
        hists[name] = (h["total"] if name.startswith(NS_HISTOGRAMS)
                       else (h["bounds"], h["counts"], h["total"]))
    return counters, hists


@pytest.mark.parametrize("name,a3,pages", [
    ("tiny", "conservative", 0), ("tiny", "conservative", 6),
    ("tiny-rg", "off", 0), ("tiny-xl", "off", 0)])
def test_telemetry_matches_jax_engine(name, a3, pages):
    """Both engines with telemetry every 2 (with ``pages``, a 6-page
    prefix cache of 8-token pages and prompts sharing 16 tokens: the
    cache's hit, dedupe and eviction events join the trace): equal
    tokens, stats, clock-free metrics, the whole trace's event names in
    order, and probe rows within 2e-5."""
    cfg, params, model = _models(name)
    prompts = _prompts(cfg.vocab_size)
    knobs = dict(slots=2, max_len=MAX_LEN, prefill_chunk=8, decode_block=2,
                 telemetry=True, telemetry_every=2)
    if pages:
        head = prompts[2][:16]
        prompts = [np.concatenate([head, p]) for p in prompts]
        knobs.update(page_size=8, cache_pages=pages)
    ref = JaxEngine(params, cfg, a3=_a3(a3), **knobs)
    port = ServeEngine(model, port_cfg(cfg), a3=port_a3(_a3(a3)), **knobs)
    rows = {}
    for key, eng in (("jax", ref), ("port", port)):
        rows[key] = _recording(eng)
        uids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        # the JAX engine's readiness probe waits, as eager CPU torch has
        # computed every block: neither engine stalls (a stall is timing)
        with jax_blocks_ready():
            eng.run_to_completion()
        rows[key + "_out"] = [eng.result(u) for u in uids]
    assert rows["port_out"] == rows["jax_out"]
    for k in ENGINE_STATS:
        assert port.stats[k] == ref.stats[k], k
    assert _clock_free_metrics(port.tm.metrics_snapshot()) == \
        _clock_free_metrics(ref.tm.metrics_snapshot())
    assert _trace_by_uid(port.tm) == _trace_by_uid(ref.tm)
    names = [[e[2] for e in eng.tm.tracer.events] for eng in (port, ref)]
    assert names[0] == names[1]
    if pages:
        assert {"prefix_hit", "page_evict"} <= set(names[0])
    assert len(rows["port"]) == len(rows["jax"])
    assert (len(rows["port"]) > 0) == (name == "tiny")
    for got, want in zip(rows["port"], rows["jax"]):
        np.testing.assert_allclose(got, want, **F32_TOL)


# ---------------------------------------------------------------------------
# the compact op's probe
# ---------------------------------------------------------------------------

# jitted: one compile instead of the eager per-op dispatch
_jsort = jax.jit(jax.vmap(jax.vmap(jax.vmap(jcs.sort_key_columns))))
_jcompact = jax.jit(jops.a3_decode_attention_compact,
                    static_argnames=("cfg", "return_probe"))


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("quant", ["fp", "int8"])
def test_compact_probe_matches_jax(quant, shards):
    """``return_probe=True`` on both compact ops, fp and int8 sorted
    columns (int8 K/V with per-row scales): the output equals the
    probe-less call's, and the probe (mean candidates, captured mass in
    [0, 1]) is within 2e-5 of the JAX op's."""
    rng = np.random.default_rng(5 + shards)
    b, hq, hkv, d, s = 2, 4, 2, 16, 128
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    valid = np.ones((b, s), bool)
    valid[0, 100:] = False
    fresh = np.zeros((b, s), bool)
    fresh[:, 90:96] = True
    cfg = dataclasses.replace(A3Config.conservative(), select_shards=shards)
    sl = s // shards
    jsk = _jsort(jnp.asarray(k).reshape(b, hkv, shards, sl, d))
    tsk = tcs.sort_key_columns(T(k).reshape(b, hkv, shards, sl, d))
    if quant == "int8":
        jqv, jsks = jquant(jsk.values, axes=(3,))
        jkq, jks = jquant(jnp.asarray(k), axes=(3,))
        jvq, jvs = jquant(jnp.asarray(v), axes=(3,))
        jargs = (jkq, jvq, jcs.SortedKeys(jqv.reshape(k.shape),
                                          jsk.rows.reshape(k.shape)))
        jkw = dict(sk_scale=jsks.reshape(b, hkv, shards, d),
                   k_scale=jks[..., 0], v_scale=jvs[..., 0])
        qv, sks = quantize_int8_block(tsk.values, axes=(3,))
        kq, ks = quantize_int8_block(T(k), axes=(3,))
        vq, vs = quantize_int8_block(T(v), axes=(3,))
        targs = (kq, vq, tcs.SortedKeys(qv.reshape(k.shape),
                                        tsk.rows.reshape(k.shape)))
        tkw = dict(sk_scale=sks.reshape(b, hkv, shards, d),
                   k_scale=ks[..., 0], v_scale=vs[..., 0])
    else:
        jargs = (jnp.asarray(k), jnp.asarray(v), jcs.SortedKeys(
            jsk.values.reshape(k.shape), jsk.rows.reshape(k.shape)))
        jkw = {}
        targs = (T(k), T(v), tcs.SortedKeys(tsk.values.reshape(k.shape),
                                            tsk.rows.reshape(k.shape)))
        tkw = {}
    _, want = _jcompact(
        jnp.asarray(q), jargs[0], jargs[1], jnp.asarray(valid), cfg=cfg,
        sorted_keys=jargs[2], fresh_mask=jnp.asarray(fresh),
        return_probe=True, **jkw)
    out, got = tops.a3_decode_attention_compact(
        T(q), targs[0], targs[1], T(valid), port_a3(cfg), targs[2],
        fresh_mask=T(fresh), return_probe=True, **tkw)
    plain = tops.a3_decode_attention_compact(
        T(q), targs[0], targs[1], T(valid), port_a3(cfg), targs[2],
        fresh_mask=T(fresh), **tkw)
    assert torch.equal(out, plain)
    assert tuple(got.shape) == (b, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert bool(((got[:, 1] >= 0) & (got[:, 1] <= 1)).all())
    assert bool((got[:, 0] >= 1).all())
