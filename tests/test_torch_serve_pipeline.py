"""The port's pipelined harvest (``pipeline_depth > 0``) against the JAX
engine, after ``tests/test_serve_pipeline.py``: deferring the harvest
changes no token. On TINY (attention, A^3 conservative) and TINY_XL
(mLSTM/mLSTM/sLSTM), f32, greedy:

* depth 1 and 2 give the tokens of depth 0 and of the JAX engine, in
  both admission orders, and every wall-clock-free counter of the JAX
  engine at the same depth (its readiness probe made to wait, as eager
  CPU torch has always computed a block);
* depth 0 is the default engine, token and counter;
* the conservation identity closes after every tick with blocks in
  flight; cancel, deadline expiry and a lane poisoned by hand (NaN in its
  floating cache leaves, as the reference's chaos injector does) act on
  the delayed view exactly as on the JAX engine;
* A^3 with resort_every 2 and decode_block 4 re-sorts on the steps the
  JAX engine does at depth 0 (the plan runs off the dispatch-time
  watermark);
* host syncs fall at depth 1, the ``tick_ns_*`` timings are sane, and
  the pipeline hides ``virtual_device_latency_s``.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import A3Config  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serve.chaos import corrupt_cache_lane  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

from test_torch_helpers import TINY, TINY_XL, assert_same_stats, \
    check_conservation, drive, jax_blocks_ready, nan_lane_, port_a3, \
    port_cfg  # noqa: E402

torch.set_num_threads(1)

MAX_LEN = 96
MAX_NEW = 6
PROMPT_LENS = (5, 12, 23, 9)
KINDS = {"attention": (TINY, A3Config()),
         "a3": (TINY, A3Config.conservative()),
         "xlstm": (TINY_XL, A3Config())}


@pytest.fixture(scope="module")
def all_models():
    out = {}
    for cfg, seed in ((TINY, 0), (TINY_XL, 2)):
        params = jdec.init_params(jax.random.PRNGKey(seed), cfg)
        out[cfg.name] = (params, params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), port_cfg(cfg),
            device="cpu"))
    return out


@pytest.fixture(scope="module", autouse=True)
def ready_blocks():
    with jax_blocks_ready():
        yield


def _prompts(vocab, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n) for n in PROMPT_LENS]


def _engines(all_models, kind, **kw):
    cfg, a3 = KINDS[kind]
    params, model = all_models[cfg.name]
    kw = {"slots": 2, "max_len": MAX_LEN, "prefill_chunk": 8,
          "decode_block": 2, **kw}
    return (JaxEngine(params, cfg, a3=a3, **kw),
            ServeEngine(model, port_cfg(cfg), a3=port_a3(a3), **kw))


_JAX_DEPTH0 = {}


def _jax_depth0(all_models, kind, order):
    """The JAX engine's tokens at depth 0 (computed once per case)."""
    if (kind, order) not in _JAX_DEPTH0:
        ref, _ = _engines(all_models, kind)
        cfg = KINDS[kind][0]
        _JAX_DEPTH0[kind, order] = drive(ref, _prompts(cfg.vocab_size),
                                         order=order)[0]
    return _JAX_DEPTH0[kind, order]


# ---------------------------------------------------------------------------
# deferred harvest never changes tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("order", ["upfront", "staggered"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_pipeline_depth_parity_all_kinds(all_models, kind, order, depth):
    cfg = KINDS[kind][0]
    prompts = _prompts(cfg.vocab_size)
    want = _jax_depth0(all_models, kind, order)
    assert all(r is not None and len(r) == MAX_NEW for r in want.values())
    ref, port = _engines(all_models, kind, pipeline_depth=depth)
    got, _ = drive(port, prompts, order=order, on_tick=check_conservation)
    assert got == want
    assert drive(ref, prompts, order=order)[0] == want
    assert_same_stats(port, ref)
    _, port0 = _engines(all_models, kind)
    assert drive(port0, prompts, order=order)[0] == want
    assert port.stats["resorts"] == port0.stats["resorts"]
    assert port.stats["host_syncs"] <= port0.stats["host_syncs"]


def test_pipeline_depth_zero_pins_default_engine(all_models):
    _, model = all_models["tiny"]
    prompts = _prompts(TINY.vocab_size)
    default = ServeEngine(model, port_cfg(TINY), slots=2, max_len=MAX_LEN,
                          prefill_chunk=8, decode_block=2)
    d0 = ServeEngine(model, port_cfg(TINY), slots=2, max_len=MAX_LEN,
                     prefill_chunk=8, decode_block=2, pipeline_depth=0)
    assert drive(d0, prompts)[0] == drive(default, prompts)[0]
    strip = lambda st: {k: v for k, v in st.items()    # noqa: E731
                        if not k.startswith("tick_ns")
                        and k != "host_sync_stalls"}
    assert strip(d0.stats) == strip(default.stats)


def test_pipeline_rejects_negative_depth(all_models):
    _, model = all_models["tiny"]
    with pytest.raises(ValueError, match="pipeline_depth"):
        ServeEngine(model, port_cfg(TINY), slots=2, max_len=MAX_LEN,
                    pipeline_depth=-1)


@pytest.mark.parametrize("depth", [1, 2])
def test_pipeline_conservation_closes_every_tick(all_models, depth):
    _, port = _engines(all_models, "attention", pipeline_depth=depth)
    uids = [port.submit(p, max_new_tokens=MAX_NEW)
            for p in _prompts(TINY.vocab_size)]
    saw_pending = False
    while port.in_flight:
        port.step()
        saw_pending = saw_pending or len(port._pending) > 0
        check_conservation(port)
        assert all(s.pending >= 0 for s in port.slots)
    assert saw_pending, "depth >= 1 must actually defer harvests"
    assert all(port.status(u) == "finished" for u in uids)
    assert not port._pending


# ---------------------------------------------------------------------------
# the A^3 resort plan on the delayed view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("slots,resort_every", [(2, 2), (1, 3)])
def test_pipeline_a3_resort_plan_uses_dispatch_watermark(
        all_models, slots, resort_every, depth):
    """A re-sort cadence below decode_block 4 puts re-sorts inside each
    block. The host's harvest-time watermark lags by the blocks in
    flight; a plan drawn from it would mark the wrong steps and skip
    sorts the device needs (resort_every 3 on one slot: no other lane's
    due steps cover the gap, and the lag is no multiple of the
    cadence). Tokens and ``resorts`` equal the JAX engine
    at depth 0, and after every tick the device watermarks of every
    layer and lane equal those of the JAX engine at the same depth,
    whose re-sort runs in the graph with no plan."""
    prompts = _prompts(TINY.vocab_size)
    kw = dict(slots=slots, decode_block=4, resort_every=resort_every)
    ref0, _ = _engines(all_models, "a3", **kw)
    want, _ = drive(ref0, prompts, max_new=12)
    assert ref0.stats["resorts"] > 0
    ref, port = _engines(all_models, "a3", pipeline_depth=depth, **kw)
    uids = {eng: [eng.submit(p, max_new_tokens=12) for p in prompts]
            for eng in (ref, port)}
    stale = 0
    while port.in_flight or ref.in_flight:
        stale += any(s.decoding and s.sorted_upto != s.planned_upto
                     for s in port.slots)
        ref.step()
        port.step()
        np.testing.assert_array_equal(
            port.cache["seg0"]["sorted_upto"].numpy(),
            np.asarray(ref.cache["seg0"]["sorted_upto"]))
    assert stale, "the harvest mirror must lag the dispatches"
    assert [port.result(u) for u in uids[port]] == list(want.values())
    assert port.stats["resorts"] == ref0.stats["resorts"]
    assert_same_stats(port, ref)


# ---------------------------------------------------------------------------
# lifecycle edges on the delayed view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1])
def test_pipeline_cancel_acts_on_delayed_view(all_models, depth):
    """Cancel a DECODING request whose latest block may be in flight: the
    slot is free at once, the stale rows are dropped by the uid guard,
    the other streams are the synchronous engine's."""
    prompts = _prompts(TINY.vocab_size)
    want = _jax_depth0(all_models, "attention", "upfront")
    outs = []
    for eng in _engines(all_models, "attention", pipeline_depth=depth):
        uids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        while not any(s.uid == uids[0] and s.decoding for s in eng.slots):
            eng.step()
        assert eng.cancel(uids[0])
        eng.run_to_completion()
        assert eng.status(uids[0]) == "cancelled"
        assert eng.result(uids[0]) is None
        for i in (1, 2, 3):
            assert eng.status(uids[i]) == "finished"
            assert eng.result(uids[i]) == want[i], (depth, i)
        check_conservation(eng)
        outs.append(eng)
    assert_same_stats(outs[1], outs[0])


def test_pipeline_deadline_expiry_on_delayed_view(all_models):
    """Deadlines act on the optimistic view: the outcome is a function of
    the tick count (two depth-1 runs agree), requests that finish under
    both views carry the same tokens, and each engine equals the JAX
    engine at its depth."""
    prompts = _prompts(TINY.vocab_size)
    outcomes = {}
    for depth, tag in ((0, "d0"), (1, "d1a"), (1, "d1b")):
        ref, port = _engines(all_models, "attention", pipeline_depth=depth,
                             deadline_ticks=4)
        for eng in (ref, port):
            uids = [eng.submit(p, max_new_tokens=32) for p in prompts]
            eng.run_to_completion()
            statuses = [eng.status(u) for u in uids]
            assert set(statuses) <= {"finished", "expired"}, tag
            assert "expired" in statuses
            check_conservation(eng)
            outcomes[tag, eng is port] = (statuses,
                                          [eng.result(u) for u in uids])
        assert outcomes[tag, True] == outcomes[tag, False]
        assert_same_stats(port, ref)
    assert outcomes["d1a", True] == outcomes["d1b", True]
    (s0, r0), (s1, r1) = outcomes["d0", True], outcomes["d1a", True]
    for i in range(len(prompts)):
        if s0[i] == s1[i] == "finished":
            assert r0[i] == r1[i], i


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("kind", ["attention", "xlstm"])
def test_pipeline_poison_quarantine_on_delayed_harvest(all_models, kind,
                                                       depth):
    """NaN the cache lane of one decoding request between two ticks: the
    victim ends FAILED (the sentinel rides its delayed harvest), POISON
    reaches no result, every other stream is the clean run's, and the
    port equals the JAX engine poisoned the same way."""
    cfg = KINDS[kind][0]
    prompts = _prompts(cfg.vocab_size)
    want = _jax_depth0(all_models, kind, "upfront")
    ref, port = _engines(all_models, kind, pipeline_depth=depth)
    seen = {}
    for eng in (ref, port):
        uids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        eng.step()
        eng.step()
        victim = [(si, s.uid) for si, s in enumerate(eng.slots)
                  if s.decoding][0]
        if eng is ref:
            eng.cache = corrupt_cache_lane(eng.cache, victim[0])
        else:
            nan_lane_(eng.cache, victim[0])
        while eng.in_flight:
            eng.step()
            check_conservation(eng)
        for i, u in enumerate(uids):
            if u == victim[1]:
                assert eng.status(u) == "failed"
                assert eng.result(u) is None
            else:
                assert eng.status(u) == "finished"
                assert eng.result(u) == want[i]
                assert tdec.POISON not in eng.result(u)
        assert eng.stats["failed"] == 1
        seen[eng is port] = (victim, [eng.result(u) for u in uids])
    assert seen[True] == seen[False]
    assert_same_stats(port, ref)


# ---------------------------------------------------------------------------
# counters: syncs fall, timings are sane, emulated latency is hidden
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [1, 8])
def test_pipeline_host_syncs_strictly_lower(all_models, block):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, TINY.vocab_size, size=8) for _ in range(2)]
    runs = {}
    for depth in (0, 1):
        ref, port = _engines(all_models, "attention", pipeline_depth=depth,
                             decode_block=block)
        got, _ = drive(port, prompts, max_new=24)
        assert got == drive(ref, prompts, max_new=24)[0]
        assert_same_stats(port, ref)
        runs[depth] = (got, port.stats)
    assert runs[1][0] == runs[0][0]
    assert runs[1][1]["host_syncs"] < runs[0][1]["host_syncs"]
    assert 0 <= runs[1][1]["host_sync_stalls"] <= runs[1][1]["host_syncs"]


@pytest.mark.parametrize("depth", [0, 1])
def test_pipeline_timing_stats_sane(all_models, depth):
    _, port = _engines(all_models, "attention", pipeline_depth=depth)
    uids = [port.submit(p, max_new_tokens=MAX_NEW)
            for p in _prompts(TINY.vocab_size)]
    t0 = time.monotonic_ns()
    port.run_to_completion()
    wall = time.monotonic_ns() - t0
    keys = ["tick_ns_prefill", "tick_ns_decode", "tick_ns_harvest",
            "tick_ns_host"]
    assert all(port.stats[k] >= 0 for k in keys)
    assert sum(port.stats[k] for k in keys) <= wall
    assert port.stats["tick_ns_decode"] > 0
    assert port.stats["tick_ns_host"] > 0
    assert port.stats["tick_ns_prefill"] > 0
    assert all(port.status(u) == "finished" for u in uids)


def test_pipeline_hides_virtual_device_latency(all_models):
    """Each block readable only ``lat`` after its dispatch, and 3 ms of
    other host work between ticks: the synchronous engine waits out
    ``lat`` at every drain, a depth-2 pipeline spends that work on the
    blocks in flight and hardly waits. The wait is read as the drains'
    time (``tick_ns_harvest``), which a loaded host can only shrink at
    depth 2, not the run's wall time. The knob never changes tokens."""
    _, model = all_models["tiny"]
    prompts = _prompts(TINY.vocab_size)[:2]
    lat, work = 0.004, 0.003

    def run(depth, latency):
        eng = ServeEngine(model, port_cfg(TINY), slots=2, max_len=MAX_LEN,
                          prefill_chunk=8, decode_block=1,
                          pipeline_depth=depth,
                          virtual_device_latency_s=latency)
        uids = [eng.submit(p, max_new_tokens=24) for p in prompts]
        while eng.in_flight:
            eng.step()
            time.sleep(work)
        return [eng.result(u) for u in uids], eng.stats

    base, _ = run(0, 0.0)
    ref, s0 = run(0, lat)
    got, s2 = run(2, lat)
    assert ref == base
    assert got == ref
    assert s0["tick_ns_harvest"] >= (s0["decode_dispatches"] - 1) * lat * 1e9
    assert s2["tick_ns_harvest"] < 0.25 * s0["tick_ns_harvest"], (s0, s2)
    assert s2["host_sync_stalls"] < s0["host_sync_stalls"]
    assert s2["host_syncs"] < s0["host_syncs"]
