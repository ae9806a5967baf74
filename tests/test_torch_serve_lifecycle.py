"""The request lifecycle of the port's ServeEngine against the JAX
engine: the cases of ``tests/test_serve_lifecycle.py`` that need no
prefix cache, L2 tier, checkpoint or telemetry (submit hardening,
cancel, deadlines, drain, both shed policies, max_ticks exhaustion,
churn, bounded retention), each run as one script on both engines
(TINY, f32, greedy) at pipeline_depth 0 and 1: the reference's
assertions hold on both, the statuses and results each script observes
are equal, every wall-clock-free counter is equal, and the conservation
identity closes after every tick.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import ServeConfig as JaxServeConfig  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.config import ServeConfig  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

from test_torch_helpers import TINY, assert_same_stats, \
    check_conservation, jax_blocks_ready, port_cfg  # noqa: E402

torch.set_num_threads(1)

MAX_LEN = 96
PROMPT_LENS = (5, 12, 23, 31, 9)
TERMINAL = {"finished", "rejected", "cancelled", "expired", "failed"}


@pytest.fixture(scope="module")
def models():
    params = jdec.init_params(jax.random.PRNGKey(0), TINY)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(TINY), device="cpu")
    return params, model


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, TINY.vocab_size, size=n) for n in PROMPT_LENS]


def _tick(eng, n=1):
    for _ in range(n):
        eng.step()
        check_conservation(eng)


def _finish(eng, max_ticks=10_000):
    eng.run_to_completion(max_ticks=max_ticks)
    check_conservation(eng)


def _both(models, script, prompts, depth, **kw):
    """Run ``script(eng, prompts) -> observations`` on the JAX engine and
    the port's with the same knobs; observations and counters equal."""
    params, model = models
    kw = {"max_len": MAX_LEN, "pipeline_depth": depth, **kw}
    with jax_blocks_ready():
        ref = JaxEngine(params, TINY, **kw)
        want = script(ref, prompts)
    port = ServeEngine(model, port_cfg(TINY), **kw)
    got = script(port, prompts)
    assert got == want
    assert_same_stats(port, ref)
    return got


DEPTHS = pytest.mark.parametrize("depth", [0, 1])


# ---------------------------------------------------------------------------
# submit() input hardening
# ---------------------------------------------------------------------------

def test_lifecycle_submit_rejects_bad_inputs(models):
    params, model = models
    for eng in (JaxEngine(params, TINY, slots=1, max_len=16),
                ServeEngine(model, port_cfg(TINY), slots=1, max_len=16)):
        with pytest.raises(ValueError):
            eng.submit(np.array([], np.int32))
        with pytest.raises(ValueError):
            eng.submit(np.array([[1, 2]], np.int32))
        with pytest.raises(TypeError):
            eng.submit(np.array([0.5, 1.5]))
        with pytest.raises(ValueError):
            eng.submit(np.arange(17, dtype=np.int32))
        with pytest.raises(ValueError):
            eng.submit(np.array([-1, 3], np.int32))
        with pytest.raises(ValueError):
            eng.submit(np.array([TINY.vocab_size], np.int32))
        with pytest.raises(ValueError):
            eng.submit(np.array([1, 2], np.int32), max_new_tokens=0)
        with pytest.raises(ValueError):
            eng.submit(np.array([1, 2], np.int32), deadline_ticks=0)
        assert eng.stats["submitted"] == 0 and eng.in_flight == 0
        check_conservation(eng)


@DEPTHS
def test_lifecycle_submit_at_max_len_allowed(models, depth):
    def script(eng, _):
        u = eng.submit(np.arange(16, dtype=np.int32), max_new_tokens=8)
        _finish(eng)
        assert eng.status(u) == "finished"
        assert len(eng.result(u)) == 1
        return eng.result(u)

    params, model = models
    with jax_blocks_ready():
        want = script(JaxEngine(params, TINY, slots=1, max_len=16,
                                pipeline_depth=depth), None)
    assert script(ServeEngine(model, port_cfg(TINY), slots=1, max_len=16,
                              pipeline_depth=depth), None) == want


def test_lifecycle_status_unknown_uid_raises(models):
    _, model = models
    eng = ServeEngine(model, port_cfg(TINY), slots=1, max_len=16)
    with pytest.raises(KeyError):
        eng.status(123)


# ---------------------------------------------------------------------------
# cancel / deadline expiry / drain
# ---------------------------------------------------------------------------

@DEPTHS
def test_lifecycle_cancel_queued_and_on_slot(models, prompts, depth):
    def script(eng, ps):
        uids = [eng.submit(p, max_new_tokens=20) for p in ps]
        assert eng.cancel(uids[4])
        assert eng.status(uids[4]) == "cancelled"
        _tick(eng, 2)
        assert eng.status(uids[0]) == "decoding"
        assert eng.cancel(uids[0])
        assert eng.status(uids[0]) == "cancelled"
        assert eng.result(uids[0]) is None
        assert not eng.cancel(uids[0])
        _finish(eng)
        assert [eng.status(u) for u in uids] == \
            ["cancelled", "finished", "finished", "finished", "cancelled"]
        assert eng.stats["cancelled"] == 2 and eng.stats["finished"] == 3
        return [eng.result(u) for u in uids]

    _both(models, script, prompts, depth, slots=2, prefill_chunk=8,
          decode_block=2)


@DEPTHS
def test_lifecycle_cancel_mid_prefill_reclaims_slot(models, prompts, depth):
    def script(eng, ps):
        u0 = eng.submit(ps[3], max_new_tokens=4)
        u1 = eng.submit(ps[0], max_new_tokens=4)
        _tick(eng)
        assert eng.status(u0) == "prefilling"
        assert eng.cancel(u0)
        _finish(eng)
        assert eng.status(u0) == "cancelled"
        assert eng.status(u1) == "finished"
        assert len(eng.result(u1)) == 4
        return eng.result(u1)

    _both(models, script, prompts, depth, slots=1, prefill_chunk=4)


@DEPTHS
def test_lifecycle_deadline_expires_queued_and_on_slot(models, prompts,
                                                       depth):
    def script(eng, ps):
        uids = [eng.submit(p, max_new_tokens=30) for p in ps[:3]]
        while eng.in_flight:
            _tick(eng)
        assert all(eng.status(u) == "expired" for u in uids)
        assert eng.stats["expired"] == 3
        return [eng.status(u) for u in uids]

    _both(models, script, prompts, depth, slots=1, prefill_chunk=8,
          deadline_ticks=3)


@DEPTHS
def test_lifecycle_deadline_generous_finishes(models, prompts, depth):
    def script(eng, ps):
        uids = [eng.submit(p, max_new_tokens=6) for p in ps]
        _finish(eng)
        assert all(eng.status(u) == "finished" for u in uids)
        return [eng.result(u) for u in uids]

    free = _both(models, script, prompts, depth, slots=2, prefill_chunk=8)
    assert _both(models, script, prompts, depth, slots=2, prefill_chunk=8,
                 deadline_ticks=1000) == free


@DEPTHS
def test_lifecycle_per_request_deadline_overrides_engine(models, prompts,
                                                         depth):
    """``submit(deadline_ticks=...)`` beats the engine-wide setting:
    one request with a short deadline expires mid-decode, the others
    finish."""
    def script(eng, ps):
        u0 = eng.submit(ps[0], max_new_tokens=30, deadline_ticks=3)
        rest = [eng.submit(p, max_new_tokens=6) for p in ps[1:3]]
        while eng.in_flight:
            _tick(eng)
        assert eng.status(u0) == "expired"
        assert all(eng.status(u) == "finished" for u in rest)
        return [eng.result(u) for u in rest]

    _both(models, script, prompts, depth, slots=2, prefill_chunk=8,
          decode_block=2, deadline_ticks=1000)


@DEPTHS
def test_lifecycle_drain_graceful_shutdown(models, prompts, depth):
    def script(eng, ps):
        uids = [eng.submit(p, max_new_tokens=4) for p in ps[:3]]
        _tick(eng)
        eng.drain()
        assert eng.draining
        rejected = eng.submit(ps[0], max_new_tokens=4)
        assert eng.status(rejected) == "rejected"
        _finish(eng)
        assert eng.status(uids[0]) == "finished"
        assert [eng.status(u) for u in uids[1:]] == ["cancelled",
                                                     "cancelled"]
        eng.drain()
        check_conservation(eng)
        return eng.result(uids[0])

    _both(models, script, prompts, depth, slots=1, prefill_chunk=8)


# ---------------------------------------------------------------------------
# bounded admission + load shedding
# ---------------------------------------------------------------------------

@DEPTHS
def test_shed_reject_new_bounds_queue(models, prompts, depth):
    def script(eng, ps):
        uids = [eng.submit(p, max_new_tokens=2) for p in ps]
        assert [eng.status(u) for u in uids] == \
            ["queued", "queued", "rejected", "rejected", "rejected"]
        assert all(eng.result(u) is None for u in uids)
        _finish(eng)
        assert [eng.status(u) for u in uids[:2]] == ["finished",
                                                     "finished"]
        assert eng.stats["rejected"] == 3
        return [eng.result(u) for u in uids]

    _both(models, script, prompts, depth, slots=1, max_queue=2)


@DEPTHS
def test_shed_evict_oldest_queued_prefers_fresh(models, prompts, depth):
    def script(eng, ps):
        uids = [eng.submit(p, max_new_tokens=2) for p in ps]
        assert [eng.status(u) for u in uids] == \
            ["rejected", "rejected", "rejected", "queued", "queued"]
        _finish(eng)
        assert [eng.status(u) for u in uids[3:]] == ["finished",
                                                     "finished"]
        assert eng.stats["rejected"] == 3
        return [eng.result(u) for u in uids]

    _both(models, script, prompts, depth, slots=1, max_queue=2,
          shed_policy="evict-oldest-queued")


@DEPTHS
def test_shed_queue_drains_then_admits_again(models, prompts, depth):
    def script(eng, ps):
        u0 = eng.submit(ps[0], max_new_tokens=2)
        _tick(eng)
        u1 = eng.submit(ps[1], max_new_tokens=2)
        u2 = eng.submit(ps[2], max_new_tokens=2)
        assert eng.status(u1) == "queued"
        assert eng.status(u2) == "rejected"
        _finish(eng)
        u3 = eng.submit(ps[2], max_new_tokens=2)
        assert eng.status(u3) == "queued"
        _finish(eng)
        assert [eng.status(u) for u in (u0, u1, u3)] == \
            ["finished", "finished", "finished"]
        return [eng.result(u) for u in (u0, u1, u3)]

    _both(models, script, prompts, depth, slots=2, max_queue=1)


def test_shed_config_validation():
    for cls in (ServeConfig, JaxServeConfig):
        with pytest.raises(ValueError):
            cls(max_queue=-1)
        with pytest.raises(ValueError):
            cls(shed_policy="drop-the-table")
        with pytest.raises(ValueError):
            cls(deadline_ticks=0)
        cls(max_queue=8, shed_policy="evict-oldest-queued",
            deadline_ticks=100)


@pytest.mark.parametrize("bad", [
    dict(max_queue=-1), dict(shed_policy="nope"), dict(deadline_ticks=0),
    dict(pipeline_depth=-1), dict(retain_results=-1),
    dict(prefill_chunk_min=0), dict(prefill_chunk=8, prefill_chunk_min=9),
    dict(virtual_device_latency_s=-1.0)], ids=lambda kw: next(iter(kw)))
def test_shed_engine_validation(models, bad):
    params, model = models
    with pytest.raises(ValueError):
        JaxEngine(params, TINY, slots=1, max_len=16, **bad)
    with pytest.raises(ValueError):
        ServeEngine(model, port_cfg(TINY), slots=1, max_len=16, **bad)


# ---------------------------------------------------------------------------
# run_to_completion max_ticks exhaustion
# ---------------------------------------------------------------------------

@DEPTHS
def test_lifecycle_max_ticks_exhaustion_raises(models, prompts, depth):
    def script(eng, ps):
        u = eng.submit(ps[0], max_new_tokens=50)
        with pytest.raises(RuntimeError, match="max_ticks"):
            eng.run_to_completion(max_ticks=2)
        assert eng.stats["max_ticks_exhausted"] == 1
        assert eng.status(u) in ("prefilling", "decoding")
        check_conservation(eng)
        _finish(eng)
        assert eng.status(u) == "finished"
        assert len(eng.result(u)) == 50
        return eng.result(u)

    _both(models, script, prompts, depth, slots=1, prefill_chunk=8)


# ---------------------------------------------------------------------------
# churn
# ---------------------------------------------------------------------------

@DEPTHS
def test_lifecycle_conservation_under_churn(models, prompts, depth):
    """Randomized submit / cancel / step interleavings: the identity
    holds at every tick and both engines end in the same states."""
    def script(eng, ps):
        rng = np.random.default_rng(7)
        uids = []
        for _ in range(40):
            op = rng.integers(3)
            if op == 0:
                p = ps[int(rng.integers(len(ps)))]
                uids.append(eng.submit(p, max_new_tokens=int(
                    rng.integers(1, 8))))
            elif op == 1 and uids:
                eng.cancel(int(rng.choice(uids)))
            else:
                eng.step()
            check_conservation(eng)
        _finish(eng)
        assert eng.in_flight == 0
        assert all(eng.status(u) in TERMINAL for u in uids)
        return [(eng.status(u), eng.result(u)) for u in uids]

    _both(models, script, prompts, depth, slots=2, prefill_chunk=8,
          decode_block=2, max_queue=3, deadline_ticks=12)


# ---------------------------------------------------------------------------
# bounded retention (retain_results)
# ---------------------------------------------------------------------------

@DEPTHS
def test_retention_result_pops_on_read(models, prompts, depth):
    def script(eng, ps):
        u = eng.submit(ps[0], max_new_tokens=3)
        _finish(eng)
        toks = eng.result(u)
        assert toks is not None and len(toks) == 3
        assert eng.result(u) is None
        return toks

    _both(models, script, prompts, depth, slots=2, prefill_chunk=8,
          retain_results=8)


@DEPTHS
def test_retention_evicts_oldest_terminal(models, prompts, depth):
    def script(eng, ps):
        uids = [eng.submit(p, max_new_tokens=2) for p in ps[:4]]
        _finish(eng)
        kept = [u for u in uids if u in eng._status]
        assert len(kept) == 2 and kept == sorted(uids)[-2:]
        assert eng.result(uids[0]) is None
        with pytest.raises(KeyError):
            eng.status(uids[0])
        last = eng.result(kept[-1])
        assert last is not None
        assert eng.stats["finished"] == 4
        return kept, last

    _both(models, script, prompts, depth, slots=2, prefill_chunk=8,
          retain_results=2)


def test_retention_conservation_over_10k_request_churn(models):
    """10k one-token requests through a 64-entry retention window (the
    reference's case without its telemetry half): the per-request maps
    stay within the window and every counter is conserved, on both
    engines alike."""
    retain = 64

    def script(eng, _):
        rng = np.random.default_rng(3)
        total, waves, sampled = 10_000, 10, []
        for _ in range(waves):
            uids = [eng.submit(rng.integers(0, TINY.vocab_size,
                                            size=int(rng.integers(2, 6))),
                               max_new_tokens=1)
                    for _ in range(total // waves)]
            eng.run_to_completion()
            for u in uids[-4:]:
                r = eng.result(u)
                assert len(r) == 1
                assert eng.result(u) is None
                sampled.append(r)
            check_conservation(eng)
            assert len(eng._status) <= retain
            assert len(eng._done) <= retain
            assert len(eng._terminal_order) <= retain
        s = eng.stats
        assert s["submitted"] == s["finished"] == total
        assert eng.in_flight == 0
        return sampled

    _both(models, script, None, 0, slots=8, prefill_chunk=16,
          retain_results=retain)
