"""The port's chaos injection against the JAX engine's: the cases of
``tests/test_serve_chaos.py`` run on both engines with the same weights
(converted through numpy), the same prompts and the same
``ChaosConfig``. Every engine case asserts equal ``events``, equal
``injected_uids``, equal statuses and tokens, and equal counters
(``ENGINE_STATS`` plus the chaos and prefix keys).

Coverage: the POISON sentinel on the decode ring of a NaN'd lane (the
decoder level, against JAX's ring); ``corrupt_cache_lane`` hits one
lane's floating leaves only; the corrupt site isolates its victim (FAILED,
the others token for token the chaos-free run, ``host_syncs`` not
grown) and the victim's slot serves again; the same seed gives the same
faults; a failed warm gather FAILS the request, not the engine, and the
next request takes the slot; mid-tick aborts and virtual delays change
no token (the stale handoff flushed); ``step`` raises the ``ChaosError``
to a hand-driven caller; config validation; rate 0 is injection free;
the spill and restore_corrupt sites on the L2 tier. Then the NaN path
through kernel #1 under an A^3 threshold: the corrupt site on TINY_LG
with A^3 conservative (local layers through #1, global ones through the
compact op), and #1's plain version against the JAX Pallas kernel
(``interpret=True``) on NaN scores with and without a threshold.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import A3Config  # noqa: E402
from repro.kernels.decode_attention import kernel as jker  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serve import chaos as jchaos  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as tker  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.chaos import ChaosConfig, ChaosError, \
    ChaosInjector, corrupt_cache_lane  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

from test_torch_helpers import ENGINE_STATS, TINY, TINY_LG, T, \
    assert_same_stats, check_conservation, port_a3, port_cfg  # noqa: E402

torch.set_num_threads(1)

MAX_LEN = 96
PROMPT_LENS = (5, 12, 23)
CHAOS_STATS = ENGINE_STATS + ("chaos_aborted_ticks", "chaos_delayed_ticks",
                              "prefix_hits", "prefix_tokens_reused",
                              "gather_dispatches", "pages_recorded",
                              "pages_evicted", "l2_spills", "l2_hits",
                              "l2_evictions", "l2_integrity_drops")
CONFIGS = {"tiny": (TINY, 0), "tiny-lg": (TINY_LG, 4)}


@functools.lru_cache(maxsize=None)
def _models(name):
    cfg, seed = CONFIGS[name]
    params = jdec.init_params(jax.random.PRNGKey(seed), cfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(cfg), device="cpu")
    return cfg, params, model


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, TINY.vocab_size, size=n) for n in PROMPT_LENS]


def _engines(name="tiny", *, a3="off", chaos=None, slots=3, decode_block=4,
             cache_pages=0, **kw):
    """(JAX engine, port engine) with the same knobs; ``chaos`` is a
    ChaosConfig's keyword dict (each engine gets its own injector)."""
    cfg, params, model = _models(name)
    a3c = A3Config() if a3 == "off" else A3Config.conservative()
    kw = dict(slots=slots, max_len=MAX_LEN, prefill_chunk=8,
              decode_block=decode_block, page_size=8,
              cache_pages=cache_pages, **kw)
    jc = tc = None
    if chaos is not None:
        jc = jchaos.ChaosInjector(jchaos.ChaosConfig(**chaos))
        tc = ChaosInjector(ChaosConfig(**chaos))
    return (JaxEngine(params, cfg, a3=a3c, chaos=jc, **kw),
            ServeEngine(model, port_cfg(cfg), a3=port_a3(a3c), chaos=tc,
                        **kw), jc, tc)


def _run(eng, prompts, max_new=6):
    uids = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run_to_completion()
    return uids


def _both(prompts, max_new=6, **kw):
    """Serve ``prompts`` on both engines under the same chaos schedule
    -> (port, ref, port uids, port injector); events, victims, statuses,
    tokens and counters asserted equal."""
    ref, port, jc, tc = _engines(**kw)
    ruids = _run(ref, prompts, max_new)
    uids = _run(port, prompts, max_new)
    assert uids == ruids
    if tc is not None:
        assert tc.events == jc.events
        assert tc.injected_uids == jc.injected_uids
    assert [port.status(u) for u in uids] == [ref.status(u) for u in uids]
    assert [port.result(u) for u in uids] == [ref.result(u) for u in uids]
    assert_same_stats(port, ref, CHAOS_STATS)
    check_conservation(port)
    return port, ref, uids, tc


# ---------------------------------------------------------------------------
# the POISON sentinel at the decoder level
# ---------------------------------------------------------------------------

def test_chaos_poison_sentinel_rides_ring():
    """A NaN'd lane emits POISON once on the token ring, then freezes;
    the healthy lane's row is bit-identical to the clean run. The port's
    rings equal JAX's."""
    cfg, params, model = _models("tiny")
    pcfg = port_cfg(cfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 12))
    jl, jcache = jdec.prefill(params, cfg, jnp.asarray(toks), max_len=32)
    tl, tcache = tdec.prefill(model, pcfg, T(toks), max_len=32)
    first = np.asarray(jnp.argmax(jl, -1), np.int32)
    assert (tl.argmax(-1).numpy() == first).all()
    pos, left = np.full((2,), 12, np.int32), np.full((2,), 4, np.int32)
    j_ok, _, _ = jdec.decode_block(params, cfg, jcache, jnp.asarray(first),
                                   jnp.asarray(pos), jnp.asarray(left),
                                   steps=4)
    j_bad, j_carry, _ = jdec.decode_block(
        params, cfg, jchaos.corrupt_cache_lane(jcache, 0),
        jnp.asarray(first), jnp.asarray(pos), jnp.asarray(left), steps=4)
    t_ok, _, _ = tdec.decode_block(
        model, pcfg, {s: {k: v.clone() for k, v in sc.items()}
                      for s, sc in tcache.items()},
        T(first), T(pos), T(left), steps=4)
    t_bad, t_carry, _ = tdec.decode_block(
        model, pcfg, corrupt_cache_lane(tcache, 0), T(first), T(pos),
        T(left), steps=4)
    t_ok, t_bad = t_ok.numpy(), t_bad.numpy()
    np.testing.assert_array_equal(t_ok, np.asarray(j_ok))
    np.testing.assert_array_equal(t_bad, np.asarray(j_bad))
    assert t_bad[0, 0] == tdec.POISON and (t_bad[0, 1:] == -1).all()
    np.testing.assert_array_equal(t_bad[1], t_ok[1])
    assert int(t_carry[0]) == int(np.asarray(j_carry)[0]) == int(first[0])


def test_chaos_corrupt_cache_lane_targets_one_lane():
    cfg, _, model = _models("tiny")
    _, cache = tdec.prefill(model, port_cfg(cfg),
                            torch.zeros((3, 4), dtype=torch.int32),
                            max_len=16)
    before = {s: {k: v.clone() for k, v in sc.items()}
              for s, sc in cache.items()}
    bad = corrupt_cache_lane(cache, 1)
    assert bad is cache                     # in place
    for name, sc in bad.items():
        for key, leaf in sc.items():
            ref = before[name][key]
            if leaf.is_floating_point():
                assert torch.isnan(leaf[:, 1]).all(), (name, key)
            else:
                assert torch.equal(leaf[:, 1], ref[:, 1])
            assert torch.equal(leaf[:, 0], ref[:, 0])
            assert torch.equal(leaf[:, 2], ref[:, 2])


# ---------------------------------------------------------------------------
# headline conformance: corrupt injection
# ---------------------------------------------------------------------------

CORRUPT = dict(seed=0, rate=0.5, raise_mid_tick=False, fail_gather=False,
               max_injections=1)


def test_chaos_conformance_corrupt_isolates_victim(prompts):
    free, free_ref, fu, _ = _both(prompts)
    port, ref, uids, tc = _both(prompts, chaos=CORRUPT)
    victims = tc.injected_uids
    assert victims, "the pinned (seed, rate) schedule must inject"
    for u, f in zip(uids, fu):
        if u in victims:
            assert port.status(u) == "failed" and port.result(u) is None
        else:
            assert port.status(u) == "finished"
            assert port.result(u) == free.result(f)
    assert port.stats["failed"] == len(victims)
    assert port.stats["host_syncs"] <= free.stats["host_syncs"]
    assert port.stats["host_syncs"] <= (port.stats["decode_dispatches"]
                                        + port.stats["handoff_syncs"])
    # the victim's slot serves again, on both engines alike
    for eng in (port, ref):
        u_next = eng.submit(prompts[0], max_new_tokens=4)
        eng.run_to_completion()
        assert eng.status(u_next) == "finished"
        assert eng.result(u_next) == free.result(fu[0])[:4]
        check_conservation(eng) if eng is port else None
    assert_same_stats(port, ref, CHAOS_STATS)


def test_chaos_determinism_same_seed_same_faults(prompts):
    p1, _, u1, c1 = _both(prompts, chaos=CORRUPT)
    p2, _, u2, c2 = _both(prompts, chaos=CORRUPT)
    assert c1.events == c2.events
    assert [p1.status(u) for u in u1] == [p2.status(u) for u in u2]
    assert [p1.result(u) for u in u1] == [p2.result(u) for u in u2]


# ---------------------------------------------------------------------------
# gather-failure injection (prefix-cache admission)
# ---------------------------------------------------------------------------

def test_chaos_gather_failure_fails_request_not_engine(prompts):
    long_prompt = np.concatenate([prompts[2], prompts[1], prompts[2]])[:48]
    ref, port, jc, tc = _engines(
        slots=2, cache_pages=16, chaos=dict(seed=1, rate=1.0,
                                            corrupt_logits=False,
                                            raise_mid_tick=False,
                                            max_injections=1))
    for eng in (ref, port):
        u0 = eng.submit(long_prompt, max_new_tokens=4)   # cold: no gather
        eng.run_to_completion()
        assert eng.status(u0) == "finished"
        u1 = eng.submit(long_prompt, max_new_tokens=4)   # warm: it fails
        eng.run_to_completion()
        assert eng.status(u1) == "failed"
        u2 = eng.submit(long_prompt, max_new_tokens=4)   # budget spent
        eng.run_to_completion()
        assert eng.status(u2) == "finished"
        assert eng.result(u2) == eng.result(u0)
        assert eng._pc.referenced_nodes == 0
    assert tc.events == jc.events and tc.injected_uids == {1}
    assert port.result(0) == ref.result(0)
    assert port.stats["prefix_hits"] >= 1
    assert_same_stats(port, ref, CHAOS_STATS)
    check_conservation(port)


def test_prefix_cache_admit_fail_hook_leaves_the_cache_untouched(prompts):
    """``PrefixCache.admit(fail_hook=...)``: the hook runs before a warm
    gather with the matched length, and when it raises (a chaos gather
    failure) the slot's cache, the prefix counters and the refcounts are
    untouched; a cold admission never calls it; as the JAX cache's."""
    from repro.serve.prefix_cache import PrefixCache as JaxPrefixCache
    from repro_torch.serve.prefix_cache import PrefixCache
    cfg, params, model = _models("tiny")
    pcfg = port_cfg(cfg)
    prompt = np.concatenate([prompts[2], prompts[1]])[:32]
    _, jcache = jdec.prefill(params, cfg, jnp.asarray(prompt[None]),
                             max_len=MAX_LEN)
    _, tcache = tdec.prefill(model, pcfg, T(prompt[None]), max_len=MAX_LEN)
    seen = []

    class Injected(RuntimeError):
        pass

    def hook(matched):
        seen.append(matched)
        raise Injected(matched)

    jpc = JaxPrefixCache(cfg, max_len=MAX_LEN, page_size=8, cache_pages=8)
    tpc = PrefixCache(pcfg, max_len=MAX_LEN, page_size=8, cache_pages=8,
                      device="cpu")
    for pc, cache in ((jpc, jcache), (tpc, tcache)):
        _, t, _ = pc.admit(cache, 0, prompt, fail_hook=hook)   # cold
        assert t == 0
        node = pc.root
        for b in range(8, 32, 8):
            node = pc.record_boundary(cache, 0, prompt, b, node)
    before = {s: {k: v.clone() for k, v in sc.items()}
              for s, sc in tcache.items()}
    for pc, cache in ((jpc, jcache), (tpc, tcache)):
        with pytest.raises(Injected):
            pc.admit(cache, 1, prompt, fail_hook=hook)
    assert seen == [24, 24]
    for s, sc in tcache.items():
        for k, v in sc.items():
            assert torch.equal(v, before[s][k])
    assert tpc.stats == jpc.stats
    assert tpc.stats["prefix_hits"] == 0
    assert tpc.referenced_nodes == jpc.referenced_nodes == 0


def test_chaos_failed_gather_hands_the_slot_to_the_next_request(prompts):
    """The admission loop: a request whose warm gather fails ends FAILED
    in the same tick, and the next queued request takes its slot at
    once (both engines tick alike)."""
    head = np.concatenate([prompts[2], prompts[1], prompts[2]])[:40]
    reqs = [np.concatenate([head, prompts[i % 3][:3]]) for i in range(4)]
    ref, port, jc, tc = _engines(
        slots=1, cache_pages=16, chaos=dict(seed=2, rate=1.0,
                                            corrupt_logits=False,
                                            raise_mid_tick=False,
                                            max_injections=2))
    for eng in (ref, port):
        _run(eng, reqs[:1], max_new=3)
        _run(eng, reqs[1:], max_new=3)
    assert tc.events == jc.events
    assert [port.status(u) for u in range(4)] == \
        [ref.status(u) for u in range(4)] == \
        ["finished", "failed", "failed", "finished"]
    assert [port.result(u) for u in range(4)] == \
        [ref.result(u) for u in range(4)]
    assert_same_stats(port, ref, CHAOS_STATS)


# ---------------------------------------------------------------------------
# mid-tick abort / delay injection
# ---------------------------------------------------------------------------

def test_chaos_mid_tick_aborts_change_nothing(prompts):
    """Aborts at the phase boundaries and virtual delays: ticks are
    retried, stale handoff tokens flushed, and every request finishes
    with the chaos-free tokens."""
    free, _, fu, _ = _both(prompts, slots=2, cache_pages=16)
    port, ref, uids, tc = _both(
        prompts, slots=2, cache_pages=16,
        chaos=dict(seed=3, rate=0.3, corrupt_logits=False,
                   fail_gather=False, raise_mid_tick=True,
                   delay_mid_tick=True))
    aborts = [e for e in tc.events if e[0] == "raise"]
    delays = [e for e in tc.events if e[0] == "delay"]
    assert aborts and delays
    assert port.stats["chaos_aborted_ticks"] == len(aborts)
    assert 0 < port.stats["chaos_delayed_ticks"] \
        <= len(delays) * tc.config.delay_ticks
    for u, f in zip(uids, fu):
        assert port.status(u) == "finished"
        assert port.result(u) == free.result(f)
    assert port.stats["host_syncs"] <= (port.stats["decode_dispatches"]
                                        + port.stats["handoff_syncs"])
    assert port._pc.referenced_nodes == 0


@pytest.mark.parametrize("seed", [13, 16])
def test_chaos_aborts_flush_stale_handoff(prompts, seed):
    """An abort at ``pre_advance`` falls between the prefill dispatch and
    the decode harvest: the handoff tokens the aborted tick left are read
    by the next prefilling tick's flush (one more ``handoff_syncs`` than
    the chaos-free run, on both engines alike); the tokens stay the
    chaos-free ones. The seeds are schedules where such an abort lands on
    a tick whose prefill finished a prompt."""
    free, _, fu, _ = _both(prompts, slots=2)
    port, ref, uids, tc = _both(
        prompts, slots=2, chaos=dict(seed=seed, rate=0.5,
                                     corrupt_logits=False,
                                     fail_gather=False))
    assert any(e[2] == "pre_advance" for e in tc.events)
    assert port.stats["handoff_syncs"] == free.stats["handoff_syncs"] + 1
    assert [port.result(u) for u in uids] == [free.result(u) for u in fu]


def test_chaos_step_propagates_chaos_error(prompts):
    """A caller driving step() by hand sees the ChaosError; the engine
    stays consistent and the next step() resumes."""
    _, port, _, _ = _engines(slots=1, chaos=dict(seed=3, rate=1.0,
                                                 corrupt_logits=False,
                                                 fail_gather=False,
                                                 raise_mid_tick=True))
    u = port.submit(prompts[0], max_new_tokens=2)
    with pytest.raises(ChaosError):
        port.step()
    check_conservation(port)
    assert port.status(u) in ("queued", "prefilling", "decoding")


# ---------------------------------------------------------------------------
# injector plumbing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [dict(rate=1.5), dict(rate=-0.1),
                                 dict(delay_ticks=-1), dict(spill_pages=-1),
                                 dict(max_injections=-1)],
                         ids=lambda kw: next(iter(kw)))
def test_chaos_config_validation(bad):
    with pytest.raises(ValueError):
        jchaos.ChaosConfig(**bad)
    with pytest.raises(ValueError):
        ChaosConfig(**bad)


def test_chaos_rate_zero_is_injection_free(prompts):
    free, _, fu, _ = _both(prompts)
    port, _, uids, tc = _both(prompts, chaos=dict(seed=9, rate=0.0))
    assert tc.events == []
    strip = lambda st: {k: v for k, v in st.items()  # noqa: E731
                        if not k.startswith("tick_ns")
                        and k != "host_sync_stalls"}
    assert strip(port.stats) == strip(free.stats)
    assert [port.result(u) for u in uids] == [free.result(u) for u in fu]


def test_chaos_injector_draws_equal_the_reference():
    """The schedule is numpy only: every site draws the reference's
    decisions tick for tick."""
    cfgs = dict(seed=5, rate=0.4, restore_corrupt=True, delay_mid_tick=True,
                spill_pages=3, crash_mid_tick=False)
    j, t = jchaos.ChaosInjector(jchaos.ChaosConfig(**cfgs)), \
        ChaosInjector(ChaosConfig(**cfgs))
    for tick in range(1, 60):
        for inj in (j, t):
            for phase in ("tick_start", "pre_prefill", "pre_advance"):
                try:
                    inj.phase(tick, phase)
                except RuntimeError:
                    pass
            inj.consume_delay()
            inj.pick_spill(tick)
            inj.l2_restore_corrupt(tick, (tick, 7, 9))
            inj.pick_corrupt_victim(tick, [3, 1, 2])
            try:
                inj.gather_fail(tick, tick % 4, 8)
            except RuntimeError:
                pass
    assert t.events == j.events and len(t.events) > 20
    assert t.injected_uids == j.injected_uids


# ---------------------------------------------------------------------------
# the durable-state sites: spill and restore_corrupt on the L2 tier
# ---------------------------------------------------------------------------

def test_chaos_spill_and_restore_corrupt_sites_on_l2():
    """``spill`` force-demotes pages at tick starts and
    ``restore_corrupt`` flips a blob byte before its restore: the
    checksum catches it (an integrity drop, a cold prefill), and every
    token equals the chaos-free serve, on both engines alike."""
    rng = np.random.default_rng(7)
    shared = rng.integers(0, TINY.vocab_size, size=24)
    reqs = [np.concatenate([shared, rng.integers(0, TINY.vocab_size,
                                                 size=4 + 3 * i)])
            for i in range(5)]
    free, _, fu, _ = _both(reqs, slots=2, cache_pages=24, l2_bytes=1 << 22)
    port, ref, uids, tc = _both(
        reqs, slots=2, cache_pages=24, l2_bytes=1 << 22,
        chaos=dict(seed=6, rate=0.5, corrupt_logits=False,
                   fail_gather=False, raise_mid_tick=False,
                   restore_corrupt=True, spill_pages=4))
    kinds = {e[0] for e in tc.events}
    assert {"spill", "restore_corrupt"} <= kinds
    assert port.stats["l2_integrity_drops"] >= 1
    assert [port.result(u) for u in uids] == [free.result(u) for u in fu]


# ---------------------------------------------------------------------------
# NaN through kernel #1 under a threshold
# ---------------------------------------------------------------------------

def test_chaos_corrupt_a3_local_global_poisons_on_both_engines():
    """TINY_LG with A^3 conservative: its local layers decode through #1
    and its global layers through the compact op. A corrupted lane
    poisons and FAILS on both engines, at the same tick, and the other
    lanes keep the chaos-free tokens."""
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, TINY.vocab_size, size=n) for n in (9, 20, 30)]
    free, _, fu, _ = _both(reqs, name="tiny-lg", a3="conservative",
                           max_new=8)
    port, ref, uids, tc = _both(reqs, name="tiny-lg", a3="conservative",
                                max_new=8, chaos=dict(CORRUPT, rate=1.0))
    victims = tc.injected_uids
    assert victims
    for u, f in zip(uids, fu):
        if u in victims:
            assert port.status(u) == "failed"
        else:
            assert port.result(u) == free.result(f)


@pytest.mark.parametrize("threshold", [None, 3.0])
def test_fused_plain_propagates_nan_scores_as_the_pallas_kernel(threshold):
    """#1's plain version (the CPU route of the port's engine) against the
    JAX Pallas fused kernel in interpret mode, on NaN scores: a NaN key
    row poisons its query rows through the running max, with or without
    a threshold, where the JAX ``ref.py`` oracle resets a non-finite max
    and drops the NaN key under a threshold. Lane 0 is clean, lane 1 has
    one NaN key (V finite), lane 2 a NaN ring whose last row is fresh
    (the corrupt site's state at the next step)."""
    rng = np.random.default_rng(5)
    b, hq, hkv, s, d = 3, 4, 2, 256, 32
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    mask = rng.random((b, hq, s)) > 0.3
    mask[:, :, 7] = True
    k[1, :, 7] = np.nan
    k[2, :, :s - 1] = np.nan
    v[2, :, :s - 1] = np.nan
    mask[2, :, s - 1] = True
    want = np.asarray(jker.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        threshold=threshold, block_k=128, interpret=True))
    got = tker.fused_plain(T(q), T(k), T(v), T(mask), threshold=threshold,
                           block_k=128).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1:]).all() and not np.isnan(got[0]).any()
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
