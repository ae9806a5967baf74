"""The port's paged prefix cache against the JAX one: each case of
``tests/test_serve_prefix_cache.py`` (the sharded lowering case aside)
run on both engines with the same weights (converted through numpy) and
the same prompts, float32 and greedy. Every case asserts equal tokens,
equal engine counters (the five prefix keys, ``prefill_tokens``,
``prefill_dispatches``, ``host_syncs`` and the rest of
``ENGINE_STATS``) and an equal trie (``len``, ``pages_in_use``,
``referenced_nodes``).

Coverage: warm == cold across the mixer kinds (TINY, TINY_RG, TINY_XL,
and TINY_SWA / TINY_LG for the windowed match terminals) with A^3 off
and conservative at ``pipeline_depth`` 0 and 1; full-prefix and
mid-page partial hits (copy-on-write); multi-page recording chunks;
the stale-ring regressions (wide final chunk, page wider than the
window, an unaligned cursor from the adaptive floor), where the
restored cache is compared leaf for leaf with JAX's; LRU eviction and
the bounded heap; the A^3 sorted columns restored at the boundary; the
cold = warm + reused identity; the flash crowd in one gather; the
standalone gather against a cold chunked prefill; adaptive chunking;
config validation. Added for the port: a recorded prompt's slot keeps
decoding while another slot warm-admits from it (snapshots must be
copies, not views of the live cache), and the lifecycle refcount audit
of ``tests/test_serve_lifecycle.py``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import A3Config, ServeConfig as JaxServeConfig  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.prefix_cache import PrefixCache as JaxPrefixCache  # noqa: E402,E501
from repro_torch.config import ServeConfig  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.prefix_cache import PrefixCache  # noqa: E402

from test_torch_helpers import ENGINE_STATS, F32_TOL, TINY, TINY_LG, \
    TINY_RG, TINY_SWA, TINY_XL, assert_cache_close, \
    assert_engine_invariants, assert_same_stats, jax_blocks_ready, \
    port_a3, port_cfg  # noqa: E402

torch.set_num_threads(1)

MAX_LEN = 96
MAX_NEW = 6
PAGE = 8
PREFIX_STATS = ENGINE_STATS + ("prefix_hits", "prefix_tokens_reused",
                               "gather_dispatches", "pages_recorded",
                               "pages_evicted")
# (config, weight seed); TINY_RG_W12 is TINY_RG with a 12-row window and
# the same weights
TINY_RG_W12 = dataclasses.replace(TINY_RG, name="tiny-rg-w12",
                                  window_size=12)
CONFIGS = {"tiny": (TINY, 0), "tiny-rg": (TINY_RG, 1),
           "tiny-xl": (TINY_XL, 2), "tiny-swa": (TINY_SWA, 3),
           "tiny-lg": (TINY_LG, 4), "tiny-rg-w12": (TINY_RG_W12, 1)}


@functools.lru_cache(maxsize=None)
def _models(name):
    cfg, seed = CONFIGS[name]
    params = jdec.init_params(jax.random.PRNGKey(seed), cfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(cfg), device="cpu")
    return cfg, params, model


def _a3(mode):
    return A3Config() if mode == "off" else A3Config.conservative()


def _shared_prefix_prompts(vocab, *, shared_len=24, n=3, seed=7):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=shared_len)
    return [np.concatenate([shared, rng.integers(0, vocab, size=4 + 3 * i)])
            for i in range(n)]


def _pair(name, *, a3="off", **kw):
    cfg, params, model = _models(name)
    kw = {"max_len": MAX_LEN, **kw}
    return (JaxEngine(params, cfg, a3=_a3(a3), **kw),
            ServeEngine(model, port_cfg(cfg), a3=port_a3(_a3(a3)), **kw))


def _serve(eng, batches, max_new=MAX_NEW):
    """Each batch of prompts submitted together and served to the end,
    in turn -> the results in prompt order."""
    out = []
    for batch in batches:
        uids = [eng.submit(p, max_new_tokens=max_new) for p in batch]
        eng.run_to_completion()
        out += [eng.result(u) for u in uids]
    return out


def _same_trie(port, ref):
    assert_same_stats(port, ref, PREFIX_STATS)
    for got, want in ((len(port._pc), len(ref._pc)),
                      (port._pc.pages_in_use, ref._pc.pages_in_use),
                      (port._pc.referenced_nodes, ref._pc.referenced_nodes)):
        assert got == want


def _both(name, batches, *, a3="off", max_new=MAX_NEW, **kw):
    """Serve ``batches`` on both engines -> (tokens, port, ref), tokens,
    counters and trie asserted equal."""
    ref, port = _pair(name, a3=a3, **kw)
    ready = (jax_blocks_ready() if kw.get("pipeline_depth", 0) > 0
             else contextlib.nullcontext())
    with ready:
        want = _serve(ref, batches, max_new)
    got = _serve(port, batches, max_new)
    assert got == want
    if port._pc is not None:
        _same_trie(port, ref)
    else:
        assert_same_stats(port, ref, PREFIX_STATS)
    assert_engine_invariants(port)
    return got, port, ref


def _cold(name, batches, *, a3="off", max_new=MAX_NEW, **kw):
    """The port's tokens without a prefix cache."""
    cfg, _, model = _models(name)
    kw = {"max_len": MAX_LEN, **kw, "cache_pages": 0}
    return _serve(ServeEngine(model, port_cfg(cfg), a3=port_a3(_a3(a3)),
                              **kw), batches, max_new)


# ---------------------------------------------------------------------------
# warm == cold, token for token, across mixer kinds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("a3", ["off", "conservative"])
@pytest.mark.parametrize("name", ["tiny", "tiny-rg", "tiny-xl", "tiny-swa",
                                  "tiny-lg"])
def test_prefix_warm_matches_cold_across_kinds(name, a3, depth):
    """The first request is cold and records; the others walk the trie,
    gather the matched pages and prefill only their suffix: the JAX
    engine's tokens, counters and trie, and the cold engine's tokens."""
    prompts = _shared_prefix_prompts(256)
    batches = [prompts[:1], prompts[1:]]
    kw = dict(slots=2, prefill_chunk=PAGE, page_size=PAGE, resort_every=2,
              pipeline_depth=depth)
    got, port, _ = _both(name, batches, a3=a3, cache_pages=32, **kw)
    assert got == _cold(name, batches, a3=a3, **kw)
    assert port.stats["prefix_hits"] == len(prompts) - 1
    assert port.stats["prefix_tokens_reused"] == 24 * (len(prompts) - 1)
    assert port.stats["pages_recorded"] > 0


def test_prefix_full_hit_reuses_all_but_last_page():
    rng = np.random.default_rng(3)
    p = rng.integers(0, TINY.vocab_size, size=40)
    _, port, _ = _both("tiny", [[p], [p]], slots=1, prefill_chunk=PAGE,
                       page_size=4, cache_pages=32)
    assert port.result(0) == port.result(1)
    assert port.stats["prefix_tokens_reused"] == 36     # floor(39/4)*4
    assert port.stats["prefill_tokens"] == 40 + 4


@pytest.mark.parametrize("name", ["tiny", "tiny-rg", "tiny-xl"])
def test_prefix_partial_hit_mid_page_divergence_cow(name):
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 256, size=24)
    p_a = np.concatenate([shared, rng.integers(0, 256, size=6)])
    p_b = np.concatenate([shared[:20], rng.integers(0, 256, size=9)])
    got, port, _ = _both(name, [[p_a], [p_b, p_a]], slots=2,
                         prefill_chunk=PAGE, page_size=PAGE, cache_pages=32)
    assert got[2] == got[0]                     # the donor's pages intact
    assert port.stats["prefix_tokens_reused"] == 16 + 24


@pytest.mark.parametrize("name,expect_reuse", [
    ("tiny", 32 + 24), ("tiny-rg", 32 + 16), ("tiny-xl", 32 + 16)])
def test_prefix_multipage_chunk_recording(name, expect_reuse):
    rng = np.random.default_rng(29)
    shared = rng.integers(0, 256, size=32)
    p1 = np.concatenate([shared, rng.integers(0, 256, size=5)])
    p2 = np.concatenate([shared, rng.integers(0, 256, size=8)])
    p3 = np.concatenate([shared[:28], rng.integers(0, 256, size=9)])
    ref, port = _pair(name, slots=2, prefill_chunk=16, page_size=PAGE,
                      cache_pages=32)
    outs = []
    for eng in (ref, port):
        first = _serve(eng, [[p1]])
        assert eng.stats["pages_recorded"] == 4     # every crossed page
        outs.append(first + _serve(eng, [[p2, p3]]))
    assert outs[1] == outs[0]
    _same_trie(port, ref)
    assert port.stats["prefix_tokens_reused"] == expect_reuse


def test_prefix_wide_final_chunk_never_records_stale_ring_rows():
    """A 64-token chunk over a 24-row sliding window: every recording
    chunk is clamped to record_span, so the warm hits are real and the
    tokens are JAX's and the cold engine's."""
    rng = np.random.default_rng(31)
    shared = rng.integers(0, 256, size=60)
    p_b = np.concatenate([shared[:32], rng.integers(0, 256, size=9)])
    p_c = np.concatenate([shared[:32], rng.integers(0, 256, size=6)])
    batches = [[shared], [p_b], [p_c]]
    got, port, _ = _both("tiny-rg", batches, slots=1, prefill_chunk=64,
                         page_size=PAGE, cache_pages=32)
    assert port.stats["prefix_hits"] >= 2
    assert got == _cold("tiny-rg", batches, slots=1, prefill_chunk=64)


def _admit_both(port, ref, name, slots, si, probe):
    """Warm-admit ``probe`` into lane ``si`` of fresh caches from both
    engines' tries -> (port cache, JAX cache, matched length)."""
    cfg = CONFIGS[name][0]
    got, t, _ = port._pc.admit(
        tdec.init_cache(port_cfg(cfg), slots, MAX_LEN, device="cpu"), si,
        probe)
    want, t_ref, _ = ref._pc.admit(jdec.init_cache(cfg, slots, MAX_LEN), si,
                                   probe)
    assert t == t_ref
    assert_cache_close(got, jax.tree_util.tree_map(np.asarray, want),
                       **F32_TOL)
    return got, t


def test_prefix_page_wider_than_window_unaligned_chunks():
    """Page 32 over a 24-row window, chunk 20: recording chunks land on
    the crossed boundaries; the restored 64-token prefix is JAX's, leaf
    for leaf, and a cold chunked prefill's."""
    rng = np.random.default_rng(37)
    shared = rng.integers(0, 256, size=72)
    p_b = np.concatenate([shared[:64], rng.integers(0, 256, size=9)])
    ref, port = _pair("tiny-rg", slots=1, prefill_chunk=20, page_size=32,
                      cache_pages=32)
    assert _serve(port, [[shared], [p_b]]) == _serve(ref, [[shared], [p_b]])
    _same_trie(port, ref)
    probe = np.concatenate([shared[:64], rng.integers(0, 256, size=6)])
    restored, t = _admit_both(port, ref, "tiny-rg", 1, 0, probe)
    assert t == 64
    cfg, _, model = _models("tiny-rg")
    cold = tdec.init_cache(port_cfg(cfg), 1, MAX_LEN, device="cpu")
    for cur in range(0, t, 16):
        toks = torch.as_tensor(shared[None, cur:cur + 16], dtype=torch.int32)
        tdec.prefill_chunk(model, port_cfg(cfg), cold, toks, [cur], [16])
    assert_cache_close(restored, cold, rtol=1e-4, atol=1e-4)


def test_prefix_unaligned_cursor_from_adaptive_floor_records_valid_pages():
    """A 6-token adaptive floor leaves the recording cursor unaligned;
    the next chunk realigns at the first boundary (window 12, page 8),
    so the page [0, 8) holds its own rows and its restore is JAX's."""
    rng = np.random.default_rng(43)
    shared = rng.integers(0, 256, size=30)
    short = rng.integers(0, 256, size=5)
    p_b = np.concatenate([shared[:8], rng.integers(0, 256, size=5)])
    ref, port = _pair("tiny-rg-w12", slots=2, prefill_chunk=16,
                      prefill_chunk_min=6, page_size=PAGE, cache_pages=32)
    outs = []
    for eng in (ref, port):
        u0 = eng.submit(short, max_new_tokens=3)
        eng.step()
        assert eng.slots[0].decoding
        ua = eng.submit(shared, max_new_tokens=MAX_NEW)
        eng.run_to_completion()
        assert eng.stats["adaptive_shrink_ticks"] > 0
        ub = eng.submit(p_b, max_new_tokens=MAX_NEW)
        eng.run_to_completion()
        outs.append([eng.result(u) for u in (u0, ua, ub)])
    assert outs[1] == outs[0]
    _same_trie(port, ref)
    probe = np.concatenate([shared[:8], rng.integers(0, 256, size=4)])
    _, t = _admit_both(port, ref, "tiny-rg-w12", 2, 1, probe)
    assert t == 8


def test_prefix_eviction_under_tiny_budget():
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=30) for _ in range(4)]
    _, port, _ = _both("tiny-rg", [prompts], max_new=4, slots=1,
                       prefill_chunk=PAGE, page_size=PAGE, cache_pages=2)
    assert port.stats["pages_evicted"] > 0
    assert port._pc.pages_in_use <= 2


def test_prefix_lru_heap_stays_bounded_under_steady_hits():
    rng = np.random.default_rng(41)
    p = rng.integers(0, 256, size=25)
    _, port, ref = _both("tiny", [[p]], max_new=2, slots=1,
                         prefill_chunk=PAGE, page_size=PAGE, cache_pages=64)
    for pc in (port._pc, ref._pc):
        for _ in range(5000):
            pc.lookup(p)
        assert len(pc._heap) <= 4 * (len(pc._nodes) + 16) + 1
    assert len(port._pc._heap) == len(ref._pc._heap)
    t, node = port._pc.lookup(p)
    assert t > 0 and node.page_id >= 0


def test_prefix_a3_warm_matches_cold():
    """Warm admission restores the sorted columns and ``sorted_upto`` at
    the boundary (no admission re-sort): the same re-sort count as the
    cache-less engine, on both packages."""
    prompts = _shared_prefix_prompts(256, seed=11)
    batches = [prompts[:1], prompts[1:]]
    kw = dict(slots=2, prefill_chunk=PAGE, resort_every=2)
    cold, cold_port, _ = _both("tiny", batches, a3="conservative", **kw)
    warm, port, _ = _both("tiny", batches, a3="conservative",
                          page_size=PAGE, cache_pages=32, **kw)
    assert warm == cold
    assert port.stats["resorts"] == cold_port.stats["resorts"] > 0
    assert port.stats["prefix_hits"] == len(prompts) - 1


def test_prefix_stats_invariant_cold_equals_warm_plus_reused():
    prompts = _shared_prefix_prompts(256, n=4, seed=13)
    batches = [[p] for p in prompts]
    stats = {}
    for label, pages in (("cold", 0), ("warm", 64)):
        _, port, _ = _both("tiny", batches, slots=2, prefill_chunk=PAGE,
                           page_size=PAGE, cache_pages=pages)
        stats[label] = port.stats
    assert stats["cold"]["prefix_tokens_reused"] == 0
    assert stats["warm"]["prefix_tokens_reused"] > 0
    assert stats["cold"]["prefill_tokens"] == \
        stats["warm"]["prefill_tokens"] + stats["warm"]["prefix_tokens_reused"]


def test_prefix_flash_crowd_batched_admission_one_dispatch():
    """Three same-prefix arrivals on one tick are restored by one
    ``gather_into``: ``gather_dispatches`` counts 1, not 3."""
    prompts = _shared_prefix_prompts(256, n=4, seed=17)
    ref, port = _pair("tiny", slots=3, prefill_chunk=PAGE, page_size=PAGE,
                      cache_pages=64)
    outs = []
    for eng in (ref, port):
        first = _serve(eng, [prompts[:1]])
        assert eng.stats["gather_dispatches"] == 0
        uids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts[1:]]
        eng.step()
        assert eng.stats["prefix_hits"] == 3
        assert eng.stats["gather_dispatches"] == 1
        eng.run_to_completion()
        outs.append(first + [eng.result(u) for u in uids])
    assert outs[1] == outs[0]
    _same_trie(port, ref)
    assert outs[1] == _cold("tiny", [prompts[:1], prompts[1:]], slots=3,
                            prefill_chunk=PAGE)


# ---------------------------------------------------------------------------
# the gather restores exactly the cold-prefill cache
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_chunk(name):
    cfg = CONFIGS[name][0]
    return jax.jit(lambda p, c, t, pos, n: jdec.prefill_chunk(p, cfg, c, t,
                                                              pos, n))


@pytest.mark.parametrize("name", ["tiny", "tiny-rg", "tiny-xl"])
def test_prefix_gather_restores_cache_like_cold_prefill(name):
    """Both caches record a prompt from lane 0 with page-aligned chunks,
    then restore its 16-token prefix into lane 1 of a fresh cache: lane
    1 equals JAX's restore and the port's cold chunked prefill of the
    prefix, leaf for leaf."""
    cfg, params, model = _models(name)
    tcfg = port_cfg(cfg)
    rng = np.random.default_rng(17)
    p = rng.integers(0, 256, size=26)
    ps, t = PAGE, 16
    jpc = JaxPrefixCache(cfg, max_len=MAX_LEN, page_size=ps, cache_pages=8)
    tpc = PrefixCache(tcfg, max_len=MAX_LEN, page_size=ps, cache_pages=8,
                      device="cpu")
    jc = jdec.init_cache(cfg, 2, MAX_LEN)
    tc = tdec.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    jnode, tnode = jpc.root, tpc.root
    for cur in range(0, len(p), ps):
        take = min(ps, len(p) - cur)
        toks = np.zeros((2, ps), np.int32)
        toks[0, :take] = p[cur:cur + take]
        _, jc = _jax_chunk(name)(params, jc, jnp.asarray(toks),
                                 jnp.asarray([cur, 0], jnp.int32),
                                 jnp.asarray([take, 0], jnp.int32))
        tdec.prefill_chunk(model, tcfg, tc, torch.as_tensor(toks),
                           [cur, 0], [take, 0])
        if (cur + take) % ps == 0:
            jnode = jpc.record_boundary(jc, 0, p, cur + take, jnode)
            tnode = tpc.record_boundary(tc, 0, p, cur + take, tnode)
            assert tnode is not None
    got, got_t, _ = tpc.admit(tdec.init_cache(tcfg, 2, MAX_LEN,
                                              device="cpu"), 1, p[:t + 1])
    want, _, _ = jpc.admit(jdec.init_cache(cfg, 2, MAX_LEN), 1, p[:t + 1])
    assert got_t == t
    assert_cache_close(got, jax.tree_util.tree_map(np.asarray, want),
                       **F32_TOL)
    cold = tdec.init_cache(tcfg, 2, MAX_LEN, device="cpu")
    for cur in range(0, t, ps):
        toks = np.zeros((2, ps), np.int32)
        toks[1] = p[cur:cur + ps]
        tdec.prefill_chunk(model, tcfg, cold, torch.as_tensor(toks),
                           [0, cur], [0, ps])
    for seg, sc in cold.items():
        for leaf, want_leaf in sc.items():
            np.testing.assert_allclose(got[seg][leaf][:, 1].numpy(),
                                       want_leaf[:, 1].numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{seg}.{leaf}")


# ---------------------------------------------------------------------------
# snapshots are copies; refcounts return to baseline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,a3", [("tiny", "conservative"),
                                     ("tiny-rg", "off"), ("tiny-xl", "off")])
def test_prefix_recording_slot_keeps_decoding_while_another_warm_admits(
        name, a3):
    """Record a prompt, keep its slot decoding (its rings, carries and
    A^3 sorted columns go on changing: re-sorts every 2 steps), and only
    then warm-admit a second request from its pages, carry snapshots and
    leaf snapshot. A snapshot taken as a view of the live cache would
    hand the second request the first one's later state."""
    prompts = _shared_prefix_prompts(256, n=2, seed=19)
    ref, port = _pair(name, a3=a3, slots=2, prefill_chunk=PAGE,
                      page_size=PAGE, cache_pages=64, resort_every=2)
    outs = []
    for eng in (ref, port):
        u0 = eng.submit(prompts[0], max_new_tokens=24)
        while not eng.slots[0].decoding:
            eng.step()
        for _ in range(6):                      # the recorder decodes on
            eng.step()
        u1 = eng.submit(prompts[1], max_new_tokens=MAX_NEW)
        eng.run_to_completion()
        assert eng.stats["prefix_hits"] == 1
        outs.append([eng.result(u0), eng.result(u1)])
    assert outs[1] == outs[0]
    _same_trie(port, ref)
    assert outs[1][1] == _cold(name, [prompts[1:]], a3=a3, slots=2,
                               prefill_chunk=PAGE, resort_every=2)[0]


def test_lifecycle_refcount_audit_after_mixed_terminals():
    """After a finish, a cancel mid-prefill, an expiry mid-decode and a
    cancel while queued, no trie node is pinned and the whole pool is
    evictable, on both engines alike."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 256, size=31).astype(np.int32)
    ref, port = _pair("tiny", slots=2, prefill_chunk=8, page_size=8,
                      cache_pages=12)
    for eng in (ref, port):
        u0 = eng.submit(shared, max_new_tokens=3)
        eng.run_to_completion()
        assert eng.status(u0) == "finished"
        u1 = eng.submit(np.concatenate([shared, shared])[:48],
                        max_new_tokens=3)
        eng.step()
        assert eng.status(u1) == "prefilling"
        assert eng.cancel(u1)
        u2 = eng.submit(shared[:16], max_new_tokens=40, deadline_ticks=2)
        eng.run_to_completion()
        assert eng.status(u2) == "expired"
        u3 = eng.submit(shared, max_new_tokens=3)
        assert eng.cancel(u3)
    _same_trie(port, ref)
    pc = port._pc
    assert pc.referenced_nodes == 0
    assert len(pc) > 0 and pc.pages_in_use > 0
    got = [pc._alloc_page() for _ in range(pc.capacity)]
    assert sorted(got) == list(range(pc.capacity))
    assert len(pc) == 0


# ---------------------------------------------------------------------------
# adaptive prefill chunking
# ---------------------------------------------------------------------------

def test_prefix_adaptive_chunk_shrinks_under_decode_load():
    rng = np.random.default_rng(23)
    short = rng.integers(0, 256, size=6)
    long_p = rng.integers(0, 256, size=64)
    ref, port = _pair("tiny", slots=2, prefill_chunk=32, prefill_chunk_min=8)
    outs = []
    for eng in (ref, port):
        us = eng.submit(short, max_new_tokens=16)
        eng.step()
        assert eng.stats["adaptive_shrink_ticks"] == 0
        assert eng.slots[0].decoding
        ul = eng.submit(long_p, max_new_tokens=MAX_NEW)
        eng.run_to_completion()
        assert eng.stats["adaptive_shrink_ticks"] == 8
        outs.append([eng.result(us), eng.result(ul)])
    assert outs[1] == outs[0]
    assert_same_stats(port, ref, PREFIX_STATS)


def test_prefix_adaptive_chunk_cold_queue_uses_full_chunk():
    rng = np.random.default_rng(25)
    p = rng.integers(0, 256, size=64)
    ref, port = _pair("tiny", slots=2, prefill_chunk=32, prefill_chunk_min=8)
    outs = []
    for eng in (ref, port):
        u = eng.submit(p, max_new_tokens=8)
        eng.step()
        eng.step()
        assert eng.slots[0].decoding
        assert eng.stats["prefill_dispatches"] == 2
        assert eng.stats["adaptive_shrink_ticks"] == 0
        eng.run_to_completion()
        outs.append(eng.result(u))
    assert outs[1] == outs[0]
    assert_same_stats(port, ref, PREFIX_STATS)


# ---------------------------------------------------------------------------
# config validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"slots": 0}, {"max_len": 0}, {"prefill_chunk": 0}, {"prefill_chunk": -3},
    {"prefill_chunk_min": 0}, {"prefill_chunk": 16, "prefill_chunk_min": 32},
    {"decode_block": 0}, {"page_size": 0}, {"cache_pages": -1},
    {"temperature": -0.5}])
def test_prefix_serveconfig_rejects_nonsense(kw):
    with pytest.raises(ValueError):
        JaxServeConfig(**kw)
    with pytest.raises(ValueError):
        ServeConfig(**kw)


def test_prefix_engine_rejects_bad_cache_knobs():
    _, _, model = _models("tiny")
    cfg = port_cfg(TINY)
    with pytest.raises(ValueError):
        ServeEngine(model, cfg, slots=1, max_len=32, page_size=0,
                    cache_pages=4)
    with pytest.raises(ValueError):
        ServeEngine(model, cfg, slots=1, max_len=32, cache_pages=-1)
    with pytest.raises(ValueError):
        ServeEngine(model, cfg, slots=1, max_len=32, prefill_chunk=8,
                    prefill_chunk_min=16)
    with pytest.raises(ValueError):
        PrefixCache(cfg, max_len=32, page_size=8, cache_pages=0,
                    device="cpu")
    eng = ServeEngine(model, cfg, slots=1, max_len=32, prefill_chunk=8)
    assert eng._pc is None
    with pytest.raises(ValueError):
        eng.submit(np.asarray([], np.int32))


def test_pool_defaults_to_the_card():
    """The pool follows the model's device: ``init_page_pool`` and a
    standalone ``PrefixCache`` default to CUDA, which raises without a
    card (no silent CPU pool); the engine's pool is on the model's
    device."""
    cfg = port_cfg(TINY)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdec.init_page_pool(cfg, 4, PAGE)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PrefixCache(cfg, max_len=MAX_LEN, page_size=PAGE, cache_pages=4)
    _, _, model = _models("tiny")
    eng = ServeEngine(model, cfg, slots=1, max_len=MAX_LEN, page_size=PAGE,
                      cache_pages=4, kv_quant="int8")
    assert all(t.device == model.device for seg in eng._pc.pool.values()
               for t in seg.values())
