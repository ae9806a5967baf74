"""The port's host-RAM L2 page tier against the JAX one: the cases of
``tests/test_serve_l2_store.py:204-306`` run on both engines with the
same weights (converted through numpy) and the same prompts, float32 and
greedy. Every case asserts equal tokens, equal counters (``ENGINE_STATS``,
the five prefix keys and the four ``l2_*`` keys) and an equal trie
(``len``, ``pages_in_use``, ``referenced_nodes``); the L2 stores hold the
same keys with blobs of the same sizes.

Coverage: spill -> promote warm == cold across the mixer kinds
(attention, RG-LRU hybrid, xLSTM) and the A^3 path (sorted-key leaf
snapshots survive the round trip); the int8 pool (quantized pages and
scales in one blob, warm = the int8 cold serve); a corrupted blob
degrades to cold prefill with no token divergence and leaks nothing; a
small byte budget loses entries, never correctness. Added for the port:
eviction under the page budget demotes on its own (no forced spill) and a
later lookup promotes; a blob whose manifest lacks ``meta`` degrades (an
integrity drop) while a device-side error in the insert propagates; a
demotion reads the card once per node. The 8-device case of the
reference file is mesh-only and stays out.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import A3Config  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import prefix_cache as tpc  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.page_store import serialize_tree  # noqa: E402

from test_torch_helpers import ENGINE_STATS, TINY, TINY_RG, TINY_XL, \
    assert_engine_invariants, assert_same_stats, port_a3, port_cfg  # noqa: E402,E501

torch.set_num_threads(1)

MAX_LEN = 96
MAX_NEW = 6
PAGE = 8
L2_BIG = 1 << 24
L2_STATS = ENGINE_STATS + ("prefix_hits", "prefix_tokens_reused",
                           "gather_dispatches", "pages_recorded",
                           "pages_evicted", "l2_spills", "l2_hits",
                           "l2_evictions", "l2_integrity_drops")
CONFIGS = {"tiny": (TINY, 0), "tiny-rg": (TINY_RG, 1),
           "tiny-xl": (TINY_XL, 2)}


@functools.lru_cache(maxsize=None)
def _models(name):
    cfg, seed = CONFIGS[name]
    params = jdec.init_params(jax.random.PRNGKey(seed), cfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(cfg), device="cpu")
    return cfg, params, model


def _a3(mode):
    return A3Config() if mode == "off" else A3Config.conservative()


def _prompts(vocab, *, shared_len=24, n=3, seed=7):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=shared_len)
    return [np.concatenate([shared, rng.integers(0, vocab, size=4 + 3 * i)])
            for i in range(n)]


def _pair(name, *, a3="off", **kw):
    cfg, params, model = _models(name)
    kw = {"max_len": MAX_LEN, "slots": 1, "prefill_chunk": 8,
          "page_size": PAGE, **kw}
    return (JaxEngine(params, cfg, a3=_a3(a3), **kw),
            ServeEngine(model, port_cfg(cfg), a3=port_a3(_a3(a3)), **kw))


def _serve(eng, prompts):
    out = []
    for p in prompts:
        u = eng.submit(p, max_new_tokens=MAX_NEW)
        eng.run_to_completion()
        out.append(eng.result(u))
    return out


def _together(eng, prompts):
    uids = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run_to_completion()
    return [eng.result(u) for u in uids]


def _same(port, ref):
    assert_same_stats(port, ref, L2_STATS)
    for got, want in ((len(port._pc), len(ref._pc)),
                      (port._pc.pages_in_use, ref._pc.pages_in_use),
                      (port._pc.referenced_nodes, ref._pc.referenced_nodes)):
        assert got == want
    if ref._pc.l2 is not None:
        sizes = lambda st: {k: len(b) for k, b in st.raw_items()}  # noqa
        assert sizes(port._pc.l2) == sizes(ref._pc.l2)
    assert_engine_invariants(port)


def _cold(name, prompts, *, a3="off", **kw):
    """The port's tokens with no prefix cache."""
    cfg, _, model = _models(name)
    eng = ServeEngine(model, port_cfg(cfg), a3=port_a3(_a3(a3)),
                      max_len=MAX_LEN, slots=1, prefill_chunk=8, **kw)
    return _serve(eng, prompts)


def _spill_and_serve(ref, port, prompts, corrupt=False):
    """Serve ``prompts[0]``, force-demote the whole trie, optionally
    corrupt every blob, then serve the rest -> the port's tokens (equal
    to the JAX engine's)."""
    want = _serve(ref, prompts[:1])
    got = _serve(port, prompts[:1])
    assert got == want
    n = ref._pc.spill(10 ** 6)
    assert port._pc.spill(10 ** 6) == n > 0
    assert len(port._pc.l2) == len(ref._pc.l2) > 0
    if corrupt:
        for pc in (ref._pc, port._pc):
            for k in list(pc.l2.keys()):
                assert pc.l2.corrupt(k)
    want += _serve(ref, prompts[1:])
    got += _serve(port, prompts[1:])
    assert got == want
    _same(port, ref)
    return got


# ---------------------------------------------------------------------------
# tests/test_serve_l2_store.py:204-306 on both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "tiny-rg", "tiny-xl"],
                         ids=["attention", "rglru", "xlstm"])
def test_l2_spill_promote_matches_cold_across_kinds(name):
    cfg = CONFIGS[name][0]
    prompts = _prompts(cfg.vocab_size)
    ref, port = _pair(name, cache_pages=32, l2_bytes=L2_BIG)
    got = _spill_and_serve(ref, port, prompts)
    assert got == _cold(name, prompts)
    assert port.stats["l2_hits"] > 0
    assert port.stats["l2_integrity_drops"] == 0
    assert port.stats["prefix_tokens_reused"] > 0
    assert port._pc.referenced_nodes == 0


def test_l2_spill_promote_matches_cold_a3():
    prompts = _prompts(TINY.vocab_size, shared_len=32)
    ref, port = _pair("tiny", a3="conservative", cache_pages=32,
                      l2_bytes=L2_BIG)
    got = _spill_and_serve(ref, port, prompts)
    assert got == _cold("tiny", prompts, a3="conservative")
    assert port.stats["l2_hits"] > 0
    assert port.stats["l2_integrity_drops"] == 0
    # the leaf's sorted-key snapshot came back with its budget pages
    assert any(n.sk_snap is not None for n in port._pc._nodes)


def test_l2_int8_pool_survives_round_trip():
    """int8 pool: quantized pages and per-page scales demote and promote
    as one blob, and the warm path matches the int8 cold serve."""
    prompts = _prompts(TINY.vocab_size)
    ref, port = _pair("tiny", cache_pages=32, kv_quant="int8",
                      l2_bytes=L2_BIG)
    got = _spill_and_serve(ref, port, prompts)
    assert got == _cold("tiny", prompts, kv_quant="int8")
    assert port.stats["l2_hits"] > 0
    assert port.stats["l2_integrity_drops"] == 0


def test_l2_corrupt_blob_degrades_to_cold_prefill_no_divergence():
    prompts = _prompts(TINY.vocab_size)
    ref, port = _pair("tiny", cache_pages=32, l2_bytes=L2_BIG)
    got = _spill_and_serve(ref, port, prompts, corrupt=True)
    assert got == _cold("tiny", prompts)
    assert port.stats["l2_integrity_drops"] >= 1
    assert port.stats["l2_hits"] == 0
    # nothing leaked: refs at baseline, the FULL pool drainable, and no
    # blob survives for a node that was dropped
    pc = port._pc
    assert pc.referenced_nodes == 0
    got_pages = [pc._alloc_page() for _ in range(pc.capacity)]
    assert sorted(got_pages) == list(range(pc.capacity))
    assert len(pc) == 0


def test_l2_budget_eviction_loses_entries_not_correctness():
    """A small L2 byte budget: blobs get LRU-evicted from the store,
    later admissions cold-prefill; tokens never change."""
    prompts = _prompts(TINY.vocab_size)
    ref, port = _pair("tiny", cache_pages=32, l2_bytes=1 << 14)
    for eng in (ref, port):
        [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        eng.run_to_completion()
    assert port._pc.spill(10 ** 6) == ref._pc.spill(10 ** 6) > 0
    assert port._pc.l2.bytes_used <= port._pc.l2.max_bytes
    want, got = _serve(ref, prompts), _serve(port, prompts)
    assert got == want == _cold("tiny", prompts)
    assert [port.result(u) for u in range(3)] == \
        [ref.result(u) for u in range(3)]
    assert port.stats["l2_evictions"] > 0
    _same(port, ref)


# ---------------------------------------------------------------------------
# added for the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,a3", [("tiny", "off"), ("tiny", "conservative"),
                                     ("tiny-rg", "off"), ("tiny-xl", "off")])
def test_l2_budget_pressure_demotes_and_promotes(name, a3):
    """No forced spill: a page budget smaller than two prompts' chains
    makes the second prompt's recording demote the first's pages, and
    the first prompt's return promotes them (the eviction path, at 2
    slots, as phase [11a] of chip_smoke.py drives it at full width)."""
    cfg = CONFIGS[name][0]
    rng = np.random.default_rng(11)
    heads = [rng.integers(0, cfg.vocab_size, size=40) for _ in range(2)]
    prompts = [np.concatenate([heads[i % 2], rng.integers(
        0, cfg.vocab_size, size=5)]) for i in range(6)]
    ref, port = _pair(name, a3=a3, slots=2, cache_pages=8 if a3 == "off"
                      else 24, l2_bytes=L2_BIG)
    want = _serve(ref, prompts[:2]) + _together(ref, prompts[2:])
    got = _serve(port, prompts[:2]) + _together(port, prompts[2:])
    assert got == want
    assert port.stats["l2_spills"] > 0 and port.stats["l2_hits"] > 0
    assert port.stats["l2_integrity_drops"] == 0
    assert port._pc.demote_reads == port.stats["l2_spills"]
    _same(port, ref)


def test_l2_blob_without_meta_degrades_and_runtime_errors_propagate(
        monkeypatch):
    """``_promote`` catches payload faults only: a blob whose manifest
    lacks ``meta`` (a KeyError from the tree) is an integrity drop and the
    request prefills cold; an error of the insert itself (standing in for
    a device fault) propagates out of the engine."""
    prompts = _prompts(TINY.vocab_size)
    _, _, model = _models("tiny")
    cold = _cold("tiny", prompts)

    def engine():
        eng = ServeEngine(model, port_cfg(TINY), max_len=MAX_LEN, slots=1,
                          prefill_chunk=8, page_size=PAGE, cache_pages=32,
                          l2_bytes=L2_BIG)
        assert _serve(eng, prompts[:1]) == cold[:1]
        assert eng._pc.spill(10 ** 6) > 0
        return eng

    eng = engine()
    from repro_torch.serve.page_store import deserialize_tree
    for key, blob in list(eng._pc.l2.raw_items()):
        tree = deserialize_tree(blob)
        del tree["meta"]
        eng._pc.l2._blobs[key] = serialize_tree(tree)
    assert _serve(eng, prompts[1:2]) == cold[1:2]
    assert eng.stats["l2_integrity_drops"] == 1
    assert eng.stats["l2_hits"] == 1 and eng._pc.referenced_nodes == 0

    eng = engine()

    def broken(self, pid, page):
        raise RuntimeError("device fault in the pool insert")

    monkeypatch.setattr(tpc.PrefixCache, "_insert_page", broken)
    eng.submit(prompts[1], max_new_tokens=MAX_NEW)
    with pytest.raises(RuntimeError, match="device fault"):
        eng.step()
