"""The port's crash-consistent checkpoint and restore: the cases of
``tests/test_serve_checkpoint.py`` on the port's engine, held against
the JAX engine's uninterrupted run (the same weights converted through
numpy, the same prompts, float32).

Coverage: a mid-stream checkpoint (requests queued, prefilling and
decoding) restored into a fresh engine on all four mixer kinds
(attention, A^3, RG-LRU hybrid, xLSTM): every token equals the JAX
engine's uninterrupted tokens, the restored cache equals the
checkpointed one bit for bit, and the final counters (``ENGINE_STATS``,
prefix and L2 keys) equal the JAX run's; sampling at T > 0 continues the
same stream; the chaos ``crash`` site with per-tick checkpoints, restore
and continue, on both engines with equal crash events; ``EngineCrash``
leaves ``run_to_completion``; ``CheckpointError`` on a flipped state
byte, a truncated ``arrays.bin``, another model, another A^3 mode, a
missing directory and another cache shape; the ``.old`` fallback; the
round trip of statuses, queue, results, stats and L2 blobs.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import A3Config  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serve.chaos import ChaosConfig as JaxChaosConfig, \
    ChaosInjector as JaxChaos, EngineCrash as JaxCrash  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.chaos import ChaosConfig, ChaosInjector, \
    EngineCrash  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.page_store import CheckpointError  # noqa: E402

from test_torch_helpers import ENGINE_STATS, TINY, TINY_RG, TINY_XL, \
    assert_same_stats, check_conservation, port_a3, port_cfg  # noqa: E402

torch.set_num_threads(1)

MAX_LEN = 96
MAX_NEW = 6
ALL_STATS = ENGINE_STATS + ("prefix_hits", "prefix_tokens_reused",
                            "gather_dispatches", "pages_recorded",
                            "pages_evicted", "l2_spills", "l2_hits",
                            "l2_evictions", "l2_integrity_drops")
CONFIGS = {"tiny": (TINY, 0), "tiny-rg": (TINY_RG, 1),
           "tiny-xl": (TINY_XL, 2)}
KINDS = {"attention": ("tiny", "off"), "a3": ("tiny", "conservative"),
         "rglru": ("tiny-rg", "off"), "xlstm": ("tiny-xl", "off")}
KW = dict(slots=2, max_len=MAX_LEN, prefill_chunk=8, page_size=8,
          cache_pages=24, l2_bytes=1 << 22)


@functools.lru_cache(maxsize=None)
def _models(name):
    cfg, seed = CONFIGS[name]
    params = jdec.init_params(jax.random.PRNGKey(seed), cfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(cfg), device="cpu")
    return cfg, params, model


def _a3(mode):
    return A3Config() if mode == "off" else A3Config.conservative()


def _prompts(vocab, seed=7, n=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=24)
    return [np.concatenate([shared, rng.integers(0, vocab, size=4 + 3 * i)])
            for i in range(n)]


def _port(name, a3="off", **kw):
    cfg, _, model = _models(name)
    return ServeEngine(model, port_cfg(cfg), a3=port_a3(_a3(a3)), **kw)


def _restore(path, name, a3="off", **kw):
    cfg, _, model = _models(name)
    return ServeEngine.restore(path, model, port_cfg(cfg),
                               a3=port_a3(_a3(a3)), **kw)


@functools.lru_cache(maxsize=None)
def _jax_free(name, a3, n=3, **kw):
    """The JAX engine's uninterrupted run -> (tokens, engine)."""
    cfg, params, _ = _models(name)
    eng = JaxEngine(params, cfg, a3=_a3(a3), **(KW | dict(kw)))
    uids = [eng.submit(p, MAX_NEW) for p in _prompts(cfg.vocab_size, n=n)]
    eng.run_to_completion()
    return [eng.result(u) for u in uids], eng


def _same_cache(a, b):
    """Leaf for leaf the same dtype and the same values."""
    assert set(a) == set(b)
    for seg, sc in a.items():
        assert set(sc) == set(b[seg])
        for k, t in sc.items():
            assert t.dtype == b[seg][k].dtype
            assert torch.equal(t, b[seg][k]), (seg, k)


# ---------------------------------------------------------------------------
# mid-stream restore: token parity across all four mixer kinds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_checkpoint_restore_midstream_token_parity(tmp_path, kind):
    name, a3 = KINDS[kind]
    free, ref = _jax_free(name, a3)
    eng = _port(name, a3, **KW)
    uids = [eng.submit(p, MAX_NEW)
            for p in _prompts(CONFIGS[name][0].vocab_size)]
    # mid-flight: slots prefilling / decoding, one request still queued
    for _ in range(3):
        eng.step()
    assert {eng.status(u) for u in uids} >= {"queued"}
    ck = str(tmp_path / "ckpt")
    eng.checkpoint(ck)
    restored = _restore(ck, name, a3)
    _same_cache(restored.cache, eng.cache)
    assert restored._pc.pages_in_use == eng._pc.pages_in_use
    assert restored._pc.referenced_nodes == eng._pc.referenced_nodes
    restored.run_to_completion()
    for u, want in zip(uids, free):
        assert restored.status(u) == "finished"
        assert restored.result(u) == want
    assert_same_stats(restored, ref, ALL_STATS)
    # the original continues identically (a checkpoint only reads)
    eng.run_to_completion()
    assert [eng.result(u) for u in uids] == free
    assert restored.stats["restores"] == 1
    assert restored._pc.referenced_nodes == 0


def test_checkpoint_restore_preserves_sampling_stream(tmp_path):
    """T > 0: the restored engine rebuilds the same key from the saved
    seed, so the tempered stream continues exactly (held against the
    JAX engine's uninterrupted draws)."""
    kw = dict(slots=2, max_len=MAX_LEN, prefill_chunk=8, temperature=0.8,
              sample_seed=5)
    cfg, params, _ = _models("tiny")
    prompts = _prompts(TINY.vocab_size, n=2)
    ref = JaxEngine(params, cfg, **kw)
    ruids = [ref.submit(p, MAX_NEW) for p in prompts]
    ref.run_to_completion()
    eng = _port("tiny", **kw)
    uids = [eng.submit(p, MAX_NEW) for p in prompts]
    for _ in range(4):
        eng.step()
    ck = str(tmp_path / "ckpt")
    eng.checkpoint(ck)
    restored = _restore(ck, "tiny")
    restored.run_to_completion()
    assert [restored.result(u) for u in uids] == \
        [ref.result(u) for u in ruids]


# ---------------------------------------------------------------------------
# chaos crash -> restore -> continue
# ---------------------------------------------------------------------------

def _crash_loop(make, restore, prompts, ck, chaos):
    """Per-tick checkpoints; on EngineCrash restore chaos-free and go
    on -> (tokens, crashes, the last engine)."""
    eng = make(chaos)
    uids = [eng.submit(p, MAX_NEW) for p in prompts]
    eng.checkpoint(ck)
    crashes = 0
    while eng.in_flight > 0:
        try:
            eng.step()
            eng.checkpoint(ck)
        except (EngineCrash, JaxCrash):
            crashes += 1
            eng = restore(ck)
    for u in uids:
        assert eng.status(u) == "finished"
    return [eng.result(u) for u in uids], crashes, eng


@pytest.mark.parametrize("kind", list(KINDS))
def test_checkpoint_crash_mid_tick_continuation(tmp_path, kind):
    """Kill the engine mid-tick at a pinned (seed, rate) schedule,
    restore from the last per-tick checkpoint, continue: both engines
    crash at the same phases and end with the crash-free tokens."""
    name, a3 = KINDS[kind]
    cfg, params, _ = _models(name)
    free, _ = _jax_free(name, a3)
    prompts = _prompts(cfg.vocab_size)
    knobs = dict(seed=3, rate=0.3, corrupt_logits=False, fail_gather=False,
                 raise_mid_tick=False, crash_mid_tick=True)
    jchaos, tchaos = JaxChaos(JaxChaosConfig(**knobs)), \
        ChaosInjector(ChaosConfig(**knobs))
    jck, tck = str(tmp_path / "jax"), str(tmp_path / "port")
    want, jcrashes, ref = _crash_loop(
        lambda ch: JaxEngine(params, cfg, a3=_a3(a3), chaos=ch, **KW),
        lambda ck: JaxEngine.restore(ck, params, cfg, a3=_a3(a3)),
        prompts, jck, jchaos)
    got, crashes, eng = _crash_loop(
        lambda ch: _port(name, a3, chaos=ch, **KW),
        lambda ck: _restore(ck, name, a3), prompts, tck, tchaos)
    assert crashes >= 1, "the pinned schedule must crash at least once"
    assert tchaos.events == jchaos.events
    assert got == want == free
    assert eng.stats["restores"] >= crashes
    assert_same_stats(eng, ref, ALL_STATS + ("restores", "checkpoints"))


def test_checkpoint_crash_propagates_out_of_run_to_completion():
    """EngineCrash is not absorbed as a tick abort is: process death has
    no in-process recovery."""
    chaos = ChaosInjector(ChaosConfig(seed=0, rate=1.0,
                                      corrupt_logits=False,
                                      fail_gather=False,
                                      raise_mid_tick=False,
                                      crash_mid_tick=True))
    eng = _port("tiny", slots=1, max_len=MAX_LEN, prefill_chunk=8,
                chaos=chaos)
    eng.submit(_prompts(TINY.vocab_size, n=1)[0], 2)
    with pytest.raises(EngineCrash):
        eng.run_to_completion()


# ---------------------------------------------------------------------------
# torn / mismatched checkpoints fail loudly; .old fallback
# ---------------------------------------------------------------------------

def test_checkpoint_corruption_raises_never_resumes_wrong(tmp_path):
    kw = dict(slots=1, max_len=MAX_LEN, prefill_chunk=8, page_size=8,
              cache_pages=16)
    eng = _port("tiny", **kw)
    eng.submit(_prompts(TINY.vocab_size, n=1)[0], MAX_NEW)
    eng.step()
    ck = str(tmp_path / "ckpt")
    eng.checkpoint(ck)
    cfg, _, model = _models("tiny")
    pcfg = port_cfg(cfg)

    def restore(c=pcfg, a3=None):
        return ServeEngine.restore(ck, model, c, a3=a3 or port_a3(A3Config()))

    # flipped byte in state.json -> checksum mismatch
    sp = os.path.join(ck, "state.json")
    raw = open(sp, "rb").read()
    open(sp, "wb").write(raw[:-2] + bytes([raw[-2] ^ 0xFF]) + raw[-1:])
    with pytest.raises(CheckpointError, match="checksum"):
        restore()
    open(sp, "wb").write(raw)
    # truncated arrays.bin -> IntegrityError surfaced as CheckpointError
    ap = os.path.join(ck, "arrays.bin")
    araw = open(ap, "rb").read()
    open(ap, "wb").write(araw[:-7])
    with pytest.raises(CheckpointError):
        restore()
    open(ap, "wb").write(araw)
    # another model / another A^3 mode -> refused, not garbled
    with pytest.raises(CheckpointError, match="tiny2"):
        restore(dataclasses.replace(pcfg, name="tiny2"))
    with pytest.raises(CheckpointError, match="A\\^3 mode"):
        restore(a3=port_a3(A3Config.conservative()))
    # a missing directory
    with pytest.raises(CheckpointError):
        ServeEngine.restore(str(tmp_path / "nowhere"), model, pcfg)
    # a state whose engine echo builds another cache shape (checksum
    # rewritten): the arrays do not fit, and restore says so
    state = json.loads(raw.split(b"\n", 1)[1])
    state["engine"]["max_len"] = MAX_LEN + 8
    body = json.dumps(state, sort_keys=True).encode()
    open(sp, "wb").write(b"%d\n" % zlib.crc32(body) + body)
    with pytest.raises(CheckpointError, match="cache/seg0"):
        restore()
    open(sp, "wb").write(raw)
    # the intact checkpoint still restores after the vandalism
    restore().run_to_completion()


def test_checkpoint_interrupted_commit_falls_back_to_old(tmp_path):
    """A crash between the two commit renames leaves only ``.old``:
    restore picks up the previous complete checkpoint."""
    kw = dict(slots=1, max_len=MAX_LEN, prefill_chunk=8)
    cfg, params, _ = _models("tiny")
    prompts = _prompts(TINY.vocab_size, n=2)
    ref = JaxEngine(params, cfg, **kw)
    ruids = [ref.submit(p, MAX_NEW) for p in prompts]
    ref.run_to_completion()
    eng = _port("tiny", **kw)
    uids = [eng.submit(p, MAX_NEW) for p in prompts]
    eng.step()
    ck = str(tmp_path / "ckpt")
    eng.checkpoint(ck)
    os.rename(ck, ck + ".old")
    restored = _restore(ck, "tiny")
    restored.run_to_completion()
    assert [restored.result(u) for u in uids] == \
        [ref.result(u) for u in ruids]


# ---------------------------------------------------------------------------
# bookkeeping round trip
# ---------------------------------------------------------------------------

def test_checkpoint_preserves_statuses_queue_results_and_l2(tmp_path):
    prompts = _prompts(TINY.vocab_size, n=4)
    eng = _port("tiny", slots=1, max_len=MAX_LEN, prefill_chunk=8,
                page_size=8, cache_pages=24, l2_bytes=1 << 22)
    u_done = eng.submit(prompts[0], 3)
    eng.run_to_completion()
    done_toks = eng.result(u_done)
    u_cancel = eng.submit(prompts[1], 3)
    assert eng.cancel(u_cancel)
    eng._pc.spill(10 ** 6)              # park blobs in L2
    assert len(eng._pc.l2) > 0
    # the in-flight pair must not share the spilled prefix, or admission
    # would promote the blobs back before the checkpoint
    fresh = _prompts(TINY.vocab_size, seed=11, n=2)
    u_a, u_b = eng.submit(fresh[0], 3), eng.submit(fresh[1], 3)
    eng.step()
    n_blobs = len(eng._pc.l2)
    assert n_blobs > 0
    ck = str(tmp_path / "ckpt")
    eng.checkpoint(ck)
    restored = _restore(ck, "tiny")
    assert restored.status(u_done) == "finished"
    assert restored.result(u_done) == done_toks
    assert restored.status(u_cancel) == "cancelled"
    assert restored.in_flight == eng.in_flight == 2
    assert restored.status(u_a) == eng.status(u_a)
    assert restored.status(u_b) == eng.status(u_b)
    assert [r.uid for r in restored._queue] == [r.uid for r in eng._queue]
    # L2 blobs survive byte for byte (they carry their own checksums)
    assert len(restored._pc.l2) == n_blobs
    assert dict(restored._pc.l2.raw_items()) == dict(eng._pc.l2.raw_items())
    for key in ENGINE_STATS + ("l2_spills", "pages_recorded",
                               "pages_evicted"):
        assert restored.stats[key] == eng.stats[key], key
    check_conservation(restored)
    restored.run_to_completion()
    assert restored.status(u_a) == restored.status(u_b) == "finished"
