"""Windowed attention in the port vs the JAX package, float32: sliding
windows whose rings wrap, and a local/global pattern where A^3 runs on
the global layers only.

* ``TINY_SWA`` (window 16): the conformance suite's three ring-wrap
  cases (``tests/test_serve_conformance.py``: prompts of 24 / 30 / 16
  tokens in chunks of 20 / 7 / 16; a chunk longer than the ring lands
  only its last 16 rows) on the port, logits and caches leaf for leaf
  within 1e-5 against the JAX whole-prompt prefill; then decode steps
  that keep wrapping the ring;
* ``TINY_LG`` (4 layers, pattern 1, window 16: local, global, local,
  global): each layer a segment, the sort leaves (``sk_vals``,
  ``sk_rows``, ``sorted_upto``) on the global segments only; prefill,
  ragged chunks, decode steps with A^3 conservative and a decode block
  with re-sorts against JAX, caches leaf for leaf (sorted rows and
  watermarks exactly).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import A3Config  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import mixer as tmixer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from test_torch_helpers import TINY_LG, TINY_SWA, N, T, \
    assert_cache_close, cache_to_torch, port_a3, port_cfg  # noqa: E402

torch.set_num_threads(1)

WRAP_TOL = 1e-5
TOL = 2e-5
MAX_LEN = 32


def _setup(cfg):
    params = jdec.init_params(jax.random.PRNGKey(1), cfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(cfg), device="cpu")
    return params, model


@pytest.fixture(scope="module")
def swa():
    return _setup(TINY_SWA)


@pytest.fixture(scope="module")
def lg():
    return _setup(TINY_LG)


@pytest.mark.parametrize("plen,chunk", [(24, 20), (30, 7), (16, 16)])
def test_prefill_chunk_ring_wrap_matches_whole_prompt(swa, plen, chunk):
    params, model = swa
    cfg = port_cfg(TINY_SWA)
    p = np.random.default_rng(plen * 10 + chunk).integers(
        0, cfg.vocab_size, size=plen)
    lg_ref, cache_ref = jdec.prefill(params, TINY_SWA,
                                     jnp.asarray(p, jnp.int32)[None],
                                     max_len=MAX_LEN)
    cache = tdec.init_cache(cfg, 1, MAX_LEN, device="cpu")
    assert cache["seg0"]["k"].shape[3] == 16           # the window's ring
    cur, lg_ = 0, None
    while cur < plen:
        take = min(chunk, plen - cur)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :take] = p[cur:cur + take]
        lg_, cache = tdec.prefill_chunk(model, cfg, cache, T(toks),
                                        T(np.array([cur])),
                                        T(np.array([take])))
        cur += take
    np.testing.assert_allclose(N(lg_), N(lg_ref), rtol=WRAP_TOL,
                               atol=WRAP_TOL)
    assert_cache_close(cache, cache_ref, WRAP_TOL, WRAP_TOL)


def test_swa_decode_wraps_the_ring(swa):
    """Prefill 14 tokens, then 6 decode steps: the ring wraps at 16 and
    the window drops the oldest rows."""
    params, model = swa
    cfg = port_cfg(TINY_SWA)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 14)).astype(np.int32)
    lg, jc = jdec.prefill(params, TINY_SWA, jnp.asarray(toks),
                          max_len=MAX_LEN)
    tc = cache_to_torch(jc)
    token = np.asarray(jnp.argmax(lg, -1), np.int32)
    for pos in range(14, 20):
        p = np.array([pos, pos], np.int32)
        lg, jc = jdec.decode_step(params, TINY_SWA, jc, jnp.asarray(token),
                                  jnp.asarray(p))
        tlg, tc = tdec.decode_step(model, cfg, tc, T(token), T(p))
        np.testing.assert_allclose(N(tlg), N(lg), rtol=TOL, atol=TOL)
        token = np.asarray(jnp.argmax(lg, -1), np.int32)
    assert_cache_close(tc, jc, TOL, TOL)


def test_local_global_segments_and_sort_leaves():
    """Four segments, windows 16 / global / 16 / global; with A^3 the
    sort leaves exist on the global segments only, in both packages."""
    cfg = port_cfg(TINY_LG)
    segs = tmixer.build_segments(cfg)
    assert [s.window for s in segs] == [16, tmixer.FULL_WINDOW, 16,
                                        tmixer.FULL_WINDOW]
    cache = tdec.init_cache(cfg, 2, MAX_LEN, a3=True, device="cpu")
    ref = jdec.init_cache(TINY_LG, 2, MAX_LEN, a3=True)
    for si in range(4):
        assert set(cache[f"seg{si}"]) == set(ref[f"seg{si}"])
        has_sort = "sk_vals" in cache[f"seg{si}"]
        assert has_sort == (si % 2 == 1)
        assert cache[f"seg{si}"]["k"].shape[3] == (16 if si % 2 == 0
                                                   else MAX_LEN)


def test_local_global_prefill_matches(lg):
    params, model = lg
    toks = np.random.default_rng(3).integers(
        0, TINY_LG.vocab_size, size=(2, 24)).astype(np.int32)
    jl, jc = jdec.prefill(params, TINY_LG, jnp.asarray(toks),
                          max_len=MAX_LEN, a3=True)
    tl, tc = tdec.prefill(model, port_cfg(TINY_LG), T(toks),
                          max_len=MAX_LEN, a3=True)
    np.testing.assert_allclose(N(tl), N(jl), rtol=TOL, atol=TOL)
    assert_cache_close(tc, jc, TOL, TOL)


def test_local_global_ragged_chunks_match(lg):
    """Two ragged dispatches over a populated cache: a fresh lane, a lane
    whose chunk wraps its local rings, a length-0 lane; the fresh lane
    folds its global rings into the sort."""
    params, model = lg
    cfg = port_cfg(TINY_LG)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 12)).astype(np.int32)
    _, jc = jdec.prefill(params, TINY_LG, jnp.asarray(toks),
                         max_len=MAX_LEN, a3=True)
    tc = cache_to_torch(jc)
    before = {k: {n: v.clone() for n, v in sc.items()}
              for k, sc in tc.items()}
    chunk = rng.integers(0, cfg.vocab_size, size=(3, 8)).astype(np.int32)
    sort = np.array([True, False, False])
    for pos, length in (([0, 12, 5], [8, 8, 0]), ([8, 20, 5], [6, 8, 0])):
        jl, jc = jdec.prefill_chunk(params, TINY_LG, jc, jnp.asarray(chunk),
                                    jnp.asarray(pos), jnp.asarray(length),
                                    a3=True, sort_lanes=jnp.asarray(sort))
        tl, tc = tdec.prefill_chunk(model, cfg, tc, T(chunk), T(pos),
                                    T(length), a3=True, sort_lanes=T(sort))
        np.testing.assert_allclose(N(tl)[:2], N(jl)[:2], rtol=TOL, atol=TOL)
    assert_cache_close(tc, jc, TOL, TOL)
    for seg, sc in before.items():
        for name, leaf in sc.items():
            assert torch.equal(tc[seg][name][:, 2], leaf[:, 2]), (seg, name)


@pytest.mark.parametrize("mode", ["off", "conservative"])
def test_local_global_decode_matches(lg, mode):
    """Ragged decode steps past the 16-row local window, with a pos -1
    lane; with A^3 the global layers take the compact path over their
    cached sort, the local layers exact attention."""
    params, model = lg
    cfg = port_cfg(TINY_LG)
    a3 = A3Config() if mode == "off" else A3Config.conservative()
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(3, 18)).astype(np.int32)
    _, jc = jdec.prefill(params, TINY_LG, jnp.asarray(toks),
                         max_len=MAX_LEN, a3=mode != "off")
    tc = cache_to_torch(jc)
    token = np.array([5, 7, 9], np.int32)
    for pos in ([18, 18, -1], [19, 19, -1], [20, 20, -1]):
        pos = np.asarray(pos, np.int32)
        jl, jc = jdec.decode_step(params, TINY_LG, jc, jnp.asarray(token),
                                  jnp.asarray(pos), a3=a3)
        tl, tc = tdec.decode_step(model, cfg, tc, T(token), T(pos),
                                  a3=port_a3(a3))
        np.testing.assert_allclose(N(tl)[:2], N(jl)[:2], rtol=TOL, atol=TOL)
        token = np.asarray(jnp.argmax(jl, -1), np.int32)
    assert_cache_close(tc, jc, TOL, TOL)


def test_local_global_decode_block_resorts_global_only(lg):
    """Four steps in one block with resort_every 2: tokens, carry and
    caches equal JAX's; the watermarks of both global segments advance,
    and the local segments carry no sort leaves."""
    params, model = lg
    cfg = port_cfg(TINY_LG)
    a3 = A3Config.conservative()
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(2, 14)).astype(np.int32)
    _, jc = jdec.prefill(params, TINY_LG, jnp.asarray(toks),
                         max_len=MAX_LEN, a3=True)
    tc = cache_to_torch(jc)
    args = (np.array([1, 2], np.int32), np.array([14, 14], np.int32),
            np.array([4, 4], np.int32))
    ring, carry, jc = jdec.decode_block(
        params, TINY_LG, jc, *map(jnp.asarray, args), steps=4, a3=a3,
        resort_every=2)
    tring, tcarry, tc = tdec.decode_block(
        model, cfg, tc, *map(T, args), steps=4, a3=port_a3(a3),
        resort_every=2)
    np.testing.assert_array_equal(N(tring), np.asarray(ring))
    np.testing.assert_array_equal(N(tcarry), np.asarray(carry))
    assert_cache_close(tc, jc, TOL, TOL)
    for si in (1, 3):
        assert N(tc[f"seg{si}"]["sorted_upto"]).tolist() == [[16, 16]]
    for si in (0, 2):
        assert "sorted_upto" not in tc[f"seg{si}"]
