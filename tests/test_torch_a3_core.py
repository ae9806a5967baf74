"""The port's ``core/`` modules vs the JAX package's.

- ``select_candidates_batch`` equals the reference exactly on tie-heavy
  int8 keys (small integers: every product and greedy sum is exact in
  float32, so both packages must break ties the same way), and equals
  the port's own numpy/heapq oracle on full-range int8 keys (the
  oracle's heap breaks ties its own way, so — as for the reference —
  the oracle is held where products do not tie).
- ``quantization``: fixed-point grids and int8 blocks bit-equal, the LUT
  exponent and the fixed-point softmax within float32 tolerance (one
  ulp of ``exp`` may move a value by one output grid step, 2^-16 here).
- ``post_scoring``, ``a3_attention_batch`` at the quickstart's sizes
  (N=320, D=64, Q=8) with and without the fixed-point LUT path,
  ``a3_self_attention`` and ``flop_savings``: masks exactly equal,
  values at 2e-5.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.core import a3_attention as ja  # noqa: E402
from repro.core import candidate_selection as jcs  # noqa: E402
from repro.core import post_scoring as jps  # noqa: E402
from repro.core import quantization as jq  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.config import A3Config  # noqa: E402
from repro_torch.core import a3_attention as ta  # noqa: E402
from repro_torch.core import candidate_selection as tcs  # noqa: E402
from repro_torch.core import post_scoring as tps  # noqa: E402
from repro_torch.core import quantization as tq  # noqa: E402

from test_torch_helpers import F32_TOL, N, T, port_a3  # noqa: E402

torch.set_num_threads(1)


def _ref_a3(cfg: A3Config) -> jcfg.A3Config:
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(jcfg.A3Config)}
    kw["mode"] = jcfg.A3Mode(cfg.mode.value)
    return jcfg.A3Config(**kw)


def test_core_exports_match_reference():
    import repro.core as jcore
    assert sorted(tcore.__all__) == sorted(jcore.__all__)


# ---------------------------------------------------------------------------
# candidate selection
# ---------------------------------------------------------------------------

_jit_batch = jax.jit(jcs.select_candidates_batch, static_argnums=(2, 3))


@pytest.mark.parametrize("heuristic", [True, False])
def test_select_candidates_batch_matches_jax_on_ties(heuristic):
    rng = np.random.default_rng(int(heuristic))
    n, d, m = 96, 16, 48
    key = rng.integers(-3, 4, (n, d)).astype(np.int8)
    queries = rng.integers(-2, 3, (10, d)).astype(np.float32)
    want_m, want_s = _jit_batch(jcs.sort_key_columns(jnp.asarray(key)),
                                jnp.asarray(queries), m, heuristic)
    sk = tcs.sort_key_columns(torch.from_numpy(key))
    for chunk_elems in (tcs.SELECT_CHUNK_ELEMS, 3 * m * d):  # whole, 3 rows
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tcs, "SELECT_CHUNK_ELEMS", chunk_elems)
            got_m, got_s = tcs.select_candidates_batch(
                sk, torch.from_numpy(queries), m, heuristic)
        np.testing.assert_array_equal(N(got_m), np.asarray(want_m))
        np.testing.assert_array_equal(N(got_s), np.asarray(want_s))


@pytest.mark.parametrize("n,d,m", [(64, 16, 32), (50, 8, 200)])
def test_select_candidates_batch_matches_oracle(n, d, m):
    rng = np.random.default_rng(n + m)
    key = rng.integers(-127, 128, (n, d)).astype(np.int8)
    queries = rng.standard_normal((6, d)).astype(np.float32)
    got, score = tcs.select_candidates_batch(
        tcs.sort_key_columns(torch.from_numpy(key)),
        torch.from_numpy(queries), m)
    for i, q in enumerate(queries):
        want, wscore = tcs.select_candidates_oracle(key, q, m)
        np.testing.assert_array_equal(N(got[i]), want)
        np.testing.assert_allclose(N(score[i]), wscore, rtol=2e-4,
                                   atol=2e-4)
        jm, js = jcs.select_candidates_oracle(key.astype(np.float32), q, m)
        np.testing.assert_array_equal(want, jm)
        np.testing.assert_array_equal(wscore, js)


def test_quantized_sorted_keys_and_scales_match_jax():
    """``quantize_sorted_keys`` + ``select_candidates(scales=...)``: the
    walk runs on the int8 values with the scales folded into the query."""
    rng = np.random.default_rng(3)
    key = rng.standard_normal((64, 8)).astype(np.float32)
    query = rng.standard_normal(8).astype(np.float32)
    jsk, jscale = jcs.quantize_sorted_keys(
        jcs.sort_key_columns(jnp.asarray(key)))
    tsk, tscale = tcs.quantize_sorted_keys(
        tcs.sort_key_columns(torch.from_numpy(key)))
    np.testing.assert_array_equal(N(tsk.values), np.asarray(jsk.values))
    np.testing.assert_array_equal(N(tsk.rows), np.asarray(jsk.rows))
    np.testing.assert_array_equal(N(tscale), np.asarray(jscale))
    wm, ws = jcs.select_candidates(jsk, jnp.asarray(query), 32,
                                   scales=jscale)
    gm, gs = tcs.select_candidates(tsk, torch.from_numpy(query), 32,
                                   scales=tscale)
    np.testing.assert_array_equal(N(gm), np.asarray(wm))
    np.testing.assert_allclose(N(gs), np.asarray(ws), **F32_TOL)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_fixed_point_bit_equal(dtype):
    """The grid is built in float32 for a bf16 input too (the PR 7 fix)."""
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(-20, 20, 512),
                        np.arange(-8, 8) / 32 + 1 / 64]).astype(np.float32)
    for i, f in ((4, 4), (2, 6), (6, 2)):
        want = jq.quantize_fixed_point(jnp.asarray(x, dtype), i, f)
        got = tq.quantize_fixed_point(T(x).to(getattr(torch, dtype)), i, f)
        assert str(got.dtype).endswith(dtype)
        np.testing.assert_array_equal(N(got), N(want))


def test_lut_exp_and_tables_match_jax():
    for kw in (dict(frac_bits=8, total_bits=16, out_frac_bits=24),
               dict(frac_bits=4, total_bits=13, lo_bits=5)):
        want, got = jq.make_lut_exp(**kw), tq.make_lut_exp(**kw)
        # XLA flushes the tables' subnormal tail (< 1.2e-38) to zero
        for g, w in ((got.hi_table, want.hi_table),
                     (got.lo_table, want.lo_table)):
            np.testing.assert_allclose(N(g), np.asarray(w), rtol=1e-6,
                                       atol=np.finfo(np.float32).tiny)
        assert got.table_entries == want.table_entries
        x = -np.linspace(0, 30, 997).astype(np.float32)
        np.testing.assert_allclose(N(got(T(x))), np.asarray(want(
            jnp.asarray(x))), **F32_TOL)
    assert tq.cached_lut_exp(16, 21) is tq.cached_lut_exp(16, 21)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_fixed_point_matches_jax(masked):
    rng = np.random.default_rng(11)
    s = (rng.standard_normal((4, 64)) * 3).astype(np.float32)
    mask = rng.random((4, 64)) < 0.5 if masked else None
    sq = np.asarray(jq.quantize_fixed_point(jnp.asarray(s), 8, 8))
    want = jq.softmax_fixed_point(jnp.asarray(sq), 8, mask=None if mask is
                                  None else jnp.asarray(mask))
    got = tq.softmax_fixed_point(T(sq), 8, mask=None if mask is None
                                 else T(mask))
    np.testing.assert_allclose(N(got), np.asarray(want), **F32_TOL)
    wbf = jq.softmax_fixed_point(jnp.asarray(sq, jnp.bfloat16), 6)
    gbf = tq.softmax_fixed_point(T(sq).bfloat16(), 6)
    assert gbf.dtype == torch.bfloat16
    np.testing.assert_allclose(N(gbf), N(wbf), rtol=0, atol=2 ** -12)


def test_int8_block_quant_bit_equal():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 8, 16)) * 5).astype(np.float32)
    for axes in ((2,), (0, 2)):
        wq, ws = jq.quantize_int8_block(jnp.asarray(x), axes)
        gq, gs = tq.quantize_int8_block(T(x), axes)
        assert gq.dtype == torch.int8 and tuple(gs.shape) == ws.shape
        np.testing.assert_array_equal(N(gq), np.asarray(wq))
        np.testing.assert_array_equal(N(gs), np.asarray(ws))
        np.testing.assert_array_equal(
            N(tq.dequantize_int8_block(gq, gs)),
            np.asarray(jq.dequantize_int8_block(wq, ws)))


# ---------------------------------------------------------------------------
# post-scoring
# ---------------------------------------------------------------------------

def test_post_scoring_matches_jax():
    rng = np.random.default_rng(5)
    s = (rng.standard_normal((6, 40)) * 2).astype(np.float32)
    cand = rng.random((6, 40)) < 0.6
    cand[2] = False                                  # no candidate at all
    for c in (None, cand):
        jc = None if c is None else jnp.asarray(c)
        tc = None if c is None else T(c)
        np.testing.assert_array_equal(
            N(tps.post_scoring_mask(T(s), 3.0, tc)),
            np.asarray(jps.post_scoring_mask(jnp.asarray(s), 3.0, jc)))
        np.testing.assert_allclose(N(tps.masked_softmax(T(s), tc)),
                                   np.asarray(jps.masked_softmax(
                                       jnp.asarray(s), jc)), **F32_TOL)
    w = N(tps.masked_softmax(T(s), T(cand)))
    true_w = N(tps.masked_softmax(T(s), None))
    for got, want in zip(tps.top_weight_stats(T(w), T(true_w), 5),
                         jps.top_weight_stats(jnp.asarray(w),
                                              jnp.asarray(true_w), 5)):
        np.testing.assert_allclose(N(got), np.asarray(want), **F32_TOL)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def _memory(seed, n=320, d=64, q=8):
    """The quickstart's memory: N=320 keys/values, D=64, Q=8 queries."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.5).astype(np.float32)
            for s in ((n, d), (n, d), (q, d))]


@pytest.mark.parametrize("mode,lut", [("off", False), ("conservative", False),
                                      ("aggressive", False),
                                      ("conservative", True)])
def test_a3_attention_batch_matches_jax(mode, lut):
    key, value, queries = _memory(0)
    cfg = {"off": A3Config(), "conservative": A3Config.conservative(),
           "aggressive": A3Config.aggressive()}[mode]
    if lut:
        cfg = dataclasses.replace(cfg, int_bits=4, frac_bits=4,
                                  lut_exponent=True)
    fn = lambda k, v, q: ja.a3_attention_batch(  # noqa: E731
        ja.preprocess(k, v), q, _ref_a3(cfg))
    if not lut:
        # jit compiles once; the LUT path stays eager, as the reference
        # builds its cached tables inside the call
        fn = jax.jit(fn)
    want, waux = fn(jnp.asarray(key), jnp.asarray(value),
                    jnp.asarray(queries))
    got, gaux = ta.a3_attention_batch(ta.preprocess(T(key), T(value)),
                                      T(queries), cfg)
    for name in ("candidates", "kept"):
        np.testing.assert_array_equal(N(gaux[name]), np.asarray(waux[name]))
    np.testing.assert_allclose(N(gaux["weights"]), np.asarray(waux["weights"]),
                               **F32_TOL)
    np.testing.assert_allclose(N(got), np.asarray(want), **F32_TOL)
    stats = ta.flop_savings(gaux, n=320, d=64)
    for k_, v_ in ja.flop_savings(waux, n=320, d=64).items():
        np.testing.assert_allclose(N(stats[k_]), np.asarray(v_), **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["off", "conservative"])
def test_a3_self_attention_matches_jax(mode, causal):
    rng = np.random.default_rng(6)
    q, k = [rng.standard_normal((64, 16)).astype(np.float32)
            for _ in range(2)]
    v = rng.standard_normal((64, 8)).astype(np.float32)
    cfg = A3Config() if mode == "off" else A3Config.conservative()
    fn = jax.jit(lambda q, k, v: ja.a3_self_attention(
        q, k, v, _ref_a3(cfg), causal=causal))
    want, waux = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got, gaux = ta.a3_self_attention(T(q), T(k), T(v), cfg, causal=causal)
    for name in ("candidates", "kept"):
        np.testing.assert_array_equal(N(gaux[name]), np.asarray(waux[name]))
    np.testing.assert_allclose(N(got), np.asarray(want), **F32_TOL)


def test_candidate_block_map_matches_jax():
    rng = np.random.default_rng(9)
    cand = rng.random((256, 384)) < 0.002
    want = ja.candidate_block_map(jnp.asarray(cand), 64, 128)
    got = ta.candidate_block_map(T(cand), 64, 128)
    np.testing.assert_array_equal(N(got), np.asarray(want))
    assert port_a3(_ref_a3(A3Config.aggressive())) == A3Config.aggressive()
