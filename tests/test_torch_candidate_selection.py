"""A^3 candidate selection and decode ops of the port vs the JAX package.

Tie order is the hazard here: ``jnp.argsort`` is stable and
``jax.lax.top_k`` takes the lower index first (and +0.0 above -0.0), so
the inputs are tie-heavy on purpose — small integer-valued keys and
queries, whose products and greedy sums are exact in float32, so the
two packages must select exactly the same rows. The decode ops are
checked with one-hot values (``v[row] = e_row``): the output row then
*is* the attention weight of every ring row, so the kept row sets are
compared exactly and the weights at 2e-5.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import A3Config  # noqa: E402
from repro.core import candidate_selection as jcs  # noqa: E402
from repro.kernels.decode_attention import ops as jops  # noqa: E402
from repro_torch.core import candidate_selection as tcs  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tops  # noqa: E402

from test_torch_helpers import F32_TOL, N, T, port_a3  # noqa: E402

torch.set_num_threads(1)


def _int_keys(rng, shape, lo=-3, hi=4):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


@pytest.mark.parametrize("n,d", [(16, 8), (96, 16), (128, 4)])
def test_sort_key_columns_rows_equal(n, d):
    rng = np.random.default_rng(n * d)
    key = _int_keys(rng, (2, 3, n, d))                  # many ties
    want = jax.vmap(jax.vmap(jcs.sort_key_columns))(jnp.asarray(key))
    got = tcs.sort_key_columns(T(key))
    np.testing.assert_array_equal(N(got.rows), np.asarray(want.rows))
    np.testing.assert_array_equal(N(got.values), np.asarray(want.values))


def test_top_k_order_matches_lax_top_k():
    x = np.array([[0.0, -0.0, 1.0, 0.0, -0.0, np.inf, 1.0, -np.inf, 2.0,
                   -1.0, -0.0, 0.0]], np.float32)
    for k in (1, 4, 12):
        for sgn in (1, -1):
            wv, wi = jax.lax.top_k(jnp.asarray(sgn * x), k)
            gv, gi = tcs.top_k(T(sgn * x), k)
            np.testing.assert_array_equal(N(gi), np.asarray(wi))
            np.testing.assert_array_equal(np.signbit(N(gv)),
                                          np.signbit(np.asarray(wv)))


@pytest.mark.parametrize("heuristic", [True, False])
@pytest.mark.parametrize("prefix_cap", [None, 5])
@pytest.mark.parametrize("n,d,m", [(32, 8, 16), (96, 16, 48), (64, 4, 200)])
def test_select_candidates_masks_equal(n, d, m, prefix_cap, heuristic):
    rng = np.random.default_rng(n + d + m)
    key = _int_keys(rng, (n, d))
    queries = _int_keys(rng, (6, d), -2, 3)
    sk = jcs.sort_key_columns(jnp.asarray(key))
    tsk = tcs.sort_key_columns(T(key))
    got_mask, got_score = tcs.select_candidates(
        tsk, T(queries), m, use_heuristic=heuristic, prefix_cap=prefix_cap)
    for i, q in enumerate(queries):
        want_mask, want_score = jcs.select_candidates(
            sk, jnp.asarray(q), m, use_heuristic=heuristic,
            prefix_cap=prefix_cap)
        np.testing.assert_array_equal(N(got_mask[i]), np.asarray(want_mask))
        np.testing.assert_array_equal(N(got_score[i]),
                                      np.asarray(want_score))


def _ring(seed, b, hq, hkv, s, d, integer=True):
    """Ring K (tie-heavy integers), one-hot V ([S] wide) and a query."""
    rng = np.random.default_rng(seed)
    if integer:
        q = _int_keys(rng, (b, hq, d), -2, 3) * np.float32(np.sqrt(d))
        k = _int_keys(rng, (b, hkv, s, d))
    else:
        q = rng.standard_normal((b, hq, d)).astype(np.float32)
        k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = np.broadcast_to(np.eye(s, dtype=np.float32), (b, hkv, s, s)).copy()
    return q, k, v


def _check_weights(got, want):
    got, want = N(got), np.asarray(want)
    np.testing.assert_array_equal(got > 0, want > 0)      # kept row sets
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("mode", ["off", "conservative", "aggressive"])
@pytest.mark.parametrize("fresh", [False, True])
def test_a3_decode_attention_matches_jax(mode, fresh):
    """Mask path (no cached sort on the JAX side: the decode kernel in
    interpret mode) — kept rows equal, weights at 2e-5."""
    b, hq, hkv, s, d = 2, 6, 2, 128, 16
    q, k, v = _ring(17, b, hq, hkv, s, d)
    valid = np.ones((b, s), bool)
    valid[1, 100:] = False
    a3 = {"off": A3Config(), "conservative": A3Config.conservative(),
          "aggressive": A3Config.aggressive()}[mode]
    sk = jax.vmap(jax.vmap(jcs.sort_key_columns))(jnp.asarray(k))
    tsk = tcs.sort_key_columns(T(k))
    ff = np.array([90, 60], np.int32) if fresh else None
    want = jops.a3_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        a3, sorted_keys=sk, fresh_from=None if ff is None else
        jnp.asarray(ff), use_kernel=True, interpret=True)
    got = tops.a3_decode_attention(
        T(q), T(k), T(v), T(valid), port_a3(a3), sorted_keys=tsk,
        fresh_from=None if ff is None else T(ff))
    _check_weights(got, want)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("case", ["mixed", "fresh_heavy"])
def test_compact_matches_jax(case, integer, shards):
    """The sharded compact op: ``fresh_heavy`` makes fresh rows outnumber
    the per-shard budget c_loc, so +inf ties decide which rows win."""
    b, hq, hkv, s, d = 2, 6, 2, 128, 16
    q, k, v = _ring(31 + shards, b, hq, hkv, s, d, integer=integer)
    valid = np.ones((b, s), bool)
    valid[0, 110:] = False
    fresh = np.zeros((b, s), bool)
    if case == "fresh_heavy":
        fresh[:, 20:] = True            # ~100 fresh rows vs c_loc 64 / 32
    else:
        fresh[:, 120:] = True
    a3 = A3Config(mode=A3Config.conservative().mode, select_shards=shards)
    sl = s // shards
    sk = jax.vmap(jax.vmap(jax.vmap(jcs.sort_key_columns)))(
        jnp.asarray(k).reshape(b, hkv, shards, sl, d))
    sk = jcs.SortedKeys(sk.values.reshape(k.shape),
                        sk.rows.reshape(k.shape))
    tsk = tcs.sort_key_columns(T(k).reshape(b, hkv, shards, sl, d))
    tsk = tcs.SortedKeys(tsk.values.reshape(k.shape),
                         tsk.rows.reshape(k.shape))
    want = jops.a3_decode_attention_compact(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        a3, sk, fresh_mask=jnp.asarray(fresh))
    got = tops.a3_decode_attention_compact(
        T(q), T(k), T(v), T(valid), port_a3(a3), tsk, fresh_mask=T(fresh))
    _check_weights(got, want)
