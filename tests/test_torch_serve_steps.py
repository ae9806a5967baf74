"""The port's serving step factories (``repro_torch.serve.make_serve_step``
and ``make_decode_block_step``) against the JAX factories of the same
names on TINY in float32, from the same JAX-prefilled cache: one ragged
decode step's logits within 2e-5, and a blocked decode dispatch's harvest
and carry token for token (handoff lanes, a ride-along lane, per-lane
budgets), with A^3 off and conservative (the in-dispatch re-sort)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import A3Config  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import make_decode_block_step, \
    make_serve_step  # noqa: E402

from test_torch_helpers import TINY, N, T, cache_to_torch, port_a3, \
    port_cfg  # noqa: E402

MAX_LEN = 64
MODES = {"off": A3Config(), "conservative": A3Config.conservative()}


@pytest.fixture(scope="module")
def tiny():
    params = jdec.init_params(jax.random.PRNGKey(3), TINY)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(TINY), device="cpu")
    toks = np.random.default_rng(6).integers(
        0, TINY.vocab_size, size=(4, 12)).astype(np.int32)
    return params, model, toks


def _prefill(params, toks, a3):
    _, jc = jdec.prefill(params, TINY, jnp.asarray(toks), max_len=MAX_LEN,
                         a3=a3.mode.value != "off")
    return jc, cache_to_torch(jc)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_serve_step_matches_reference(tiny, mode):
    params, model, toks = tiny
    a3 = MODES[mode]
    jc, tc = _prefill(params, toks, a3)
    token = np.array([5, 6, 7, 8], np.int32)
    pos = np.array([12, 12, -1, 12], np.int32)
    want, _ = jax.jit(jeng.make_serve_step(TINY, a3))(
        params, jc, jnp.asarray(token), jnp.asarray(pos))
    got, _ = make_serve_step(port_cfg(TINY), port_a3(a3))(
        model, tc, T(token), T(pos))
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=0, atol=2e-5)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_decode_block_step_matches_reference(tiny, mode):
    params, model, toks = tiny
    a3 = MODES[mode]
    jc, tc = _prefill(params, toks, a3)
    ctrl = np.zeros((4, jeng.CTRL_COLS), np.int32)
    ctrl[:, jeng.CTRL_D_POS] = [12, 12, -1, 12]
    ctrl[:, jeng.CTRL_D_STEPS] = [4, 2, 4, 4]
    ctrl[:, jeng.CTRL_D_IDS] = [0, 1, 2, 3]
    ctrl[:, jeng.CTRL_D_HMASK] = [1, 0, 0, 1]
    token = np.array([1, 2, 3, 4], np.int32)
    first = np.array([9, 10, 11, 12], np.int32)
    resort = 2 if mode != "off" else 0
    harvest, carry, jc = jax.jit(jeng.make_decode_block_step(
        TINY, a3, steps=4, resort_every=resort))(
        params, jc, jnp.asarray(token), jnp.asarray(first),
        jnp.asarray(ctrl))
    step = make_decode_block_step(port_cfg(TINY), port_a3(a3), steps=4,
                                  resort_every=resort)
    t_harvest, t_carry, tc = step(model, tc, T(token), T(first), T(ctrl))
    np.testing.assert_array_equal(N(t_harvest), np.asarray(harvest))
    np.testing.assert_array_equal(N(t_carry), np.asarray(carry))
    assert N(t_harvest)[:, 0].tolist() == [9, 2, 3, 12]    # the handoff
