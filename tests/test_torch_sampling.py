"""The port's tempered sampling against JAX's: the threefry keys and bits
of ``repro_torch.models.sampling`` bit-equal to ``jax.random`` (uids
and positions 0 and 2**31 - 1 included), its Gumbel noise within 1e-6,
``decoder.sample_logits`` drawing the reference's tokens over a padded
vocab, and the engine at temperature 0.8 drawing the JAX engine's
tokens at decode_block {1, 4} x pipeline_depth {0, 1}. Plus the
reference's blocking-invariance and twin-prompt checks
(``tests/test_serve_conformance.py``) on the port.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import decoder as jdec  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import sampling  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

from test_torch_helpers import TINY, assert_same_stats, drive, \
    jax_blocks_ready, port_cfg  # noqa: E402

torch.set_num_threads(1)

SEEDS = (0, 11, 2 ** 31 - 1)
EDGES = np.array([0, 1, 2 ** 31 - 1], np.int32)
MAX_LEN = 96
MAX_NEW = 6
PROMPT_LENS = (5, 12, 23, 31, 9)


def _ids(seed, n=61):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, 2 ** 31 - 1, size=n,
                                               dtype=np.int32)])


def _jax_keys(seed, uids, pos):
    key = jax.random.PRNGKey(seed)
    return jax.vmap(lambda u, p: jax.random.fold_in(
        jax.random.fold_in(key, u), p))(jnp.asarray(uids), jnp.asarray(pos))


def _port_keys(seed, uids, pos):
    key = sampling.prng_key(seed)
    return sampling.fold_in(sampling.fold_in(key, torch.from_numpy(uids)),
                            torch.from_numpy(pos))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_is_bit_equal(seed):
    np.testing.assert_array_equal(sampling.prng_key(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_is_bit_equal(seed):
    uids, pos = _ids(seed), _ids(seed + 1)[::-1].copy()
    np.testing.assert_array_equal(_port_keys(seed, uids, pos).numpy(),
                                  np.asarray(_jax_keys(seed, uids, pos)))


def test_fold_in_of_a_negative_position_wraps_as_uint32():
    """An inactive lane samples at position -1: JAX casts it to
    2**32 - 1."""
    pos = np.array([-1, -2], np.int32)
    uids = np.array([3, 3], np.int32)
    np.testing.assert_array_equal(_port_keys(5, uids, pos).numpy(),
                                  np.asarray(_jax_keys(5, uids, pos)))


@pytest.mark.parametrize("n", [1, 384, 1000])
def test_random_bits_are_bit_equal(n):
    uids, pos = _ids(n, 5), _ids(n + 7, 5)
    jk = _jax_keys(3, uids, pos)
    want = jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(jk)
    got = sampling.random_bits(_port_keys(3, uids, pos), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_within_1e6():
    uids, pos = _ids(1, 13), _ids(2, 13)
    jk = _jax_keys(7, uids, pos)
    want = jax.vmap(lambda k: jax.random.gumbel(k, (4096,)))(jk)
    got = sampling.gumbel(_port_keys(7, uids, pos), 4096)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("temperature", [0.5, 1.0])
def test_sample_logits_matches_reference(temperature):
    """Random float32 logits over a padded vocab (300 ids in 384
    columns, the pad masked as the unembedding masks it), 64 lanes with
    random uids and positions: the same tokens."""
    b, v, vp = 64, 300, 384
    rng = np.random.default_rng(int(temperature * 10))
    logits = rng.standard_normal((b, vp)).astype(np.float32) * 3.0
    logits[:, v:] = -1e30
    uids, pos = _ids(4, b - 3), _ids(5, b - 3)
    want = jdec.sample_logits(jnp.asarray(logits), temperature=temperature,
                              rng=jax.random.PRNGKey(9),
                              pos=jnp.asarray(pos), ids=jnp.asarray(uids))
    got = tdec.sample_logits(torch.from_numpy(logits),
                             temperature=temperature,
                             key=sampling.prng_key(9),
                             pos=torch.from_numpy(pos),
                             ids=torch.from_numpy(uids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() < v).all()
    # not argmax: the draw is tempered
    assert (got.numpy() != logits.argmax(-1)).any()


# ---------------------------------------------------------------------------
# the engine at temperature 0.8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    params = jdec.init_params(jax.random.PRNGKey(0), TINY)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(TINY), device="cpu")
    return params, model


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, TINY.vocab_size, size=n) for n in PROMPT_LENS]


def _port(model, **kw):
    kw = {"slots": 2, "max_len": MAX_LEN, "prefill_chunk": 8, **kw}
    return ServeEngine(model, port_cfg(TINY), **kw)


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("decode_block", [1, 4])
def test_engine_sampling_matches_jax_engine(models, prompts, decode_block,
                                            depth):
    params, model = models
    kw = dict(slots=2, max_len=MAX_LEN, prefill_chunk=8,
              decode_block=decode_block, pipeline_depth=depth,
              temperature=0.8, sample_seed=3)
    with jax_blocks_ready():
        ref = JaxEngine(params, TINY, **kw)
        want, _ = drive(ref, prompts, max_new=MAX_NEW)
    port = ServeEngine(model, port_cfg(TINY), **kw)
    got, _ = drive(port, prompts, max_new=MAX_NEW)
    assert got == want
    assert_same_stats(port, ref)


def test_temperature_sampling_blocking_invariant(models, prompts):
    """The reference's check on the port: draws are the same across
    decode_block sizes (the key folds the position, not the step),
    differ from greedy, and twin prompts (distinct uids) diverge from
    the first token on."""
    _, model = models
    outs = {}
    for block in (1, 4):
        outs[block], _ = drive(_port(model, decode_block=block,
                                     temperature=0.8, sample_seed=3),
                               prompts[:2], max_new=MAX_NEW)
    for out in outs.values():
        for r in out.values():
            assert r is not None and len(r) == MAX_NEW
            assert max(r) < TINY.vocab_size
    assert outs[1] == outs[4]
    greedy, _ = drive(_port(model, decode_block=4), prompts[:1],
                      max_new=MAX_NEW)
    assert outs[1][0] != greedy[0]
    twin, _ = drive(_port(model, decode_block=4, temperature=0.8,
                          sample_seed=3), [prompts[0], prompts[0]],
                    max_new=MAX_NEW)
    assert twin[0] != twin[1]
    assert twin[0][0] != twin[1][0]


def test_sampling_seed_changes_the_draw(models, prompts):
    _, model = models
    a, _ = drive(_port(model, temperature=0.8, sample_seed=3), prompts[:2])
    b, _ = drive(_port(model, temperature=0.8, sample_seed=4), prompts[:2])
    assert a != b
