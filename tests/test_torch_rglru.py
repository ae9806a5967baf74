"""The port's RG-LRU block (``repro_torch.models.rglru``) vs the JAX
package's ``repro.models.rglru``, float32, with the reference's
parameters copied over (the dense projections transposed).

Outputs within 2e-5. The recurrent state ``h`` within 1e-5: the port's
log-depth scan associates the products in another order than
``lax.associative_scan`` (the reference holds its own chunked-vs-whole
scans at 1e-5). The conv tail (rows of the rnn-branch projection) within
2e-5.
Then the mixer through the decoder on the conformance suite's
``TINY_RG``: chunked prefill in the reference's splits against one
whole-prompt prefill (both packages), the length-0 and pos -1 lanes bit
for bit, a fresh lane that resets a finished request's state, and the
port's initial distributions.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import decoder as jdec  # noqa: E402
from repro.models import rglru as jr  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import rglru as tr  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from test_torch_helpers import F32_TOL, TINY_RG, N, T, \
    assert_cache_close, port_cfg  # noqa: E402

torch.set_num_threads(1)

D, C = 64, 96
H_TOL = dict(rtol=1e-5, atol=1e-5)
DENSE = ("w_in_gate", "w_in_rnn", "w_a", "w_x", "w_out")


@pytest.fixture(scope="module")
def block():
    params = jr.rglru_init(jax.random.PRNGKey(0), D, C, jnp.float32)
    mod = tr.RGLRU(D, C, torch.float32).requires_grad_(False)
    for name in DENSE:
        getattr(mod, name).weight.copy_(T(params[name]).t())
    for name in ("conv_w", "conv_b", "lam"):
        getattr(mod, name).copy_(T(params[name]))
    # a non-zero conv bias, so its add is held too
    params["conv_b"] = jnp.linspace(-0.5, 0.5, C, dtype=jnp.float32)
    mod.conv_b.copy_(T(params["conv_b"]))
    return params, mod


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("s,chunk", [(40, 512), (40, 16), (1100, 512)])
@pytest.mark.parametrize("carried", [False, True])
def test_apply_scan_matches(block, s, chunk, carried):
    """Whole sequences in one chunk, across 16-token chunks (h carried
    between them) and across 512-token chunks with a partial last one
    (1100 tokens); from the zero state or from a carried h and conv
    tail."""
    params, mod = block
    x = _rand((2, s, D), 1)
    h0 = _rand((2, C), 2) if carried else None
    buf = _rand((2, tr.CONV_WIDTH - 1, C), 3) if carried else None
    jargs = [None if a is None else jnp.asarray(a) for a in (h0, buf)]
    targs = [None if a is None else T(a) for a in (h0, buf)]
    o, h, cv = jr.rglru_apply_scan(params, jnp.asarray(x), *jargs,
                                   chunk=chunk)
    to, th, tcv = tr.rglru_apply_scan(mod, T(x), *targs, chunk=chunk)
    np.testing.assert_allclose(N(to), N(o), **F32_TOL)
    np.testing.assert_allclose(N(th), N(h), **H_TOL)
    np.testing.assert_allclose(N(tcv), N(cv), **F32_TOL)
    assert th.dtype == torch.float32


def test_chunk_step_matches(block):
    """A ragged chunk: lanes with 5, 0, 8 and 2 valid tokens of 8 over a
    carried state; the lane with nothing valid returns its h and conv
    tail bit for bit."""
    params, mod = block
    x = _rand((4, 8, D), 4)
    h0 = _rand((4, C), 5)
    buf = _rand((4, tr.CONV_WIDTH - 1, C), 6)
    valid = np.arange(8)[None, :] < np.array([5, 0, 8, 2])[:, None]
    o, h, cv = jr.rglru_chunk_step(params, jnp.asarray(x), jnp.asarray(h0),
                                   jnp.asarray(buf), jnp.asarray(valid))
    to, th, tcv = tr.rglru_chunk_step(mod, T(x), T(h0), T(buf), T(valid))
    live = valid.any(1)
    np.testing.assert_allclose(N(to)[valid], N(o)[valid], **F32_TOL)
    np.testing.assert_allclose(N(th)[live], N(h)[live], **H_TOL)
    np.testing.assert_allclose(N(tcv), N(cv), **F32_TOL)
    assert torch.equal(th[1], T(h0)[1])
    assert torch.equal(tcv[1], T(buf)[1])


def test_decode_step_matches(block):
    params, mod = block
    x = _rand((3, 1, D), 7)
    h = _rand((3, C), 8)
    buf = _rand((3, tr.CONV_WIDTH - 1, C), 9)
    o, hn, cv = jr.rglru_decode_step(params, jnp.asarray(x), jnp.asarray(h),
                                     jnp.asarray(buf))
    to, thn, tcv = tr.rglru_decode_step(mod, T(x), T(h), T(buf))
    np.testing.assert_allclose(N(to), N(o), **F32_TOL)
    np.testing.assert_allclose(N(thn), N(hn), **H_TOL)
    np.testing.assert_allclose(N(tcv), N(cv), **F32_TOL)


# ---------------------------------------------------------------------------
# the RG-LRU mixer through the decoder (TINY_RG)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_rg():
    params = jdec.init_params(jax.random.PRNGKey(1), TINY_RG)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(TINY_RG), device="cpu")
    return params, model


def _chunked(model, cfg, p, chunk, max_len=32):
    cache = tdec.init_cache(cfg, 1, max_len, device="cpu")
    cur, lg = 0, None
    while cur < len(p):
        take = min(chunk, len(p) - cur)
        toks = np.zeros((1, chunk), np.int32)
        toks[0, :take] = p[cur:cur + take]
        lg, cache = tdec.prefill_chunk(model, cfg, cache, T(toks),
                                       T(np.array([cur])), T(np.array([take])))
        cur += take
    return lg, cache


@pytest.mark.parametrize("plen,chunk", [(23, 8), (7, 3), (16, 16), (30, 7)])
def test_prefill_chunk_matches_whole_prompt(tiny_rg, plen, chunk):
    """The reference's splits (mid-prompt boundaries, chunks that do not
    divide the prompt; 30 tokens wrap the 24-row ring): the port's
    chunked prefill against the JAX whole-prompt prefill, logits and
    every state leaf."""
    params, model = tiny_rg
    p = np.random.default_rng(plen * 100 + chunk).integers(
        0, TINY_RG.vocab_size, size=plen)
    lg, cache = jdec.prefill(params, TINY_RG, jnp.asarray(p, jnp.int32)[None],
                             max_len=32)
    tlg, tcache = _chunked(model, port_cfg(TINY_RG), p, chunk)
    np.testing.assert_allclose(N(tlg), N(lg), rtol=3e-5, atol=3e-5)
    assert_cache_close(tcache, cache, 3e-5, 3e-5)


def test_prefill_and_decode_match(tiny_rg):
    """Whole-prompt prefill, then two ragged decode steps with a pos -1
    lane, logits and caches against JAX."""
    params, model = tiny_rg
    cfg = port_cfg(TINY_RG)
    toks = np.random.default_rng(3).integers(
        0, TINY_RG.vocab_size, size=(3, 20)).astype(np.int32)
    lg, jc = jdec.prefill(params, TINY_RG, jnp.asarray(toks), max_len=32)
    tlg, tc = tdec.prefill(model, cfg, T(toks), max_len=32)
    np.testing.assert_allclose(N(tlg), N(lg), **F32_TOL)
    before = {k: {n: v.clone() for n, v in sc.items()} for k, sc in
              tc.items()}
    token = np.array([5, 6, 7], np.int32)
    for pos in ([20, 20, -1], [21, 21, -1]):
        pos = np.asarray(pos, np.int32)
        lg, jc = jdec.decode_step(params, TINY_RG, jc, jnp.asarray(token),
                                  jnp.asarray(pos))
        tlg, tc = tdec.decode_step(model, cfg, tc, T(token), T(pos))
        np.testing.assert_allclose(N(tlg)[:2], N(lg)[:2], rtol=3e-5,
                                   atol=3e-5)
        token = np.asarray(jnp.argmax(lg, -1), np.int32)
    assert_cache_close(tc, jc, 3e-5, 3e-5)
    for seg, sc in before.items():
        for name, leaf in sc.items():
            assert torch.equal(tc[seg][name][:, 2], leaf[:, 2]), (seg, name)


def test_pad_lane_and_fresh_lane(tiny_rg):
    """A length-0 lane of a chunk keeps every leaf bit for bit; a lane
    admitted at pos 0 over a finished request's state equals the same
    chunk on a fresh cache, bit for bit."""
    _, model = tiny_rg
    cfg = port_cfg(TINY_RG)
    rng = np.random.default_rng(4)
    stale = rng.integers(0, cfg.vocab_size, size=(2, 13)).astype(np.int32)
    _, cache = tdec.prefill(model, cfg, T(stale), max_len=32)
    before = {k: {n: v.clone() for n, v in sc.items()} for k, sc in
              cache.items()}
    toks = rng.integers(0, cfg.vocab_size, size=(2, 6)).astype(np.int32)
    tdec.prefill_chunk(model, cfg, cache, T(toks), T(np.array([0, 0])),
                       T(np.array([6, 0])))
    scratch = tdec.init_cache(cfg, 2, 32, device="cpu")
    tdec.prefill_chunk(model, cfg, scratch, T(toks), T(np.array([0, 0])),
                       T(np.array([6, 0])))
    for seg, sc in cache.items():
        for name, leaf in sc.items():
            assert torch.equal(leaf[:, 1], before[seg][name][:, 1])
            assert torch.equal(leaf[:, 0], scratch[seg][name][:, 0])


def test_native_init_distributions():
    """``rglru_init_`` draws the reference's distributions: a spans
    [0.9, 0.999] over the channels, N(0, 1/4) conv taps, zero conv bias,
    N(0, 1/d_in) dense weights."""
    mod = tr.RGLRU(256, 512, torch.float32).requires_grad_(False)
    tr.rglru_init_(mod, torch.Generator().manual_seed(0))
    a = torch.sigmoid(mod.lam) ** tr.LRU_C
    assert abs(float(a[0]) - 0.9) < 1e-5 and abs(float(a[-1]) - 0.999) < 1e-5
    assert float(mod.conv_b.abs().sum()) == 0
    assert abs(float(mod.conv_w.std()) * 2 - 1) < 0.1
    for lin, fan_in in ((mod.w_in_gate, 256), (mod.w_a, 512),
                        (mod.w_out, 512)):
        assert abs(float(lin.weight.std()) * fan_in ** 0.5 - 1) < 0.05
