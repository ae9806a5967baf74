"""xLSTM layers and decoder of the port vs the JAX package, with the
reference's weights carried over by ``params_from_numpy``.

Module level: ``mlstm_chunkwise`` (from a carried state, with a ragged
``valid`` mask), ``mlstm_decode_step``, ``slstm_apply_scan`` (``valid``)
and ``slstm_decode_step`` on layer 0 / layer 2 of the conformance
suite's ``TINY_XL`` (mLSTM, mLSTM, sLSTM; f32, no FFN). Decoder level:
whole-prompt ``prefill``, ragged ``prefill_chunk`` with chunk boundaries
mid-prompt, ``decode_step`` and ``decode_block``: logits and every state
leaf. Pad lanes (length 0 in a chunk, pos = -1 in a step) keep every
state leaf bit-identical, as ``tests/test_serve_conformance.py`` asserts
for the JAX package.

Tolerance 1e-4 on outputs, logits and state leaves (float32): each op
agrees at ~1e-6, the chunk loop sums in another order than the JAX
scan, and three layers compound it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import A3Config, get_arch  # noqa: E402
from repro.config import smoke_variant as jsmoke  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro_torch.config import A3Config as TA3  # noqa: E402
from repro_torch.config import smoke_variant  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import mixer as tmixer  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from test_torch_helpers import TINY_XL, N, T, assert_cache_close, \
    cache_to_torch, port_cfg  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
H, HD, D = TINY_XL.num_heads, TINY_XL.resolved_head_dim, TINY_XL.d_model
MAX_LEN = 64


@pytest.fixture(scope="module")
def setup():
    params = jdec.init_params(jax.random.PRNGKey(2), TINY_XL)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_numpy(tree, port_cfg(TINY_XL), device="cpu")
    return params, model, port_cfg(TINY_XL)


def _layer(params, si, l=0):
    return jax.tree_util.tree_map(lambda x: x[l], params[f"seg{si}"])


def _x(seed, b, s):
    return np.random.default_rng(seed).standard_normal(
        (b, s, D)).astype(np.float32)


def _prompts(b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, TINY_XL.vocab_size, size=(b, s)).astype(np.int32)


def _close_tuple(got, want, names):
    for name, a, w in zip(names, got, want):
        np.testing.assert_allclose(N(a), N(w), **TOL, err_msg=name)


def _rand_mlstm_state(seed, b):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, H, HD, HD)).astype(np.float32),
            rng.standard_normal((b, H, HD)).astype(np.float32),
            rng.standard_normal((b, H)).astype(np.float32))


def _rand_slstm_state(seed, b):
    rng = np.random.default_rng(seed)
    c, h = (rng.standard_normal((b, D)).astype(np.float32)
            for _ in range(2))
    n = np.abs(rng.standard_normal((b, D))).astype(np.float32) + 0.5
    return c, n, rng.standard_normal((b, D)).astype(np.float32), h


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_params_carried_bit_for_bit(setup):
    params, model, _ = setup
    ml, sl = _layer(params, 0, 1)["mlstm"], _layer(params, 1)["slstm"]
    tm, ts = model.segs[0].layers[1].mlstm, model.segs[1].layers[0].slstm
    np.testing.assert_array_equal(N(tm.wk.weight), N(ml["wk"]).T)
    np.testing.assert_array_equal(N(tm.w_out.weight), N(ml["w_out"]).T)
    for name in ("w_i", "w_f", "b_i", "b_f", "ln_scale"):
        np.testing.assert_array_equal(N(getattr(tm, name)), N(ml[name]))
    np.testing.assert_array_equal(N(ts.wx.weight), N(sl["wx"]).T)
    for name in ("wr", "b", "ln_scale"):
        np.testing.assert_array_equal(N(getattr(ts, name)), N(sl[name]))
    assert model.segs[0].layers[0].ffn is None


@pytest.mark.parametrize("chunk", [8, 256])
@pytest.mark.parametrize("carried", [False, True])
def test_mlstm_chunkwise_matches(setup, chunk, carried):
    """Output and final state, from the initial or a random carried
    state, with a ragged valid mask (a lane of 13 of 21 tokens)."""
    params, model, _ = setup
    x = _x(1, 2, 21)
    valid = np.arange(21)[None, :] < np.array([[21], [13]])
    st = _rand_mlstm_state(2, 2) if carried else None
    want, wst = jxl.mlstm_chunkwise(
        _layer(params, 0)["mlstm"], jnp.asarray(x), H, HD, chunk=chunk,
        state=None if st is None else tuple(map(jnp.asarray, st)),
        valid=jnp.asarray(valid))
    got, gst = txl.mlstm_chunkwise(
        model.segs[0].layers[0].mlstm, T(x), H, HD, chunk=chunk,
        state=None if st is None else tuple(map(T, st)), valid=T(valid))
    np.testing.assert_allclose(N(got), N(want), **TOL)
    _close_tuple(gst, wst, "Cnm")


def test_mlstm_decode_step_matches(setup):
    params, model, _ = setup
    x, st = _x(3, 2, 1), _rand_mlstm_state(4, 2)
    want, wst = jxl.mlstm_decode_step(_layer(params, 0)["mlstm"],
                                      jnp.asarray(x),
                                      tuple(map(jnp.asarray, st)), H, HD)
    got, gst = txl.mlstm_decode_step(model.segs[0].layers[0].mlstm, T(x),
                                     tuple(map(T, st)), H, HD)
    np.testing.assert_allclose(N(got), N(want), **TOL)
    _close_tuple(gst, wst, "Cnm")


@pytest.mark.parametrize("masked", [False, True])
def test_slstm_apply_scan_matches(setup, masked):
    params, model, _ = setup
    x, st = _x(5, 2, 11), _rand_slstm_state(6, 2)
    valid = np.arange(11)[None, :] < np.array([[11], [4]]) if masked \
        else None
    want, wst = jxl.slstm_apply_scan(
        _layer(params, 1)["slstm"], jnp.asarray(x), H,
        state=tuple(map(jnp.asarray, st)),
        valid=None if valid is None else jnp.asarray(valid))
    got, gst = txl.slstm_apply_scan(
        model.segs[1].layers[0].slstm, T(x), H, state=tuple(map(T, st)),
        valid=None if valid is None else T(valid))
    np.testing.assert_allclose(N(got), N(want), **TOL)
    _close_tuple(gst, wst, "cnmh")


def test_slstm_decode_step_matches(setup):
    params, model, _ = setup
    x, st = _x(7, 3, 1), _rand_slstm_state(8, 3)
    want, wst = jxl.slstm_decode_step(_layer(params, 1)["slstm"],
                                      jnp.asarray(x),
                                      tuple(map(jnp.asarray, st)), H)
    got, gst = txl.slstm_decode_step(model.segs[1].layers[0].slstm, T(x),
                                     tuple(map(T, st)), H)
    np.testing.assert_allclose(N(got), N(want), **TOL)
    _close_tuple(gst, wst, "cnmh")


@pytest.mark.parametrize("si", [0, 1], ids=["mlstm", "slstm"])
def test_mixer_forward_matches(setup, si):
    """The mixers' full-sequence ``forward`` (no state in or out)."""
    from repro.models import mixer as jmixer
    params, model, tcfg = setup
    seg = jmixer.build_segments(TINY_XL)[si]
    x = _x(10 + si, 2, 19)
    want = jmixer.MIXERS[seg.kind].forward(_layer(params, si),
                                           jnp.asarray(x), cfg=TINY_XL,
                                           seg=seg)
    tseg = tmixer.build_segments(tcfg)[si]
    got = tmixer.MIXERS[tseg.kind].forward(model.segs[si].layers[0], T(x),
                                           cfg=tcfg, seg=tseg)
    np.testing.assert_allclose(N(got), N(want), **TOL)


def test_init_state_matches(setup):
    _, _, tcfg = setup
    want = jdec.init_cache(TINY_XL, 3, MAX_LEN)
    got = tdec.init_cache(tcfg, 3, MAX_LEN, device="cpu")
    assert_cache_close(got, want, 0.0, 0.0)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def test_prefill_matches(setup):
    params, model, tcfg = setup
    toks = _prompts(2, 20)
    lg, cache = jdec.prefill(params, TINY_XL, jnp.asarray(toks),
                             max_len=MAX_LEN)
    tlg, tcache = tdec.prefill(model, tcfg, T(toks), max_len=MAX_LEN)
    np.testing.assert_allclose(N(tlg), N(lg), **TOL)
    assert_cache_close(tcache, cache, **TOL)


@pytest.mark.parametrize("chunk", [8, 5])
def test_prefill_chunk_matches_prefill(setup, chunk):
    """A 23-token prompt and a 13-token one fed in ragged chunks whose
    boundaries fall mid-prompt (the short lane rides along at length 0
    once it is done): every chunk's logits and the final state leaves
    equal the JAX package's, and the chunked state equals the
    whole-prompt prefill's."""
    params, model, tcfg = setup
    toks = _prompts(2, 23, seed=1)
    lens = np.array([23, 13])
    jc = jdec.init_cache(TINY_XL, 2, MAX_LEN)
    tc = cache_to_torch(jc)
    for c0 in range(0, 23, chunk):
        length = np.clip(lens - c0, 0, chunk).astype(np.int32)
        tk = np.zeros((2, chunk), np.int32)
        for b in range(2):
            tk[b, :length[b]] = toks[b, c0:c0 + length[b]]
        pos = np.full((2,), c0, np.int32)
        jl, jc = jdec.prefill_chunk(params, TINY_XL, jc, jnp.asarray(tk),
                                    jnp.asarray(pos), jnp.asarray(length))
        tl, tc = tdec.prefill_chunk(model, tcfg, tc, T(tk), T(pos),
                                    T(length))
        live = length > 0
        np.testing.assert_allclose(N(tl)[live], N(jl)[live], **TOL)
    assert_cache_close(tc, jc, **TOL)
    _, whole = tdec.prefill(model, tcfg, T(toks[:1]), max_len=MAX_LEN)
    for seg, sc in whole.items():
        for name, leaf in sc.items():
            np.testing.assert_allclose(N(tc[seg][name])[:, :1], N(leaf),
                                       **TOL, err_msg=f"{seg}.{name}")


def test_decode_step_matches(setup):
    params, model, tcfg = setup
    toks = _prompts(3, 12, seed=4)
    _, jc = jdec.prefill(params, TINY_XL, jnp.asarray(toks),
                         max_len=MAX_LEN)
    tc = cache_to_torch(jc)
    token = np.array([5, 7, 9], np.int32)
    for pos in ([12, 12, 12], [13, 13, 13]):
        jl, jc = jdec.decode_step(params, TINY_XL, jc, jnp.asarray(token),
                                  jnp.asarray(pos, jnp.int32))
        tl, tc = tdec.decode_step(model, tcfg, tc, T(token),
                                  T(np.asarray(pos, np.int32)))
        np.testing.assert_allclose(N(tl), N(jl), **TOL)
        token = np.asarray(jnp.argmax(jl, -1), np.int32)
    assert_cache_close(tc, jc, **TOL)


def test_decode_block_matches(setup):
    """Four steps in one block: per-lane budgets, a ride-along lane; A^3
    asked for is a no-op on xLSTM (no attention segment), as in the
    reference."""
    params, model, tcfg = setup
    toks = _prompts(3, 10, seed=6)
    _, jc = jdec.prefill(params, TINY_XL, jnp.asarray(toks),
                         max_len=MAX_LEN)
    tc = cache_to_torch(jc)
    token = np.array([1, 2, 3], np.int32)
    pos = np.array([10, 10, -1], np.int32)
    steps_left = np.array([4, 2, 4], np.int32)
    ring, carry, jc = jdec.decode_block(
        params, TINY_XL, jc, jnp.asarray(token), jnp.asarray(pos),
        jnp.asarray(steps_left), steps=4, a3=A3Config.conservative(),
        resort_every=2)
    tring, tcarry, tc = tdec.decode_block(
        model, tcfg, tc, T(token), T(pos), T(steps_left), steps=4,
        a3=TA3.conservative(), resort_every=2)
    np.testing.assert_array_equal(N(tring), np.asarray(ring))
    np.testing.assert_array_equal(N(tcarry), np.asarray(carry))
    assert N(tring)[2].tolist() == [-1, -1, -1, -1]
    assert_cache_close(tc, jc, **TOL)


def test_pad_lanes_are_bit_identical(setup):
    """A lane riding a chunk dispatch at length 0 and a lane riding a
    decode step at pos = -1 keep every recurrent state leaf
    bit-identical (tests/test_serve_conformance.py's contract)."""
    _, model, tcfg = setup
    _, cache = tdec.prefill(model, tcfg, T(_prompts(2, 9, seed=3)),
                            max_len=32)
    before = {seg: {k: v.clone() for k, v in sc.items()}
              for seg, sc in cache.items()}
    tk = np.zeros((2, 4), np.int32)
    tk[0] = _prompts(1, 4, seed=9)[0]
    tdec.prefill_chunk(model, tcfg, cache, T(tk),
                       T(np.array([9, 0], np.int32)),
                       T(np.array([4, 0], np.int32)))
    tdec.decode_step(model, tcfg, cache, T(np.array([5, 6], np.int32)),
                     T(np.array([13, -1], np.int32)))
    for seg, sc in before.items():
        for name, leaf in sc.items():
            assert torch.equal(cache[seg][name][:, 1], leaf[:, 1]), \
                (seg, name)
            assert not torch.equal(cache[seg][name][:, 0], leaf[:, 0]), \
                (seg, name)


def test_native_init_distributions():
    """``init_params`` draws the reference's xLSTM distributions: forget
    biases 3, other biases 0, unit norms, N(0, 1/d_in) weights."""
    cfg = smoke_variant(port_cfg(TINY_XL))
    model = tdec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ml = model.segs[0].layers[0].mlstm
    sl = model.segs[1].layers[0].slstm
    d = cfg.d_model
    assert torch.equal(ml.b_f, torch.full_like(ml.b_f, 3.0))
    assert torch.equal(ml.b_i, torch.zeros_like(ml.b_i))
    assert torch.equal(sl.b[2 * d:3 * d], torch.full((d,), 3.0))
    assert float(sl.b[:2 * d].abs().sum() + sl.b[3 * d:].abs().sum()) == 0
    assert torch.equal(ml.ln_scale, torch.ones_like(ml.ln_scale))
    for w, fan_in in ((ml.wq.weight, d), (ml.w_i, d), (sl.wx.weight, d),
                      (sl.wr, d // cfg.num_heads),
                      (ml.w_out.weight, cfg.num_heads * cfg.head_dim)):
        std = float(w.float().std()) * fan_in ** 0.5
        assert abs(std - 1.0) < 0.1, (tuple(w.shape), std)


def test_unported_kinds_still_raise():
    """Every token-prompt kind is ported now (RG-LRU blocks and GELU FFNs
    build); what stays unported is a frontend arch, which the port's
    engine refuses as the reference's does."""
    rg = port_cfg(jsmoke(get_arch("recurrentgemma-2b")))
    assert tdec.Decoder(rg, device="cpu").segs[0].layers[0].rnn is not None
    gelu = dataclasses.replace(port_cfg(TINY_XL), d_ff=32, act="gelu")
    seg = tmixer.build_segments(gelu)[0]
    assert seg.ffn == "dense"
    assert tdec.Decoder(gelu, device="cpu").segs[0].layers[0].ffn.w_gate \
        is None
    from repro_torch.serve.engine import ServeEngine
    audio = dataclasses.replace(port_cfg(TINY_XL), frontend="audio_frames")
    with pytest.raises(ValueError, match="frontend"):
        ServeEngine(tdec.Decoder(audio, device="cpu"), audio, slots=1,
                    max_len=8)
