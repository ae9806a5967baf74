"""Decoder of the port vs the JAX package, with the reference's weights
carried over by ``params_from_numpy``.

Configs: the conformance suite's ``TINY`` (f32) and the phi4-mini smoke
variant in f32 and bf16. Caches are compared leaf for leaf (float leaves
within tolerance, integer leaves — sorted rows, watermarks — equal).

Tolerances, and why:
* f32: 1e-4 on logits and cache leaves. Each op agrees at ~1e-6, but
  matmuls sum in another order in XLA and torch, and two layers of
  attention, FFN and norms compound it; logits are O(1)-O(10).
* bf16: 0.25 on logits (O(10)), 0.1 on cache leaves. bf16 keeps 8
  mantissa bits, so an intermediate that rounds one way in XLA and the
  other in torch moves by one bf16 step (2^-7 relative) and carries
  through the following layers; 0.25 is a few such steps at the logits'
  scale. Ring rows are written from the same projections (checked
  first-hand at 0.1).
Sorted-key rows are compared exactly only where the keys are (f32):
with bf16 keys equal values can come from different rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import A3Config, get_arch, smoke_variant  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from test_torch_helpers import TINY, N, T, assert_cache_close, \
    cache_to_torch, port_a3, port_cfg  # noqa: E402

torch.set_num_threads(1)

PHI4_SMOKE = smoke_variant(get_arch("phi4-mini-3.8b"))
CONFIGS = {
    "tiny-f32": TINY,
    "phi4smoke-f32": dataclasses.replace(PHI4_SMOKE, dtype="float32"),
    "phi4smoke-bf16": PHI4_SMOKE,
}
MAX_LEN = 64
TOL = {"float32": dict(logits=1e-4, cache=1e-4),
       "bfloat16": dict(logits=0.25, cache=0.1)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    jcfg = CONFIGS[request.param]
    params = jdec.init_params(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_numpy(tree, port_cfg(jcfg), device="cpu")
    return jcfg, port_cfg(jcfg), params, model, TOL[jcfg.dtype]


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                size=(b, s)).astype(np.int32)


def _drop_rows(cache):
    """Cache minus the sorted rows (compared separately when exact)."""
    return {seg: {k: v for k, v in sc.items() if k != "sk_rows"}
            for seg, sc in cache.items()}


def _check_cache(got, want, cfg, tol):
    if cfg.dtype == "float32":
        assert_cache_close(got, want, tol["cache"], tol["cache"])
    else:
        assert_cache_close(_drop_rows(got), _drop_rows(want), tol["cache"],
                           tol["cache"])


def test_params_carried_bit_for_bit(setup):
    jcfg, tcfg, params, model, _ = setup
    np.testing.assert_array_equal(N(model.embed), N(params["embed"]))
    np.testing.assert_array_equal(N(model.lm_head.weight),
                                  N(params["lm_head"]).T)
    seg = params["seg0"]
    for l, blk in enumerate(model.segs[0].layers):
        np.testing.assert_array_equal(N(blk.attn.wk.weight),
                                      N(seg["attn"]["wk"][l]).T)
        np.testing.assert_array_equal(N(blk.ffn.w_down.weight),
                                      N(seg["ffn"]["w_down"][l]).T)
        np.testing.assert_array_equal(N(blk.ln2.scale),
                                      N(seg["ln2"]["scale"][l]))


def test_prefill_matches(setup):
    """Whole-prompt prefill with the A^3 sort: logits, rings, sorted
    columns and watermarks."""
    jcfg, tcfg, params, model, tol = setup
    toks = _prompts(jcfg, 2, 20)
    lg, cache = jdec.prefill(params, jcfg, jnp.asarray(toks),
                             max_len=MAX_LEN, a3=True)
    tlg, tcache = tdec.prefill(model, tcfg, T(toks), max_len=MAX_LEN,
                               a3=True)
    np.testing.assert_allclose(N(tlg), N(lg), rtol=tol["logits"],
                               atol=tol["logits"])
    _check_cache(tcache, cache, jcfg, tol)


def test_attn_forward_matches(setup):
    """The mixer's full-sequence forward (the chunked flash attention in
    torch ops), with chunks shorter than the sequence."""
    from repro.models import mixer as jmixer
    from repro_torch.models import mixer as tmixer
    jcfg, tcfg, params, model, tol = setup
    seg, tseg = jmixer.build_segments(jcfg)[0], tmixer.build_segments(tcfg)[0]
    hn = np.random.default_rng(8).standard_normal(
        (2, 20, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20))
    lp = jax.tree_util.tree_map(lambda x: x[0], params["seg0"])
    want = jmixer._attn_forward(lp, jnp.asarray(hn, jcfg.dtype), cfg=jcfg,
                                seg=seg, positions=jnp.asarray(pos),
                                attn_chunk=8)
    got = tmixer.MIXERS[tseg.kind].forward(
        model.segs[0].layers[0], T(hn).to(model.embed.dtype), cfg=tcfg,
        seg=tseg, positions=T(pos), attn_chunk=8)
    np.testing.assert_allclose(N(got), N(want), rtol=tol["cache"],
                               atol=tol["cache"])


def test_prefill_chunk_ragged_matches(setup):
    """Two ragged chunk dispatches over a populated cache: a fresh lane
    (pos 0), a mid-prompt lane, and a length-0 lane whose cache must
    stay bit-identical."""
    jcfg, tcfg, params, model, tol = setup
    toks = _prompts(jcfg, 3, 30, seed=1)
    _, base = jdec.prefill(params, jcfg, jnp.asarray(toks), max_len=MAX_LEN,
                           a3=True)
    jc, tc = base, cache_to_torch(base)
    before = {k: v.clone() for k, v in tc["seg0"].items()}
    chunk = _prompts(jcfg, 3, 8, seed=2)
    for pos, length in (([0, 30, 5], [8, 6, 0]), ([8, 36, 5], [5, 8, 0])):
        sort = np.array([True, False, False])
        jl, jc = jdec.prefill_chunk(params, jcfg, jc, jnp.asarray(chunk),
                                    jnp.asarray(pos), jnp.asarray(length),
                                    a3=True, sort_lanes=jnp.asarray(sort))
        tl, tc = tdec.prefill_chunk(model, tcfg, tc, T(chunk), T(pos),
                                    T(length), a3=True, sort_lanes=T(sort))
        live = np.asarray(length) > 0
        np.testing.assert_allclose(N(tl)[live], N(jl)[live],
                                   rtol=tol["logits"], atol=tol["logits"])
    _check_cache(tc, jc, jcfg, tol)
    for name, leaf in before.items():            # the length-0 lane
        assert torch.equal(tc["seg0"][name][:, 2], leaf[:, 2]), name


@pytest.mark.parametrize("mode", ["off", "conservative"])
def test_decode_step_matches(setup, mode):
    """Ragged decode over a prefilled cache, with a pos = -1 lane whose
    cache must stay bit-identical."""
    jcfg, tcfg, params, model, tol = setup
    a3 = A3Config() if mode == "off" else A3Config.conservative()
    toks = _prompts(jcfg, 3, 24, seed=4)
    _, jc = jdec.prefill(params, jcfg, jnp.asarray(toks), max_len=MAX_LEN,
                         a3=mode != "off")
    tc = cache_to_torch(jc)
    before = {k: v.clone() for k, v in tc["seg0"].items()}
    token = np.array([5, 7, 9], np.int32)
    for pos in ([24, 24, -1], [25, 25, -1]):
        jl, jc = jdec.decode_step(params, jcfg, jc, jnp.asarray(token),
                                  jnp.asarray(pos, jnp.int32), a3=a3)
        tl, tc = tdec.decode_step(model, tcfg, tc, T(token),
                                  T(np.asarray(pos, np.int32)),
                                  a3=port_a3(a3))
        np.testing.assert_allclose(N(tl)[:2], N(jl)[:2], rtol=tol["logits"],
                                   atol=tol["logits"])
        token = np.asarray(jnp.argmax(jl, -1), np.int32)
    _check_cache(tc, jc, jcfg, tol)
    for name, leaf in before.items():
        assert torch.equal(tc["seg0"][name][:, 2], leaf[:, 2]), name


def test_resort_sorted_keys_matches(setup):
    """Due lanes (pos - sorted_upto >= resort_every) re-sort, the rest
    and pos < 0 lanes keep their columns; rows equal exactly (same
    input keys on both sides)."""
    jcfg, tcfg, params, model, _ = setup
    toks = _prompts(jcfg, 3, 16, seed=5)
    _, jc = jdec.prefill(params, jcfg, jnp.asarray(toks), max_len=MAX_LEN,
                         a3=True)
    # ring rows 16..19 written after the sort (the fresh tail)
    k = np.asarray(jc["seg0"]["k"]).astype(np.float32)
    k[:, :, :, 16:20] = np.random.default_rng(9).standard_normal(
        k[:, :, :, 16:20].shape)
    jc = {"seg0": {**jc["seg0"],
                   "k": jnp.asarray(k, jc["seg0"]["k"].dtype)}}
    tc = cache_to_torch(jc)
    pos = np.array([20, 17, -1], np.int32)
    want = jdec.resort_sorted_keys(jc, jnp.asarray(pos), 3)
    got = tdec.resort_sorted_keys(tc, T(pos), 3)
    for name in ("sk_vals", "sk_rows", "sorted_upto"):
        np.testing.assert_array_equal(N(got["seg0"][name]),
                                      N(want["seg0"][name]), err_msg=name)
    assert N(got["seg0"]["sorted_upto"])[0].tolist() == [20, 16, 16]
    assert not np.array_equal(N(got["seg0"]["sk_vals"])[:, 0],
                              N(jc["seg0"]["sk_vals"])[:, 0])   # re-sorted


@pytest.mark.parametrize("mode", ["off", "conservative"])
def test_decode_block_matches(setup, mode):
    """Four steps in one block: per-lane budgets, a ride-along lane, a
    POISON lane (emits POISON once, then freezes) and the re-sort.

    In bf16 greedy tokens can differ where two logits tie in bf16: the
    smoke config shows a top-2 gap of exactly 0.0, which the last
    rounding bit decides differently in XLA and torch. There only the
    ring's sentinel structure (budgets, ride-along, poison) is compared;
    the per-step bf16 logits are held by ``test_decode_step_matches``."""
    jcfg, tcfg, params, model, tol = setup
    a3 = A3Config() if mode == "off" else A3Config.conservative()
    toks = _prompts(jcfg, 4, 12, seed=6)
    _, jc = jdec.prefill(params, jcfg, jnp.asarray(toks), max_len=MAX_LEN,
                         a3=mode != "off")
    tc = cache_to_torch(jc)
    token = np.array([1, 2, jdec.POISON, 4], np.int32)
    pos = np.array([12, 12, 12, -1], np.int32)
    steps_left = np.array([4, 2, 4, 4], np.int32)
    ring, carry, jc = jdec.decode_block(
        params, jcfg, jc, jnp.asarray(token), jnp.asarray(pos),
        jnp.asarray(steps_left), steps=4, a3=a3, resort_every=2)
    tring, tcarry, tc = tdec.decode_block(
        model, tcfg, tc, T(token), T(pos), T(steps_left), steps=4,
        a3=port_a3(a3), resort_every=2)
    assert N(tring)[2].tolist() == [jdec.POISON, -1, -1, -1]
    assert N(tring)[3].tolist() == [-1, -1, -1, -1]
    np.testing.assert_array_equal(N(tring) < 0, np.asarray(ring) < 0)
    if jcfg.dtype == "float32":
        np.testing.assert_array_equal(N(tring), np.asarray(ring))
        np.testing.assert_array_equal(N(tcarry), np.asarray(carry))
        _check_cache(tc, jc, jcfg, tol)


def test_sample_logits_greedy_first_max():
    lg = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 0.0, 5.0]])
    assert tdec.sample_logits(lg).tolist() == [1, 0]
    # a temperature without a key stays greedy, as the reference's
    # sample_logits does without an rng
    assert tdec.sample_logits(lg, temperature=0.7).tolist() == [1, 0]


def test_native_init_distributions():
    """``init_params`` draws the reference's distributions: unit norms,
    N(0, 1) embeddings, N(0, 1/d_in) dense weights (wo and w_down scaled
    by their own fan-in)."""
    cfg = port_cfg(CONFIGS["phi4smoke-f32"])
    model = tdec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    blk = model.segs[0].layers[0]
    assert torch.equal(blk.ln1.scale, torch.ones_like(blk.ln1.scale))
    for w, fan_in in ((model.embed, 1), (blk.attn.wq.weight, cfg.d_model),
                      (blk.attn.wo.weight, cfg.num_heads * cfg.head_dim),
                      (blk.ffn.w_down.weight, cfg.d_ff),
                      (model.lm_head.weight, cfg.d_model)):
        std = float(w.float().std()) * fan_in ** 0.5
        assert abs(std - 1.0) < 0.05, (tuple(w.shape), std)
        assert abs(float(w.float().mean())) * fan_in ** 0.5 < 0.05
