"""The port's MoE FFN (``repro_torch.models.moe``) vs the JAX package's
``moe_apply``, float32, with the reference's parameters copied over.

Outputs, the load-balance loss and the drop fraction within 2e-5; the
routing integers (``top_e``, ``sort_idx``, ``keep``, ``slot``) exactly
equal to the reference's, which this file recomputes in jnp with the
reference's own steps (``moe_apply`` does not return them). Cases: random
routers at the smoke variants' expert counts (deepseek's shared experts,
grok's routing without them) and at deepseek's top-6 over 16 experts; a
skewed router that drops tokens; an all-tie router (zero weights), where
the lowest expert indices must win; a ragged chunk whose pad tokens take
capacity from real ones. Then deepseek's dense layer 0 and MoE layers
through the decoder.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.models.moe import moe_apply as jmoe_apply, moe_init  # noqa: E402
from repro_torch.config import MoEConfig as TMoEConfig  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.mixer import build_segments  # noqa: E402

from test_torch_helpers import F32_TOL, N, T, port_cfg  # noqa: E402

torch.set_num_threads(1)

D = 128
MOES = {
    "deepseek": jcfg.smoke_variant(jcfg.get_arch("deepseek-moe-16b")).moe,
    "grok": jcfg.smoke_variant(jcfg.get_arch("grok-1-314b")).moe,
    "top6": jcfg.MoEConfig(num_experts=16, num_shared=1, top_k=6,
                           d_expert=32),
}


def tcfg_moe(moe):
    return TMoEConfig(**dataclasses.asdict(moe))


def _pair(name, seed=0):
    moe = MOES[name]
    params = moe_init(jax.random.PRNGKey(seed), D, moe, jnp.float32)
    mod = tmoe.MoE(D, tcfg_moe(moe), torch.float32).requires_grad_(False)
    with torch.no_grad():
        for leaf in ("router", "w_gate", "w_up", "w_down"):
            getattr(mod, leaf).copy_(T(params[leaf]))
        if mod.shared is not None:
            for leaf in ("w_gate", "w_up", "w_down"):
                getattr(mod.shared, leaf).weight.copy_(
                    T(params["shared"][leaf]).t())
    return moe, params, mod


def _ref_route(params, x, moe, capacity_factor=1.25):
    """The reference's routing steps (``repro.models.moe.moe_apply``)."""
    t, k, e = x.shape[0], moe.top_k, moe.num_experts
    probs = jax.nn.softmax(x.astype(jnp.float32) @ params["router"], -1)
    top_p, top_e = jax.lax.top_k(probs, k)
    cap = int(math.ceil(t * k / e * capacity_factor))
    cap = ((max(cap, 4) + 63) // 64) * 64
    flat_e = top_e.reshape(-1)
    sort_idx = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = jnp.bincount(flat_e, length=e)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    rank = jnp.arange(t * k) - starts[sorted_e]
    keep = rank < cap
    slot = jnp.where(keep, sorted_e * cap + rank, e * cap)
    return dict(top_e=top_e, sort_idx=sort_idx, keep=keep, slot=slot,
                cap=cap)


def _check(moe, params, mod, x):
    """Output, aux and routing of the port vs the reference on x
    [B, S, D]; returns the port's routing."""
    want, waux = jmoe_apply(params, jnp.asarray(x), moe)
    got, gaux = tmoe.moe_apply(mod, T(x), tcfg_moe(moe))
    np.testing.assert_allclose(N(got), N(want), **F32_TOL)
    for key in ("moe_aux_loss", "moe_drop_fraction"):
        np.testing.assert_allclose(float(gaux[key]), float(waux[key]),
                                   **F32_TOL)
    xt = x.reshape(-1, x.shape[-1])
    ref = _ref_route(params, jnp.asarray(xt), moe)
    r = tmoe.moe_route(mod, T(xt), tcfg_moe(moe))
    assert r["cap"] == ref["cap"]
    for key in ("top_e", "sort_idx", "keep", "slot"):
        np.testing.assert_array_equal(N(r[key]), np.asarray(ref[key]),
                                      err_msg=key)
    return r


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name", sorted(MOES))
def test_moe_apply_matches(name):
    moe, params, mod = _pair(name)
    assert (mod.shared is None) == (moe.num_shared == 0)
    r = _check(moe, params, mod, _x((2, 24, D), 1))
    assert bool(r["keep"].all())                   # no expert full


@pytest.mark.parametrize("name", ["deepseek", "grok"])
def test_skewed_router_drops_the_same_tokens(name):
    """A router that favours expert 0 for most tokens overflows its
    capacity: the dropped choices (keep False) and the outputs equal."""
    moe, params, mod = _pair(name, seed=2)
    bias = np.zeros((D, moe.num_experts), np.float32)
    bias[:, 0] = 0.5
    params = {**params, "router": params["router"] + bias}
    with torch.no_grad():
        mod.router.add_(T(bias))
    r = _check(moe, params, mod, np.abs(_x((2, 128, D), 3)))
    assert 0 < int((~r["keep"]).sum()) < r["keep"].numel()


@pytest.mark.parametrize("name", ["deepseek", "top6"])
def test_all_tie_router_takes_the_lowest_experts(name):
    """Zero router weights: every expert ties, and ``lax.top_k`` takes
    the lower index, so every token routes to experts 0 .. k-1."""
    moe, params, mod = _pair(name, seed=3)
    params = {**params, "router": params["router"] * 0}
    with torch.no_grad():
        mod.router.zero_()
    r = _check(moe, params, mod, _x((2, 16, D), 4))
    assert (r["top_e"] == torch.arange(moe.top_k)).all()


def test_pad_tokens_take_capacity():
    """A ragged chunk routes its pad positions too (T = B * C): on a tied
    router they fill experts 0 and 1 ahead of lane 1's real tokens, which
    are dropped; routing the real tokens alone drops none."""
    moe, params, mod = _pair("grok", seed=5)
    params = {**params, "router": params["router"] * 0}
    with torch.no_grad():
        mod.router.zero_()
    x = _x((2, 96, D), 6)
    x[0, 16:] = x[0, 15]                 # lane 0: 16 real tokens, pads
    r = _check(moe, params, mod, x)      # 192 choices per expert, cap 128
    keep = N(r["keep"])[np.argsort(N(r["sort_idx"]))].reshape(2, 96, 2)
    assert keep[0].all() and not keep[1].all()          # lane 1 dropped
    alone = np.concatenate([x[0, :16], x[1]])[None]
    r_alone = _check(moe, params, mod, alone)   # 112 choices, cap 128
    assert bool(r_alone["keep"].all())


@pytest.fixture(scope="module")
def deepseek():
    cfg = dataclasses.replace(
        jcfg.smoke_variant(jcfg.get_arch("deepseek-moe-16b")),
        num_layers=3, dtype="float32")
    params = jdec.init_params(jax.random.PRNGKey(7), cfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(cfg), device="cpu")
    return cfg, params, model


def test_deepseek_dense_layer0_then_moe(deepseek):
    """Layer 0 keeps a dense SwiGLU FFN, layers 1-2 are MoE with the
    shared experts; the reference's leaves arrive bit for bit."""
    cfg, params, model = deepseek
    segs = build_segments(port_cfg(cfg))
    assert [(s.ffn, s.layers) for s in segs] == [("dense", (0,)),
                                                 ("moe", (1, 2))]
    blk0, blk1 = model.segs[0].layers[0], model.segs[1].layers[1]
    assert blk0.moe is None and blk0.ffn is not None
    assert blk1.ffn is None and blk1.moe.shared is not None
    moe = params["seg1"]["moe"]
    np.testing.assert_array_equal(N(blk1.moe.w_down), N(moe["w_down"][1]))
    np.testing.assert_array_equal(N(blk1.moe.router), N(moe["router"][1]))
    np.testing.assert_array_equal(N(blk1.moe.shared.w_up.weight),
                                  N(moe["shared"]["w_up"][1]).T)


def test_deepseek_ragged_chunk_matches(deepseek):
    """Ragged prefill chunks (a fresh lane, a mid-prompt lane, a length-0
    lane) through the dense layer 0 and the MoE layers; the length-0
    lane's pad rows are routed with the rest and its cache stays
    bit-identical."""
    cfg, params, model = deepseek
    tcfg = port_cfg(cfg)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 20)).astype(np.int32)
    _, jc = jdec.prefill(params, cfg, jnp.asarray(toks), max_len=64)
    _, tc = tdec.prefill(model, tcfg, T(toks), max_len=64)
    before = {k: v.clone() for k, v in tc["seg1"].items()}
    chunk = rng.integers(0, cfg.vocab_size, size=(3, 8)).astype(np.int32)
    pos, length = np.array([0, 20, 5]), np.array([8, 5, 0])
    jl, jc = jdec.prefill_chunk(params, cfg, jc, jnp.asarray(chunk),
                                jnp.asarray(pos), jnp.asarray(length))
    tl, tc = tdec.prefill_chunk(model, tcfg, tc, T(chunk), T(pos),
                                T(length))
    np.testing.assert_allclose(N(tl)[:2], N(jl)[:2], rtol=2e-4, atol=2e-4)
    for name, leaf in before.items():
        assert torch.equal(tc["seg1"][name][:, 2], leaf[:, 2]), name
