"""The frontend archs (musicgen-medium, internvl2-2b) from precomputed
embeddings, the port vs the JAX package, on the smoke variant of each
(``smoke_variant``, float32, B=2, S=32) with the reference's weights
carried over and the same embeddings, made with numpy from a seed, fed
to both packages:

* ``forward(inputs_embeds=...)`` logits, ``prefill(inputs_embeds=...)``
  logits and cache, and ``decode_step(input_embed=...)`` after it, within
  2e-4 (the reference's own tolerance for logits through a whole smoke
  model, ``tests/test_archs_smoke.py``); the port's prefill-then-decode
  against its own full forward within 2e-4;
* internvl2-2b's layout: patch embeddings followed by the embedded text
  prompt, prefilled, then greedy ``decode_step(token)``: tokens equal;
* ``prefill(a3=True)`` and conservative ``decode_step(input_embed=...)``:
  sorted-key rows equal, logits within 2e-4;
* train steps on ``{"embeds", "labels"}`` batches: ``lm_loss`` within
  1e-5 and every gradient within 1e-4 of the largest, ``embed``'s exactly
  zero in both (the table is not in the graph); 3 steps of
  ``make_train_step`` at microbatches 1 and 2: losses within 1e-5
  relative, ``embed`` after them decayed by AdamW alone (its moments
  zero) and within 1e-6 of the reference's;
* the frontend stubs: shape, dtype, the same values from the same
  generator seed, per-element std near 1 (their values are not
  ``jax.random``'s: the two packages draw from different streams).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa
from repro.train.step import TrainState as JTrainState  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import config as tcfg  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import frontend  # noqa: E402
from repro_torch.models.convert import params_from_numpy, \
    train_state_from_numpy  # noqa: E402
from repro_torch.optim.adamw import cosine_schedule  # noqa: E402
from repro_torch.train.step import _grads_one, make_train_step  # noqa

from test_torch_helpers import N, T, assert_cache_close, port_a3, \
    port_cfg  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("musicgen-medium", "internvl2-2b")
TOL = dict(rtol=2e-4, atol=2e-4)
B, S = 2, 32


def _embeds(cfg, seed, s=S):
    return np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    cfg = dataclasses.replace(jcfg.smoke_variant(jcfg.get_arch(request.param)),
                              dtype="float32")
    params = jdec.init_params(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_numpy(np_params, port_cfg(cfg), device="cpu")
    return cfg, port_cfg(cfg), params, np_params, model, _embeds(cfg, 1)


def test_forward_matches(smoke):
    cfg, tc, params, _, model, emb = smoke
    lg, _ = jdec.forward(params, cfg, inputs_embeds=jnp.asarray(emb))
    tlg, _ = tdec.forward(model, tc, inputs_embeds=T(emb))
    assert tlg.shape == (B, S, tdec.padded_vocab(cfg.vocab_size))
    np.testing.assert_allclose(N(tlg), N(lg), **TOL)


def test_prefill_then_decode_matches(smoke):
    """Prefill S - 1 frames, decode the last one at position S - 1:
    logits and every cache leaf after each, against the reference and
    against the port's own full forward."""
    cfg, tc, params, _, model, emb = smoke
    lg, cache = jdec.prefill(params, cfg, inputs_embeds=jnp.asarray(
        emb[:, :S - 1]), max_len=S + 4)
    tlg, tcache = tdec.prefill(model, tc, inputs_embeds=T(emb[:, :S - 1]),
                               max_len=S + 4)
    np.testing.assert_allclose(N(tlg), N(lg), **TOL)
    assert_cache_close(tcache, cache, TOL["rtol"], TOL["atol"])
    ld, cache = jdec.decode_step(params, cfg, cache, None, jnp.int32(S - 1),
                                 input_embed=jnp.asarray(emb[:, S - 1]))
    tld, tcache = tdec.decode_step(model, tc, tcache, pos=S - 1,
                                   input_embed=T(emb[:, S - 1]))
    np.testing.assert_allclose(N(tld), N(ld), **TOL)
    assert_cache_close(tcache, cache, TOL["rtol"], TOL["atol"])
    full, _ = tdec.forward(model, tc, inputs_embeds=T(emb))
    np.testing.assert_allclose(N(tlg), N(full[:, S - 2]), **TOL)
    np.testing.assert_allclose(N(tld), N(full[:, S - 1]), **TOL)


def test_decode_on_a_ring_block_k_does_not_divide(smoke):
    """max_len 532 (> 512, not a multiple of #1's block_k; musicgen's
    served ring is 1064): decode steps from embeddings, A^3 off (#1's
    plain version on the CPU), within 2e-4 of the reference."""
    cfg, tc, params, _, model, emb = smoke
    lg, cache = jdec.prefill(params, cfg, inputs_embeds=jnp.asarray(
        emb[:, :S - 2]), max_len=532)
    tlg, tcache = tdec.prefill(model, tc, inputs_embeds=T(emb[:, :S - 2]),
                               max_len=532)
    assert tcache["seg0"]["k"].shape[3] == 532
    for pos in (S - 2, S - 1):
        lg, cache = jdec.decode_step(params, cfg, cache, None, jnp.int32(pos),
                                     input_embed=jnp.asarray(emb[:, pos]))
        tlg, tcache = tdec.decode_step(model, tc, tcache, pos=pos,
                                       input_embed=T(emb[:, pos]))
        np.testing.assert_allclose(N(tlg), N(lg), **TOL)


def test_a3_prefill_and_conservative_decode_match(smoke):
    """``prefill(a3=True)`` builds the same sorted keys from embeddings
    (rows equal), and conservative decode steps from them agree."""
    cfg, tc, params, _, model, emb = smoke
    a3 = jcfg.A3Config.conservative()
    lg, cache = jdec.prefill(params, cfg, inputs_embeds=jnp.asarray(
        emb[:, :S - 3]), max_len=S + 4, a3=True)
    tlg, tcache = tdec.prefill(model, tc, inputs_embeds=T(emb[:, :S - 3]),
                               max_len=S + 4, a3=True)
    assert "sk_rows" in tcache["seg0"]
    np.testing.assert_allclose(N(tlg), N(lg), **TOL)
    assert_cache_close(tcache, cache, TOL["rtol"], TOL["atol"])
    for pos in range(S - 3, S):
        ld, cache = jdec.decode_step(params, cfg, cache, None, jnp.int32(pos),
                                     input_embed=jnp.asarray(emb[:, pos]),
                                     a3=a3)
        tld, tcache = tdec.decode_step(model, tc, tcache, pos=pos,
                                       input_embed=T(emb[:, pos]),
                                       a3=port_a3(a3))
        np.testing.assert_allclose(N(tld), N(ld), **TOL)


def test_internvl2_patches_then_text_greedy_tokens_equal():
    """internvl2-2b's layout: 16 patch embeddings and the embedded
    16-token text prompt prefilled as one sequence, then 6 greedy
    ``decode_step(token)`` steps: the same tokens in both packages."""
    cfg = dataclasses.replace(jcfg.smoke_variant(jcfg.get_arch(
        "internvl2-2b")), dtype="float32")
    tc = port_cfg(cfg)
    params = jdec.init_params(jax.random.PRNGKey(3), cfg)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tc,
                              device="cpu")
    rng = np.random.default_rng(4)
    vis = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    text = rng.integers(0, cfg.vocab_size, size=(B, 16)).astype(np.int32)
    j_in = jnp.concatenate([jnp.asarray(vis), jdec.embed_tokens(
        params, cfg, jnp.asarray(text))], axis=1)
    t_in = torch.cat([T(vis), tdec.embed_tokens(model, tc, T(text))], 1)
    lg, cache = jdec.prefill(params, cfg, inputs_embeds=j_in, max_len=40)
    tlg, tcache = tdec.prefill(model, tc, inputs_embeds=t_in, max_len=40)
    want, got = [], []
    for pos in range(32, 38):
        np.testing.assert_allclose(N(tlg), N(lg), **TOL)
        want.append(np.asarray(jnp.argmax(lg, -1), np.int32))
        got.append(N(torch.argmax(tlg, -1).to(torch.int32)))
        lg, cache = jdec.decode_step(params, cfg, cache,
                                     jnp.asarray(want[-1]), jnp.int32(pos))
        tlg, tcache = tdec.decode_step(model, tc, tcache, T(got[-1]), pos)
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def _labels(cfg, seed=2):
    labels = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels[0, -3:] = -1                       # ignored positions
    return labels


def test_embeds_loss_and_grads_match_reference(smoke):
    """One batch of embeddings: the loss and every gradient against
    ``jax.value_and_grad`` of the reference's ``lm_loss``; ``embed`` is
    not in either graph and its gradient is exactly zero in both."""
    cfg, tc, params, np_params, _, emb = smoke
    labels = _labels(cfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, e, l: jdec.lm_loss(p, cfg, None, l, inputs_embeds=e,
                                     ce_chunk=16)[0]))(
        params, jnp.asarray(emb), jnp.asarray(labels))
    model = params_from_numpy(np_params, tc,
                              device="cpu").requires_grad_(True)
    got_loss, got = _grads_one(model, tc, {"embeds": T(emb),
                                           "labels": T(labels)},
                               "none", 1024, 16)
    assert float(got_loss) == pytest.approx(float(loss), rel=1e-5, abs=1e-6)
    want = {n: N(w) for n, w in params_from_numpy(
        jax.tree_util.tree_map(np.asarray, grads), tc,
        device="cpu").named_parameters()}
    assert set(got) == set(want)
    assert not np.asarray(grads["embed"]).any()
    assert got["embed"].shape == model.embed.shape
    assert not got["embed"].any()
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, g in got.items():
        np.testing.assert_allclose(N(g), want[name], rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_embeds_train_steps_match_reference(smoke, microbatches):
    """3 steps of each package's ``make_train_step`` on one
    ``{"embeds", "labels"}`` batch from the same parameters: losses within
    1e-5 relative; ``embed`` after them is the initial table times
    prod(1 - lr_t * weight_decay) (weight decay alone moves it: m and v
    stay zero) and within 1e-6 of the reference's. The other parameters
    are held through the losses: AdamW divides each gradient by its own
    RMS, so an entry whose gradient is rounding noise takes an lr-sized
    step of either sign in either package."""
    cfg, tc, _, np_params, _, emb = smoke
    labels = _labels(cfg)

    def run(m, model):
        return m.RunConfig(
            model=model, shape=m.ShapeConfig("t", m.ShapeKind.TRAIN, S, B),
            optimizer=m.OptimizerConfig(lr=1e-3, total_steps=10,
                                        warmup_steps=1),
            sharding=m.ShardingConfig(remat="none",
                                      microbatches=microbatches))
    jrun, trun = run(jcfg, cfg), run(tcfg, tc)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jstate = JTrainState(jp, j_adamw_init(jp, jrun.optimizer), None)
    jstep = j_make_train_step(jrun, None, donate=False)
    tstate = train_state_from_numpy(np_params, trun, device="cpu")
    tstep = make_train_step(trun)
    jbatch = {"embeds": jnp.asarray(emb), "labels": jnp.asarray(labels)}
    tbatch = {"embeds": emb, "labels": labels}
    want, got = [], []
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert not tstate.opt.m["embed"].any() and not tstate.opt.v["embed"].any()
    decayed = torch.from_numpy(np.array(np_params["embed"]))
    for step in range(1, 4):
        lr = float(cosine_schedule(trun.optimizer, torch.tensor(step)))
        decayed = decayed - lr * trun.optimizer.weight_decay * decayed
    got_embed = N(tstate.model.embed)
    assert not np.array_equal(got_embed, np_params["embed"])
    np.testing.assert_allclose(got_embed, N(decayed), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_embed, np.asarray(jstate.params["embed"]),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_frontend_stubs(arch):
    cfg = tcfg.smoke_variant(tcfg.get_arch(arch))
    assert cfg.frontend and cfg.dtype == "bfloat16"

    def gen(seed):
        return torch.Generator().manual_seed(seed)
    audio = frontend.audio_frame_embeds(gen(0), 3, 200, cfg)
    assert audio.shape == (3, 200, cfg.d_model)
    assert audio.dtype == torch.bfloat16
    assert torch.equal(audio, frontend.audio_frame_embeds(gen(0), 3, 200,
                                                          cfg))
    assert not torch.equal(audio, frontend.audio_frame_embeds(gen(1), 3, 200,
                                                              cfg))
    # another count of codebooks: other sums, still of unit variance
    other = frontend.audio_frame_embeds(gen(0), 3, 200, cfg,
                                        num_codebooks=cfg.num_codebooks + 1)
    assert not torch.equal(audio, other)
    vis, toks = frontend.vlm_sequence(gen(0), 3, 300, 200, cfg)
    assert vis.shape == (3, 200, cfg.d_model) and vis.dtype == torch.bfloat16
    assert toks.shape == (3, 100) and toks.dtype == torch.int32
    assert 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size
    v2, t2 = frontend.vlm_sequence(gen(0), 3, 300, 200, cfg)
    assert torch.equal(vis, v2) and torch.equal(toks, t2)
    patches = frontend.vision_patch_embeds(gen(5), 3, 200, cfg)
    assert patches.shape == (3, 200, cfg.d_model)
    for x in (audio, other, vis, patches):
        x = x.float()
        assert abs(float(x.mean())) < 0.02
        assert float(x.std()) == pytest.approx(1.0, abs=0.02)
