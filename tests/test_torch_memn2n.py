"""The port's MemN2N (``repro_torch.models.memn2n``) vs the JAX package's,
float32, with the reference's parameters carried over by
``memn2n_from_numpy``; then the paper's workload trained by the port.

* ``answer`` (softmax and linear start), ``loss_fn`` and its gradients
  against the reference's (``vmap`` over examples there, a batch
  dimension here) within 1e-5.
* ``answer_with_a3`` per example at conservative, aggressive, custom and
  the i=4/f=4 quantized setting: logits within 2e-5 and each hop's
  candidate mask exactly the reference's; over a batch of examples
  (what ``accuracy`` uses) it selects exactly the candidates it selects
  for each example alone.
* 700 steps of the port's AdamW on ``tests/test_memn2n.py``'s task (from
  the reference's initial parameters, the port's copy of the bAbI
  generator): the four claims of that file hold on the port.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.data.babi import generate_babi as jgen, \
    make_task as jtask  # noqa: E402
from repro.models import memn2n as jm  # noqa: E402
from repro_torch import config as tcfg  # noqa: E402
from repro_torch.data.babi import generate_babi, make_task  # noqa: E402
from repro_torch.models import memn2n as tm  # noqa: E402
from repro_torch.models.convert import memn2n_from_numpy  # noqa: E402
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: E402

from test_torch_helpers import N, port_a3  # noqa: E402

torch.set_num_threads(1)

A3S = {
    "conservative": jcfg.A3Config.conservative(),
    "aggressive": jcfg.A3Config.aggressive(),
    "custom": jcfg.A3Config(mode=jcfg.A3Mode.CUSTOM, m_fraction=0.25,
                            threshold_pct=8.0),
    "i4f4": jcfg.A3Config(mode=jcfg.A3Mode.CUSTOM, m_fraction=1.0,
                          threshold_pct=1e-4, int_bits=4, frac_bits=4),
}


def _task():
    return jtask(num_actors=32, num_places=8, max_sentences=24, max_words=8)


@pytest.fixture(scope="module")
def pair():
    task = _task()
    jc = jm.MemN2NConfig(vocab_size=task.vocab_size, d_embed=32,
                         num_hops=2, max_sentences=task.max_sentences,
                         max_words=task.max_words)
    params = jm.init_params(jax.random.PRNGKey(0), jc)
    tp = memn2n_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    return task, jc, tm.MemN2NConfig(*jc), params, tp


@pytest.mark.parametrize("linear", [False, True])
def test_answer_loss_and_grads_match(pair, linear):
    task, jc, tc, params, tp = pair
    b = jgen(task, 16, 20, seed=3)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = jax.jit(jax.vmap(lambda s, q: jm.answer(params, s, q, jc,
                                                   linear=linear)))(
        jb["sentences"], jb["question"])
    got = tm.answer(tp, b["sentences"], b["question"], tc, linear=linear)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    wl, wg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, jc, linear)))(params, jb)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    loss = tm.loss_fn(leaves, b, tc, linear=linear)
    loss.backward()
    assert loss.item() == pytest.approx(float(wl), rel=1e-5)
    for k, t in leaves.items():
        np.testing.assert_allclose(N(t.grad), np.asarray(wg[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("setting", sorted(A3S))
def test_answer_with_a3_matches(pair, setting):
    task, jc, tc, params, tp = pair
    a3 = A3S[setting]
    b = jgen(task, 12, 20, seed=5)
    # the reference per example (vmapped and jitted: no LUT on this path)
    wl, waux = jax.jit(jax.vmap(
        lambda s, q: jm.answer_with_a3(params, s, q, jc, a3)))(
        jnp.asarray(b["sentences"]), jnp.asarray(b["question"]))
    batch_logits, batch_aux = tm.answer_with_a3(
        tp, b["sentences"], b["question"], tc, port_a3(a3))
    for i in range(len(b["answer"])):
        gl, gaux = tm.answer_with_a3(tp, b["sentences"][i],
                                     b["question"][i], tc, port_a3(a3))
        np.testing.assert_allclose(N(gl), np.asarray(wl[i]), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(N(batch_logits[i]), N(gl), rtol=2e-5,
                                   atol=2e-5)
        for hop in range(jc.num_hops):
            h = f"hop{hop}"
            want = np.asarray(waux[h]["candidates"][i])
            np.testing.assert_array_equal(N(gaux[h]["candidates"]), want)
            np.testing.assert_array_equal(
                N(batch_aux[h]["candidates"][i]), want)
            np.testing.assert_array_equal(N(gaux[h]["kept"]),
                                          np.asarray(waux[h]["kept"][i]))


def test_babi_data_is_the_reference_generator(pair):
    task = pair[0]
    assert tuple(make_task(num_actors=32, num_places=8, max_sentences=24,
                           max_words=8)) == tuple(task)
    for k, v in generate_babi(make_task(32, 8, 24, 8), 8, 20,
                              seed=1).items():
        np.testing.assert_array_equal(v, jgen(task, 8, 20, seed=1)[k])


@pytest.fixture(scope="module")
def trained(pair):
    """tests/test_memn2n.py's training run, on the port."""
    _, _, cfg, _, init = pair
    task = make_task(num_actors=32, num_places=8, max_sentences=24,
                     max_words=8)
    params = {k: v.clone().requires_grad_() for k, v in init.items()}
    ocfg = tcfg.OptimizerConfig(lr=1e-2, warmup_steps=10, total_steps=700,
                                weight_decay=0.0, min_lr_ratio=0.3)
    opt = adamw_init(params, ocfg)
    for i in range(700):
        b = generate_babi(task, 64, 20, seed=100 + i)
        grads = torch.autograd.grad(tm.loss_fn(params, b, cfg),
                                    list(params.values()))
        _, opt, _ = adamw_update(dict(zip(params, grads)), opt, params, ocfg)
    test = generate_babi(task, 256, 20, seed=9)
    return {k: v.detach() for k, v in params.items()}, cfg, test


def test_learns_task(trained):
    params, cfg, test = trained
    acc = float(tm.accuracy(params, test, cfg))
    assert acc > 0.85, acc


def test_a3_conservative_small_drop(trained):
    params, cfg, test = trained
    base = float(tm.accuracy(params, test, cfg))
    acc = float(tm.accuracy(params, test, cfg,
                            tcfg.A3Config.conservative()))
    assert acc >= base - 0.05, (base, acc)


def test_a3_m_monotonic_candidates(trained):
    """More iterations M -> more (or equal) candidates selected."""
    params, cfg, test = trained
    counts = []
    for frac in [0.125, 0.5, 1.0]:
        a3 = tcfg.A3Config(mode=tcfg.A3Mode.CUSTOM, m_fraction=frac,
                           threshold_pct=1e-4)
        _, aux = tm.answer_with_a3(params, test["sentences"][:32],
                                   test["question"][:32], cfg, a3)
        counts.append(float(aux["hop0"]["candidates"].sum(-1).float()
                            .mean()))
    assert counts[0] <= counts[1] + 1e-6 <= counts[2] + 2e-6, counts


def test_quantized_path_close(trained):
    """i=4, f=4 fixed-point inputs (paper SSVI-B): accuracy within 2%."""
    params, cfg, test = trained
    base = float(tm.accuracy(params, test, cfg))
    a3 = tcfg.A3Config(mode=tcfg.A3Mode.CUSTOM, m_fraction=1.0,
                       threshold_pct=1e-4, int_bits=4, frac_bits=4)
    acc = float(tm.accuracy(params, test, cfg, a3))
    assert acc >= base - 0.02, (base, acc)
