"""The port's training forward, loss and gradients, checkpoint manager,
watchdog and launcher vs the JAX package (``repro.models.decoder`` /
``repro.train``), float32, with the reference's parameters carried over
by ``params_from_numpy``.

* ``lm_loss`` and every parameter's gradient against
  ``jax.value_and_grad`` of the reference's ``lm_loss`` on TINY, TINY_XL,
  TINY_RG and a tiny MoE, at remat none / full / dots on the port (the
  reference at remat none: its remat changes no number either). Loss
  within 1e-5, every gradient within 1e-4 of the largest gradient
  magnitude of the model (float32 sums taken in another order in XLA and
  torch, through two to three layers and a backward; the mLSTM input-gate
  biases' gradients are ~1e-8, sums of terms that cancel, so a bound per
  tensor would measure that cancellation's rounding, not the port).
* ``chunked_ce`` with a chunk that divides S and one that does not (the
  single-chunk fallback), labels of -1 ignored.
* ``MLSTMChunk``'s backward (the plain version recomputed) against
  autograd through ``mlstm_chunk_plain``: equal.
* The checkpoint, watchdog and restart cases of ``tests/test_substrate.py``
  restated on the port, plus bf16 leaves and a whole ``TrainState``.
* ``python -m repro_torch.launch.train`` with ``--device cpu``, and its
  refusal to run without a card when ``--device`` is left out.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro_torch import config as tcfg  # noqa: E402
from repro_torch.kernels.mlstm_chunk.kernel import \
    mlstm_chunk_plain  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models.convert import params_from_numpy, \
    train_state_from_numpy  # noqa: E402
from repro_torch.models.xlstm import MLSTMChunk  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.fault import Watchdog, WatchdogTimeout, \
    run_with_restarts  # noqa: E402

from test_torch_helpers import TINY, TINY_RG, TINY_XL, N, port_cfg  # noqa

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_MOE = dataclasses.replace(
    TINY, name="tiny-moe", family="moe", num_layers=3,
    moe=jcfg.MoEConfig(num_experts=4, num_shared=1, top_k=2, d_expert=32,
                       num_dense_layers=1))
CONFIGS = {"tiny": TINY, "tiny-xl": TINY_XL, "tiny-rg": TINY_RG,
           "tiny-moe": TINY_MOE}
B, S, CE_CHUNK = 2, 32, 16


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels[0, -3:] = -1                       # ignored positions
    return toks, labels


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def ref(request):
    """The reference's loss and gradients at remat none, and its
    parameters (numpy)."""
    cfg = CONFIGS[request.param]
    params = jdec.init_params(jax.random.PRNGKey(1), cfg)
    toks, labels = _batch(cfg)

    @jax.jit
    def loss_grad(p, t, l):
        return jax.value_and_grad(
            lambda p: jdec.lm_loss(p, cfg, t, l, ce_chunk=CE_CHUNK)[0])(p)

    loss, grads = loss_grad(params, jnp.asarray(toks), jnp.asarray(labels))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return cfg, np_tree(params), float(loss), np_tree(grads), toks, labels


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_lm_loss_and_grads_match_reference(ref, remat):
    cfg, params, want_loss, want_grads, toks, labels = ref
    pc = port_cfg(cfg)
    model = params_from_numpy(params, pc, device="cpu").requires_grad_(True)
    loss, aux = tdec.lm_loss(model, pc, torch.from_numpy(toks),
                             torch.from_numpy(labels), remat=remat,
                             ce_chunk=CE_CHUNK)
    assert loss.item() == pytest.approx(want_loss, rel=1e-5, abs=1e-6)
    loss.backward()
    want = {n: N(w) for n, w in params_from_numpy(
        want_grads, pc, device="cpu").named_parameters()}
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        np.testing.assert_allclose(N(p.grad), want[name], rtol=0,
                                   atol=1e-4 * scale,
                                   err_msg=f"{cfg.name} {remat} {name}")


@pytest.mark.parametrize("ce_chunk", [8, 12, 64])
def test_chunked_ce_matches_reference(ce_chunk):
    """8 divides S=32 (4 chunks), 12 does not (one chunk), 64 > S."""
    params = jdec.init_params(jax.random.PRNGKey(2), TINY)
    toks, labels = _batch(TINY, seed=ce_chunk)
    labels[1, :5] = -1
    h, _ = jdec.forward_hidden(params, TINY, jnp.asarray(toks))
    want = jdec.chunked_ce(params, TINY, h, jnp.asarray(labels), ce_chunk)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              port_cfg(TINY), device="cpu")
    got = tdec.chunked_ce(model, port_cfg(TINY),
                          torch.from_numpy(np.array(h)),
                          torch.from_numpy(labels), ce_chunk)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    # the ignored positions change nothing: the same mean over the rest
    lab = labels.copy()
    lab[lab == -1] = 0
    full = tdec.chunked_ce(model, port_cfg(TINY),
                           torch.from_numpy(np.array(h)),
                           torch.from_numpy(lab), ce_chunk)
    assert float(full) != pytest.approx(float(got), rel=1e-6)


def test_forward_hidden_then_unembed_is_forward():
    cfg = port_cfg(TINY)
    model = tdec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_batch(TINY)[0])
    h, _ = tdec.forward_hidden(model, cfg, toks)
    logits, _ = tdec.forward(model, cfg, toks)
    assert torch.equal(tdec.unembed(model, cfg, h), logits)
    emb = torch.randn((2, 8, cfg.d_model), generator=torch.Generator(
        ).manual_seed(1))
    h, _ = tdec.forward_hidden(model, cfg, inputs_embeds=emb)
    logits, _ = tdec.forward(model, cfg, inputs_embeds=emb)
    assert h.shape == (2, 8, cfg.d_model)
    assert torch.equal(tdec.unembed(model, cfg, h), logits)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunk_backward_is_autograd_of_plain(with_state):
    """MLSTMChunk's backward recomputes the plain version: its input
    gradients equal autograd through ``mlstm_chunk_plain`` (the same
    ops), for h and the final state."""
    g = torch.Generator().manual_seed(0)
    b, h, s, d, chunk = 2, 2, 20, 8, 8
    q, k, v = (torch.randn(b, h, s, d, generator=g) for _ in range(3))
    li = torch.randn(b, h, s, generator=g)
    lf = torch.nn.functional.logsigmoid(torch.randn(b, h, s, generator=g))
    st = (torch.randn(b, h, d, d, generator=g),
          torch.randn(b, h, d, generator=g),
          torch.randn(b, h, generator=g)) if with_state else \
        (torch.zeros(b, h, d, d), torch.zeros(b, h, d),
         torch.full((b, h), -1e30))
    ins = [t.clone().requires_grad_() for t in (q, k, v, li, lf, *st)]
    h1, C1, n1, m1 = MLSTMChunk.apply(*ins, chunk, 0.3)
    ws = [torch.randn(t.shape, generator=g) for t in (h1, C1, n1)]
    got = torch.autograd.grad(
        sum((o * w).sum() for o, w in zip((h1, C1, n1), ws)), ins)
    h2, (C2, n2, _) = mlstm_chunk_plain(*ins[:5], chunk=chunk, scale=0.3,
                                        state=tuple(ins[5:]),
                                        return_state=True)
    want = torch.autograd.grad(
        sum((o * w).sum() for o, w in zip((h2, C2, n2), ws)), ins)
    assert torch.equal(h1, h2.detach())
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_mlstm_params_get_gradients():
    """Every mLSTM parameter of a TINY_XL block gets a non-zero gradient
    through the chunk function (the q/k/v and gate projections sit before
    it)."""
    cfg = port_cfg(TINY_XL)
    model = tdec.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model.requires_grad_(True)
    toks, labels = (torch.from_numpy(a) for a in _batch(TINY_XL))
    tdec.lm_loss(model, cfg, toks, labels)[0].backward()
    for name, p in model.named_parameters():
        if ".mlstm." in name:
            assert p.grad is not None and bool(p.grad.abs().sum() > 0), name


# ---------------------------------------------------------------------------
# checkpoint (tests/test_substrate.py's cases, restated)
# ---------------------------------------------------------------------------

def _mgr(d, **kw):
    return CheckpointManager(tcfg.CheckpointConfig(directory=d, **kw))


def test_checkpoint_roundtrip_and_gc():
    with tempfile.TemporaryDirectory() as d:
        mgr = _mgr(d, keep=2, async_save=False)
        state = {"a": torch.arange(6).reshape(2, 3),
                 "nested": {"b": torch.randn(4).bfloat16()}}
        for step in [5, 10, 15]:
            mgr.save(step, state, extra={"step": step})
        assert mgr.all_steps() == [10, 15]        # keep=2
        target = {"a": torch.zeros(2, 3, dtype=torch.int64),
                  "nested": {"b": torch.zeros(4, dtype=torch.bfloat16)}}
        restored, extra = mgr.restore(target)
        assert extra["step"] == 15
        assert torch.equal(restored["a"], state["a"])
        assert restored["nested"]["b"].dtype == torch.bfloat16
        assert torch.equal(restored["nested"]["b"], state["nested"]["b"])
        # the reference's format: bf16 as raw 16-bit words
        import json
        with open(os.path.join(d, "step_000000015", "manifest.json")) as f:
            leaves = json.load(f)["leaves"]
        assert [(x["name"], x["dtype"]) for x in leaves] == [
            ("a", "int64"), ("nested::b", "bfloat16")]
        raw = np.load(os.path.join(d, "step_000000015", leaves[1]["file"]))
        assert raw.dtype == np.uint16
        # restore casts to the target's dtype
        t32 = {"a": torch.zeros(2, 3), "nested": {"b": torch.zeros(4)}}
        mgr.restore(t32, step=10)
        assert t32["nested"]["b"].dtype == torch.float32
        assert torch.equal(t32["nested"]["b"],
                           state["nested"]["b"].float())


def test_checkpoint_async_snapshot():
    """async_save writes on a thread; the host copy is taken at save(),
    so an in-place update right after it is not in the checkpoint."""
    with tempfile.TemporaryDirectory() as d:
        mgr = _mgr(d, async_save=True)
        state = {"a": torch.zeros((128, 128))}
        mgr.save(1, state)
        state["a"].fill_(7.0)
        mgr.save(2, state)          # joins the first write first
        mgr.wait()
        assert mgr.latest_step() == 2
        out = {"a": torch.ones((128, 128))}
        mgr.restore(out, step=1)
        assert float(out["a"].abs().max()) == 0.0
        mgr.restore(out)
        assert float(out["a"].min()) == 7.0


def test_checkpoint_errors():
    with tempfile.TemporaryDirectory() as d:
        mgr = _mgr(d, async_save=False)
        with pytest.raises(FileNotFoundError):
            mgr.restore({"a": torch.zeros(4)})
        mgr.save(1, {"a": torch.zeros((4,))})
        with pytest.raises(ValueError):
            mgr.restore({"a": torch.zeros(5)})
        with pytest.raises(KeyError):
            mgr.restore({"b": torch.zeros(4)})


def test_checkpoint_default_directory_is_fresh():
    """With no directory configured each manager writes to a fresh one of
    its own: a second run neither sees nor restores the first run's
    steps."""
    first = CheckpointManager(tcfg.CheckpointConfig(async_save=False))
    second = CheckpointManager(tcfg.CheckpointConfig(async_save=False))
    try:
        first.save(3, {"a": torch.ones(4)})
        assert first.all_steps() == [3]
        assert second.directory != first.directory
        assert second.latest_step() is None
        with pytest.raises(FileNotFoundError):
            second.restore({"a": torch.zeros(4)})
    finally:
        shutil.rmtree(first.directory)
        shutil.rmtree(second.directory)


def test_checkpoint_train_state_roundtrip():
    """A whole TrainState: parameters under ``params``, the AdamW step and
    moments under ``opt``; bf16 parameters and a bf16 first moment come
    back bit-equal."""
    cfg = dataclasses.replace(port_cfg(TINY), dtype="bfloat16")
    run = tcfg.RunConfig(model=cfg,
                         shape=tcfg.ShapeConfig("t", tcfg.ShapeKind.TRAIN,
                                                S, B),
                         optimizer=tcfg.OptimizerConfig(m_dtype="bfloat16"))
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jax.random.PRNGKey(0),
                                     dataclasses.replace(TINY,
                                                         dtype="bfloat16")))
    st = train_state_from_numpy(params, run, device="cpu")
    with torch.no_grad():
        for t in st.opt.m.values():
            t.normal_()
        st.opt.step.fill_(3)
    other = train_state_from_numpy(params, run, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        mgr = _mgr(d, async_save=False)
        mgr.save(3, st, extra={"data": {"step": 3, "seed": 0}})
        _, extra = mgr.restore(other)
    assert extra == {"data": {"step": 3, "seed": 0}}
    assert int(other.opt.step) == 3
    for name, t in st.opt.m.items():
        assert t.dtype == torch.bfloat16 and torch.equal(t,
                                                         other.opt.m[name])
    for (n1, a), (n2, b) in zip(st.model.named_parameters(),
                                other.model.named_parameters()):
        assert n1 == n2 and a.dtype == torch.bfloat16 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# fault tolerance (tests/test_substrate.py's cases, restated)
# ---------------------------------------------------------------------------

def test_watchdog_timeout():
    wd = Watchdog(0.2)
    with pytest.raises(WatchdogTimeout):
        wd.run(lambda: time.sleep(2.0))
    assert wd.run(lambda: 42) == 42


def test_run_with_restarts():
    calls = []

    def body(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise RuntimeError("boom")
        return "ok"

    assert run_with_restarts(body, max_restarts=5) == "ok"
    assert calls == [0, 1, 2]

    with pytest.raises(RuntimeError):
        run_with_restarts(lambda a: (_ for _ in ()).throw(RuntimeError()),
                          max_restarts=1)


def test_mesh_fields_raise():
    """The mesh fields are the reference's, with its defaults; what needs
    a mesh raises without one: ``grad_compression`` at the step, where
    the reference ignores it."""
    sh = tcfg.ShardingConfig(fsdp=False, tp_axis="x")
    assert (sh.fsdp, sh.tp_axis) == (False, "x")
    with pytest.raises(ValueError):
        tcfg.ShardingConfig(remat="some")
    sh = tcfg.ShardingConfig()
    ref = jcfg.ShardingConfig()
    for f in dataclasses.fields(jcfg.ShardingConfig):
        assert getattr(sh, f.name) == getattr(ref, f.name), f.name
    assert dataclasses.replace(sh, microbatches=2).microbatches == 2
    run = tcfg.RunConfig(model=port_cfg(TINY),
                         shape=tcfg.ShapeConfig("t", tcfg.ShapeKind.TRAIN,
                                                32, 2),
                         sharding=tcfg.ShardingConfig(grad_compression=True))
    with pytest.raises(ValueError, match="needs a mesh"):
        tstep.make_train_step(run)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _cli(args, tmp):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "internlm2-1.8b", "--smoke", "--steps", "4", "--batch", "2",
         "--seq", "32", "--ckpt-dir", str(tmp), "--save-every", "2", *args],
        env=env, capture_output=True, text=True, timeout=300)


def test_train_cli_cpu(tmp_path):
    p = _cli(["--device", "cpu"], tmp_path)
    assert p.returncode == 0, p.stderr[-2000:]
    m = re.search(r"arch=(\S+) steps=(\d+) loss (\S+) -> (\S+) \((\d+) "
                  r"tok/s, ([\d.]+)s, restarts=(\[.*\])\)", p.stdout)
    assert m, p.stdout
    assert m.group(1) == "internlm2-1.8b" and m.group(2) == "4"
    assert np.isfinite(float(m.group(3))) and np.isfinite(float(m.group(4)))
    assert m.group(7) == "[]"
    assert sorted(os.listdir(tmp_path)) == ["step_000000002",
                                            "step_000000004"]


def test_train_cli_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device runs")
    p = _cli([], tmp_path)
    assert p.returncode != 0
    assert "CUDA is not available" in p.stderr
