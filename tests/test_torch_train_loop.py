"""The port's training loop vs the JAX package's (``repro.train.loop``),
float32, step for step from the same initial state: the reference's
``init_train_state`` carried over by ``train_state_from_numpy``.

* ``train_loop``, 4 steps of ``SyntheticLM`` batches on TINY and TINY_XL
  (mLSTM, mLSTM, sLSTM; kernel #7's plain version and its backward), at
  ``microbatches`` 1 and 2: each step's loss within 1e-5 relative, the
  final parameters (O(0.1)-O(1)) within 1e-4 (float32 sums in another
  order in XLA and torch, through four AdamW steps; AdamW divides each
  gradient by its own RMS, so the mLSTM input-gate biases, whose ~1e-8
  gradients are sums of terms that cancel, take lr-sized steps whose
  last digits follow that cancellation's rounding: ~2e-6 apart on
  ~2e-3).
* ``train_with_recovery`` with a crash at step 4 and checkpoints every 3
  steps, 6 steps: restarted once, its last loss equal to the
  uninterrupted port run's (the same ops on the same restored bits) and
  within 1e-5 of the reference's recovered run.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train.step import init_train_state  # noqa: E402
from repro_torch import config as tcfg  # noqa: E402
from repro_torch.models.convert import params_from_numpy, \
    train_state_from_numpy  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402

from test_torch_helpers import TINY, TINY_XL, N, port_cfg  # noqa: E402

torch.set_num_threads(1)

CONFIGS = {"tiny": TINY, "tiny-xl": TINY_XL}
STEPS = 4


def _runs(cfg, directory, microbatches=1, **ckpt):
    """(reference RunConfig, port RunConfig) with the same fields."""
    kw = dict(shape=("t", 32, 4),
              optimizer=dict(lr=1e-3, total_steps=10, warmup_steps=2),
              sharding=dict(remat="none", microbatches=microbatches),
              checkpoint=dict(directory=directory, **ckpt))

    def build(m, model):
        return m.RunConfig(
            model=model,
            shape=m.ShapeConfig(kw["shape"][0], m.ShapeKind.TRAIN,
                                *kw["shape"][1:]),
            optimizer=m.OptimizerConfig(**kw["optimizer"]),
            sharding=m.ShardingConfig(**kw["sharding"]),
            checkpoint=m.CheckpointConfig(**kw["checkpoint"]))
    return build(jcfg, cfg), build(tcfg, port_cfg(cfg))


def _ref_init(run):
    st = init_train_state(jax.random.PRNGKey(run.seed), run)
    return jax.tree_util.tree_map(np.asarray, st.params)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_loop_matches_reference(name, microbatches, tmp_path):
    jrun, trun = _runs(CONFIGS[name], str(tmp_path), microbatches,
                       save_every=100)
    want = jloop.train_loop(jrun, num_steps=STEPS)
    state = train_state_from_numpy(_ref_init(jrun), trun, device="cpu")
    got = tloop.train_loop(trun, device="cpu", num_steps=STEPS, state=state)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    ref = dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, want["state"].params),
        trun.model, device="cpu").named_parameters())
    for pname, p in got["state"].model.named_parameters():
        np.testing.assert_allclose(N(p), N(ref[pname]), rtol=0, atol=1e-4,
                                   err_msg=pname)
    assert int(got["state"].opt.step) == STEPS


def test_train_with_recovery_matches_uninterrupted_and_reference(tmp_path):
    d0, d1, d2 = (str(tmp_path / x) for x in ("base", "rec", "ref"))
    jrun, trun = _runs(TINY, d1, save_every=3, async_save=False)
    init = _ref_init(jrun)

    def init_state():
        return train_state_from_numpy(init, trun, device="cpu")

    base = tloop.train_loop(dataclasses.replace(
        trun, checkpoint=dataclasses.replace(trun.checkpoint, directory=d0,
                                             save_every=100)),
        device="cpu", num_steps=6, state=init_state())
    rec = tloop.train_with_recovery(trun, device="cpu", num_steps=6,
                                    fail_at_step=4, init_state=init_state)
    assert rec["restarts"] == [1] and rec["final_step"] == 6
    # the restarted attempt resumed at the step-3 checkpoint
    assert len(rec["losses"]) == 3
    assert rec["losses"][-1] == base["losses"][-1]
    ref = jloop.train_with_recovery(dataclasses.replace(
        jrun, checkpoint=dataclasses.replace(jrun.checkpoint, directory=d2)),
        num_steps=6, fail_at_step=4)
    assert ref["restarts"] == [1]
    assert rec["losses"][-1] == pytest.approx(ref["losses"][-1], rel=1e-5)
