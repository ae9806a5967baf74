"""The port's sharded train step, elastic checkpoints and distributed
launcher on gloo CPU ranks, against the JAX package's single-device
step (``repro.train.step``) and checkpoints.

One spawn of 4 ranks and one of 8 for the file (module fixtures); the
JAX side runs in this process. From the JAX init of TINY, a tiny MoE
(deepseek-moe-16b's smoke variant in float32: 4 experts, expert-parallel
on both meshes) and TINY_XL:

* 2 sharded steps on a (data 2, model 2) and a (data 2, model 4) mesh
  equal 2 single-device JAX steps on the same global batches: losses
  within 2e-5 relative, parameters within 1e-4 of the largest; the MoE
  also at 2 microbatches (each routed as a whole);
* every rank holds exactly its shards: its bytes of parameters, m and v
  (and of the error-feedback state) are the sum of its shards' sizes
  under the rules;
* the compressed step on (pod 2, data 2): its first update equals AdamW
  applied to JAX's ``psum_compressed`` (jitted, as the reference runs
  it) of JAX's per-pod gradients, within 1e-5; its loss the pods' mean;
* ``train_with_recovery`` on a mesh with a crash equals the
  uninterrupted run; a checkpoint written from (4, 2) restores onto
  (2, 4) bit-equal (a matrix, and a whole train state); a checkpoint the
  JAX package wrote restores onto a port mesh bit-equal;
* ``python -m repro_torch.launch.train --distributed`` on 2 gloo ranks.
"""
from __future__ import annotations

import dataclasses
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.data.synthetic import make_lm_batch  # noqa: E402
from repro.optim.adamw import adamw_init, adamw_update  # noqa: E402
from repro.sharding.compression import psum_compressed  # noqa: E402
from repro.train.checkpoint import CheckpointManager  # noqa: E402
from repro.train.step import _loss_fn, init_train_state, \
    make_train_step  # noqa: E402
from repro_torch import config as tcfg  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from test_torch_helpers import TINY, TINY_XL, port_cfg  # noqa: E402
from test_torch_mesh_worker import BATCH, SEQ, load_tree, result, \
    run_ranks, save_tree  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = dataclasses.replace(jcfg.smoke_variant(jcfg.get_arch("deepseek-moe-16b")),
                          dtype="float32")
CONFIGS = {"tiny": TINY, "moe": MOE, "tiny-xl": TINY_XL}
STEPS = 2


def _run(cfg, **sharding):
    """The reference RunConfig of the worker's ``train_run``."""
    return jcfg.RunConfig(
        model=cfg, shape=jcfg.ShapeConfig("t", jcfg.ShapeKind.TRAIN, SEQ,
                                          BATCH),
        optimizer=jcfg.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10),
        sharding=jcfg.ShardingConfig(remat="none", **sharding))


def _batch(step, cfg):
    return {k: jnp.asarray(v) for k, v in
            make_lm_batch(step, BATCH, SEQ, cfg.vocab_size, 0).items()}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_reference(d):
    """Write each config's JAX init, run the JAX single-device steps and
    the compressed reference, and write a JAX checkpoint -> {name:
    (losses, final params)}, the compressed reference."""
    out = {}
    for name, cfg in CONFIGS.items():
        for mb in (1, 2) if name == "moe" else (1,):
            run = _run(cfg, microbatches=mb)
            state = init_train_state(jax.random.PRNGKey(0), run)
            save_tree(d / f"init_{name}.npz", _numpy(state.params))
            step = make_train_step(run, None, donate=False)
            losses = []
            for i in range(STEPS):
                state, metrics = step(state, _batch(i, cfg))
                losses.append(float(metrics["loss"]))
            out[name, mb] = (np.array(losses), _numpy(state.params))

    # per-pod gradients, reduced as the reference's compressed step does
    run = _run(TINY)
    params = load_tree(d / "init_tiny.npz")
    params = jax.tree_util.tree_map(jnp.asarray, params)
    batch = _batch(0, TINY)
    half = BATCH // 2
    pods = []
    for p in range(2):
        pb = {k: v[p * half:(p + 1) * half] for k, v in batch.items()}
        (loss, _), grads = jax.value_and_grad(_loss_fn, has_aux=True)(
            params, TINY, pb, "none", run.sharding.attn_chunk,
            run.sharding.ce_chunk)
        pods.append((loss, grads))
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                     *[g for _, g in pods])
    mean, err = jax.jit(jax.vmap(lambda g: psum_compressed(g, "pod"),
                                 axis_name="pod"))(stacked)
    mean0 = jax.tree_util.tree_map(lambda t: t[0], mean)
    new_params, _, _ = adamw_update(mean0, adamw_init(params, run.optimizer),
                                    params, run.optimizer)
    compressed = (float(np.mean([float(l) for l, _ in pods])),
                  _numpy(new_params),
                  _numpy(jax.tree_util.tree_map(lambda t: t[0], err)))

    rng = np.random.default_rng(7)
    tree = {"w": jnp.asarray(rng.standard_normal((8, 8)), jnp.float32),
            "sub": {"b": jnp.asarray(rng.standard_normal((4, 8)),
                                     jnp.bfloat16)}}
    mgr = CheckpointManager(jcfg.CheckpointConfig(
        directory=str(d / "jax_ckpt"), async_save=False))
    mgr.save(5, tree, extra={"data": {"step": 5}})
    return out, compressed, _numpy(tree)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_train")
    ref, compressed, ckpt_tree = _jax_reference(d)
    run_ranks(4, [f"step_{n}_2x2" for n in CONFIGS]
              + ["step_moe_2x2_mb2", "compressed", "recovery"], d)
    run_ranks(8, [f"step_{n}_2x4" for n in CONFIGS]
              + ["elastic", "jax_ckpt"], d)
    return d, ref, compressed, ckpt_tree


def _port_named(tree, cfg):
    return {n: p.numpy() for n, p in params_from_numpy(
        tree, port_cfg(cfg), device="cpu").named_parameters()}


@pytest.mark.parametrize("name,shape,mb", [
    (n, s, 1) for n in sorted(CONFIGS) for s in ("2x2", "2x4")]
    + [("moe", "2x2", 2)])
def test_sharded_step_matches_single_device_reference(mesh_runs, name,
                                                      shape, mb):
    d, ref, _, _ = mesh_runs
    got = result(d, f"step_{name}_{shape}" + (f"_mb{mb}" if mb > 1 else ""))
    want_losses, want_params = ref[name, mb]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-5)
    want = _port_named(want_params, CONFIGS[name])
    scale = max(float(np.abs(w).max()) for w in want.values())
    assert {k[2:] for k in got if k.startswith("p/")} == want.keys()
    for n, w in want.items():
        np.testing.assert_allclose(got[f"p/{n}"], w, rtol=0,
                                   atol=1e-4 * scale, err_msg=n)


@pytest.mark.parametrize("shape", ["2x2", "2x4"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_each_rank_holds_only_its_shards(mesh_runs, name, shape):
    d = mesh_runs[0]
    got = result(d, f"step_{name}_{shape}")
    world = int(shape[0]) * int(shape[2])
    assert got["held"].shape == (world,)
    np.testing.assert_array_equal(got["held"], got["want"])
    # sharding is real: a rank holds well under the full state
    cfg = port_cfg(CONFIGS[name])
    full = 3 * 4 * sum(v.size for v in _port_named(
        load_tree(d / f"init_{name}.npz"), CONFIGS[name]).values())
    assert got["held"].max() < full / 2, (cfg.name, got["held"], full)


def test_compressed_step_matches_reference_psum_compressed(mesh_runs):
    """The first update and the error state (pod 0's, as rank 0 gathers
    it) within 1e-5 of the reference's; one scale per reference leaf,
    its amax over every shard and pod."""
    d, _, (loss, params, err), _ = mesh_runs
    got = result(d, "compressed")
    np.testing.assert_allclose(float(got["loss"]), loss, rtol=2e-5)
    for prefix, tree in (("p", params), ("err", err)):
        for n, w in _port_named(tree, TINY).items():
            np.testing.assert_allclose(got[f"{prefix}/{n}"], w, rtol=0,
                                       atol=1e-5, err_msg=f"{prefix}/{n}")
    np.testing.assert_array_equal(got["err_held"], got["err_want"])


def test_compressed_step_needs_a_pod_axis():
    from types import SimpleNamespace
    from repro_torch.train.step import make_train_step as port_step
    run = tcfg.RunConfig(
        model=port_cfg(TINY),
        shape=tcfg.ShapeConfig("t", tcfg.ShapeKind.TRAIN, SEQ, BATCH),
        sharding=tcfg.ShardingConfig(grad_compression=True))
    with pytest.raises(ValueError, match="pod"):
        port_step(run)
    with pytest.raises(ValueError, match="pod"):
        port_step(run, SimpleNamespace(mesh_dim_names=("data", "model")))


def test_recovery_on_a_mesh_matches_uninterrupted(mesh_runs):
    got = result(mesh_runs[0], "recovery")
    assert got["restarts"].tolist() == [1]
    np.testing.assert_allclose(got["rec"][-1], got["base"][-1], rtol=1e-6)


def test_elastic_restore_onto_another_mesh(mesh_runs):
    got = result(mesh_runs[0], "elastic")
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    np.testing.assert_array_equal(got["w"], w)
    np.testing.assert_array_equal(got["placed"], w)
    assert bool(got["local_ok"]) and bool(got["moved"])
    assert float(got["state_diff"]) == 0.0


def test_jax_checkpoint_restores_onto_a_port_mesh(mesh_runs):
    d, _, _, tree = mesh_runs
    got = result(d, "jax_ckpt")
    np.testing.assert_array_equal(got["w"], tree["w"])
    np.testing.assert_array_equal(got["b"], tree["sub"]["b"].astype(
        np.float32))
    assert str(got["b_dtype"]) == "torch.bfloat16"
    assert str(got["extra"]) == '{"data": {"step": 5}}'


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_distributed_on_gloo_ranks(tmp_path):
    """``--distributed`` joins the process group torchrun's environment
    describes; every rank trains its replica from the same seed."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "internlm2-1.8b", "--smoke", "--device", "cpu", "--distributed",
         "--steps", "2", "--batch", "2", "--seq", "16"],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, err[-2000:]
        m = re.search(r"arch=internlm2-1.8b steps=2 loss (\S+) -> (\S+)",
                      out)
        assert m, out
        outs.append(m.groups())
    assert outs[0] == outs[1]
