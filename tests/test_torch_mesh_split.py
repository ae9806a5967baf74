"""The model-axis compute split of the port's sharded train step, on gloo
CPU ranks, against the JAX package's single-device step and against the
per-device matmul FLOPs of the reference's GSPMD program.

One spawn of 4 ranks and one of 8 (``test_torch_mesh_worker.py``,
``SPLIT_CELLS``), at batch 8 x 64 with remat full, from the JAX init:

* TINY on (data 2, model 2) and (2, 4): the axis divides the q heads
  (and on (2, 4) not the 2 kv heads: each rank projects its k / v
  columns and gathers them); TINY with 6 heads on (2, 4): the axis does
  not divide the heads, so each rank takes its block of the q rows; the
  smoke MoE with its experts over the model axis (EP) on both meshes,
  and with a slice of every expert (TP) on (2, 2);
* 2 sharded steps equal 2 JAX single-device steps: losses within 2e-5
  relative, parameters within 1e-4 of the largest (the tolerances of
  ``test_torch_mesh_train.py``);
* every rank's ``FlopCounterMode`` count of a step equals the reference's
  per-device ``HloModule.dot_flops()`` of ``lower_train`` on the same
  mesh within 1e-6 relative (104,857,600, 52,428,800 and 60,817,408),
  which is the single-device count over the ranks: no product is left
  whole on any rank. The MoE's ranks each run their experts (or expert
  columns) over their block of the capacity slots, and the router over
  their block of the rows: each rank's count is the single device's over
  the ranks, no higher than the reference's per-device count;
* the f32 smoke recurrentgemma-2b and xlstm-350m on (2, 4): the RG-LRU
  channels, the mLSTM heads and the sLSTM channels split over the model
  axis. recurrentgemma-2b counts the reference's per-device FLOPs;
  xlstm-350m splits its count over the ranks exactly, with the mLSTM
  backward's recompute counted apart, and stays at or under the
  reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.data.synthetic import make_lm_batch  # noqa: E402
from repro.train.step import init_train_state, make_train_step  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from helpers import check, run_with_devices  # noqa: E402
from test_torch_helpers import TINY, port_cfg  # noqa: E402
from test_torch_mesh_worker import BATCH, SPLIT_CELLS, SPLIT_SEQ, \
    mlstm_recompute_counted, result, run_ranks, save_tree  # noqa: E402

MOE = dataclasses.replace(jcfg.smoke_variant(jcfg.get_arch("deepseek-moe-16b")),
                          dtype="float32")
CONFIGS = {"tiny": TINY, "tiny-6h": dataclasses.replace(TINY, name="tiny-6h",
                                                        num_heads=6),
           "moe": MOE,
           "rg": dataclasses.replace(jcfg.smoke_variant(
               jcfg.get_arch("recurrentgemma-2b")), dtype="float32"),
           "xl": dataclasses.replace(jcfg.smoke_variant(
               jcfg.get_arch("xlstm-350m")), dtype="float32")}
STEPS = 2

# the reference's per-device dot FLOPs of one step of these cells, as
# ``HloModule.dot_flops()`` counts ``lower_train`` on an 8-device mesh
_JAX_FLOPS = """
import dataclasses, numpy as np, jax
from jax.sharding import Mesh
from repro import config as C
from repro.launch.dryrun import lower_train
from repro.launch.hlo_analysis import HloModule
TINY = C.ModelConfig("tiny", "dense", num_layers=2, d_model=64, num_heads=4,
                     num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
                     dtype="float32")
CF = {"tiny": TINY, "tiny-6h": dataclasses.replace(TINY, name="tiny-6h",
                                                   num_heads=6),
      "moe": dataclasses.replace(C.smoke_variant(C.get_arch(
          "deepseek-moe-16b")), dtype="float32")}
for a, n in (("recurrentgemma-2b", "rg"), ("xlstm-350m", "xl")):
    CF[n] = dataclasses.replace(C.smoke_variant(C.get_arch(a)),
                                dtype="float32")
shape = C.ShapeConfig("t", C.ShapeKind.TRAIN, %(seq)d, %(batch)d)
for case, (name, ms, ep) in %(cells)r.items():
    mesh = Mesh(np.array(jax.devices()[:ms[0] * ms[1]]).reshape(ms),
                ("data", "model"))
    with mesh:
        txt = lower_train(CF[name], shape, mesh, C.ShardingConfig(
            remat="full", expert_parallel=ep)).compile().as_text()
    print("FLOPS", case, HloModule(txt).dot_flops())
mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
with mesh:
    txt = lower_train(CF["moe"], shape, mesh, C.ShardingConfig(
        remat="full")).compile().as_text()
print("FLOPS one_moe", HloModule(txt).dot_flops())
"""


def _run(cfg):
    return jcfg.RunConfig(
        model=cfg, shape=jcfg.ShapeConfig("t", jcfg.ShapeKind.TRAIN,
                                          SPLIT_SEQ, BATCH),
        optimizer=jcfg.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10),
        sharding=jcfg.ShardingConfig(remat="full"))


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_split")
    ref = {}
    for name, cfg in CONFIGS.items():
        run = _run(cfg)
        state = init_train_state(jax.random.PRNGKey(0), run)
        save_tree(d / f"init_{name}.npz",
                  jax.tree_util.tree_map(np.asarray, state.params))
        step = make_train_step(run, None, donate=False)
        losses = []
        for i in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in make_lm_batch(
                i, BATCH, SPLIT_SEQ, cfg.vocab_size, 0).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        ref[name] = (np.array(losses),
                     jax.tree_util.tree_map(np.asarray, state.params))
    by_world = {}
    for case, (_, shape, _) in SPLIT_CELLS.items():
        by_world.setdefault(shape[0] * shape[1], []).append(case)
    for world, cases in sorted(by_world.items()):
        run_ranks(world, cases, d)
    out = check(run_with_devices(_JAX_FLOPS % dict(
        seq=SPLIT_SEQ, batch=BATCH, cells=SPLIT_CELLS), devices=8,
        timeout=600))
    flops = {ln.split()[1]: float(ln.split()[2])
             for ln in out.splitlines() if ln.startswith("FLOPS ")}
    return d, ref, flops


@pytest.mark.parametrize("case", sorted(SPLIT_CELLS))
def test_split_step_matches_single_device_reference(split_runs, case):
    d, ref, _ = split_runs
    name = SPLIT_CELLS[case][0]
    got = result(d, case)
    want_losses, want_tree = ref[name]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-5)
    want = {n: p.numpy() for n, p in params_from_numpy(
        want_tree, port_cfg(CONFIGS[name]), device="cpu").named_parameters()}
    scale = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        np.testing.assert_allclose(got[f"p/{n}"], w, rtol=0,
                                   atol=1e-4 * scale, err_msg=n)


@pytest.mark.parametrize("case", ["split_tiny_2x2", "split_tiny_2x4",
                                  "split_tiny-6h_2x4", "split_rg_2x4"])
def test_each_rank_does_the_reference_per_device_flops(split_runs, case):
    """Every rank's count is the reference's per-device count, and that is
    the one-device count over the ranks; the RG-LRU's channels split
    too."""
    d, _, jax_flops = split_runs
    got = result(d, case)["flops"]
    want = {"split_tiny_2x2": 104_857_600, "split_tiny_2x4": 52_428_800,
            "split_tiny-6h_2x4": 60_817_408}.get(case, jax_flops[case])
    assert jax_flops[case] == want
    assert want * shape_ranks(case) == _single_device_flops(
        SPLIT_CELLS[case][0])
    np.testing.assert_allclose(got, np.full_like(got, want), rtol=1e-6)


def test_xlstm_step_splits_its_products_over_the_ranks(split_runs):
    """xlstm-350m on (2, 4): the mLSTM heads and sLSTM channels split, so
    each rank's count, with ``MLSTMChunk``'s backward recompute counted
    apart (``mlstm_recompute_counted``: the reference has no such pass),
    is the one-device count so counted over the 8 ranks, and the
    recompute splits the same way. That count is at or under the
    reference's per-device ``dot_flops()`` (434,421,760 against
    440,991,744, printed with ``-s``): a train step skips the update of
    the final mLSTM state, which it never reads (XLA drops it too)."""
    d, _, jax_flops = split_runs
    got = result(d, "split_xl_2x4")
    one, one_recompute = _one_device_counts("xl")
    ranks = shape_ranks("split_xl_2x4")
    np.testing.assert_allclose(got["flops"] - got["recompute"],
                               np.full(ranks, (one - one_recompute) / ranks),
                               rtol=1e-6)
    np.testing.assert_allclose(got["recompute"],
                               np.full(ranks, one_recompute / ranks),
                               rtol=1e-6)
    assert one_recompute > 0
    apart = got["flops"] - got["recompute"]
    assert float(apart.max()) <= jax_flops["split_xl_2x4"]
    print(f"xlstm-350m (2, 4): per rank {float(apart[0]):.0f} with the "
          f"recompute ({float(got['recompute'][0]):.0f}) apart, the "
          f"reference's {jax_flops['split_xl_2x4']:.0f}")


def _single_device_flops(name: str) -> float:
    """``FlopCounterMode``'s count of one port step on one device."""
    return _one_device_counts(name)[0]


def _one_device_counts(name: str):
    """``FlopCounterMode``'s count of one port step on one device, and of
    the mLSTM backward's recompute in it."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import config as tc
    from repro_torch.data.synthetic import make_lm_batch as port_batch
    from repro_torch.train.step import init_train_state as port_init, \
        make_train_step as port_step
    cfg = port_cfg(CONFIGS[name])
    run = tc.RunConfig(model=cfg, shape=tc.ShapeConfig(
        "t", tc.ShapeKind.TRAIN, SPLIT_SEQ, BATCH),
        sharding=tc.ShardingConfig(remat="full"))
    state = port_init(run, torch.Generator().manual_seed(0), "cpu")
    with FlopCounterMode(display=False) as fc, \
            mlstm_recompute_counted() as rc:
        port_step(run)(state, port_batch(0, BATCH, SPLIT_SEQ,
                                         cfg.vocab_size, 0))
    return float(fc.get_total_flops()), float(rc.flops)


def shape_ranks(case: str) -> int:
    shape = SPLIT_CELLS[case][1]
    return shape[0] * shape[1]


def _moe_flops(ranks: int) -> float:
    """The port's per-rank FLOPs of the smoke MoE's step: the single
    device's count over the ranks. The router scores each rank's block of
    its data row's rows, and the routed experts run each rank's experts
    (or expert columns) over its block of the capacity slots."""
    return _single_device_flops("moe") / ranks


def _shared_down_flops() -> float:
    """The smoke MoE's shared experts' down projection over the batch: its
    recompute under remat full is dead (the layer's output is not needed
    for its gradients). The reference's program drops it; the port's
    checkpointed layer recomputes it."""
    cfg = port_cfg(MOE)
    return 2.0 * BATCH * SPLIT_SEQ * cfg.moe.num_shared * cfg.moe.d_expert \
        * cfg.d_model


@pytest.mark.parametrize("case", ["split_moe_2x2", "split_moe_2x4",
                                  "split_moe-tp_2x2"])
def test_moe_rank_flops_follow_the_expert_split(split_runs, case):
    """Every rank does 1/ranks of the single device's products, experts
    and router included. Against the reference's GSPMD program per
    device it does no more, but for its share of the one product XLA
    drops from the remat recompute and the port's checkpoint does not:
    the single-device counts differ by exactly that product (the
    remat-none cells of ``test_torch_mesh_moe.py`` are held to the
    reference's count with no such allowance)."""
    d, _, jax_flops = split_runs
    _, shape, _ = SPLIT_CELLS[case]
    ranks = shape[0] * shape[1]
    got = result(d, case)["flops"]
    want = _moe_flops(ranks)
    np.testing.assert_allclose(got, np.full_like(got, want), rtol=1e-6)
    dead = _shared_down_flops()
    assert _single_device_flops("moe") - jax_flops["one_moe"] == dead
    assert float(got.max()) <= jax_flops[case] + dead / ranks
    print(f"{case}: per rank {float(got[0]):.0f}, the reference's "
          f"{jax_flops[case]:.0f} (+ {dead / ranks:.0f} of dead recompute)")
