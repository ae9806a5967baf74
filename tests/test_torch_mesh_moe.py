"""The port's routed experts on a mesh, on gloo CPU ranks, against the JAX
package's single-device MoE and against the per-device matmul FLOPs of
the reference's GSPMD programs.

The f32 smoke deepseek-moe-16b (4 experts, top-2, a dense layer 0) with
its experts over the model axis (EP) on (data 2, model 2) and (2, 4),
and with every expert's ``d_expert`` columns there (TP,
``expert_parallel=False``) on (2, 2): one spawn of 4 ranks and one of 8
(``test_torch_mesh_worker.py``, ``MOE_CELLS``), from the JAX init. Each
rank routes its own rows; only the routing integers cross the ranks
that share the batch, so each choice gets one device's slot, and each
rank runs its experts over its block of the capacity slots.

* 2 sharded steps (batch 8 x 32; TP at 2 microbatches) equal 2 JAX
  single-device steps: losses within 2e-5 relative, parameters within
  1e-4 of the largest;
* ``prefill`` (A^3 sort over the ring's ranks), ``prefill_chunk``,
  ``decode_step`` and ``decode_block`` equal JAX's single-device
  dispatches: logits within 2e-5 of their largest, greedy tokens equal,
  each rank's share of the cache within 2e-5 of the same share of JAX's;
* one lane on (2, 2): the prefill splits the prompt's positions over
  the 4 ranks (the routing integers gathered along the sequence), the
  decode step runs the lane on every rank; both equal JAX's;
* the drop cell: one MoE layer over 256 tokens whose router sends every
  token to expert 0 first. Its capacity (192) keeps the first 192 of
  them in the global order; the last 64, all on data rank 1's rows, are
  dropped. The aux loss, the drop fraction (> 0) and the outputs equal
  JAX's;
* every rank's ``FlopCounterMode`` count of a step or a dispatch is the
  port's single-device count over the ranks (within 1e-6), and no
  higher than the reference's per-device ``HloModule.dot_flops()`` of
  the same cell (an 8-device JAX subprocess).
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
from repro.models.moe import moe_apply as jax_moe_apply, \
    moe_init  # noqa: E402
from repro.train.step import init_train_state, make_train_step  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from test_torch_helpers import port_cfg  # noqa: E402
from test_torch_mesh_serve import _jax_inputs, _tol, \
    start_with_devices  # noqa: E402
from test_torch_mesh_worker import BATCH, DROP, MOE_CELLS, MOE_SEQ, \
    MOE_SERVE, SERVE_SEQ, CHUNK, result, save_tree, serve_inputs_name, \
    start_ranks  # noqa: E402

MOE = dataclasses.replace(jcfg.smoke_variant(jcfg.get_arch("deepseek-moe-16b")),
                          dtype="float32")
TOL = 2e-5
DISPATCHES = MOE_SERVE.split()

# the reference's per-device dot FLOPs of each cell's train step and
# serving dispatches, as ``HloModule.dot_flops()`` counts its
# ``lower_*`` on an 8-device mesh
_JAX_FLOPS = """
import dataclasses, numpy as np, jax
from jax.sharding import Mesh
from repro import config as C
from repro.launch import dryrun as D
from repro.launch.hlo_analysis import HloModule
cfg = dataclasses.replace(C.smoke_variant(C.get_arch("deepseek-moe-16b")),
                          dtype="float32")
for case, (ms, ep, mb) in %(cells)r.items():
    mesh = Mesh(np.array(jax.devices()[:ms[0] * ms[1]]).reshape(ms),
                ("data", "model"))
    sh = C.ShardingConfig(remat="none", expert_parallel=ep)
    pre = C.ShapeConfig("p", C.ShapeKind.PREFILL, %(seq)d, %(batch)d)
    dec = C.ShapeConfig("d", C.ShapeKind.DECODE, %(seq)d, %(batch)d)
    with mesh:
        lows = {
            "train": D.lower_train(cfg, C.ShapeConfig(
                "t", C.ShapeKind.TRAIN, %(train_seq)d, %(batch)d), mesh,
                dataclasses.replace(sh, microbatches=mb)),
            "prefill": D.lower_prefill(cfg, pre, mesh, sh),
            "decode": D.lower_decode(cfg, dec, mesh, sh),
            "decode_block": D.lower_decode_block(cfg, dec, mesh, sh,
                                                 steps=4),
            "chunk": D.lower_prefill_chunk(cfg, pre, mesh, sh,
                                           chunk=%(chunk)d)}
        for tag, low in lows.items():
            print("FLOPS", case, tag,
                  HloModule(low.compile().as_text()).dot_flops())
"""


def _train_run(microbatches):
    return jcfg.RunConfig(
        model=MOE, shape=jcfg.ShapeConfig("t", jcfg.ShapeKind.TRAIN, MOE_SEQ,
                                          BATCH),
        optimizer=jcfg.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10),
        sharding=jcfg.ShardingConfig(remat="none",
                                     microbatches=microbatches))


def _jax_steps(d):
    """2 JAX single-device steps at each cell's microbatches from
    PRNGKey(0) -> {microbatches: (losses, params)}; the init written for
    the ranks."""
    out = {}
    for mb in sorted({mb for _, _, mb in MOE_CELLS.values()}):
        run = _train_run(mb)
        state = init_train_state(jax.random.PRNGKey(0), run)
        if mb == 1:
            save_tree(d / "init_moe.npz",
                      jax.tree_util.tree_map(np.asarray, state.params))
        step = make_train_step(run, None, donate=False)
        losses = []
        for i in range(2):
            batch = {k: jnp.asarray(v) for k, v in make_lm_batch(
                i, BATCH, MOE_SEQ, MOE.vocab_size, 0).items()}
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        out[mb] = (np.array(losses),
                   jax.tree_util.tree_map(np.asarray, state.params))
    return out


def _drop_inputs(d):
    """One MoE layer's reference weights with the router biased towards
    expert 0 on a feature every input carries, and [8, 32, d] inputs
    (numpy seed 5) -> the reference's (out, aux, drop, keep mask) of
    them; the inputs written for the ranks."""
    p = jax.tree_util.tree_map(np.asarray, moe_init(
        jax.random.PRNGKey(3), MOE.d_model, MOE.moe, jnp.float32))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((DROP["batch"], DROP["seq"], MOE.d_model),
                            dtype=np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 1.0
    router = np.array(p["router"])
    router[0, 0] += DROP["bias"]
    p["router"] = router
    np.savez(d / "moe_drop_in.npz", x=x, router=router, w_gate=p["w_gate"],
             w_up=p["w_up"], w_down=p["w_down"],
             **{f"shared_{k}": v for k, v in p["shared"].items()})
    out, aux = jax_moe_apply(jax.tree_util.tree_map(jnp.asarray, p),
                             jnp.asarray(x), MOE.moe)
    # the reference's kept choices, in token order
    t, k, e = DROP["batch"] * DROP["seq"], MOE.moe.top_k, MOE.moe.num_experts
    probs = jax.nn.softmax(x.reshape(t, -1) @ router, -1)
    _, top_e = jax.lax.top_k(probs, k)
    flat = np.asarray(top_e).reshape(-1)
    rank = np.array([np.sum(flat[:i] == flat[i]) for i in range(t * k)])
    cap = -(-int(np.ceil(t * k / e * 1.25)) // 64) * 64
    return (np.asarray(out), float(aux["moe_aux_loss"]),
            float(aux["moe_drop_fraction"]), (rank < cap).reshape(t, k))


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_moe")
    counting = start_with_devices(_JAX_FLOPS % dict(
        cells=MOE_CELLS, seq=SERVE_SEQ, batch=BATCH, train_seq=MOE_SEQ,
        chunk=CHUNK), devices=8)
    steps = _jax_steps(d)
    serve = _jax_inputs(d, "moe", BATCH, set(DISPATCHES),
                        {shape[1] for shape, _, _ in MOE_CELLS.values()})
    serve_b1 = _jax_inputs(d, "moe", 1, {"prefill", "decode"}, {4})
    drop = _drop_inputs(d)
    by_world = {4: ["moe_b1_2x2"]}
    for case, (shape, _, _) in MOE_CELLS.items():
        by_world.setdefault(shape[0] * shape[1], []).append(case)
    waits = [start_ranks(world, cases, d)
             for world, cases in sorted(by_world.items())]
    one = _one_device_flops(d)
    for wait in waits:
        wait()
    out, err = counting.communicate(timeout=900)
    assert counting.returncode == 0, err[-3000:]
    flops = {(ln.split()[1], ln.split()[2]): float(ln.split()[3])
             for ln in out.splitlines() if ln.startswith("FLOPS ")}
    return d, steps, serve, drop, one, flops, serve_b1


def _one_device_flops(d):
    """The port's single-device ``FlopCounterMode`` count of each cell's
    step (per microbatching) and of each serving dispatch, from the JAX
    init and the same inputs."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import config as tc
    from repro_torch.config import A3Config
    from repro_torch.data.synthetic import make_lm_batch as port_batch
    from repro_torch.models import decoder
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.train.step import make_train_step as port_step
    from test_torch_mesh_worker import load_tree, port_cache
    cfg = port_cfg(MOE)
    tree = load_tree(d / "init_moe.npz")
    out = {}
    for mb in sorted({mb for _, _, mb in MOE_CELLS.values()}):
        run = tc.RunConfig(model=cfg, shape=tc.ShapeConfig(
            "t", tc.ShapeKind.TRAIN, MOE_SEQ, BATCH),
            sharding=tc.ShardingConfig(remat="none", microbatches=mb))
        state = train_state_from_numpy(tree, run, "cpu")
        with FlopCounterMode(display=False) as fc:
            port_step(run)(state, port_batch(0, BATCH, MOE_SEQ,
                                             cfg.vocab_size, 0))
        out["train", mb] = float(fc.get_total_flops())
    model = params_from_numpy(tree, cfg, "cpu")
    ins = load_tree(d / f"{serve_inputs_name('moe', BATCH)}.npz")
    with np.load(d / f"{serve_inputs_name('moe', BATCH)}_x.npz") as f:
        x = {k: torch.from_numpy(f[k]) for k in f.files}
    dec = port_cache(ins["decode_in"], cfg, BATCH, False)
    runs = {
        "prefill": lambda: decoder.prefill(model, cfg, x["tokens"],
                                           max_len=SERVE_SEQ, a3=True),
        "decode": lambda: decoder.decode_step(
            model, cfg, dec, x["dec_token"], x["dec_pos"], a3=A3Config()),
        "decode_block": lambda: decoder.decode_block(
            model, cfg, port_cache(ins["decode_in"], cfg, BATCH, False),
            x["dec_token"], x["dec_pos"], x["steps_left"], steps=4),
        "chunk": lambda: decoder.prefill_chunk(
            model, cfg, port_cache(ins["chunk_in"], cfg, BATCH, False),
            x["chunk_tokens"], x["chunk_pos"], x["chunk_len"])}
    for tag, fn in runs.items():
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            fn()
        out[tag] = float(fc.get_total_flops())
    return out


@pytest.mark.parametrize("case", sorted(MOE_CELLS))
def test_sharded_steps_match_single_device_reference(moe_runs, case):
    d, steps = moe_runs[:2]
    got = result(d, case)
    want_losses, want_tree = steps[MOE_CELLS[case][2]]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-5)
    want = {n: p.numpy() for n, p in params_from_numpy(
        want_tree, port_cfg(MOE), device="cpu").named_parameters()}
    scale = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        np.testing.assert_allclose(got[f"p/{n}"], w, rtol=0,
                                   atol=1e-4 * scale, err_msg=n)


@pytest.mark.parametrize("tag", DISPATCHES)
@pytest.mark.parametrize("case", sorted(MOE_CELLS))
def test_dispatch_matches_single_device_reference(moe_runs, case, tag):
    d, _, want = moe_runs[:3]
    got = result(d, case)
    if tag == "decode_block":
        np.testing.assert_array_equal(got[f"{tag}/ring"],
                                      want["decode_block/ring"])
        np.testing.assert_array_equal(got[f"{tag}/carry"],
                                      want["decode_block/carry"])
    else:
        key = f"prefill/{MOE_CELLS[case][0][1]}/logits" \
            if tag == "prefill" else f"{tag}/logits"
        np.testing.assert_allclose(got[f"{tag}/logits"], want[key], rtol=0,
                                   atol=_tol("moe", want[key]))
        np.testing.assert_array_equal(got[f"{tag}/logits"].argmax(-1),
                                      want[key].argmax(-1))
    assert float(got[f"{tag}/diff"].max()) <= TOL, got[f"{tag}/diff"]
    assert bool(got[f"{tag}/sorted_equal"].all())


@pytest.mark.parametrize("tag", ["prefill", "decode"])
def test_one_lane_matches_single_device_reference(moe_runs, tag):
    """Batch 1 on (2, 2): the prefill splits the prompt's positions over
    the 4 ranks (each routes its block, the routing integers gathered
    along the sequence, one device's capacity); the decode step runs the
    lane on every rank. Logits, tokens and each rank's cache share equal
    JAX's single-device dispatches."""
    d, want = moe_runs[0], moe_runs[6]
    got = result(d, "moe_b1_2x2")
    key = "prefill/4/logits" if tag == "prefill" else "decode/logits"
    np.testing.assert_allclose(got[f"{tag}/logits"], want[key], rtol=0,
                               atol=_tol("moe", want[key]))
    np.testing.assert_array_equal(got[f"{tag}/logits"].argmax(-1),
                                  want[key].argmax(-1))
    assert float(got[f"{tag}/diff"].max()) <= TOL, got[f"{tag}/diff"]
    assert bool(got[f"{tag}/sorted_equal"].all())


@pytest.mark.parametrize("case", sorted(MOE_CELLS))
def test_drop_cell_drops_the_reference_choices(moe_runs, case):
    """Expert 0 is every token's first choice: the reference keeps the
    first 192 in token order and drops the last 64 tokens' first choices,
    which are data rank 1's rows. The ranks, each routing its own rows
    from the gathered routing integers, drop the same ones: the same drop
    fraction, aux loss and outputs."""
    d = moe_runs[0]
    out, aux, dropped, keep = moe_runs[3]
    got = result(d, case)
    t = DROP["batch"] * DROP["seq"]
    assert keep[:, 1].all()
    np.testing.assert_array_equal(np.flatnonzero(~keep[:, 0]),
                                  np.arange(192, t))
    assert dropped > 0
    assert float(got["drop/dropped"]) == pytest.approx(dropped, abs=0)
    np.testing.assert_allclose(float(got["drop/aux"]), aux, rtol=1e-6)
    np.testing.assert_allclose(got["drop/out"], out, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(out).max())))


def _cell_flops():
    return [(c, t) for c in sorted(MOE_CELLS) for t in ["train", *DISPATCHES]]


@pytest.mark.parametrize("case,tag", _cell_flops())
def test_each_rank_does_its_share_of_the_single_device_flops(moe_runs, case,
                                                             tag):
    """Every rank's count is the single device's over the ranks (the
    experts over their capacity blocks, the router over its rows: no
    product left whole), and no more than the reference's GSPMD program
    does per device."""
    d, _, _, _, one, jax_flops, _ = moe_runs
    shape, _, mb = MOE_CELLS[case]
    got = result(d, case)[f"{tag}/flops"]
    single = one["train", mb] if tag == "train" else one[tag]
    np.testing.assert_allclose(got, np.full_like(got, single / got.size),
                               rtol=1e-6)
    assert got.size == shape[0] * shape[1]
    assert float(got.max()) <= jax_flops[case, tag], (
        float(got.max()), jax_flops[case, tag])
    print(f"{case} {tag}: per rank {float(got[0]):.0f} = one device "
          f"{single:.0f} / {got.size}; the reference's "
          f"{jax_flops[case, tag]:.0f}")
