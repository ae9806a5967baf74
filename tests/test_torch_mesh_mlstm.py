"""The mLSTM on a model axis that does not divide its heads, on gloo CPU
ranks, against the JAX package's single-device step and dispatches and
against the per-device matmul FLOPs of the reference's GSPMD programs.

The f32 smoke xlstm-350m (7 mLSTM layers of 4 heads of 32 columns, one
sLSTM layer) on (data 1, model 8): one spawn of 8 ranks
(``test_torch_mesh_worker.py``, ``mlstm_1x8``), from the JAX init. The
plan puts the 4 heads over g = gcd(4, 8) = 4 groups of r = 2 ranks; each
rank projects its head's 16 value columns of q, k, v and the output
gate, gathers q and k over its group, runs the chunk loop on whole q and
k against its value columns and holds C [.., 1, 32, 16].

* 2 sharded steps (batch 8 x 64, remat full) equal 2 JAX single-device
  steps: losses within 2e-5 relative, parameters within 1e-4 of the
  largest;
* ``prefill``, ``prefill_chunk``, ``decode_step`` and ``decode_block``
  equal JAX's single-device dispatches: logits within 2e-5 of their
  largest, greedy tokens equal, each rank's share of the result cache
  (its head's C columns, its head's n and m) within 2e-5 of the same
  share of JAX's;
* each rank's rows of ``wq`` / ``wk`` / ``wv`` / ``w_o`` and columns of
  ``w_out``, as the layout cuts them, are its head's value columns;
* every rank's ``FlopCounterMode`` count (``MLSTMChunk``'s backward
  recompute apart) is the port's one-device count / 8 plus a named
  residual (:func:`_whole`): the products that each of a head's 2 ranks
  computes whole. That is the scalar gates, the within-chunk q k^T and
  the q n and n terms of the chunk loop (the ``pairs 2 Dk`` and ``4 Dk``
  terms of ``kernels.mlstm_chunk.kernel.need``) and their gradients.
  The count is at most 1.10 x one device's / 8, and is printed beside
  the reference's per-device ``dot_flops()`` of the same cell (an
  8-device JAX subprocess).
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

from test_torch_helpers import port_cfg  # noqa: E402
from test_torch_mesh_serve import _jax_inputs, _tol, \
    start_with_devices  # noqa: E402
from test_torch_mesh_split import _one_device_counts  # noqa: E402
from test_torch_mesh_worker import BATCH, CHUNK, MLSTM_MESH, MLSTM_SERVE, \
    SERVE_SEQ, SPLIT_SEQ, result, save_tree, serve_inputs_name, \
    start_ranks  # noqa: E402

XL = dataclasses.replace(jcfg.smoke_variant(jcfg.get_arch("xlstm-350m")),
                         dtype="float32")
TOL = 2e-5
RANKS = MLSTM_MESH[0] * MLSTM_MESH[1]
GROUPS, SHARE = 4, 2          # g = gcd(4 heads, 8 ranks), r = 8 / g
DISPATCHES = MLSTM_SERVE.split()
TAGS = ["train", *DISPATCHES]

# the reference's per-device dot FLOPs of the cell's train step and
# serving dispatches on the (1, 8) mesh, as ``HloModule.dot_flops()``
# counts its ``lower_*``
_JAX_FLOPS = """
import dataclasses, numpy as np, jax
from jax.sharding import Mesh
from repro import config as C
from repro.launch import dryrun as D
from repro.launch.hlo_analysis import HloModule
cfg = dataclasses.replace(C.smoke_variant(C.get_arch("xlstm-350m")),
                          dtype="float32")
mesh = Mesh(np.array(jax.devices()[:8]).reshape(%(mesh)r), ("data", "model"))
sh = C.ShardingConfig(remat="none")
pre = C.ShapeConfig("p", C.ShapeKind.PREFILL, %(seq)d, %(batch)d)
dec = C.ShapeConfig("d", C.ShapeKind.DECODE, %(seq)d, %(batch)d)
with mesh:
    lows = {
        "train": D.lower_train(cfg, C.ShapeConfig(
            "t", C.ShapeKind.TRAIN, %(train_seq)d, %(batch)d), mesh,
            dataclasses.replace(sh, remat="full")),
        "prefill": D.lower_prefill(cfg, pre, mesh, sh),
        "decode": D.lower_decode(cfg, dec, mesh, sh),
        "decode_block": D.lower_decode_block(cfg, dec, mesh, sh, steps=4),
        "chunk": D.lower_prefill_chunk(cfg, pre, mesh, sh, chunk=%(chunk)d)}
    for tag, low in lows.items():
        print("FLOPS", tag, HloModule(low.compile().as_text()).dot_flops())
"""


def _run():
    return jcfg.RunConfig(
        model=XL, shape=jcfg.ShapeConfig("t", jcfg.ShapeKind.TRAIN,
                                         SPLIT_SEQ, BATCH),
        optimizer=jcfg.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10),
        sharding=jcfg.ShardingConfig(remat="full"))


def _jax_steps(d):
    """2 JAX single-device steps from PRNGKey(0) -> (losses, params); the
    init written for the ranks."""
    run = _run()
    state = init_train_state(jax.random.PRNGKey(0), run)
    save_tree(d / "init_xl.npz",
              jax.tree_util.tree_map(np.asarray, state.params))
    step = make_train_step(run, None, donate=False)
    losses = []
    for i in range(2):
        batch = {k: jnp.asarray(v) for k, v in make_lm_batch(
            i, BATCH, SPLIT_SEQ, XL.vocab_size, 0).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return np.array(losses), jax.tree_util.tree_map(np.asarray, state.params)


@pytest.fixture(scope="module")
def mlstm_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_mlstm")
    counting = start_with_devices(_JAX_FLOPS % dict(
        mesh=MLSTM_MESH, seq=SERVE_SEQ, batch=BATCH, train_seq=SPLIT_SEQ,
        chunk=CHUNK), devices=8)
    steps = _jax_steps(d)
    serve = _jax_inputs(d, "xl", BATCH, set(DISPATCHES), {MLSTM_MESH[1]})
    wait = start_ranks(RANKS, ["mlstm_1x8"], d)
    one = _one_device_flops(d)
    wait()
    out, err = counting.communicate(timeout=900)
    assert counting.returncode == 0, err[-3000:]
    flops = {ln.split()[1]: float(ln.split()[2])
             for ln in out.splitlines() if ln.startswith("FLOPS ")}
    return d, steps, serve, one, flops


def _one_device_flops(d):
    """The port's single-device ``FlopCounterMode`` counts from the JAX
    init and the ranks' inputs: the train step's (and its mLSTM
    recompute's) and each serving dispatch's."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.config import A3Config
    from repro_torch.models import decoder
    from test_torch_mesh_worker import load_tree, port_cache
    cfg = port_cfg(XL)
    out = {"train": _one_device_counts("xl")}
    model = params_from_numpy(load_tree(d / "init_xl.npz"), cfg, "cpu")
    ins = load_tree(d / f"{serve_inputs_name('xl', BATCH)}.npz")
    with np.load(d / f"{serve_inputs_name('xl', BATCH)}_x.npz") as f:
        x = {k: torch.from_numpy(f[k]) for k in f.files}
    runs = {
        "prefill": lambda: decoder.prefill(model, cfg, x["tokens"],
                                           max_len=SERVE_SEQ, a3=True),
        "decode": lambda: decoder.decode_step(
            model, cfg, port_cache(ins["decode_in"], cfg, BATCH, False),
            x["dec_token"], x["dec_pos"], a3=A3Config()),
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


def _whole(tag: str) -> tuple:
    """One device's FLOPs, over the 7 mLSTM layers, of the products that
    each rank sharing a head computes whole -> (the step or dispatch's,
    the train step's ``MLSTMChunk`` recompute's). Per layer of B rows of
    S tokens (one chunk: S <= 256), H heads, hd columns, d wide:

    * the scalar gates, x @ w_i and x @ w_f: 2 x 2 B S d H;
    * the chunk loop (``kernels.mlstm_chunk.kernel.mlstm_chunk_plain``):
      the within-chunk q k^T, 2 B H S^2 hd; q n, 2 B H S hd; the n
      update, 2 B H S hd, where the final state is returned (serving);
    * the one-token decode step: the gates over B rows and q n;
    * training (remat full): the forward twice (the remat recompute),
      then the gradients of the gates (x and the weights, 2 x their
      products) and of the chunk's q k^T (q and k) and q n (q); the
      backward's own recompute of the chunk loop is counted apart.

    The rank's count is one device's / ranks plus (1 - 1 / r) / g of
    this: one device's count of it over g head groups, each of whose r
    ranks computes its group's share whole."""
    b, d, h, hd = BATCH, XL.d_model, XL.num_heads, XL.head_dim
    layers = sum(XL.block_kind(i) == jcfg.BlockKind.MLSTM
                 for i in range(XL.num_layers))

    def gates(rows):
        return 2 * 2 * rows * d * h

    def chunk(s, update):
        return 2 * b * h * s * s * hd + 2 * b * h * s * hd * (1 + update)

    s = SPLIT_SEQ
    decode = gates(b) + 2 * b * h * hd
    per = {"prefill": (gates(b * SERVE_SEQ) + chunk(SERVE_SEQ, True), 0),
           "chunk": (gates(b * CHUNK) + chunk(CHUNK, True), 0),
           "decode": (decode, 0),
           "decode_block": (4 * decode, 0),
           "train": (2 * (gates(b * s) + chunk(s, False)) + 2 * gates(b * s)
                     + 4 * b * h * s * s * hd + 2 * b * h * s * hd,
                     chunk(s, False))}[tag]
    return tuple(layers * w * (1 - 1 / SHARE) / GROUPS for w in per)


def test_train_steps_match_single_device_reference(mlstm_runs):
    d, (want_losses, want_tree) = mlstm_runs[:2]
    got = result(d, "mlstm_1x8_train")
    np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-5)
    want = {n: p.numpy() for n, p in params_from_numpy(
        want_tree, port_cfg(XL), device="cpu").named_parameters()}
    scale = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        np.testing.assert_allclose(got[f"p/{n}"], w, rtol=0,
                                   atol=1e-4 * scale, err_msg=n)


@pytest.mark.parametrize("tag", DISPATCHES)
def test_dispatch_matches_single_device_reference(mlstm_runs, tag):
    d, _, want = mlstm_runs[:3]
    got = result(d, "mlstm_1x8_serve")
    if tag == "decode_block":
        np.testing.assert_array_equal(got[f"{tag}/ring"],
                                      want["decode_block/ring"])
        np.testing.assert_array_equal(got[f"{tag}/carry"],
                                      want["decode_block/carry"])
    else:
        key = f"prefill/{MLSTM_MESH[1]}/logits" if tag == "prefill" \
            else f"{tag}/logits"
        np.testing.assert_allclose(got[f"{tag}/logits"], want[key], rtol=0,
                                   atol=_tol("xl", want[key]))
        np.testing.assert_array_equal(got[f"{tag}/logits"].argmax(-1),
                                      want[key].argmax(-1))
    assert float(got[f"{tag}/diff"].max()) <= TOL, got[f"{tag}/diff"]


def test_each_rank_holds_its_heads_value_columns(mlstm_runs):
    """The layout's contiguous block of the head-major projection rows is
    the rank's head's block of value columns; the plan's groups are
    (4, 2); a rank's C is [layers, B, 1 head, 32, 16]."""
    got = result(mlstm_runs[0], "mlstm_1x8_serve")
    assert got["layout"].all()
    assert got["groups"].tolist() == [GROUPS, SHARE]
    layers = sum(XL.block_kind(i) == jcfg.BlockKind.MLSTM
                 for i in range(XL.num_layers))
    want = [layers, BATCH, XL.num_heads // GROUPS, XL.head_dim,
            XL.head_dim // SHARE]
    assert got["C_shape"].tolist() == [want] * RANKS


@pytest.mark.parametrize("tag", TAGS)
def test_each_rank_does_its_share_plus_the_named_residual(mlstm_runs, tag):
    """Every rank's count is one device's / 8 plus :func:`_whole`'s
    residual, within 1e-6 relative, and at most 1.10 x one device's / 8
    (the train step's with ``MLSTMChunk``'s recompute apart, which is
    held the same way)."""
    d, _, _, one, jax_flops = mlstm_runs
    main, rec = _whole(tag)
    if tag == "train":
        got = result(d, "mlstm_1x8_train")
        single, single_rec = one["train"]
        counts = got["flops"] - got["recompute"]
        np.testing.assert_allclose(
            got["recompute"], np.full(RANKS, single_rec / RANKS + rec),
            rtol=1e-6)
        single -= single_rec
    else:
        counts = result(d, "mlstm_1x8_serve")[f"{tag}/flops"]
        single = one[tag]
    assert counts.size == RANKS
    np.testing.assert_allclose(counts, np.full(RANKS, single / RANKS + main),
                               rtol=1e-6)
    assert float(counts.max()) <= 1.10 * single / RANKS
    print(f"xlstm-350m (1, 8) {tag}: per rank {float(counts[0]):.0f} = one "
          f"device {single:.0f} / {RANKS} + {main:.0f} whole on each rank "
          f"of a head ({float(counts[0]) * RANKS / single:.4f} of one "
          f"device's share); the reference's per device "
          f"{jax_flops[tag]:.0f}")
