"""Rank-side code of the port's gloo-rank tests (``test_torch_sharding.py``,
``test_torch_mesh_train.py``, ``test_torch_mesh_split.py``,
``test_torch_mesh_serve.py``, ``test_torch_mesh_moe.py``); no tests of
its own.

:func:`run_ranks` starts ``world`` CPU processes of this file, each a
rank of one gloo process group (a file store in the case directory).
Each rank runs the named cases in order; a case reads its inputs from
the directory (numpy ``.npz`` files the test wrote, made with numpy
from fixed seeds or by the JAX package) and rank 0 writes
``<case>.npz``. The ranks import torch and the port only, never JAX: the
test process compares the results with the JAX package. A case that
raises writes ``<case>.err.<rank>`` and ends its rank (its peers then
time out); :func:`result` reports those files.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------

def run_ranks(world: int, cases, directory, timeout: float = 300.0):
    """Run ``cases`` on ``world`` gloo ranks; -> the ranks' exit codes
    (None for a rank killed at the timeout)."""
    return start_ranks(world, cases, directory)(timeout)


def start_ranks(world: int, cases, directory):
    """Start ``cases`` on ``world`` gloo ranks -> wait(timeout=300.0),
    which returns the ranks' exit codes (None for a rank killed at the
    timeout)."""
    directory = Path(directory)
    store = tempfile.mktemp(prefix="gloo_store_", dir=directory)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(SRC), str(HERE),
                                           os.environ.get("PYTHONPATH",
                                                          "")]))
    procs = []
    for rank in range(world):
        arg = json.dumps(dict(rank=rank, world=world, store=store,
                              directory=str(directory), cases=list(cases)))
        log = open(directory / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, __file__, arg],
                                       env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))

    def wait(timeout: float = 300.0):
        codes = []
        for p, log in procs:
            try:
                codes.append(p.wait(timeout=timeout))
            except subprocess.TimeoutExpired:
                codes.append(None)
            finally:
                log.close()
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        return codes

    return wait


def result(directory, case: str) -> dict:
    """The arrays rank 0 wrote for ``case``, or an AssertionError with
    every rank's traceback of it."""
    directory = Path(directory)
    path = directory / f"{case}.npz"
    if not path.exists():
        errs = "\n".join(p.read_text() for p in
                         sorted(directory.glob(f"{case}.err.*")))
        logs = "\n".join(p.read_text()[-3000:] for p in
                         sorted(directory.glob("rank*.log")))
        raise AssertionError(f"case {case} wrote no result\n{errs}\n{logs}")
    with np.load(path) as f:
        return dict(f)


def save_tree(path, tree) -> None:
    """A nested dict of arrays -> one ``.npz`` with ``/``-joined keys."""
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v, dtype=np.float32)
    walk(tree, "")
    np.savez(path, **flat)


def load_tree(path) -> dict:
    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            *outer, last = key.split("/")
            t = tree
            for k in outer:
                t = t.setdefault(k, {})
            t[last] = f[key]
    return tree


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


class Ctx:
    def __init__(self, rank, world, directory):
        self.rank, self.world = rank, world
        self.dir = Path(directory)

    def save(self, name, **arrays):
        if self.rank == 0:
            np.savez(self.dir / f"{name}.npz", **arrays)

    def gather(self, t):
        """Every rank's tensor, stacked in rank order (on every rank)."""
        import torch
        import torch.distributed as dist
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t.contiguous())
        return torch.stack(out).numpy()


def configs():
    """The port's tiny configs of the mesh tests (as the JAX side's)."""
    from repro_torch import config as C
    tiny = C.ModelConfig("tiny", "dense", num_layers=2, d_model=64,
                         num_heads=4, num_kv_heads=2, d_ff=128,
                         vocab_size=256, head_dim=16, dtype="float32")
    tiny_xl = C.ModelConfig("tiny-xl", "ssm", num_layers=3, d_model=64,
                            num_heads=4, num_kv_heads=4, d_ff=0,
                            vocab_size=256, head_dim=16,
                            block_pattern=(C.BlockKind.MLSTM,
                                           C.BlockKind.MLSTM,
                                           C.BlockKind.SLSTM),
                            dtype="float32")
    moe = dataclasses.replace(C.smoke_variant(C.get_arch("deepseek-moe-16b")),
                              dtype="float32")
    six = dataclasses.replace(tiny, name="tiny-6h", num_heads=6)
    rg, xl = (dataclasses.replace(C.smoke_variant(C.get_arch(a)),
                                  dtype="float32")
              for a in ("recurrentgemma-2b", "xlstm-350m"))
    return {"tiny": tiny, "moe": moe, "tiny-xl": tiny_xl, "tiny-6h": six,
            "rg": rg, "xl": xl}


BATCH, SEQ = 8, 16


def train_run(cfg, **sharding):
    from repro_torch import config as C
    return C.RunConfig(
        model=cfg, shape=C.ShapeConfig("t", C.ShapeKind.TRAIN, SEQ, BATCH),
        optimizer=C.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        sharding=C.ShardingConfig(remat="none", **sharding))


def full(t):
    from torch.distributed.tensor import DTensor
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().float().numpy()


def sharded_steps(ctx, name, shape, steps=2, microbatches=1):
    """``name``'s config on a ("data", "model") mesh of ``shape`` from the
    JAX init (``init_<name>.npz``): ``steps`` sharded steps -> losses,
    the final parameters, and every rank's bytes of parameters, m and v
    held against the sum of its shards under the rules."""
    import math
    import torch
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.sharding.rules import mesh_sizes, param_specs
    from repro_torch.train.step import make_train_step

    mesh = make_mesh(shape, ("data", "model"), "cpu")
    cfg = configs()[name]
    run = train_run(cfg, microbatches=microbatches)
    state = train_state_from_numpy(load_tree(ctx.dir / f"init_{name}.npz"),
                                   run, "cpu", mesh)
    sizes = mesh_sizes(mesh)
    specs = param_specs(state.model, run.sharding, mesh)
    want = 0
    for n, p in state.model.named_parameters():
        split = math.prod(sizes[a] for e in specs[n] if e is not None
                          for a in ((e,) if isinstance(e, str) else e))
        want += 3 * p.numel() // split * p.element_size()
    held = sum(t.to_local().untyped_storage().nbytes()
               for tree in (dict(state.model.named_parameters()),
                            state.opt.m, state.opt.v)
               for t in tree.values())
    step = make_train_step(run, mesh)
    losses = []
    for i in range(steps):
        state, metrics = step(state, make_lm_batch(i, BATCH, SEQ,
                                                   cfg.vocab_size, 0))
        losses.append(float(metrics["loss"]))
    params = {f"p/{n}": full(p) for n, p in state.model.named_parameters()}
    ctx.save(name_of(name, shape, microbatches), losses=np.array(losses),
             held=ctx.gather(torch.tensor(held)),
             want=ctx.gather(torch.tensor(want)), **params)


def name_of(cfg_name, shape, microbatches=1):
    mb = f"_mb{microbatches}" if microbatches > 1 else ""
    return f"step_{cfg_name}_{shape[0]}x{shape[1]}{mb}"


for _cfg in ("tiny", "moe", "tiny-xl"):
    for _shape in ((2, 2), (2, 4)):
        CASES[name_of(_cfg, _shape)] = (
            lambda ctx, c=_cfg, s=_shape: sharded_steps(ctx, c, s))
CASES[name_of("moe", (2, 2), 2)] = (
    lambda ctx: sharded_steps(ctx, "moe", (2, 2), microbatches=2))


# the model-axis compute split (test_torch_mesh_split.py): batch 8 x 64,
# remat full, the shape of the reference's per-device FLOP counts
SPLIT_SEQ = 64
SPLIT_CELLS = {          # case -> (config, mesh shape, expert_parallel)
    "split_tiny_2x2": ("tiny", (2, 2), True),
    "split_tiny_2x4": ("tiny", (2, 4), True),
    "split_tiny-6h_2x4": ("tiny-6h", (2, 4), True),
    "split_moe_2x2": ("moe", (2, 2), True),
    "split_moe_2x4": ("moe", (2, 4), True),
    "split_moe-tp_2x2": ("moe", (2, 2), False),
    "split_rg_2x4": ("rg", (2, 4), True),
    "split_xl_2x4": ("xl", (2, 4), True),
}


def split_run(cfg, expert_parallel=True):
    from repro_torch import config as C
    return C.RunConfig(
        model=cfg, shape=C.ShapeConfig("t", C.ShapeKind.TRAIN, SPLIT_SEQ,
                                       BATCH),
        optimizer=C.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        sharding=C.ShardingConfig(remat="full",
                                  expert_parallel=expert_parallel))


class mlstm_recompute_counted:
    """Within it, the FLOPs of ``MLSTMChunk``'s backward recompute (the
    plain chunk its backward re-runs under autograd; the reference
    differentiates its forward, with no such pass) are counted on their
    own as well, into ``.flops``; an enclosing ``FlopCounterMode`` still
    counts them."""

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.models import xlstm
        self.flops, self._plain = 0, xlstm.mlstm_chunk_plain

        def counted(*a, **k):
            with FlopCounterMode(display=False) as fc:
                out = self._plain(*a, **k)
            self.flops += fc.get_total_flops()
            return out
        xlstm.mlstm_chunk_plain = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import xlstm
        xlstm.mlstm_chunk_plain = self._plain


def split_steps(ctx, case_name, cell=None):
    """2 sharded steps of a split cell (``cell``: (config, mesh shape,
    expert_parallel), by default ``SPLIT_CELLS[case_name]``) from the JAX
    init -> losses, final parameters and every rank's matmul FLOPs of the
    first step (``FlopCounterMode`` around the whole step), with those of
    the mLSTM backward's recompute apart (``recompute``)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.train.step import make_train_step

    name, shape, ep = cell or SPLIT_CELLS[case_name]
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    cfg = configs()[name]
    run = split_run(cfg, ep)
    state = train_state_from_numpy(load_tree(ctx.dir / f"init_{name}.npz"),
                                   run, "cpu", mesh)
    step = make_train_step(run, mesh)
    losses, flops = [], []
    for i in range(2):
        with FlopCounterMode(display=False) as fc, \
                mlstm_recompute_counted() as rc:
            state, metrics = step(state, make_lm_batch(
                i, BATCH, SPLIT_SEQ, cfg.vocab_size, 0))
        losses.append(float(metrics["loss"]))
        flops.append((fc.get_total_flops(), rc.flops))
    params = {f"p/{n}": full(p) for n, p in state.model.named_parameters()}
    ctx.save(case_name, losses=np.array(losses),
             flops=ctx.gather(torch.tensor(flops[0][0], dtype=torch.float64)),
             recompute=ctx.gather(torch.tensor(flops[0][1],
                                               dtype=torch.float64)),
             **params)


for _case in SPLIT_CELLS:
    CASES[_case] = lambda ctx, c=_case: split_steps(ctx, c)


# the mLSTM on a model axis that its heads do not divide
# (test_torch_mesh_mlstm.py): the smoke xlstm-350m's 4 heads on 8 model
# ranks, each head's value columns over 2 of them
MLSTM_MESH = (1, 8)
MLSTM_SERVE = "prefill decode decode_block chunk"


@case
def mlstm_1x8(ctx):
    """The split-cell training (``mlstm_1x8_train``: 2 steps at batch 8 x
    64, remat full) and the serving dispatches (``mlstm_1x8_serve``) of
    the smoke xlstm-350m on (1, 8), plus every rank's layout: its rows of
    ``wq`` / ``wk`` / ``wv`` / ``w_o`` and columns of ``w_out`` are its
    head's block of value columns (``layout``), and the shape of its
    share of the cache's C (``C_shape``)."""
    import torch
    from repro_torch.config import ShardingConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.sharding.plan import serving_plan
    from repro_torch.sharding.rules import distribute_parameters

    split_steps(ctx, "mlstm_1x8_train", ("xl", MLSTM_MESH, True))
    cfg, shd = configs()["xl"], ShardingConfig(remat="none")
    mesh = make_mesh(MLSTM_MESH, ("data", "model"), "cpu")
    model = distribute_parameters(params_from_numpy(
        load_tree(ctx.dir / "init_xl.npz"), cfg, "cpu"), shd, mesh)
    plan = serving_plan(cfg, mesh, shd, batch=BATCH, max_len=SERVE_SEQ,
                        dispatch="decode")
    g, r = plan.mlstm_groups()
    a, c = divmod(plan.coord["model"], r)
    hd = cfg.resolved_head_dim
    dv = hd // r
    ok = True
    for n, p in model.named_parameters():
        if ".mlstm.w" not in n or not n.endswith(".weight"):
            continue
        whole = p.full_tensor()
        if ".w_out." in n:
            want = whole.reshape(whole.shape[0], -1, hd)[:, a, c * dv:
                                                         (c + 1) * dv]
        else:
            want = whole.reshape(-1, hd, whole.shape[1])[a, c * dv:
                                                         (c + 1) * dv]
        ok = ok and torch.equal(p.to_local(), want)
    cache = plan.init_cache(BATCH, SERVE_SEQ, device="cpu")
    shapes = [list(v["C"].shape) for v in cache.values() if "C" in v]
    out = serve_dispatches(ctx, "xl", MLSTM_MESH, BATCH, MLSTM_SERVE, shd)
    ctx.save("mlstm_1x8_serve", layout=ctx.gather(torch.tensor(ok)),
             groups=np.array([g, r]),
             C_shape=ctx.gather(torch.tensor(shapes[0])), **out)


# the serving dispatches on a mesh (test_torch_mesh_serve.py): prompts of
# SERVE_SEQ tokens into rings of SERVE_SEQ rows, the reference's
# per-device FLOP cells; decode from a DECODE_FROM-token prefill
SERVE_SEQ, DECODE_FROM, CHUNK = 64, 48, 16
SERVE_CELLS = {      # case -> (config, mesh shape, batch, dispatches)
    "serve_tiny_2x2": ("tiny", (2, 2), 8, "prefill decode decode_a3 "
                       "decode_block chunk"),
    "serve_tiny_2x4": ("tiny", (2, 4), 8, "prefill prefill_short decode "
                       "decode_a3 decode_block chunk chunk_a3"),
    "serve_tiny-b1_2x4": ("tiny", (2, 4), 1, "prefill decode"),
    "serve_tiny-6h_2x4": ("tiny-6h", (2, 4), 8, "prefill decode"),
    "serve_moe_2x4": ("moe", (2, 4), 8, "prefill decode"),
    "serve_rg_2x4": ("rg", (2, 4), 8, "prefill decode"),
    "serve_xl_2x4": ("xl", (2, 4), 8, "prefill decode"),
}


def serve_inputs_name(cfg_name: str, batch: int) -> str:
    return f"serve_in_{cfg_name}_b{batch}"


def port_cache(tree, cfg, batch, a3):
    """A reference cache tree (numpy, float32 through ``save_tree``) ->
    the port's whole cache with its leaves' dtypes."""
    import torch
    from repro_torch.models import decoder
    want = decoder.init_cache(cfg, batch, SERVE_SEQ, a3=a3, device="cpu")
    return {s: {k: torch.from_numpy(np.asarray(tree[s][k])).to(v.dtype)
                for k, v in leaves.items()} for s, leaves in want.items()}


def serve_cell(ctx, case_name):
    """The serving dispatches of a ``SERVE_CELLS`` cell on its mesh; rank 0
    writes what :func:`serve_dispatches` returns."""
    from repro_torch.config import ShardingConfig
    name, shape, batch, dispatches = SERVE_CELLS[case_name]
    ctx.save(case_name, **serve_dispatches(
        ctx, name, shape, batch, dispatches, ShardingConfig(remat="none")))


def serve_dispatches(ctx, name, shape, batch, dispatches, shd):
    """The serving dispatches of config ``name`` on a ("data", "model")
    mesh of ``shape`` laid out by ``shd``, from the reference's
    parameters and inputs (``serve_in_*.npz``, caches the JAX package
    made): each rank holds its share of the model (DTensors by the rules)
    and of the cache, runs the dispatch under its plan, and compares its
    share of the result cache with the same share of the reference's
    (``<dispatch>/cache_out``): the max |difference| of each leaf, and
    whether the A^3 sorted rows are equal -> the whole logits (gathered),
    decode_block's tokens and every rank's FLOPs, by dispatch."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.config import A3Config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder
    from repro_torch.models.common import all_gather
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.sharding.plan import serving_plan
    from repro_torch.sharding.rules import distribute_parameters

    cfg = configs()[name]
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    model = distribute_parameters(params_from_numpy(
        load_tree(ctx.dir / f"init_{name}.npz"), cfg, "cpu"), shd, mesh)
    tree = load_tree(ctx.dir / f"{serve_inputs_name(name, batch)}.npz")
    with np.load(ctx.dir / f"{serve_inputs_name(name, batch)}_x.npz") as f:
        x = {k: torch.from_numpy(f[k]) for k in f.files}
    ns = shape[1] if batch % shape[0] == 0 and batch >= shape[0] \
        else shape[0] * shape[1]
    a3c = dataclasses.replace(A3Config.conservative(), select_shards=ns)
    out = {}

    def whole(plan, t, vocab):
        if vocab and plan.keeps("embed", model.embed):
            t = all_gather(t, -1, plan.model, plan.model_group)
        if plan.lane_size > 1:
            t = all_gather(t, 0, plan.lane_size, plan.lane_group)
        return t.numpy()

    def compare(tag, key, plan, cache, a3):
        want = plan.cut_cache(port_cache(tree[key]["cache_out"], cfg,
                                         batch, a3))
        diff, same = 0.0, True
        for s_, leaves in cache.items():
            for k, v in leaves.items():
                if k.startswith("_"):
                    continue
                w = want[s_][k]
                diff = max(diff, float((v.float() - w.float()).abs().max())
                           if v.numel() else 0.0)
                if k == "sk_rows":
                    same = same and torch.equal(v, w)
        out[f"{tag}/diff"] = ctx.gather(torch.tensor(diff))
        out[f"{tag}/sorted_equal"] = ctx.gather(torch.tensor(same))

    for tag in dispatches.split():
        if tag == "chunk_a3":
            chunk_then_a3_decode(ctx, out, x, model, mesh, shd, compare,
                                 whole, name, batch, ns, a3c)
            continue
        kind = {"decode_a3": "decode", "decode_block": "decode",
                "prefill_short": "prefill"}.get(tag, tag)
        a3 = tag in ("prefill", "prefill_short", "decode_a3")
        plan = serving_plan(cfg, mesh, shd, batch=batch, max_len=SERVE_SEQ,
                            dispatch=kind, select_shards=ns)
        key = {"prefill": f"prefill_{ns}",
               "decode_a3": f"decode_a3_{ns}"}.get(tag, tag)
        src = {"prefill": None, "prefill_short": None, "decode": "decode_in",
               "decode_a3": f"decode_a3_in_{ns}", "decode_block": "decode_in",
               "chunk": "chunk_in"}[tag]
        cache = None if src is None else plan.cut_cache(
            port_cache(tree[src], cfg, batch, a3))
        with FlopCounterMode(display=False) as fc, \
                plan.dispatch_context(model):
            if tag in ("prefill", "prefill_short"):
                # the short prompt leaves some ranks' ring rows unwritten
                toks = x["tokens"] if tag == "prefill" \
                    else x["tokens"][:, :DECODE_FROM - 8]
                logits, cache = decoder.prefill(
                    model, cfg, toks, max_len=SERVE_SEQ, a3=a3,
                    select_shards=ns)
            elif tag == "chunk":
                logits, cache = decoder.prefill_chunk(
                    model, cfg, cache, x["chunk_tokens"], x["chunk_pos"],
                    x["chunk_len"])
            elif tag == "decode_block":
                ring, carry, cache = decoder.decode_block(
                    model, cfg, cache, x["dec_token"], x["dec_pos"],
                    x["steps_left"], steps=4)
                logits = None
            else:
                logits, cache = decoder.decode_step(
                    model, cfg, cache, x["dec_token"], x["dec_pos"],
                    a3=a3c if a3 else A3Config())
        out[f"{tag}/flops"] = ctx.gather(torch.tensor(
            float(fc.get_total_flops()), dtype=torch.float64))
        if logits is not None:
            out[f"{tag}/logits"] = whole(plan, logits, True)
        else:
            out[f"{tag}/ring"] = whole(plan, ring, False)
            out[f"{tag}/carry"] = whole(plan, carry, False)
        compare(tag, key, plan, cache, a3)
    return out


def chunk_then_a3_decode(ctx, out, x, model, mesh, shd, compare, whole,
                         name, batch, ns, a3c):
    """``chunk_a3``: two chunks of a chunked prefill with A^3 (16 tokens a
    lane, then the ragged second chunk) from an empty cache, then the
    conservative decode step from each lane's next position. The cache
    against the reference's and the whole decode logits for the test."""
    import torch
    from repro_torch.models import decoder
    from repro_torch.sharding.plan import serving_plan
    cfg = configs()[name]
    plan = serving_plan(cfg, mesh, shd, batch=batch, max_len=SERVE_SEQ,
                        dispatch="chunk", select_shards=ns)
    cache = plan.cut_cache(decoder.init_cache(cfg, batch, SERVE_SEQ, a3=True,
                                              device="cpu"))
    with plan.dispatch_context(model):
        decoder.prefill_chunk(model, cfg, cache, x["tokens"][:, :CHUNK],
                              torch.zeros(batch, dtype=torch.int32),
                              torch.full((batch,), CHUNK, dtype=torch.int32),
                              a3=True)
        decoder.prefill_chunk(model, cfg, cache, x["chunk_tokens"],
                              x["chunk_pos"], x["chunk_len"], a3=True)
    compare("chunk_a3", "chunk_a3", plan, cache, True)
    plan = serving_plan(cfg, mesh, shd, batch=batch, max_len=SERVE_SEQ,
                        dispatch="decode", select_shards=ns)
    with plan.dispatch_context(model):
        logits, _ = decoder.decode_step(
            model, cfg, cache, x["tokens"][:, 2 * CHUNK],
            x["chunk_pos"] + x["chunk_len"], a3=a3c)
    out["chunk_a3/logits"] = whole(plan, logits, True)


for _case in SERVE_CELLS:
    CASES[_case] = lambda ctx, c=_case: serve_cell(ctx, c)


# the routed experts on a mesh (test_torch_mesh_moe.py): the f32 smoke
# deepseek-moe-16b (4 experts, top-2) with its experts over the model
# axis (EP) or each expert's columns there (TP); train steps at batch
# 8 x MOE_SEQ, the serving dispatches of SERVE_CELLS, the drop cell
MOE_SEQ = 32
MOE_SERVE = "prefill decode decode_block chunk"
MOE_CELLS = {      # case -> (mesh shape, expert_parallel, microbatches)
    "moe_ep_2x2": ((2, 2), True, 1),
    "moe_ep_2x4": ((2, 4), True, 1),
    "moe_tp_2x2": ((2, 2), False, 2),
}
DROP = dict(batch=8, seq=32, bias=4.0)      # 256 tokens, expert 0 first


def moe_train_run(ep, microbatches):
    from repro_torch import config as C
    return C.RunConfig(
        model=configs()["moe"],
        shape=C.ShapeConfig("t", C.ShapeKind.TRAIN, MOE_SEQ, BATCH),
        optimizer=C.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        sharding=C.ShardingConfig(remat="none", expert_parallel=ep,
                                  microbatches=microbatches))


def moe_drop(ctx, mesh, ep):
    """``moe_apply`` of one MoE layer (``moe_drop_in.npz``: the reference's
    weights with a router that sends every token to expert 0 first, and
    [8, 32, d] inputs) on ``mesh`` in a train plan: this rank's rows of
    the inputs, its experts or expert columns -> the whole output
    (gathered over the data axis), the aux loss and the drop fraction."""
    import torch
    import torch.nn as nn
    from repro_torch.config import ShapeConfig, ShapeKind, ShardingConfig
    from repro_torch.models.common import activation_shardings, all_gather
    from repro_torch.models.moe import MoE, moe_apply
    from repro_torch.sharding.plan import MeshPlan, group_name

    cfg = configs()["moe"]
    with np.load(ctx.dir / "moe_drop_in.npz") as f:
        a = {k: torch.from_numpy(f[k]) for k in f.files}
    plan = MeshPlan(cfg, ShapeConfig("t", ShapeKind.TRAIN, DROP["seq"],
                                     DROP["batch"]), mesh,
                    ShardingConfig(remat="none", expert_parallel=ep),
                    dispatch="train", row_dims=("data",))
    n_data, n_model = mesh.shape
    r, m = plan.coord["data"], plan.coord["model"]
    e, de = cfg.moe.num_experts, cfg.moe.d_expert
    moe = MoE(cfg.d_model, cfg.moe, torch.float32)
    if ep:
        cut = slice(m * e // n_model, (m + 1) * e // n_model)
        w = (a["w_gate"][cut], a["w_up"][cut], a["w_down"][cut])
    else:
        c = slice(m * de // n_model, (m + 1) * de // n_model)
        w = (a["w_gate"][:, :, c], a["w_up"][:, :, c], a["w_down"][:, c])
    for name, t in zip(("w_gate", "w_up", "w_down"), w):
        setattr(moe, name, nn.Parameter(t.contiguous()))
    with torch.no_grad():
        moe.router.copy_(a["router"])
        for name in ("w_gate", "w_up", "w_down"):
            getattr(moe.shared, name).weight.copy_(a[f"shared_{name}"].t())
    b = DROP["batch"] // n_data
    with activation_shardings(plan.plan([moe])), torch.no_grad():
        out, aux = moe_apply(moe, a["x"][r * b:(r + 1) * b], cfg.moe)
    whole = all_gather(out, 0, n_data, group_name(mesh, ("data",)))
    return {"drop/out": whole.numpy(),
            "drop/aux": aux["moe_aux_loss"].numpy(),
            "drop/dropped": aux["moe_drop_fraction"].numpy()}


def moe_cell(ctx, case_name):
    """A ``MOE_CELLS`` cell: 2 sharded steps from the JAX init (losses,
    final parameters, every rank's FLOPs of the first step), the serving
    dispatches ``MOE_SERVE`` (``serve_dispatches``) and the drop cell."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.config import ShardingConfig
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.train.step import make_train_step

    shape, ep, mb = MOE_CELLS[case_name]
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    run = moe_train_run(ep, mb)
    state = train_state_from_numpy(load_tree(ctx.dir / "init_moe.npz"), run,
                                   "cpu", mesh)
    step = make_train_step(run, mesh)
    losses, flops = [], []
    for i in range(2):
        with FlopCounterMode(display=False) as fc:
            state, metrics = step(state, make_lm_batch(
                i, BATCH, MOE_SEQ, run.model.vocab_size, 0))
        losses.append(float(metrics["loss"]))
        flops.append(float(fc.get_total_flops()))
    out = {f"p/{n}": full(p) for n, p in state.model.named_parameters()}
    out["losses"] = np.array(losses)
    out["train/flops"] = ctx.gather(torch.tensor(flops[0],
                                                 dtype=torch.float64))
    del state
    out.update(serve_dispatches(ctx, "moe", shape, BATCH, MOE_SERVE,
                                ShardingConfig(remat="none",
                                               expert_parallel=ep)))
    out.update(moe_drop(ctx, mesh, ep))
    ctx.save(case_name, **out)


for _case in MOE_CELLS:
    CASES[_case] = lambda ctx, c=_case: moe_cell(ctx, c)


@case
def moe_b1_2x2(ctx):
    """One lane on (2, 2), EP: the prefill splits the sequence over (data,
    model), so each rank routes its block of the prompt's positions (the
    routing integers gathered along the sequence); the decode step runs
    the lane on every rank."""
    from repro_torch.config import ShardingConfig
    ctx.save("moe_b1_2x2", **serve_dispatches(
        ctx, "moe", (2, 2), 1, "prefill decode", ShardingConfig(
            remat="none")))


def one_rank_serve(cfg, mesh, a3_mode, seed=0):
    """TINY's chunked prefill and two 4-step decode blocks through
    ``make_decode_block_step`` unsharded and on a one-rank mesh (the plan,
    its collectives and the partial-softmax kernels with their combine,
    on one rank) -> (prefill logits, harvests, final caches) of each."""
    import torch
    from repro_torch.config import A3Config, ShardingConfig
    from repro_torch.models import decoder
    from repro_torch.serve import engine as E
    from repro_torch.sharding.rules import distribute_parameters

    batch, max_len, prompt = 4, SERVE_SEQ, 24
    a3 = {"off": A3Config(), "conservative": A3Config.conservative()}[a3_mode]
    use_a3 = a3_mode != "off"
    shd = ShardingConfig(remat="none")
    g = torch.Generator().manual_seed(seed)
    model = decoder.init_params(cfg, g, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g)
    out = {}
    for label, m in (("single", None), ("mesh", mesh)):
        step = E.make_decode_block_step(cfg, a3, steps=4, resort_every=8,
                                        mesh=m, sharding_cfg=shd,
                                        max_len=max_len)
        if m is None:
            net = model
            cache = decoder.init_cache(cfg, batch, max_len, a3=use_a3,
                                       device="cpu")
        else:
            net = distribute_parameters(decoder.init_params(
                cfg, torch.Generator().manual_seed(seed), "cpu"), shd, m)
            cache = step.plan(batch).init_cache(batch, max_len, a3=use_a3,
                                                device="cpu")
        pos = torch.zeros(batch, dtype=torch.int32)
        length = torch.full((batch,), prompt, dtype=torch.int32)
        if m is None:
            logits, cache = decoder.prefill_chunk(net, cfg, cache, tokens,
                                                  pos, length, a3=use_a3)
        else:
            from repro_torch.sharding.plan import serving_plan
            plan = serving_plan(cfg, m, shd, batch=batch, max_len=max_len,
                                dispatch="chunk",
                                select_shards=a3.select_shards
                                if use_a3 else 0)
            with plan.dispatch_context(net):
                logits, cache = decoder.prefill_chunk(
                    net, cfg, cache, tokens, pos, length, a3=use_a3)
        token = logits.argmax(-1).to(torch.int32)
        ctrl = torch.zeros((batch, E.CTRL_COLS), dtype=torch.int32)
        harvests = []
        for blk in range(2):
            ctrl[:, E.CTRL_D_POS] = prompt + 4 * blk
            ctrl[:, E.CTRL_D_STEPS] = 4
            harvest, token, cache = step(net, cache, token, token, ctrl)
            harvests.append(harvest)
        out[label] = (logits, torch.cat(harvests, 1), cache)
    return out


COMBINE_SHAPE = dict(b=3, hq=4, hkv=2, s=64, d=16)


def combine_inputs():
    """q, k, v, mask of ``COMBINE_SHAPE`` (numpy seed 3), float32: lane 1
    with a NaN key row 37, lane 2 with its rows 16-31 masked for every
    head (an empty slice on the second of 4 ranks) and head 3 of lane 0
    masked everywhere (a -1e30 ring)."""
    import torch
    c = COMBINE_SHAPE
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((c["b"], c["hq"], c["d"]),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal(
        (c["b"], c["hkv"], c["s"], c["d"]), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal(
        (c["b"], c["hkv"], c["s"], c["d"]), dtype=np.float32))
    mask = torch.from_numpy(rng.random((c["b"], c["hq"], c["s"])) < 0.7)
    k[1, :, 37] = float("nan")
    mask[1, :, 37] = True
    mask[2, :, 16:32] = False
    mask[0, 3] = False
    return q, k, v, mask


@case
def combine_group(ctx):
    """``combine_partials`` over the world's ranks, each holding its slice
    of the ring: #1's plain version with the log-sum-exp, and #2 / #3
    against the ranks' max (NaN kept), threshold None and 3.0."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.decode_attention import kernel as tk
    from repro_torch.kernels.decode_attention.ops import combine_partials
    from repro_torch.models.common import nan_max
    grp = dist.group.WORLD.group_name
    q, k, v, mask = combine_inputs()
    n = k.shape[2] // ctx.world
    sl = slice(ctx.rank * n, (ctx.rank + 1) * n)
    ks, vs, ms = k[:, :, sl], v[:, :, sl], mask[:, :, sl].contiguous()
    o, lse = tk.fused(q, ks, vs, ms, partial=True)
    out = {"fused": combine_partials(o, lse, group=grp).numpy()}
    rm = nan_max(tk.rowmax(q, ks, ms), grp)
    for thr in (None, 3.0):
        o, lsum = tk.attend(q, ks, vs, ms, rm, threshold=thr, partial=True)
        out[f"attend_{thr}"] = combine_partials(o, lsum, stat="sum",
                                                group=grp).numpy()
    ctx.save("combine_group", **out)


GATHER = dict(pages=32, page_size=16, si=5, t=40, select_shards=2)


@case
def gather_2x2(ctx):
    """``serve.prefix_cache.gather_fn`` on a (2, 2) mesh, from the
    reference's TINY cache and an fp and an int8 pool (``gather_in.npz``):
    each rank holds its lanes' ring rows and its pages' page rows (pages
    over data, rows over model); lane ``si`` (rank data 1's) takes the
    matched prefix. Each rank's share of the result against the same
    share of the reference's (``gather_<kind>/cache_out``)."""
    import torch
    from repro_torch.config import ShardingConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decoder
    from repro_torch.models.common import activation_shardings
    from repro_torch.models.mixer import build_segments
    from repro_torch.serve.prefix_cache import gather_fn
    from repro_torch.sharding.plan import serving_plan

    cfg = configs()["tiny"]
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    g = GATHER
    tree = load_tree(ctx.dir / "gather_in.npz")
    out = {}
    for kind in ("none", "int8"):
        plan = serving_plan(cfg, mesh, ShardingConfig(remat="none"),
                            batch=8, max_len=SERVE_SEQ, dispatch="decode",
                            select_shards=g["select_shards"]).with_pool(
                                g["pages"], g["page_size"])
        cache = plan.cut_cache(port_cache(tree["cache"], cfg, 8, True))
        want_pool = decoder.init_page_pool(cfg, g["pages"], g["page_size"],
                                           a3=True, kv_quant=kind,
                                           device="cpu")
        pool = plan.cut_pool({
            s_: {k: torch.from_numpy(np.asarray(tree[f"pool_{kind}"][s_][k]))
                 .to(v.dtype) for k, v in leaves.items()}
            for s_, leaves in want_pool.items()})
        idx = {"seg0": {"page": torch.from_numpy(
                            tree["idx"]["page"].astype(np.int64)),
                        "off": torch.from_numpy(
                            tree["idx"]["off"].astype(np.int64)),
                        "valid": torch.from_numpy(tree["idx"]["valid"] > 0)}}
        with activation_shardings(plan.plan()):
            gather_fn(build_segments(cfg), True, cache, pool, g["si"],
                      g["t"], idx, {}, {})
        want = plan.cut_cache(port_cache(tree[f"gather_{kind}"]["cache_out"],
                                         cfg, 8, True))["seg0"]
        diff = max(float((cache["seg0"][k].float()
                          - want[k].float()).abs().max())
                   for k in ("k", "v", "sk_vals"))
        out[f"{kind}/diff"] = ctx.gather(torch.tensor(diff))
        out[f"{kind}/sorted_equal"] = ctx.gather(torch.tensor(
            torch.equal(cache["seg0"]["sk_rows"], want["sk_rows"])
            and torch.equal(cache["seg0"]["sorted_upto"],
                            want["sorted_upto"])))
    ctx.save("gather_2x2", **out)


@case
def serve_one_rank(ctx):
    """The serving mesh path on a one-rank (data 1, model 1) mesh equals
    the unsharded dispatches bit for bit (TINY f32, A^3 off and
    conservative): prefill logits, tokens and the cache."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    res = {}
    for mode in ("off", "conservative"):
        r = one_rank_serve(configs()["tiny"], mesh, mode)
        (l1, h1, c1), (l2, h2, c2) = r["single"], r["mesh"]
        res[f"{mode}/logits"] = np.array(torch.equal(l1, l2))
        res[f"{mode}/tokens"] = np.array(torch.equal(h1, h2))
        res[f"{mode}/cache"] = np.array(all(
            torch.equal(c1[s_][k], c2[s_][k]) for s_ in c1 for k in c1[s_]))
        res[f"{mode}/harvest"] = h2.numpy()
    ctx.save("serve_one_rank", **res)


@case
def compressed(ctx):
    """TINY on a (pod 2, data 2) mesh with grad_compression: one step
    from the JAX init -> loss, parameters, the error-feedback state, and
    each rank's bytes of that state against its shards."""
    import torch
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.train.step import make_train_step

    mesh = make_mesh((2, 2), ("pod", "data"), "cpu")
    cfg = configs()["tiny"]
    run = train_run(cfg, grad_compression=True)
    state = train_state_from_numpy(load_tree(ctx.dir / "init_tiny.npz"),
                                   run, "cpu", mesh)
    err_held = sum(e.to_local().untyped_storage().nbytes()
                   for e in state.err.values())
    err_want = sum(p.to_local().numel() * 4
                   for p in state.model.parameters())
    state, metrics = make_train_step(run, mesh)(
        state, make_lm_batch(0, BATCH, SEQ, cfg.vocab_size, 0))
    out = {f"p/{n}": full(p) for n, p in state.model.named_parameters()}
    out.update({f"err/{n}": full(e) for n, e in state.err.items()})
    ctx.save("compressed", loss=np.array(float(metrics["loss"])),
             err_held=ctx.gather(torch.tensor(err_held)),
             err_want=ctx.gather(torch.tensor(err_want)), **out)


@case
def recovery(ctx):
    """``train_with_recovery`` on a (2, 2) mesh, checkpoints every 2
    steps in a directory rank 0 makes, a crash at step 3 -> its losses
    and an uninterrupted ``train_loop``'s on the same mesh."""
    from repro_torch.config import CheckpointConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.loop import train_loop, train_with_recovery

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    run = train_run(configs()["tiny"]).replace(
        checkpoint=CheckpointConfig(save_every=2))
    rec = train_with_recovery(run, mesh=mesh, device="cpu", num_steps=4,
                              fail_at_step=3)
    base = train_loop(run, mesh=mesh, device="cpu", num_steps=4)
    ctx.save("recovery", rec=np.array(rec["losses"]),
             restarts=np.array(rec["restarts"]),
             base=np.array(base["losses"]))


@case
def elastic(ctx):
    """Save from a (4, 2) mesh, restore onto (2, 4): a matrix laid out
    ("data", "model") restored as ("model", "data"), in place and through
    ``shardings=`` on a meta target; and TINY's whole train state after
    a step, into an empty state on the other mesh."""
    import torch
    from repro_torch.config import CheckpointConfig
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.sharding.rules import distribute, shardings_for
    from repro_torch.train.checkpoint import CheckpointManager, _flatten
    from repro_torch.train.step import empty_train_state, make_train_step

    m1 = make_mesh((4, 2), ("data", "model"), "cpu")
    m2 = make_mesh((2, 4), ("data", "model"), "cpu")
    w = torch.arange(64.0).reshape(8, 8)
    mgr = CheckpointManager(CheckpointConfig(async_save=False), mesh=m1)
    mgr.save(1, {"w": distribute(w, shardings_for(("data", "model"), m1))})
    tgt = {"w": distribute(torch.zeros(8, 8),
                           shardings_for(("model", "data"), m2))}
    restored, _ = mgr.restore(tgt)
    placed, _ = mgr.restore({"w": torch.empty(8, 8, device="meta")},
                            shardings={"w": shardings_for(("model", "data"),
                                                          m2)})
    local_ok = torch.equal(restored["w"].to_local(), placed["w"].to_local())

    cfg = configs()["tiny"]
    run = train_run(cfg)
    state = train_state_from_numpy(load_tree(ctx.dir / "init_tiny.npz"),
                                   run, "cpu", m1)
    state, _ = make_train_step(run, m1)(
        state, make_lm_batch(0, BATCH, SEQ, cfg.vocab_size, 0))
    mgr.save(2, state)
    back, _ = mgr.restore(empty_train_state(run, "cpu", m2))
    diff = max(float(np.abs(full(a) - full(b)).max()) for (_, a), (_, b)
               in zip(_flatten(state), _flatten(back)))
    moved = all(t.device_mesh == m2 for n, t in _flatten(back)
                if n != "opt::step")
    ctx.save("elastic", w=full(restored["w"]), placed=full(placed["w"]),
             local_ok=np.array(local_ok), state_diff=np.array(diff),
             moved=np.array(moved))


@case
def jax_ckpt(ctx):
    """A checkpoint the JAX package wrote (``jax_ckpt/``) restored onto a
    (2, 4) mesh through ``shardings=``."""
    import torch
    from repro_torch.config import CheckpointConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import shardings_for
    from repro_torch.train.checkpoint import CheckpointManager

    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    mgr = CheckpointManager(CheckpointConfig(
        directory=str(ctx.dir / "jax_ckpt"), async_save=False), mesh=mesh)
    target = {"w": torch.empty(8, 8, device="meta"),
              "sub": {"b": torch.empty(4, 8, dtype=torch.bfloat16,
                                       device="meta")}}
    shd = shardings_for({"w": ("data", "model"), "sub": {"b": ("model",
                                                                None)}},
                        mesh)
    got, extra = mgr.restore(target, shardings=shd)
    ctx.save("jax_ckpt", w=full(got["w"]), b=full(got["sub"]["b"]),
             b_dtype=np.array(str(got["sub"]["b"].dtype)),
             extra=np.array(json.dumps(extra)))


@case
def psum(ctx):
    """``psum_compressed`` over 4 pods on ``psum_in.npz``'s per-pod
    gradients, then again with the error state fed back; the int8
    payload from the port's scale."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.compression import compress_int8, \
        psum_compressed

    mesh = make_mesh((ctx.world,), ("pod",), "cpu")
    grp = mesh.get_group("pod")
    with np.load(ctx.dir / "psum_in.npz") as f:
        g = torch.from_numpy(f["g"][ctx.rank])
    mean1, err1 = psum_compressed({"g": g}, grp)
    mean2, err2 = psum_compressed({"g": g}, grp, err1)
    amax = g.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=grp)
    q = compress_int8(g, torch.clamp(amax * (1.0 / 127.0), min=1e-12))
    ctx.save("psum", mean1=ctx.gather(mean1["g"]), err1=ctx.gather(err1["g"]),
             mean2=ctx.gather(mean2["g"]), err2=ctx.gather(err2["g"]),
             q=ctx.gather(q))


@case
def psum_feedback(ctx):
    """The reference's two error-feedback properties on the port: 8
    reductions of one gradient (bias) and 32 of ``5 x`` another (drain)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.compression import psum_compressed

    mesh = make_mesh((ctx.world,), ("pod",), "cpu")
    grp = mesh.get_group("pod")
    with np.load(ctx.dir / "psum_in.npz") as f:
        g = torch.from_numpy(f["g"][ctx.rank])
        g5 = torch.from_numpy(f["g5"][ctx.rank])
    once, _ = psum_compressed({"g": g}, grp)
    err, means = None, []
    for _ in range(8):
        mean, err = psum_compressed({"g": g}, grp, err)
        means.append(mean["g"])
    err, acc, e_norm = None, torch.zeros_like(g5), []
    for _ in range(32):
        mean, err = psum_compressed({"g": g5}, grp, err)
        acc += mean["g"]
        e_norm.append(float(np.abs(ctx.gather(err["g"])).max()))
    ctx.save("psum_feedback", once=once["g"].numpy(),
             avg8=torch.stack(means).mean(0).numpy(), acc32=acc.numpy(),
             e_norm=np.array(e_norm))


@case
def pipeline(ctx):
    """``pipeline_forward`` over 4 stages on ``pipe_in.npz``'s weights
    and microbatches."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.pipeline import pipeline_forward

    mesh = make_mesh((ctx.world,), ("pipe",), "cpu")
    with np.load(ctx.dir / "pipe_in.npz") as f:
        w, x = torch.from_numpy(f["w"]), torch.from_numpy(f["x"])
    out = pipeline_forward(lambda p, h: torch.tanh(h @ p["w"]), {"w": w}, x,
                           mesh, axis="pipe")
    ctx.save("pipeline", out=ctx.gather(out))


@case
def mesh_checks(ctx):
    """``make_mesh`` and ``make_production_mesh`` refuse a shape whose
    product is not the world size."""
    import torch
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    refused = []
    for fn in (lambda: make_mesh((3,), ("data",), "cpu"),
               lambda: make_production_mesh(device="cpu"),
               lambda: make_production_mesh(multi_pod=True, device="cpu")):
        try:
            fn()
            refused.append(False)
        except ValueError:
            refused.append(True)
    mesh = make_mesh((2, ctx.world // 2), ("data", "model"), "cpu")
    ctx.save("mesh_checks", refused=np.array(refused),
             coords=ctx.gather(torch.tensor(mesh.get_coordinate())))


def main(arg: str) -> int:
    a = json.loads(arg)
    sys.path[:0] = [str(SRC)]
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed
    init_distributed("cpu", rank=a["rank"], world_size=a["world"],
                     init_method=f"file://{a['store']}")
    ctx = Ctx(a["rank"], a["world"], a["directory"])
    try:
        for name in a["cases"]:
            try:
                CASES[name](ctx)
            except Exception:
                (ctx.dir / f"{name}.err.{ctx.rank}").write_text(
                    traceback.format_exc())
                os._exit(1)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
