"""Rank-side code of the port's gloo-rank tests (``test_torch_sharding.py``,
``test_torch_mesh_train.py``); no tests of its own.

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
    return {"tiny": tiny, "moe": moe, "tiny-xl": tiny_xl}


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
