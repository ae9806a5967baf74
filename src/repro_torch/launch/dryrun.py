"""Training dry run: one step of every (arch x train shape) cell traced
on the production meshes, per rank, without memory (PyTorch port of the
training half of ``repro.launch.dryrun``).

The world is the fake process group (``torch.testing``'s ``FakeStore``,
backend ``"fake"``): 256 ranks for (16, 16), 512 for (2, 16, 16). This
process is rank 0. The train state is built under ``FakeTensorMode`` and
laid out by the sharding rules, and one ``make_train_step`` step runs on
it under ``launch.hlo_analysis.OpStream``: every op is dispatched with
its shapes, no kernel is launched and no collective moves data. The
tensors are fake ``cuda`` tensors by default, the card's route, so the
custom kernel ops (#7) are counted by their formulas; ``--device cpu``
traces the plain route (the CPU tests). A mesh of any shape can be
asked for (``run_cell(mesh_shape=...)``), and the empty shape traces
the single-device step.

The serving cells (prefill, decode) are slice 17: they need the serving
dispatches on a mesh, with the KV ring split over the model axis.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape train_4k --both-meshes
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.config import (
    SHAPE_SUITE,
    ModelConfig,
    RunConfig,
    ShapeConfig,
    ShapeKind,
    ShardingConfig,
    applicable_shapes,
    get_arch,
    list_archs,
)
from repro_torch.launch import roofline
from repro_torch.launch.hlo_analysis import HloStats, analyze_step

SERVING = ("serving cells (prefill, decode) are not traced yet: they need "
           "the serving dispatches on a mesh, with the KV ring split over "
           "the model axis (slice 17)")


class TensorSpec(NamedTuple):
    """The shape and dtype of a model input (``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


class Trace(NamedTuple):
    """One rank's traced step: its stats, the ranks of every group a
    collective ran on, the seconds the trace took."""
    stats: HloStats
    group_ranks: Dict[str, Tuple[int, ...]]
    seconds: float


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """Model inputs of one training step of ``shape``."""
    if shape.kind != ShapeKind.TRAIN:
        raise NotImplementedError(f"{shape.name}: {SERVING}")
    from repro_torch.models.decoder import DTYPES
    b, s = shape.global_batch, shape.seq_len
    if cfg.frontend:
        return {"embeds": TensorSpec((b, s, cfg.d_model), DTYPES[cfg.dtype]),
                "labels": TensorSpec((b, s), torch.int32)}
    return {"tokens": TensorSpec((b, s), torch.int32),
            "labels": TensorSpec((b, s), torch.int32)}


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == ShapeKind.TRAIN:
        return 6.0 * n_active * shape.tokens_per_step
    return 2.0 * n_active * shape.tokens_per_step


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

def fake_world(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks, this
    process rank 0 (an earlier fake group of another size is replaced; a
    real one raises)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs its own process: a real "
                               "process group is initialized")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh_shape(multi_pod: bool) -> Tuple[Tuple[int, ...],
                                                    Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


# ---------------------------------------------------------------------------
# the trace of one step
# ---------------------------------------------------------------------------

def lower_train(cfg: ModelConfig, shape: ShapeConfig, mesh,
                sharding_cfg: ShardingConfig, device="cuda") -> Trace:
    """One ``make_train_step`` step of ``cfg`` on ``mesh`` (None: one
    device) traced by rank 0 under ``FakeTensorMode`` -> its
    :class:`Trace`."""
    from repro_torch.train.step import init_train_state_shape, \
        make_train_step
    run = RunConfig(model=cfg, shape=shape, sharding=sharding_cfg)
    dev = resolve_device(device)
    state = init_train_state_shape(run, dev, mesh)
    embed = state.model.embed
    mode = getattr(embed, "_local_tensor", embed).fake_mode
    with mode:
        batch = {k: torch.zeros(sp.shape, dtype=sp.dtype, device=dev)
                 for k, sp in input_specs(cfg, shape).items()}
    step = make_train_step(run, mesh)
    resident = [*state.model.parameters(), *state.opt.m.values(),
                *state.opt.v.values(), *(state.err or {}).values(),
                *batch.values()]
    t0 = time.time()
    with mode:
        stats, groups, _ = analyze_step(lambda: step(state, batch), resident)
    return Trace(stats, groups, time.time() - t0)


def run_cell(arch: Union[str, ModelConfig],
             shape_name: Union[str, ShapeConfig], *,
             multi_pod: bool = False,
             mesh_shape: Optional[Sequence[int]] = None,
             mesh_axes: Optional[Sequence[str]] = None,
             sharding_cfg: Optional[ShardingConfig] = None,
             device="cuda", verbose: bool = True) -> Dict[str, Any]:
    """Trace one cell -> its record (the reference's keys). ``arch`` and
    ``shape_name`` may be configs; ``mesh_shape`` (with ``mesh_axes``,
    default ("data", "model")) replaces the production mesh, and ``()``
    traces the single-device step."""
    from repro_torch.launch.mesh import make_mesh
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPE_SUITE[shape_name] if isinstance(shape_name, str) \
        else shape_name
    if shape.kind != ShapeKind.TRAIN:
        raise NotImplementedError(f"{cfg.name} x {shape.name}: {SERVING}")
    if mesh_shape is None:
        mesh_shape, mesh_axes = production_mesh_shape(multi_pod)
    mesh_shape = tuple(int(n) for n in mesh_shape)
    mesh_axes = tuple(mesh_axes or ("pod", "data", "model")[-len(mesh_shape):]
                      if mesh_shape else ())
    mesh_name = "x".join(map(str, mesh_shape)) or "1"
    chips = math.prod(mesh_shape)
    if sharding_cfg is None:
        sharding_cfg = ShardingConfig(remat="full")
    mesh = None
    if mesh_shape:
        fake_world(chips)
        mesh = make_mesh(mesh_shape, mesh_axes, resolve_device(device).type)
    trace = lower_train(cfg, shape, mesh, sharding_cfg, device)
    st = trace.stats
    r = roofline.analyze(cfg.name, shape.name, mesh_name, chips, st,
                         trace.group_ranks, model_flops_for(cfg, shape))
    rec = {
        **r.to_dict(),
        "a3_mode": "off",
        "memory": {
            "argument_bytes": st.resident_bytes,
            "output_bytes": 0,
            "temp_bytes": st.peak_bytes - st.resident_bytes,
            "alias_bytes": 0,
            "peak_device_bytes": st.peak_bytes,
        },
        "kernel_flops": st.kernel_flops,
        "ops": st.ops,
        "lower_s": trace.seconds,
        "compile_s": 0.0,
    }
    if verbose:
        print(f"[{mesh_name}] {cfg.name} x {shape.name}: "
              f"compute={r.compute_s*1e3:.2f}ms memory={r.memory_s*1e3:.2f}ms "
              f"collective={r.collective_s*1e3:.2f}ms "
              f"bottleneck={r.bottleneck} "
              f"peak_dev={st.peak_bytes/2**30:.2f}GiB "
              f"(trace {trace.seconds:.0f}s, {st.ops} ops)")
        sys.stdout.flush()
    return rec


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (the card's "
                         "route, default) or cpu (the plain route)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a in list_archs():
            print(a, "->", ", ".join(applicable_shapes(a)))
        return

    archs = list_archs() if args.arch == "all" else [args.arch]
    results = []
    meshes = [False, True] if args.both_meshes else [args.multipod]
    for arch in archs:
        shapes = (applicable_shapes(arch) if args.shape == "all"
                  else [args.shape])
        for shape_name in shapes:
            if shape_name not in applicable_shapes(arch):
                print(f"SKIP {arch} x {shape_name} (inapplicable)")
                continue
            if SHAPE_SUITE[shape_name].kind != ShapeKind.TRAIN:
                print(f"SKIP {arch} x {shape_name}: {SERVING}")
                continue
            for mp in meshes:
                results.append(run_cell(arch, shape_name, multi_pod=mp,
                                        device=args.device))
                gc.collect()

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {len(results)} records to {args.out}")
    print(f"dry-run: {len(results)} cells traced")


if __name__ == "__main__":
    main()
