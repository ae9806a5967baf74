"""Dry run: one training step or one serving dispatch of every (arch x
shape) cell traced on the production meshes, per rank, without memory
(PyTorch port of ``repro.launch.dryrun``).

The world is the fake process group (``torch.testing``'s ``FakeStore``,
backend ``"fake"``): 256 ranks for (16, 16), 512 for (2, 16, 16). This
process is rank 0. The parameters are built under ``FakeTensorMode`` and
laid out by the sharding rules, and one step runs on them under
``launch.hlo_analysis.OpStream``: every op is dispatched with its shapes,
no kernel is launched and no collective moves data. The tensors are
fake ``cuda`` tensors by default, the card's route, so the custom kernel
ops (#1-#3, #7) are counted by their formulas; ``--device cpu`` traces
the plain route (the CPU tests). A mesh of any shape can be asked for
(``run_cell(mesh_shape=...)``), and the empty shape traces one device.

The cells, as the reference's: ``train_4k`` one ``make_train_step``
step; a prefill shape the whole-prompt ``decoder.prefill`` (or, with
``--prefill-chunk``, the ragged ``prefill_chunk`` dispatch, or with
``--gather-pages`` the prefix cache's warm-admission copy
``serve.prefix_cache.gather_fn`` against a pool of that many pages); a
decode shape one ragged ``decode_step`` (or, with ``--decode-block``,
``decode_block``'s blocked steps with in-dispatch greedy sampling and
A^3 re-sort), A^3 per ``--a3`` with ``--select-shards`` selection
blocks. Each serving dispatch runs this rank's share under the serving
plan (``sharding.plan``): its lanes, its ring rows, its share of every
split weight. The frontend archs refuse the chunked, blocked and gather
cells, as the reference does. The reference's ``--save-hlo`` has no
counterpart: the port compiles no HLO (its trace is the op stream).

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape decode_32k \\
      --both-meshes
  python -m repro_torch.launch.dryrun --arch all --shape decode_32k \\
      --one-device
  python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape \\
      decode_32k --a3 conservative --select-shards 16
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import dataclasses
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
    A3Config,
    A3Mode,
    BlockKind,
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
    """Model inputs for one step of the given shape kind (a decode step's
    ``pos`` is the per-lane vector of the ragged dispatch)."""
    from repro_torch.models.decoder import DTYPES
    b, s = shape.global_batch, shape.seq_len
    dt = DTYPES[cfg.dtype]
    if shape.kind == ShapeKind.TRAIN:
        if cfg.frontend:
            return {"embeds": TensorSpec((b, s, cfg.d_model), dt),
                    "labels": TensorSpec((b, s), torch.int32)}
        return {"tokens": TensorSpec((b, s), torch.int32),
                "labels": TensorSpec((b, s), torch.int32)}
    if shape.kind == ShapeKind.PREFILL:
        if cfg.frontend:
            return {"embeds": TensorSpec((b, s, cfg.d_model), dt)}
        return {"tokens": TensorSpec((b, s), torch.int32)}
    tok = ({"embed": TensorSpec((b, cfg.d_model), dt)} if cfg.frontend
           else {"token": TensorSpec((b,), torch.int32)})
    return {**tok, "pos": TensorSpec((b,), torch.int32)}


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


class _Serving(NamedTuple):
    model: Any
    mode: Any             # the parameters' FakeTensorMode
    plan: Any             # sharding.plan.MeshPlan, None on one device
    device: torch.device


def _serving(cfg: ModelConfig, shape: ShapeConfig, mesh, sharding_cfg,
             device, dispatch: str, select_shards: int = 0) -> _Serving:
    """Fake parameters laid out by the rules on ``mesh`` and the serving
    plan of ``dispatch`` at ``shape``."""
    from repro_torch.models.decoder import init_params_shape
    from repro_torch.sharding.plan import MeshPlan
    from repro_torch.sharding.rules import distribute_parameters
    dev = resolve_device(device)
    model = init_params_shape(cfg, dev)
    mode = model.embed.fake_mode
    plan = None
    if mesh is not None:
        with mode:
            distribute_parameters(model, sharding_cfg, mesh)
        # outside the fake mode: a flattened mesh group holds real tensors
        plan = MeshPlan(cfg, shape, mesh, sharding_cfg, dispatch=dispatch,
                        select_shards=select_shards)
    return _Serving(model, mode, plan, dev)


def _cache(sv: _Serving, cfg: ModelConfig, shape: ShapeConfig, a3: bool):
    from repro_torch.models import decoder
    b, s = shape.global_batch, shape.seq_len
    with sv.mode:
        if sv.plan is None:
            return decoder.init_cache(cfg, b, s, a3=a3, device=sv.device)
        return sv.plan.init_cache(b, s, a3=a3, device=sv.device)


def _inputs(sv: _Serving, specs: Dict[str, TensorSpec]):
    with sv.mode:
        return {k: torch.zeros(sp.shape, dtype=sp.dtype, device=sv.device)
                for k, sp in specs.items()}


def _trace_serving(sv: _Serving, fn, resident) -> Trace:
    """``fn()`` under the plan's dispatch context, traced -> its Trace."""
    import contextlib
    resident = [*sv.model.parameters(), *resident]
    ctx = sv.plan.dispatch_context(sv.model) if sv.plan is not None \
        else contextlib.nullcontext()

    def run():
        with ctx, torch.no_grad():
            return fn()

    t0 = time.time()
    with sv.mode:
        stats, groups, _ = analyze_step(run, resident)
    return Trace(stats, groups, time.time() - t0)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def lower_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  sharding_cfg: ShardingConfig, device="cuda") -> Trace:
    """The whole-prompt ``decoder.prefill`` dispatch (tokens, or the
    frontend archs' embeddings) traced by rank 0."""
    from repro_torch.models import decoder
    sv = _serving(cfg, shape, mesh, sharding_cfg, device, "prefill")
    x = _inputs(sv, input_specs(cfg, shape))
    return _trace_serving(sv, lambda: decoder.prefill(
        sv.model, cfg, x.get("tokens"), inputs_embeds=x.get("embeds"),
        max_len=shape.seq_len), x.values())


def lower_decode(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 sharding_cfg: ShardingConfig, a3: A3Config = A3Config(),
                 device="cuda") -> Trace:
    """The ragged ``decode_step`` dispatch: per-lane pos [B] against a
    cache of ``shape.seq_len`` rows (A^3 sorted keys with ``a3`` on)."""
    from repro_torch.models import decoder
    use_a3 = a3.mode != A3Mode.OFF
    sv = _serving(cfg, shape, mesh, sharding_cfg, device, "decode",
                  a3.select_shards if use_a3 else 0)
    cache = _cache(sv, cfg, shape, use_a3)
    x = _inputs(sv, input_specs(cfg, shape))
    return _trace_serving(sv, lambda: decoder.decode_step(
        sv.model, cfg, cache, x.get("token"), x["pos"],
        input_embed=x.get("embed"), a3=a3), [*_leaves(cache), *x.values()])


def lower_decode_block(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       sharding_cfg: ShardingConfig, *, steps: int = 8,
                       a3: A3Config = A3Config(), resort_every: int = 64,
                       device="cuda") -> Trace:
    """The multi-step ``decode_block`` dispatch: ``steps`` decode steps
    with in-dispatch greedy sampling and (A^3) the re-sort, planned at
    every step (the reference's graph holds the sort under a cond)."""
    from repro_torch.models import decoder
    if cfg.frontend:
        raise ValueError(f"{cfg.name}: blocked decode feeds sampled token "
                         "ids back in-graph; frontend archs decode "
                         "single-step from precomputed embeddings")
    use_a3 = a3.mode != A3Mode.OFF
    sv = _serving(cfg, shape, mesh, sharding_cfg, device, "decode",
                  a3.select_shards if use_a3 else 0)
    cache = _cache(sv, cfg, shape, use_a3)
    with sv.mode:
        vec = [torch.zeros((shape.global_batch,), dtype=torch.int32,
                           device=sv.device) for _ in range(3)]
    return _trace_serving(sv, lambda: decoder.decode_block(
        sv.model, cfg, cache, *vec, steps=steps, a3=a3,
        resort_every=resort_every if use_a3 else 0,
        resort_plan=[True] * steps), [*_leaves(cache), *vec])


def lower_prefill_chunk(cfg: ModelConfig, shape: ShapeConfig, mesh,
                        sharding_cfg: ShardingConfig, *, chunk: int = 256,
                        a3: A3Config = A3Config(), device="cuda") -> Trace:
    """The ragged admission-prefill dispatch: a [B, chunk] token block
    extends the caches from per-lane (pos, length)."""
    from repro_torch.models import decoder
    if cfg.frontend:
        raise ValueError(f"{cfg.name}: chunked admission prefill takes "
                         "token prompts; frontend archs admit whole-prompt")
    use_a3 = a3.mode != A3Mode.OFF
    sv = _serving(cfg, shape, mesh, sharding_cfg, device, "chunk",
                  a3.select_shards if use_a3 else 0)
    cache = _cache(sv, cfg, shape, use_a3)
    b = shape.global_batch
    with sv.mode:
        tok = torch.zeros((b, chunk), dtype=torch.int32, device=sv.device)
        vec = [torch.zeros((b,), dtype=torch.int32, device=sv.device)
               for _ in range(2)]
    return _trace_serving(sv, lambda: decoder.prefill_chunk(
        sv.model, cfg, cache, tok, *vec, a3=use_a3, sort_any=use_a3),
        [*_leaves(cache), tok, *vec])


def lower_gather_pages(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       sharding_cfg: ShardingConfig, *, page_size: int = 64,
                       pages: int = 4096, a3: A3Config = A3Config(),
                       kv_quant: str = "none", device="cuda") -> Trace:
    """The prefix cache's warm-admission copy (``gather_fn``, the engine's
    own) of one slot, on the no-donor path (A^3 sorted columns re-sorted
    from the gathered ring), against a pool laid out as the rings: pages
    over the data axes, page rows over ``model``."""
    from repro_torch.models import decoder
    from repro_torch.models.mixer import build_segments, cache_len_for
    from repro_torch.serve.prefix_cache import gather_fn
    if cfg.frontend:
        raise ValueError(f"{cfg.name}: the prefix cache reuses token "
                         "prompts; frontend archs admit whole-prompt")
    use_a3 = a3.mode != A3Mode.OFF
    sv = _serving(cfg, shape, mesh, sharding_cfg, device, "decode",
                  a3.select_shards if use_a3 else 0)
    cache = _cache(sv, cfg, shape, use_a3)
    segs = build_segments(cfg)
    with sv.mode:
        if sv.plan is None:
            pool = decoder.init_page_pool(cfg, pages, page_size, a3=use_a3,
                                          kv_quant=kv_quant,
                                          device=sv.device)
        else:
            sv.plan.with_pool(pages, page_size)
            pool = sv.plan.init_pool(pages, page_size, a3=use_a3,
                                     kv_quant=kv_quant, device=sv.device)
        idx, snaps = {}, {}
        for i, seg in enumerate(segs):
            name = f"seg{i}"
            if seg.kind == BlockKind.ATTENTION:
                w = cache_len_for(seg, shape.seq_len)
                idx[name] = {"page": torch.zeros((w,), dtype=torch.int32,
                                                 device=sv.device),
                             "off": torch.zeros((w,), dtype=torch.int32,
                                                device=sv.device),
                             "valid": torch.zeros((w,), dtype=torch.bool,
                                                  device=sv.device)}
            else:
                snaps[name] = {k: torch.zeros((v.shape[0], 1) + v.shape[2:],
                                              dtype=v.dtype,
                                              device=sv.device)
                               for k, v in cache[name].items()}
    return _trace_serving(sv, lambda: gather_fn(
        segs, use_a3, cache, pool, 0, 0, idx, snaps, {}),
        [*_leaves(cache), *_leaves(pool), *_leaves(idx), *_leaves(snaps)])


def run_cell(arch: Union[str, ModelConfig],
             shape_name: Union[str, ShapeConfig], *,
             multi_pod: bool = False,
             mesh_shape: Optional[Sequence[int]] = None,
             mesh_axes: Optional[Sequence[str]] = None,
             sharding_cfg: Optional[ShardingConfig] = None,
             a3: A3Config = A3Config(),
             prefill_chunk: Optional[int] = None,
             decode_block: Optional[int] = None,
             gather_pages: Optional[int] = None,
             page_size: int = 64,
             kv_quant: str = "none",
             device="cuda", verbose: bool = True) -> Dict[str, Any]:
    """Trace one cell -> its record (the reference's keys). ``arch`` and
    ``shape_name`` may be configs; ``mesh_shape`` (with ``mesh_axes``,
    default ("data", "model")) replaces the production mesh, and ``()``
    traces one device. A prefill shape traces ``prefill`` (or, with
    ``prefill_chunk`` / ``gather_pages``, the chunked dispatch / the
    warm-admission copy), a decode shape ``decode_step`` (or, with
    ``decode_block`` > 1, the blocked dispatch), as the reference's
    ``run_cell``."""
    from repro_torch.launch.mesh import make_mesh
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPE_SUITE[shape_name] if isinstance(shape_name, str) \
        else shape_name
    if mesh_shape is None:
        mesh_shape, mesh_axes = production_mesh_shape(multi_pod)
    mesh_shape = tuple(int(n) for n in mesh_shape)
    mesh_axes = tuple(mesh_axes or ("pod", "data", "model")[-len(mesh_shape):]
                      if mesh_shape else ())
    mesh_name = "x".join(map(str, mesh_shape)) or "1"
    chips = math.prod(mesh_shape)
    if sharding_cfg is None:
        sharding_cfg = ShardingConfig(
            remat="full" if shape.kind == ShapeKind.TRAIN else "none")
    mesh = None
    if mesh_shape:
        fake_world(chips)
        mesh = make_mesh(mesh_shape, mesh_axes, resolve_device(device).type)
    args = (cfg, shape, mesh, sharding_cfg)
    if shape.kind == ShapeKind.TRAIN:
        trace = lower_train(*args, device)
    elif shape.kind == ShapeKind.PREFILL:
        # chunked admission covers every token arch; the frontend archs
        # admit whole-prompt from precomputed embeddings
        if prefill_chunk and cfg.frontend and verbose:
            print(f"  {cfg.name}: chunked admission takes token prompts; "
                  f"tracing whole-prompt (embeds) prefill")
        if gather_pages and not cfg.frontend:
            trace = lower_gather_pages(*args, page_size=page_size,
                                       pages=gather_pages, a3=a3,
                                       kv_quant=kv_quant, device=device)
        elif prefill_chunk and not cfg.frontend:
            trace = lower_prefill_chunk(*args, chunk=prefill_chunk, a3=a3,
                                        device=device)
        else:
            trace = lower_prefill(*args, device=device)
    else:
        blockable = bool(decode_block) and decode_block > 1
        if blockable and cfg.frontend and verbose:
            print(f"  {cfg.name}: blocked decode unsupported (frontend "
                  f"embeds); tracing single-step decode")
        if blockable and not cfg.frontend:
            trace = lower_decode_block(*args, steps=decode_block, a3=a3,
                                       device=device)
        else:
            trace = lower_decode(*args, a3=a3, device=device)
    st = trace.stats
    r = roofline.analyze(cfg.name, shape.name, mesh_name, chips, st,
                         trace.group_ranks, model_flops_for(cfg, shape))
    rec = {
        **r.to_dict(),
        "a3_mode": a3.mode.value,
        "memory": {
            "argument_bytes": st.resident_bytes,
            "output_bytes": 0,
            "temp_bytes": st.peak_bytes - st.resident_bytes,
            "alias_bytes": 0,
            "peak_device_bytes": st.peak_bytes,
        },
        "kernel_flops": st.kernel_flops,
        "collective_bytes_by_kind": st.collective_bytes,
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
    ap.add_argument("--one-device", action="store_true",
                    help="trace each cell on one device, no mesh: the "
                         "count a mesh's per-rank FLOPs x ranks is held "
                         "against (what stays replicated over the ranks)")
    ap.add_argument("--a3", default="off",
                    choices=["off", "conservative", "aggressive"])
    ap.add_argument("--select-shards", type=int, default=16,
                    help="A3 distributed-selection blocks (a multiple of "
                         "the ranks the KV ring splits over: 16 = model "
                         "axis, 256 = the (data, model) grid)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="trace prefill cells as the chunked ragged "
                         "admission-prefill dispatch with this chunk size "
                         "(0 = whole-prompt prefill)")
    ap.add_argument("--decode-block", type=int, default=0,
                    help="trace decode cells as the blocked decode "
                         "dispatch with this many steps per block "
                         "(in-dispatch sampling + A^3 re-sort; 0/1 = "
                         "single-step decode)")
    ap.add_argument("--gather-pages", type=int, default=0,
                    help="trace prefill cells as the prefix-cache "
                         "warm-admission copy against a pool of this many "
                         "pages (0 = normal prefill cell)")
    ap.add_argument("--page-size", type=int, default=64,
                    help="prefix-cache page size for --gather-pages")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="pool precision for --gather-pages (int8: "
                         "per-page float32 scales, dequantized in the copy)")
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

    a3 = {"off": A3Config(),
          "conservative": A3Config.conservative(),
          "aggressive": A3Config.aggressive()}[args.a3]
    if a3.mode != A3Mode.OFF:
        # distributed selection aligned with the sharded KV ring
        a3 = dataclasses.replace(a3, select_shards=args.select_shards)

    archs = list_archs() if args.arch == "all" else [args.arch]
    results = []
    meshes = [None] if args.one_device else \
        [False, True] if args.both_meshes else [args.multipod]
    for arch in archs:
        shapes = (applicable_shapes(arch) if args.shape == "all"
                  else [args.shape])
        for shape_name in shapes:
            if shape_name not in applicable_shapes(arch):
                print(f"SKIP {arch} x {shape_name} (inapplicable)")
                continue
            for mp in meshes:
                mesh_name = "1" if mp is None else \
                    "2x16x16" if mp else "16x16"
                try:
                    results.append(run_cell(
                        arch, shape_name, multi_pod=bool(mp),
                        mesh_shape=() if mp is None else None, a3=a3,
                        prefill_chunk=args.prefill_chunk or None,
                        decode_block=args.decode_block or None,
                        gather_pages=args.gather_pages or None,
                        page_size=args.page_size, kv_quant=args.kv_quant,
                        device=args.device))
                except Exception as e:   # noqa: BLE001
                    print(f"FAIL {arch} x {shape_name} ({mesh_name}): "
                          f"{e!r}")
                    results.append({"arch": arch, "shape": shape_name,
                                    "mesh": mesh_name, "error": repr(e)})
                sys.stdout.flush()
                gc.collect()

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {len(results)} records to {args.out}")
    n_fail = sum(1 for r in results if "error" in r)
    print(f"dry-run: {len(results) - n_fail}/{len(results)} cells OK")
    if n_fail:
        sys.exit(1)


if __name__ == "__main__":
    main()
