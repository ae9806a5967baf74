"""Training launcher of the port: the reference's ``repro.launch.train``
flags, through the full training stack (config registry,
data pipeline, checkpointing, watchdog, restart supervisor).

  python -m repro_torch.launch.train --arch internlm2-1.8b --smoke \\
      --steps 50 --batch 8 --seq 256
  python -m repro_torch.launch.train --arch internlm2-1.8b --smoke \\
      --device cpu --steps 4 --batch 2 --seq 32

Runs on the card unless ``--device cpu`` is given. ``--distributed``
joins the process group torchrun describes in the environment (NCCL on
the card, gloo with ``--device cpu``), the counterpart of the
reference's ``jax.distributed.initialize()``; like the reference it
passes no mesh, so every rank trains its own replica:

  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch internlm2-1.8b --smoke --distributed

Prints the reference's summary line.
"""
from __future__ import annotations

import argparse
import time

import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.config import (
    CheckpointConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    ShapeKind,
    ShardingConfig,
    get_arch,
    list_archs,
    smoke_variant,
)
from repro_torch.launch.mesh import init_distributed
from repro_torch.train.loop import train_with_recovery


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a fresh temporary directory per run")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process: join torchrun's process group")
    args = ap.parse_args(argv)

    if args.distributed:
        device = init_distributed(args.device)
    else:
        device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    shape = ShapeConfig("cli", ShapeKind.TRAIN, args.seq, args.batch)
    run = RunConfig(
        model=cfg, shape=shape,
        optimizer=OptimizerConfig(lr=args.lr, total_steps=args.steps,
                                  warmup_steps=max(1, args.steps // 10)),
        sharding=ShardingConfig(remat=args.remat),
        checkpoint=CheckpointConfig(directory=args.ckpt_dir,
                                    save_every=args.save_every),
    )

    t0 = time.time()
    try:
        out = train_with_recovery(run, device=device, num_steps=args.steps)
    finally:
        if args.distributed:
            dist.destroy_process_group()
    dt = time.time() - t0
    losses = out["losses"]
    toks = shape.tokens_per_step * len(losses)
    print(f"arch={cfg.name} steps={len(losses)} "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({toks / dt:.0f} tok/s, {dt:.1f}s, restarts={out['restarts']})")


if __name__ == "__main__":
    main()
