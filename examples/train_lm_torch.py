"""End-to-end training driver of the PyTorch port: ~100M-param LM for a
few hundred steps through the full training stack — config registry,
synthetic data pipeline with host prefetch, AdamW + cosine schedule,
per-layer remat, async checkpointing, watchdog, and crash recovery. The
port's counterpart of ``examples/train_lm.py``, with the same arguments
and printout; on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--arch internlm2-1.8b]
"""
import argparse
import dataclasses
import tempfile
import time

from repro_torch import resolve_device
from repro_torch.config import (
    CheckpointConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    ShapeKind,
    ShardingConfig,
    get_arch,
)
from repro_torch.train.loop import train_with_recovery


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)

    base = get_arch(args.arch)
    # ~100M-param variant of the assigned family
    cfg = dataclasses.replace(
        base, num_layers=16, d_model=512, num_heads=8, num_kv_heads=4,
        head_dim=64, d_ff=1536, vocab_size=8192, dtype="float32",
        moe=None, block_pattern=base.block_pattern)
    print(f"model: {cfg.name} variant, {cfg.param_count()/1e6:.1f}M params")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_lm_")
    run = RunConfig(
        model=cfg,
        shape=ShapeConfig("train", ShapeKind.TRAIN, args.seq, args.batch),
        optimizer=OptimizerConfig(lr=3e-4, total_steps=args.steps,
                                  warmup_steps=args.steps // 10),
        sharding=ShardingConfig(remat="none"),
        checkpoint=CheckpointConfig(directory=ckpt_dir, save_every=50),
    )

    t0 = time.time()
    out = train_with_recovery(run, device=device, num_steps=args.steps)
    dt = time.time() - t0
    losses = out["losses"]
    toks = args.seq * args.batch * len(losses)
    print(f"steps={len(losses)} loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"| {toks/dt:,.0f} tok/s | checkpoints in {ckpt_dir}")
    assert losses[-1] < losses[0], "training did not reduce loss"


if __name__ == "__main__":
    main()
