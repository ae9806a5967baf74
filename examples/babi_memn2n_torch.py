"""End-to-End Memory Network on synthetic bAbI, on the PyTorch port (the
paper's SSVI evaluation, self-contained): train with exact attention and
the port's AdamW, then evaluate with the A^3 approximation at several
(M, T) settings. The port's counterpart of ``examples/babi_memn2n.py``,
with the same arguments and printout; on the card unless ``--device cpu``
is given.

    PYTHONPATH=src python examples/babi_memn2n_torch.py [--steps 300]
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.config import A3Config, A3Mode, OptimizerConfig
from repro_torch.data.babi import generate_babi, make_task
from repro_torch.models import memn2n
from repro_torch.optim.adamw import adamw_init, adamw_update


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--statements", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)

    task = make_task(num_actors=64, num_places=16, max_sentences=64)
    cfg = memn2n.MemN2NConfig(vocab_size=task.vocab_size, d_embed=64,
                              num_hops=3, max_sentences=task.max_sentences,
                              max_words=task.max_words)
    params = memn2n.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    for p in params.values():
        p.requires_grad_(True)
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=10, min_lr_ratio=0.3,
                           total_steps=args.steps, weight_decay=0.0)
    opt = adamw_init(params, ocfg)

    for i in range(args.steps):
        b = generate_babi(task, 64, args.statements, seed=1000 + i)
        loss = memn2n.loss_fn(params, b, cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
        _, opt, _ = adamw_update(dict(zip(params, grads)), opt, params, ocfg)
        if i % 100 == 0:
            print(f"step {i:4d} loss {float(loss):.4f}")

    params = {k: v.detach() for k, v in params.items()}
    test = generate_babi(task, 512, args.statements, seed=7)
    base = float(memn2n.accuracy(params, test, cfg))
    print(f"\nexact attention accuracy: {base:.3f}")
    for label, a3 in [
            ("conservative M=n/2 T=5%", A3Config.conservative()),
            ("aggressive  M=n/8 T=10%", A3Config.aggressive()),
            ("custom      M=n/4 T=8%", A3Config(mode=A3Mode.CUSTOM,
                                                m_fraction=0.25,
                                                threshold_pct=8.0))]:
        acc = float(memn2n.accuracy(params, test, cfg, a3))
        print(f"A3 {label}: accuracy {acc:.3f} (delta "
              f"{100 * (acc - base):+.1f}%)")


if __name__ == "__main__":
    main()
