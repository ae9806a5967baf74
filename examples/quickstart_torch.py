"""Quickstart of the PyTorch port: the paper's attention pipeline in 60
lines. The port's counterpart of ``examples/quickstart.py``, with its
printout; on the card unless ``--device cpu`` is given.

Builds a (key, value) memory, preprocesses it at "comprehension time"
(column sort, paper SSIV-C), then answers queries with exact attention,
conservative A^3, and aggressive A^3, printing the candidate / kept
counts and the output error — the accuracy/efficiency trade-off knob the
paper exposes via (M, T).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import A3Config
from repro_torch.core.a3_attention import a3_attention_batch, preprocess

N, D, Q = 320, 64, 8                       # paper's BERT-scale memory


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                * 0.5).to(device)
    keys, values, queries = normal(N, D), normal(N, D), normal(Q, D)

    # --- comprehension time (off the critical path) ----------------------
    state = preprocess(keys, values)

    # --- query time --------------------------------------------------------
    exact, _ = a3_attention_batch(state, queries, A3Config())

    for name, cfg in [("conservative (M=n/2, T=5%)", A3Config.conservative()),
                      ("aggressive  (M=n/8, T=10%)", A3Config.aggressive())]:
        out, aux = a3_attention_batch(state, queries, cfg)
        cand = float(aux["candidates"].sum(-1).float().mean())
        kept = float(aux["kept"].sum(-1).float().mean())
        err = float((out - exact).abs().max())
        cos = float(((out * exact).sum(-1) /
                     (out.norm(dim=-1) * exact.norm(dim=-1) + 1e-9)).mean())
        print(f"{name}")
        print(f"  candidates {cand:6.1f}/{N}   kept {kept:6.1f}/{N}   "
              f"max|err| {err:.4f}   cos(exact) {cos:.4f}")

    print("\nexact output row 0, first 6 dims:", exact[0, :6].cpu().numpy())


if __name__ == "__main__":
    main()
