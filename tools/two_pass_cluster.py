#!/usr/bin/env python3
"""Cluster size of the two-pass decode kernels (#2 row max, #3 attend) on
one NVIDIA GPU.

    python3 tools/two_pass_cluster.py [--clusters 1 2 4 8]

For each cluster size (set through ``MAX_TWO_PASS_CLUSTER``, which
``two_pass_cluster_size`` reads at every call) checks #2 and #3 against
their plain versions and times them at ``chip_smoke.py`` phase [2]'s
shapes (B=4, Hq=24, Hkv=8, D=128, bf16, masks of density 0.6, the pair
at threshold 3.0), at S=512 over 8 input sets and at S=4096 over 2 (both
larger than L2), by CUDA events and by the profiler's device time per
launch, with the fused kernel #1 beside them. Prints the card's name and
power limit, then one line per (S, cluster size).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clusters", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("two_pass_cluster: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import kernel as tk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    thr = 3.0
    for s, n_sets in ((512, 8), (4096, 2)):
        sets = [cs.make_inputs(i, dev, s=s) for i in range(n_sets)]
        rsets = [(x[0], x[1], x[3]) for x in sets]
        fused = cs.device_ms(lambda *x: tk.fused(*x), sets, 100, True)
        for c in args.clusters:
            tk.MAX_TWO_PASS_CLUSTER = c
            rms = [tk.rowmax(*r) for r in rsets]
            asets = [(*x, rm) for x, rm in zip(sets, rms)]
            e_rm, ok_rm = cs.max_err(rms[0], tk.rowmax_plain(*rsets[0]))
            e_at, ok_at = cs.max_err(
                tk.attend(*asets[0], threshold=thr),
                tk.attend_plain(*asets[0], threshold=thr))
            if not (ok_rm and ok_at):
                print(f"S={s} cluster {c}: disagrees with the plain "
                      f"versions (rowmax {e_rm}, attend {e_at})")
                return 1

            def rowmax(*x):
                return tk.rowmax(*x)

            def attend(*x):
                return tk.attend(*x, threshold=thr)

            t = {name: (cs.cuda_ms(fn, a, 100),
                        cs.device_ms(fn, a, 100, True))
                 for name, fn, a in (("rowmax", rowmax, rsets),
                                     ("attend", attend, asets))}
            print(f"S={s} cluster {tk.two_pass_cluster_size(s)}: "
                  + "; ".join(f"{n} {ms:.4f} ms by events, "
                              f"{cs.fmt_ms(dms)} device"
                              for n, (ms, dms) in t.items())
                  + f"; fused {cs.fmt_ms(fused)} device; max_abs_err "
                  f"rowmax {e_rm:.3g} attend {e_at:.3g} [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
