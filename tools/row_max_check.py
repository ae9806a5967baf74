#!/usr/bin/env python3
"""The row-max kernels of a port tree on NaN keys, and their device
times, on one NVIDIA GPU.

    python3 tools/row_max_check.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of the port tree to build (default:
this checkout's; another commit unpacked with ``git archive`` compares
against it). Builds that tree's ``decode_attention.cu`` and
``a3_attention.cu`` and prints, for #2/#3 and #5/#6 against their plain
versions on ``chip_smoke.py``'s NaN-key inputs (phase [2]'s NaN lanes,
phase [7]'s NaN key 200), bf16 and float32, thresholds None and 3.0:
the NaN row maxima, and the NaN rows and all-zero rows of the attend
pass. Then the profiler's device time per launch of #1-#3 (S=512 and
4096) and #5/#6 (S=2048, bf16 and float32) over inputs larger than L2,
and the card's name and power limit. Run it on two trees in turns
(A, B, B, A) in one call to compare them.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def rows(t):
    """Rows (last axis) whose every entry is true."""
    return int(t.reshape(-1, t.shape[-1]).all(-1).sum())


def nan_rows(label, card):
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.a3_attention import kernel as ak
    from repro_torch.kernels.decode_attention import kernel as tk

    dev = torch.device("cuda")
    q, k, v, mask = cs.make_inputs(0, dev)
    k, v, mask = cs.nan_lanes(k, v, mask)
    pq, pk, pv = cs.prefill_inputs(100, dev)
    idx, cnt = cs.random_map(100, dev)
    pk = pk.clone()
    pk[:, :, 200] = float("nan")
    for dt in ("bf16", "f32"):
        f = (lambda t: t) if dt == "bf16" else (lambda t: t.float())
        for name, rm, prm, attend, plain in (
                ("#2/#3", tk.rowmax(f(q), f(k), mask),
                 tk.rowmax_plain(f(q), f(k), mask),
                 lambda rm, thr: tk.attend(f(q), f(k), f(v), mask, rm,
                                           threshold=thr),
                 lambda rm, thr: tk.attend_plain(f(q), f(k), f(v), mask, rm,
                                                 threshold=thr)),
                ("#5/#6", ak.sparse_rowmax(f(pq), f(pk), idx, cnt),
                 ak.sparse_rowmax_plain(f(pq), f(pk), idx, cnt),
                 lambda rm, thr: ak.sparse_attend(f(pq), f(pk), f(pv), idx,
                                                  cnt, rm, threshold=thr),
                 lambda rm, thr: ak.sparse_attend_plain(
                     f(pq), f(pk), f(pv), idx, cnt, rm, threshold=thr))):
            for thr in (None, 3.0):
                out, want = attend(rm, thr), plain(prm, thr)
                print(f"{label} {name} {dt} thr={thr}: NaN row maxima "
                      f"{int(torch.isnan(rm).sum())} (plain "
                      f"{int(torch.isnan(prm).sum())}); attend NaN rows "
                      f"{rows(torch.isnan(out))} (plain "
                      f"{rows(torch.isnan(want))}), zero rows "
                      f"{rows(out == 0)} (plain {rows(want == 0)}) of "
                      f"{out.numel() // out.shape[-1]} [{card}]", flush=True)


def device_times(label, card):
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.a3_attention import kernel as ak
    from repro_torch.kernels.decode_attention import kernel as tk

    dev = torch.device("cuda")
    out = {}
    for s in (512, cs.LONG_S):
        sets = [cs.make_inputs(10 + i, dev, s=s)
                for i in range(cs.N_SETS if s == 512 else cs.N_LONG_SETS)]
        rms = [tk.rowmax(x[0], x[1], x[3]) for x in sets]
        out[f"#1 S={s}"] = cs.device_ms(lambda *x: tk.fused(*x), sets, 100,
                                        True)
        out[f"#2 S={s}"] = cs.device_ms(lambda *x: tk.rowmax(*x),
                                        [(x[0], x[1], x[3]) for x in sets],
                                        100, True)
        out[f"#3 S={s}"] = cs.device_ms(
            lambda *x: tk.attend(*x, threshold=3.0),
            [(*x, rm) for x, rm in zip(sets, rms)], 100, True)
    psets = [cs.prefill_inputs(200 + i, dev) for i in range(4)]
    maps = [cs.random_map(200 + i, dev) for i in range(4)]
    for dt in ("bf16", "f32"):
        ps = psets if dt == "bf16" else \
            [tuple(t.float() for t in x) for x in psets]
        rsets = [(x[0], x[1], *m) for x, m in zip(ps, maps)]
        rms = [ak.sparse_rowmax(*a) for a in rsets]
        out[f"#5 {dt}"] = cs.device_ms(lambda *x: ak.sparse_rowmax(*x),
                                       rsets, 40, True)
        out[f"#6 {dt}"] = cs.device_ms(
            lambda *x: ak.sparse_attend(*x, threshold=3.0),
            [(x[0], x[1], x[2], *m, rm) for x, m, rm in zip(ps, maps, rms)],
            40, True)
    print(f"{label} device ms per launch: "
          + ", ".join(f"{k} {cs.fmt_ms(v)}" for k, v in out.items())
          + f" [{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("row_max_check: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all(["a3_attention.cu", "decode_attention.cu"])
    nan_rows(args.label, card)
    device_times(args.label, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
