#!/usr/bin/env python3
"""Device times of the prefill attention kernels (#4, #5, #6) of a port
tree at phi4-mini's and gemma3-4b's attention widths, on one NVIDIA GPU.

    python3 tools/prefill_times.py [--src DIR] [--sass]

``--src`` is the ``src`` directory of the port tree to build (default:
this checkout's; another commit unpacked with ``git archive`` compares
against it). Builds that tree's ``flash_attention.cu`` and
``a3_attention.cu`` and prints the profiler's device time per launch of
#4, #5 and #6 (bf16, causal, #6 at t=3.0, random maps of density 0.5)
over ``chip_smoke.py``'s timing sets at its phase [7a] shape (B=1,
Hq=24, Hkv=8, S=2048, D=128) and [7d] shape (Hq=8, Hkv=4, D=256), each
call on the route that tree gives it, with the routes taken and the
card's name and power limit. ``--sass`` adds a digest of each
tensor-core kernel's machine code (``cuobjdump -sass``), so that two
trees' instantiations can be compared. Run it on two trees in turns
(A, B, B, A) in one call to compare them.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def times(src, card):
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.a3_attention import kernel as ak
    from repro_torch.kernels.flash_attention import kernel as fk

    dev = torch.device("cuda")
    out = {}
    for width, inputs, shape in (
            ("D128", cs.prefill_inputs, cs.PREFILL),
            ("D256", cs.head_dim_256_inputs, cs.GEMMA)):
        sets, rsets, asets, _ = cs.timing_sets(inputs, shape, 200, dev)
        fk.reset_launch_counts()
        ak.reset_launch_counts()
        for name, fn, args in (
                ("#4", fk.flash_attention, sets),
                ("#5", ak.sparse_rowmax, rsets),
                ("#6", lambda *x: ak.sparse_attend(*x, threshold=cs.T_CONS),
                 asets)):
            out[f"{name} {width}"] = cs.device_ms(fn, args, 50, True)
        routes = {n: c for n, c in {**fk.LAUNCHES, **ak.LAUNCHES}.items()
                  if c}
        print(f"{src} {width} routes: {sorted(routes)}", flush=True)
    print(f"{src} device ms per launch: "
          + ", ".join(f"{k} {cs.fmt_ms(v)}" for k, v in out.items())
          + f" [{card}]", flush=True)


def sass_digests(src, libs):
    """One line per tensor-core kernel of the built libraries: its
    instructions and a digest of its SASS text."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    for lib in libs:
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        for part in re.split(r"\n\s*Function : ", text)[1:]:
            name, body = part.split("\n", 1)
            if "wgmma_kernel" not in name:
                continue
            code = [ln for ln in body.splitlines()
                    if re.search(r"/\*[0-9a-f]{4,}\*/", ln)]
            digest = hashlib.sha256("\n".join(code).encode()).hexdigest()
            print(f"{src} sass {name.strip()}: {len(code)} instructions, "
                  f"{digest[:16]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("prefill_times: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build.build_all(["flash_attention.cu", "a3_attention.cu"])
    if args.sass:
        sass_digests(src, libs.values())
    times(src, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
