#!/usr/bin/env python3
"""Ring depth of the A^3 row-max kernel's tensor-core route (#5) on one
NVIDIA GPU.

    python3 tools/rowmax_ring_depth.py [--depths 2 3 4 5 6]

Builds ``src/repro_torch/csrc/a3_attention.cu`` once per depth of its
K-only ring (a copy with ``kRowmaxStages`` replaced, under
``build/ring_depth/``; one ``nvcc`` per depth, all started together),
checks each build's ``a3_sparse_rowmax_wgmma`` against the plain version
and times it at ``chip_smoke.py`` phase [7a]'s shape (B=1, Hq=24, Hkv=8,
S=2048, D=128, bf16, causal, random maps of density 0.5, 4 input sets
larger than L2) by CUDA events and by the profiler's device time per
launch. Prints one line per depth and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ring_depth"


def build(depths):
    """depth -> loaded library, every depth compiled in parallel."""
    from repro_torch.kernels import build as kb
    procs = {}
    for depth in depths:
        src = OUT / f"stages{depth}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(kb.CSRC, src)
        cu = src / "a3_attention.cu"
        text, n = re.subn(r"constexpr int kRowmaxStages = \d+;",
                          f"constexpr int kRowmaxStages = {depth};",
                          cu.read_text())
        if n != 1:
            raise RuntimeError("kRowmaxStages not found in a3_attention.cu")
        cu.write_text(text)
        cmd = [kb._nvcc(), *kb.NVCC_FLAGS, "-o", str(src / "lib.so"),
               str(cu)]
        procs[depth] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
    libs = {}
    for depth, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed at depth {depth}:\n{log}")
        libs[depth] = ctypes.CDLL(str(OUT / f"stages{depth}" / "lib.so"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depths", type=int, nargs="+", default=[2, 3, 4, 5, 6])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("rowmax_ring_depth: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    from repro_torch.kernels.a3_attention import kernel as ak

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    sets = [cs.prefill_inputs(200 + i, dev) for i in range(4)]
    maps = [cs.random_map(200 + i, dev) for i in range(4)]
    b, hq, hkv, s, d = (cs.PREFILL[x] for x in ("b", "hq", "hkv", "s", "d"))
    argtypes = ak._ARGTYPES["a3_sparse_rowmax_wgmma"][1]
    for depth, lib in build(args.depths).items():
        fn = lib.a3_sparse_rowmax_wgmma
        fn.argtypes, fn.restype = argtypes, ctypes.c_int

        def rowmax(q, k, idx, cnt):
            out = torch.empty((b, hkv, hq // hkv, s), device=dev)
            err = fn(q.data_ptr(), k.data_ptr(), idx.data_ptr(),
                     cnt.data_ptr(), out.data_ptr(), b, hq, hkv, s, s, d,
                     d, idx.shape[-1], d ** -0.5, 1, 0, 0, kb.stream(dev))
            kb.raise_on(err, f"a3_sparse_rowmax_wgmma (depth {depth})")
            return out

        rsets = [(x[0], x[1], *m) for x, m in zip(sets, maps)]
        e, ok = cs.max_err(rowmax(*rsets[0]),
                           ak.sparse_rowmax_plain(*rsets[0]))
        if not ok:
            raise RuntimeError(f"depth {depth} disagrees with plain: {e}")
        ms = cs.cuda_ms(rowmax, rsets, 50)
        dms = cs.device_ms(rowmax, rsets, 50, True)
        print(f"depth {depth}: {ms:.4f} ms by events, {cs.fmt_ms(dms)} "
              f"device, max_abs_err {e:.3g} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
