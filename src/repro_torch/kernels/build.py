"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Builds happen at first use, never at
import, into ``build/repro_torch_kernels/`` at the repository root; the
library name carries a hash of the source and flags, so an edited source
is rebuilt and a stale library is never loaded.

The launch plumbing the kernel wrappers share lives here too: the route
a tensor's device selects, the checks of a launch's inputs, the C entry
of a kernel, the current stream and the check of a launch's
``cudaError_t``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
# ptxas register / shared-memory report of each build, by source name
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` goes; the name hashes the
    source, the shared headers (``csrc/*.cuh``) and the flags."""
    src = CSRC / source
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{tag}.so"


def _start(source: str) -> Tuple[subprocess.Popen, Path, Path]:
    out = library_path(source)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), out


def _finish(source: str, proc: subprocess.Popen, tmp: Path,
            out: Path) -> None:
    log, _ = proc.communicate()
    BUILD_LOGS[source] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    os.replace(tmp, out)              # atomic: readers never see a torn .so


def build_all(sources: Iterable[str]) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all
    started together. Returns source -> library path."""
    started, paths = [], {}
    for source in sources:
        paths[source] = library_path(source)
        if not paths[source].exists():
            started.append((source, *_start(source)))
    for source, proc, tmp, out in started:
        _finish(source, proc, tmp, out)
    return paths


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        path = build_all([source])[source]
        lib = _LIBS[source] = ctypes.CDLL(str(path))
    return lib


# ---------------------------------------------------------------------------
# launch plumbing shared by the kernel wrappers
# ---------------------------------------------------------------------------

def route(t: torch.Tensor) -> str:
    """"plain" for a CPU tensor, "kernel" for a CUDA tensor; anything
    else raises. There is no fallback from one route to the other."""
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "kernel"
    raise ValueError(f"unsupported device {t.device}")


def check_launch(name: str, floats, others, dims, max_dim: int) -> None:
    """Raise unless the ``floats`` (q, k, v) share one dtype, float32 or
    bfloat16, every tensor of ``floats`` and ``others`` (masks, maps, row
    maxima) is contiguous on one device, and each head dim in ``dims`` is
    at most ``max_dim``."""
    dev = floats[0].device
    for t in (*floats, *others):
        if t.device != dev:
            raise ValueError(f"{name} inputs must share a device")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernels need contiguous inputs")
    if floats[0].dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != floats[0].dtype for t in floats):
        raise ValueError("q, k and v must share one dtype, float32 or "
                         "bfloat16")
    if max(dims) > max_dim:
        raise ValueError(f"head dims {tuple(dims)} exceed {max_dim}")


def window_args(window, sq: int, sk: int) -> Tuple[int, int]:
    """(has_window, window) for a C entry. A window wider than every
    row's reach masks nothing, so it is clamped to fit an int."""
    return (0, 0) if window is None else (1, min(int(window), sq + sk))


def entry(source: str, name: str, argtypes: List) -> ctypes._CFuncPtr:
    """The C entry ``name`` of ``csrc/<source>`` (returns cudaError_t),
    typed once and cached."""
    fn = _ENTRIES.get((source, name))
    if fn is None:
        fn = getattr(load_library(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[(source, name)] = fn
    return fn


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
