"""Fused (flash) attention kernel for Hopper, with its plain version.

Ports ``repro/kernels/flash_attention/kernel.py::_flash_kernel``:
causal / sliding-window GQA attention with an online softmax over kv
tiles, query rows offset by ``seq_k - seq_q``. The kernels are
hand-written CUDA C++ in ``repro_torch/csrc/flash_attention.cu`` (see the
note there for the bound and the design), one per route, chosen from the
dtype and head dims before the launch (``kernel_route``): bf16 with D and
Dv multiples of 16 up to 256 runs on the tensor cores (wgmma + TMA;
128-key kv tiles up to D, Dv = 128, 64-key tiles above), float32 and
every other head dim (up to 256) on the CUDA cores.

The device of the tensors decides the route: CUDA tensors launch the
kernel (or raise), CPU tensors take the plain PyTorch version, which
repeats the Pallas kernel's arithmetic kv tile by kv tile (scale after
the dot, masked scores at -1e30, running max, l == 0 -> 0). There is no
fallback from the kernel to the plain version.

``LAUNCHES`` counts kernel launches by route (plain calls do not count).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
SOURCE = "flash_attention.cu"
MAX_HEAD_DIM = 256          # a CUDA-core thread holds 16 value columns
# the head dims of the tensor-core engine (wgmma_attention.cuh), which
# the A^3 pair (#5 / #6) shares
WGMMA_MAX_HEAD_DIM = 256

# launches per route: the tensor-core kernel and the CUDA-core kernel
LAUNCHES = {"flash_attention_wgmma": 0, "flash_attention_simt": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "flash_attention_simt": ("flash_attention_fwd",
                             [_P] * 4 + [_I] * 8 + [_F, _I, _I, _I, _P]),
    "flash_attention_wgmma": ("flash_attention_fwd_wgmma",
                              [_P] * 4 + [_I] * 7 + [_F, _I, _I, _I, _P]),
}


def kernel_route(dtype: torch.dtype, d: int, dv: int, aligned: bool = True,
                 scale: float = 1.0) -> str:
    """The kernel a CUDA call takes, decided before the launch:
    ``"flash_attention_wgmma"`` for bf16 with D and Dv multiples of 16 up
    to 256, 16-byte aligned q/k/v (what the wgmma tiles and TMA take) and
    a positive scale (its softmax takes the row max of unscaled scores),
    else ``"flash_attention_simt"`` (float32, other head dims up to
    256)."""
    if dtype == torch.bfloat16 and aligned and scale > 0 and \
            all(x % 16 == 0 and 0 < x <= WGMMA_MAX_HEAD_DIM for x in (d, dv)):
        return "flash_attention_wgmma"
    return "flash_attention_simt"


def _check(q, k, v, block_q, block_k) -> Tuple[int, ...]:
    """Shapes as the Pallas wrapper asserts them -> (b, hq, hkv, sq, sk,
    d, dv, bq, bk)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects q [B,Hq,Sq,D], "
                         "k [B,Hkv,Sk,D], v [B,Hkv,Sk,Dv]")
    b, hq, sq, d = q.shape
    _, hkv, sk, dv = v.shape
    if tuple(k.shape) != (b, hkv, sk, d) or hq % hkv != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq != 0 or sk % bk != 0:
        raise ValueError(f"Sq={sq} / Sk={sk} are not multiples of "
                         f"block_q={bq} / block_k={bk}")
    return b, hq, hkv, sq, sk, d, dv, bq, bk


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None,
                          block_q=128, block_k=128):
    """Plain version of the flash kernel (#4), kv tile by kv tile."""
    b, hq, hkv, sq, sk, d, dv, _, bk = _check(q, k, v, block_q, block_k)
    scale = d ** -0.5 if scale is None else scale
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, sq, d)
    abs_rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    m = torch.full((b, hkv, g, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, sq, 1), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), device=q.device)
    for c0 in range(0, sk, bk):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf,
                         k[:, :, c0:c0 + bk].float()) * scale
        cols = torch.arange(c0, c0 + bk, device=q.device)[None, :]
        mask = torch.ones((sq, bk), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (cols <= abs_rows)
        if window is not None:
            mask = mask & (cols > abs_rows - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                         v[:, :, c0:c0 + bk].float())
        m = m_new
    out = torch.where(l == 0.0, 0.0, acc / torch.where(l == 0.0, 1.0, l))
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def flash_attention(
    q: torch.Tensor,                # [B, Hq, Sq, D]
    k: torch.Tensor,                # [B, Hkv, Sk, D]
    v: torch.Tensor,                # [B, Hkv, Sk, Dv]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Kernel #4 on CUDA tensors, its plain version on CPU tensors (the
    reference's arguments minus ``interpret``). ``block_q``/``block_k``
    fix the shape contract and the plain version's tiles; the kernels
    tile the work their own way."""
    if build.route(q) == "plain":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, block_q=block_q,
                                     block_k=block_k)
    b, hq, hkv, sq, sk, d, dv, _, _ = _check(q, k, v, block_q, block_k)
    build.check_launch("flash_attention", (q, k, v), (), (d, dv),
                       MAX_HEAD_DIM)
    scale = d ** -0.5 if scale is None else scale
    has_window, win = build.window_args(window, sq, sk)
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    name = kernel_route(q.dtype, d, dv, all(t.data_ptr() % 16 == 0
                                            for t in (q, k, v)), scale)
    fn = build.entry(SOURCE, *_ARGTYPES[name])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    shape = (b, hq, hkv, sq, sk, d, dv, scale, int(causal), has_window, win,
             build.stream(q.device))
    if name == "flash_attention_wgmma":
        err = fn(*ptrs, *shape)
    else:
        err = fn(*ptrs, int(q.dtype == torch.bfloat16), *shape)
    build.raise_on(err, name)
    LAUNCHES[name] += 1
    return out
