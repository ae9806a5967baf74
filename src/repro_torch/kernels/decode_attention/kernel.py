"""Decode attention kernels for Hopper, with their plain versions.

Ports ``repro/kernels/decode_attention/kernel.py``: the fused
single-pass online-softmax kernel (``_fused_kernel``) and the
``exact_two_pass`` pair (``_rowmax_kernel`` then ``_attend_kernel``),
hand-written in CUDA C++ in ``repro_torch/csrc/decode_attention.cu``
(see the note there for the bound and the design). All three run a
thread-block cluster per (batch, kv head): the fused kernel
``cluster_size(S, block_k)`` CTAs, each owning a slice of every
``block_k`` tile; the two-pass pair ``two_pass_cluster_size(S)`` CTAs,
each owning a contiguous slice of the ring, both passes scoring with the
one route ``score_route(k)`` picks from K alone.

The device of the tensors decides the route: CUDA tensors launch the
kernel (or raise), CPU tensors take the plain PyTorch version, which
repeats the kernel's arithmetic tile by tile (running max advanced once
per ``block_k`` tile, masked scores at -1e30). There is no fallback from
the kernel to the plain version.

``LAUNCHES`` counts kernel launches per kernel (plain calls do not
count), so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
SOURCE = "decode_attention.cu"
MAX_HEAD_DIM = 256          # the kernels hold a key row in 8 registers/lane
MAX_CLUSTER = 4             # CTAs of the fused kernel per (batch, kv head)
MAX_TWO_PASS_CLUSTER = 4    # CTAs of the two-pass kernels per (batch, kv head)
MIN_CLUSTER_KEYS = 32       # keys each CTA of a cluster keeps (of a tile)

LAUNCHES = {"decode_attention_fused": 0, "decode_attention_rowmax": 0,
            "decode_attention_attend": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "decode_attention_fused": [_P] * 5 + [_I] * 9 + [_F, _I, _F, _P],
    "decode_attention_rowmax": [_P] * 4 + [_I] * 9 + [_F, _P],
    "decode_attention_attend": [_P] * 6 + [_I] * 10 + [_F, _I, _F, _P],
}


def _entry(name: str):
    return build.entry(SOURCE, name, _ARGTYPES[name])


def cluster_size(s: int, block_k: int) -> int:
    """CTAs of the fused kernel's cluster for a ring of ``s`` rows at
    ``block_k``: the most of 4, 3, 2 that splits a tile of
    ``min(block_k, s)`` keys into equal slices of at least
    ``MIN_CLUSTER_KEYS`` keys, else 1. At the serving shape (S=512,
    block_k 512 or 128) that is 4; a short ring shrinks the cluster so
    that no CTA is left with too few keys."""
    bk = min(block_k, s)
    for c in range(MAX_CLUSTER, 1, -1):
        if bk % c == 0 and bk // c >= MIN_CLUSTER_KEYS:
            return c
    return 1


def two_pass_cluster_size(s: int) -> int:
    """CTAs of the two-pass kernels' cluster for a ring of ``s`` rows:
    the most of ``MAX_TWO_PASS_CLUSTER`` down to 2 that splits the ring
    into equal contiguous slices of at least ``MIN_CLUSTER_KEYS`` keys,
    else 1. ``block_k`` does not enter: neither pass carries anything
    from one tile to the next. 4 measured faster than 8 on the H100 at
    S=512 and S=4096 (``tools/two_pass_cluster.py``)."""
    for c in range(MAX_TWO_PASS_CLUSTER, 1, -1):
        if s % c == 0 and s // c >= MIN_CLUSTER_KEYS:
            return c
    return 1


def score_route(k: torch.Tensor) -> str:
    """How both two-pass kernels score q.k: ``"vec"`` (a few lanes a key
    row, 8 at D=128, with 16-byte loads and q in registers) when K's rows
    are 16-byte aligned, else ``"scalar"`` (a warp a row). Decided from K
    alone, so the row max of pass 1 and the scores of pass 2 are the same
    floats whatever V is."""
    aligned = k.data_ptr() % 16 == 0 and \
        (k.shape[-1] * k.element_size()) % 16 == 0
    return "vec" if aligned else "scalar"


# ---------------------------------------------------------------------------
# shape checks (shared by both routes, as the Pallas kernel asserts)
# ---------------------------------------------------------------------------

def _check(q, k, v, mask, block_k) -> Tuple[int, int, int, int, int, int, int]:
    if q.dim() != 3 or k.dim() != 4 or (v is not None and v.dim() != 4):
        raise ValueError("decode_attention expects q [B,Hq,D], "
                         "k [B,Hkv,S,D], v [B,Hkv,S,Dv]")
    b, hq, d = q.shape
    _, hkv, s, dk = k.shape
    dv = v.shape[3] if v is not None else d
    if k.shape[0] != b or dk != d or hq % hkv != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if v is not None and tuple(v.shape[:3]) != (b, hkv, s):
        raise ValueError(f"shape mismatch: k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if tuple(mask.shape) != (b, hq, s) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool [B,Hq,S]={(b, hq, s)}, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    bk = min(block_k, s)
    if s % bk != 0:
        raise ValueError(f"S={s} is not a multiple of block_k={bk}")
    return b, hq, hkv, s, d, dv, bk


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic, tile by tile)
# ---------------------------------------------------------------------------

def _tiles(q, k, mask, scale, bk):
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, d)
    mk = mask.reshape(b, hkv, g, s)
    for t0 in range(0, s, bk):
        sc = torch.einsum("bhgd,bhkd->bhgk", qf,
                          k[:, :, t0:t0 + bk].float()) * scale
        yield t0, sc, mk[..., t0:t0 + bk]


def _emit(acc, l, q):
    b, hq = q.shape[:2]
    out = torch.where(l == 0.0, 0.0, acc / torch.where(l == 0.0, 1.0, l))
    return out.reshape(b, hq, acc.shape[-1]).to(q.dtype)


def fused_plain(q, k, v, mask, *, threshold=None, scale=None, block_k=512):
    """Plain version of the fused kernel (#1)."""
    b, hq, hkv, s, d, dv, bk = _check(q, k, v, mask, block_k)
    scale = d ** -0.5 if scale is None else scale
    g = hq // hkv
    m = torch.full((b, hkv, g, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, 1), device=q.device)
    acc = torch.zeros((b, hkv, g, dv), device=q.device)
    for t0, sc, mt in _tiles(q, k, mask, scale, bk):
        sc = torch.where(mt, sc, NEG_INF)
        m_cur = torch.maximum(m, sc.amax(-1, keepdim=True))
        keep = mt
        if threshold is not None:
            keep = keep & (sc >= m_cur - threshold)
        p = torch.where(keep, torch.exp(sc - m_cur), 0.0)
        alpha = torch.exp(m - m_cur)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhgk,bhkd->bhgd", p, v[:, :, t0:t0 + bk].float())
        m = m_cur
    return _emit(acc, l, q)


def rowmax_plain(q, k, mask, *, scale=None, block_k=512):
    """Plain version of the row-max kernel (#2): float32 [B, Hq]."""
    b, hq, hkv, s, d, _, bk = _check(q, k, None, mask, block_k)
    scale = d ** -0.5 if scale is None else scale
    m = torch.full((b, hkv, hq // hkv), NEG_INF, device=q.device)
    for _, sc, mt in _tiles(q, k, mask, scale, bk):
        m = torch.maximum(m, torch.where(mt, sc, NEG_INF).amax(-1))
    return m.reshape(b, hq)


def attend_plain(q, k, v, mask, rowmax, *, threshold=None, scale=None,
                 block_k=512):
    """Plain version of the attend kernel (#3) given pass 1's row max."""
    b, hq, hkv, s, d, dv, bk = _check(q, k, v, mask, block_k)
    scale = d ** -0.5 if scale is None else scale
    g = hq // hkv
    rm = rowmax.float().reshape(b, hkv, g, 1)
    l = torch.zeros((b, hkv, g, 1), device=q.device)
    acc = torch.zeros((b, hkv, g, dv), device=q.device)
    for t0, sc, mt in _tiles(q, k, mask, scale, bk):
        keep = mt
        if threshold is not None:
            keep = keep & (sc >= rm - threshold)
        p = torch.where(keep, torch.exp(sc - rm), 0.0)
        l = l + p.sum(-1, keepdim=True)
        acc = acc + torch.einsum("bhgk,bhkd->bhgd", p,
                                 v[:, :, t0:t0 + bk].float())
    return _emit(acc, l, q)


def decode_attention_plain(q, k, v, mask, *, threshold=None, scale=None,
                           block_k=512, exact_two_pass=False):
    if not exact_two_pass:
        return fused_plain(q, k, v, mask, threshold=threshold, scale=scale,
                           block_k=block_k)
    rm = rowmax_plain(q, k, mask, scale=scale, block_k=block_k)
    return attend_plain(q, k, v, mask, rm, threshold=threshold, scale=scale,
                        block_k=block_k)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _thr(threshold) -> Tuple[int, float]:
    return (0, 0.0) if threshold is None else (1, float(threshold))


def fused(q, k, v, mask, *, threshold=None, scale=None, block_k=512):
    """Kernel #1 on CUDA tensors, its plain version on CPU tensors."""
    if build.route(q) == "plain":
        return fused_plain(q, k, v, mask, threshold=threshold, scale=scale,
                           block_k=block_k)
    b, hq, hkv, s, d, dv, bk = _check(q, k, v, mask, block_k)
    build.check_launch("decode_attention", (q, k, v), (mask,), (d, dv),
                       MAX_HEAD_DIM)
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, hq, dv), dtype=q.dtype, device=q.device)
    has_thr, thr = _thr(threshold)
    err = _entry("decode_attention_fused")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), b, hq, hkv, s, d,
        dv, bk, cluster_size(s, block_k), scale, has_thr, thr,
        build.stream(q.device))
    build.raise_on(err, "decode_attention_fused")
    LAUNCHES["decode_attention_fused"] += 1
    return out


def rowmax(q, k, mask, *, scale=None, block_k=512):
    """Kernel #2 on CUDA tensors, its plain version on CPU tensors."""
    if build.route(q) == "plain":
        return rowmax_plain(q, k, mask, scale=scale, block_k=block_k)
    b, hq, hkv, s, d, _, bk = _check(q, k, None, mask, block_k)
    build.check_launch("decode_attention", (q, k), (mask,), (d,),
                       MAX_HEAD_DIM)
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    err = _entry("decode_attention_rowmax")(
        q.data_ptr(), k.data_ptr(), mask.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, hq, hkv, s, d, bk,
        two_pass_cluster_size(s), int(score_route(k) == "vec"), scale,
        build.stream(q.device))
    build.raise_on(err, "decode_attention_rowmax")
    LAUNCHES["decode_attention_rowmax"] += 1
    return out


def attend(q, k, v, mask, rm, *, threshold=None, scale=None, block_k=512):
    """Kernel #3 on CUDA tensors, its plain version on CPU tensors."""
    if build.route(q) == "plain":
        return attend_plain(q, k, v, mask, rm, threshold=threshold,
                            scale=scale, block_k=block_k)
    b, hq, hkv, s, d, dv, bk = _check(q, k, v, mask, block_k)
    build.check_launch("decode_attention", (q, k, v), (mask, rm), (d, dv),
                       MAX_HEAD_DIM)
    if rm.dtype != torch.float32 or tuple(rm.shape) != (b, hq):
        raise ValueError("rowmax must be float32 [B, Hq]")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, hq, dv), dtype=q.dtype, device=q.device)
    has_thr, thr = _thr(threshold)
    err = _entry("decode_attention_attend")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        rm.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16), b,
        hq, hkv, s, d, dv, bk, two_pass_cluster_size(s),
        int(score_route(k) == "vec"), scale, has_thr, thr,
        build.stream(q.device))
    build.raise_on(err, "decode_attention_attend")
    LAUNCHES["decode_attention_attend"] += 1
    return out


def decode_attention(
    q: torch.Tensor,                # [B, Hq, D] one new token per sequence
    k: torch.Tensor,                # [B, Hkv, S, D]
    v: torch.Tensor,                # [B, Hkv, S, Dv]
    mask: torch.Tensor,             # [B, Hq, S] candidates & cache validity
    *,
    threshold: Optional[float] = None,
    scale: Optional[float] = None,
    block_k: int = 512,
    exact_two_pass: bool = False,
) -> torch.Tensor:
    """Port of the reference ``decode_attention`` (same arguments minus
    ``interpret``): fused single pass by default, the literal two-pass
    SSIV-D pipeline with ``exact_two_pass=True``."""
    if not exact_two_pass:
        return fused(q, k, v, mask, threshold=threshold, scale=scale,
                     block_k=block_k)
    rm = rowmax(q, k, mask, scale=scale, block_k=block_k)
    return attend(q, k, v, mask, rm, threshold=threshold, scale=scale,
                  block_k=block_k)
