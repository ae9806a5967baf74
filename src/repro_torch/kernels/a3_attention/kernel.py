"""A^3 block-sparse attention kernels for Hopper, with their plain
versions and the block-map helpers.

Ports ``repro/kernels/a3_attention/kernel.py``: the candidate mask is
reduced to kv-block granularity (``kv_indices``/``kv_counts`` per
(batch, kv head, q block)) and only the live kv blocks are visited, the
GQA group folded into the query rows so each live K/V block is staged
once per group. Pass 1 (``_sparse_rowmax_kernel``) takes the true masked
row max over the live blocks; pass 2 (``_sparse_attend_kernel``) drops
every score more than ``threshold`` nats below it, then does the exp-sum
and P.V. Both are hand-written CUDA C++ in
``repro_torch/csrc/a3_attention.cu`` (see the note there for the bound
and the design). Each has two routes, and one decision before the
launches (``sparse_route``) sends both passes down the same one: bf16
with 128 x 128 blocks and head dims multiples of 16 up to 128 runs on
the tensor cores (kernel #4's wgmma + TMA engine, one q head per CTA);
float32, other blocks and other head dims (up to 256) on the CUDA
cores, with the GQA group folded into the rows. Both passes of a route
score q.k with the same code, so the attend pass's scores are the very
floats whose maximum the row-max pass took, and threshold 0 keeps each
row's maximum.

The device of the tensors decides the route: CUDA tensors launch the
kernels (or raise), CPU tensors take the plain PyTorch versions, which
repeat the kernels' arithmetic live block by live block (-1e30 masking,
p = exp(s - rowmax), l == 0 -> 0). There is no fallback from a kernel to
its plain version. Block ids outside [0, Sk / block_k) count as dead in
both routes.

``build_block_map``, ``block_map_to_mask`` and ``union_block_map_gqa``
are the reference's jnp helpers as torch ops; their maps equal the
reference's exactly (stable sort, live blocks first).

``LAUNCHES`` counts kernel launches per kernel and route (plain calls
do not count).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
SOURCE = "a3_attention.cu"
MAX_HEAD_DIM = 256          # a CUDA-core thread holds 16 value columns
WGMMA_MAX_HEAD_DIM = 128    # the tensor-core kernels' head dims
WGMMA_BLOCK = 128           # the tensor-core kernels' q and kv block
ROUTES = ("wgmma", "simt")  # tensor cores, CUDA cores

# launches per kernel and route
LAUNCHES = {f"a3_sparse_{kernel}_{route}": 0
            for kernel in ("rowmax", "attend") for route in ROUTES}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel (route) -> (C entry, argtypes)
_ARGTYPES = {
    "a3_sparse_rowmax_simt": ("a3_sparse_rowmax",
                              [_P] * 5 + [_I] * 10 + [_F, _I, _I, _I, _P]),
    "a3_sparse_rowmax_wgmma": ("a3_sparse_rowmax_wgmma",
                               [_P] * 5 + [_I] * 7 + [_F, _I, _I, _I, _P]),
    "a3_sparse_attend_simt": ("a3_sparse_attend",
                              [_P] * 7 + [_I] * 11 + [_F] + [_I] * 4
                              + [_F, _P]),
    "a3_sparse_attend_wgmma": ("a3_sparse_attend_wgmma",
                               [_P] * 7 + [_I] * 8 + [_F] + [_I] * 4
                               + [_F, _P]),
}


def sparse_route(dtype: torch.dtype, d: int, dv: int, bq: int, bk: int,
                 aligned: bool = True) -> str:
    """The route both passes of a CUDA call take, decided before the
    launches: ``"wgmma"`` (the tensor-core kernels) for bf16 with D and Dv
    multiples of 16 up to 128, 128 x 128 blocks (``block_q``/``block_k``
    after clamping to Sq/Sk) and 16-byte aligned q/k/v (what the wgmma
    tiles and TMA take), else ``"simt"`` (the CUDA-core kernels)."""
    if dtype == torch.bfloat16 and aligned and \
            bq == bk == WGMMA_BLOCK and \
            all(x % 16 == 0 and 0 < x <= WGMMA_MAX_HEAD_DIM for x in (d, dv)):
        return "wgmma"
    return "simt"


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _pick_route(route, dtype, d, dv, bq, bk, aligned) -> str:
    """``route`` as given (checked against what the call can take), or
    decided here when it is None."""
    fits = sparse_route(dtype, d, dv, bq, bk, aligned)
    if route is None:
        return fits
    if route not in ROUTES or (route == "wgmma" and fits != "wgmma"):
        raise ValueError(f"route {route!r} does not take this call "
                         f"(it takes {fits!r})")
    return route


# ---------------------------------------------------------------------------
# block maps
# ---------------------------------------------------------------------------

def build_block_map(block_mask: torch.Tensor,       # [B, H, nq, nk] bool
                    max_blocks: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a boolean block mask into (kv_indices, kv_counts), int32.

    Live block ids are compacted to the front (stable order); padding
    points at block 0 and is masked by kv_counts inside the kernels."""
    b, h, nq, nk = block_mask.shape
    if max_blocks is None:
        max_blocks = nk
    order = torch.argsort((~block_mask).to(torch.uint8), dim=-1,
                          stable=True)                      # live first
    counts = block_mask.sum(-1).to(torch.int32)
    idx = order[..., :max_blocks].to(torch.int32)
    pos = torch.arange(max_blocks, device=block_mask.device)
    idx = torch.where(pos < counts[..., None], idx, 0).to(torch.int32)
    return idx, torch.clamp(counts, max=max_blocks)


def block_map_to_mask(kv_indices: torch.Tensor, kv_counts: torch.Tensor,
                      nk: int) -> torch.Tensor:
    """Inverse of :func:`build_block_map`: the dense [B, H, nq, nk] bool
    block mask."""
    b, h, nq, maxb = kv_indices.shape
    live = torch.arange(maxb, device=kv_indices.device) < kv_counts[..., None]
    bm = torch.zeros((b, h, nq, nk), dtype=torch.int32,
                     device=kv_indices.device)
    bm = bm.scatter_reduce(-1, kv_indices.long(), live.to(torch.int32),
                           "amax")
    return bm > 0


def union_block_map_gqa(kv_indices: torch.Tensor,    # [B, Hq, nq, maxb]
                        kv_counts: torch.Tensor,     # [B, Hq, nq]
                        group: int, nk: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Union per-query-head block maps across each GQA group: the kernels
    stage each kv block once per group, so the map is per kv head; the
    union only ever adds candidates."""
    b, hq, nq, _ = kv_indices.shape
    bm = block_map_to_mask(kv_indices, kv_counts, nk)
    return build_block_map(bm.reshape(b, hq // group, group, nq, nk).any(2))


# ---------------------------------------------------------------------------
# shape checks (shared by both routes, as the Pallas wrapper asserts)
# ---------------------------------------------------------------------------

def _check(q, k, v, kv_indices, kv_counts, block_q, block_k):
    """-> (b, hq, hkv, sq, sk, d, dv, bq, bk, nq, nk, maxb)."""
    if q.dim() != 4 or k.dim() != 4 or (v is not None and v.dim() != 4):
        raise ValueError("a3 sparse attention expects q [B,Hq,Sq,D], "
                         "k [B,Hkv,Sk,D], v [B,Hkv,Sk,Dv]")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    dv = v.shape[3] if v is not None else d
    if k.shape[0] != b or k.shape[3] != d or hq % hkv != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if v is not None and tuple(v.shape[:3]) != (b, hkv, sk):
        raise ValueError(f"shape mismatch: k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq != 0 or sk % bk != 0:
        raise ValueError(f"Sq={sq} / Sk={sk} are not multiples of "
                         f"block_q={bq} / block_k={bk}")
    nq, nk = sq // bq, sk // bk
    maxb = kv_indices.shape[-1] if kv_indices.dim() == 4 else -1
    if tuple(kv_indices.shape) != (b, hkv, nq, maxb) or \
            tuple(kv_counts.shape) != (b, hkv, nq) or \
            kv_indices.dtype != torch.int32 or kv_counts.dtype != torch.int32:
        raise ValueError(
            f"kv_indices must be int32 [B,Hkv,nq,maxb] and kv_counts int32 "
            f"[B,Hkv,nq] with (B,Hkv,nq)={(b, hkv, nq)}; got "
            f"{kv_indices.dtype} {tuple(kv_indices.shape)}, "
            f"{kv_counts.dtype} {tuple(kv_counts.shape)}")
    return b, hq, hkv, sq, sk, d, dv, bq, bk, nq, nk, maxb


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic, live block by live block)
# ---------------------------------------------------------------------------

def _live_tiles(q, k, v, kv_indices, kv_counts, *, bq, bk, scale, causal,
                window):
    """For each position of the live lists: (scores [B,Hkv,nq,G,bq,bk]
    float32 with -1e30 where not admitted, admitted mask, the V block
    [B,Hkv,nq,bk,Dv] or None)."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g, nq, nk, maxb = hq // hkv, sq // bq, sk // bk, kv_indices.shape[-1]
    qf = q.float().reshape(b, hkv, g, nq, bq, d).transpose(2, 3)
    kb = k.reshape(b, hkv, nk, bk, d)
    vb = v.reshape(b, hkv, nk, bk, v.shape[-1]) if v is not None else None
    cnt = kv_counts.long().clamp(max=maxb)
    dev = q.device
    rows = (torch.arange(nq, device=dev)[:, None] * bq
            + torch.arange(bq, device=dev)[None, :] + (sk - sq))
    rows = rows[None, None, :, None, :, None]              # [1,1,nq,1,bq,1]
    steps = int(cnt.max()) if cnt.numel() else 0
    for c in range(steps):
        jk = kv_indices[..., c].long()                     # [B,Hkv,nq]
        live = (c < cnt) & (jk >= 0) & (jk < nk)
        jk = jk.clamp(0, nk - 1)
        sel = jk[..., None, None]
        kt = torch.gather(kb, 2, sel.expand(b, hkv, nq, bk, d)).float()
        s = torch.einsum("bhngid,bhnjd->bhngij", qf, kt) * scale
        cols = jk[..., None] * bk + torch.arange(bk, device=dev)
        cols = cols[:, :, :, None, None, :]                # [B,Hkv,nq,1,1,bk]
        mask = live[..., None, None, None].expand(s.shape)
        if causal:
            mask = mask & (cols <= rows)
        if window is not None:
            mask = mask & (cols > rows - window)
        vt = None
        if vb is not None:
            vt = torch.gather(vb, 2, sel.expand(b, hkv, nq, bk,
                                                vb.shape[-1])).float()
        yield torch.where(mask, s, NEG_INF), mask, vt


def sparse_rowmax_plain(q, k, kv_indices, kv_counts, *, causal=True,
                        window=None, scale=None, block_q=128, block_k=128):
    """Plain version of the row-max kernel (#5): float32 [B,Hkv,G,Sq]."""
    b, hq, hkv, sq, _, d, _, bq, bk, nq, _, _ = _check(
        q, k, None, kv_indices, kv_counts, block_q, block_k)
    scale = d ** -0.5 if scale is None else scale
    g = hq // hkv
    m = torch.full((b, hkv, nq, g, bq), NEG_INF, device=q.device)
    for s, _, _ in _live_tiles(q, k, None, kv_indices, kv_counts, bq=bq,
                               bk=bk, scale=scale, causal=causal,
                               window=window):
        m = torch.maximum(m, s.amax(-1))
    return m.transpose(2, 3).reshape(b, hkv, g, sq)


def sparse_attend_plain(q, k, v, kv_indices, kv_counts, rowmax, *,
                        threshold=None, causal=True, window=None, scale=None,
                        block_q=128, block_k=128):
    """Plain version of the attend kernel (#6) given pass 1's row max:
    [B,Hq,Sq,Dv] in q's dtype."""
    b, hq, hkv, sq, _, d, dv, bq, bk, nq, _, _ = _check(
        q, k, v, kv_indices, kv_counts, block_q, block_k)
    scale = d ** -0.5 if scale is None else scale
    g = hq // hkv
    rm = rowmax.float().reshape(b, hkv, g, nq, bq).transpose(2, 3)[..., None]
    l = torch.zeros((b, hkv, nq, g, bq, 1), device=q.device)
    acc = torch.zeros((b, hkv, nq, g, bq, dv), device=q.device)
    for s, mask, vt in _live_tiles(q, k, v, kv_indices, kv_counts, bq=bq,
                                   bk=bk, scale=scale, causal=causal,
                                   window=window):
        keep = mask
        if threshold is not None:
            keep = keep & (s >= rm - threshold)
        p = torch.where(keep, torch.exp(s - rm), 0.0)
        l = l + p.sum(-1, keepdim=True)
        acc = acc + torch.einsum("bhngij,bhnjd->bhngid", p, vt)
    out = torch.where(l == 0.0, 0.0, acc / torch.where(l == 0.0, 1.0, l))
    return out.transpose(2, 3).reshape(b, hq, sq, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def sparse_rowmax(q, k, kv_indices, kv_counts, *, causal=True, window=None,
                  scale=None, block_q=128, block_k=128, route=None):
    """Kernel #5 on CUDA tensors, its plain version on CPU tensors.
    ``route`` ("wgmma" / "simt") is the pair's route when
    :func:`a3_sparse_attention` calls it; alone, the call decides from
    (D, D)."""
    if build.route(q) == "plain":
        return sparse_rowmax_plain(q, k, kv_indices, kv_counts,
                                   causal=causal, window=window, scale=scale,
                                   block_q=block_q, block_k=block_k)
    b, hq, hkv, sq, sk, d, _, bq, bk, _, _, maxb = _check(
        q, k, None, kv_indices, kv_counts, block_q, block_k)
    build.check_launch("a3 sparse", (q, k), (kv_indices, kv_counts), (d,),
                       MAX_HEAD_DIM)
    route = _pick_route(route, q.dtype, d, d, bq, bk, _aligned(q, k))
    scale = d ** -0.5 if scale is None else scale
    has_win, win = build.window_args(window, sq, sk)
    out = torch.empty((b, hkv, hq // hkv, sq), dtype=torch.float32,
                      device=q.device)
    name = f"a3_sparse_rowmax_{route}"
    fn = build.entry(SOURCE, *_ARGTYPES[name])
    ptrs = (q.data_ptr(), k.data_ptr(), kv_indices.data_ptr(),
            kv_counts.data_ptr(), out.data_ptr())
    tail = (scale, int(causal), has_win, win, build.stream(q.device))
    if route == "wgmma":
        err = fn(*ptrs, b, hq, hkv, sq, sk, d, maxb, *tail)
    else:
        err = fn(*ptrs, int(q.dtype == torch.bfloat16), b, hq, hkv, sq, sk,
                 d, bq, bk, maxb, *tail)
    build.raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def sparse_attend(q, k, v, kv_indices, kv_counts, rowmax, *, threshold=None,
                  causal=True, window=None, scale=None, block_q=128,
                  block_k=128, route=None):
    """Kernel #6 on CUDA tensors, its plain version on CPU tensors.
    ``route`` as for :func:`sparse_rowmax`; alone, the call decides from
    (D, Dv)."""
    if build.route(q) == "plain":
        return sparse_attend_plain(q, k, v, kv_indices, kv_counts, rowmax,
                                   threshold=threshold, causal=causal,
                                   window=window, scale=scale,
                                   block_q=block_q, block_k=block_k)
    b, hq, hkv, sq, sk, d, dv, bq, bk, _, _, maxb = _check(
        q, k, v, kv_indices, kv_counts, block_q, block_k)
    build.check_launch("a3 sparse", (q, k, v),
                       (kv_indices, kv_counts, rowmax), (d, dv), MAX_HEAD_DIM)
    if rowmax.dtype != torch.float32 or \
            tuple(rowmax.shape) != (b, hkv, hq // hkv, sq):
        raise ValueError("rowmax must be float32 [B, Hkv, G, Sq]")
    route = _pick_route(route, q.dtype, d, dv, bq, bk, _aligned(q, k, v))
    scale = d ** -0.5 if scale is None else scale
    has_win, win = build.window_args(window, sq, sk)
    has_thr, thr = (0, 0.0) if threshold is None else (1, float(threshold))
    out = torch.empty((b, hq, sq, dv), dtype=q.dtype, device=q.device)
    name = f"a3_sparse_attend_{route}"
    fn = build.entry(SOURCE, *_ARGTYPES[name])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_indices.data_ptr(),
            kv_counts.data_ptr(), rowmax.data_ptr(), out.data_ptr())
    tail = (scale, int(causal), has_win, win, has_thr, thr,
            build.stream(q.device))
    if route == "wgmma":
        err = fn(*ptrs, b, hq, hkv, sq, sk, d, dv, maxb, *tail)
    else:
        err = fn(*ptrs, int(q.dtype == torch.bfloat16), b, hq, hkv, sq, sk,
                 d, dv, bq, bk, maxb, *tail)
    build.raise_on(err, name)
    LAUNCHES[name] += 1
    return out


def a3_sparse_attention(
    q: torch.Tensor,                # [B, Hq, Sq, D]
    k: torch.Tensor,                # [B, Hkv, Sk, D]
    v: torch.Tensor,                # [B, Hkv, Sk, Dv]
    kv_indices: torch.Tensor,       # [B, Hkv|Hq, nq_blocks, max_blocks] int32
    kv_counts: torch.Tensor,        # [B, Hkv|Hq, nq_blocks] int32
    *,
    threshold: Optional[float] = None,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Block-sparse A^3 attention with the GQA group folded into the rows
    (the reference's arguments minus ``interpret``): kernel #5, then #6,
    both on the route :func:`sparse_route` picks for the pair.

    ``kv_indices``/``kv_counts`` are per kv head; per-query-head maps are
    unioned across each GQA group first (a superset)."""
    hq, hkv = q.shape[1], k.shape[1]
    group = hq // hkv
    if kv_counts.dim() != 3 or kv_counts.shape[:2] not in (
            (q.shape[0], hkv), (q.shape[0], hq)):
        raise ValueError(f"kv_counts {tuple(kv_counts.shape)} is neither "
                         f"per kv head nor per query head")
    if kv_indices.shape[1] == hq and group > 1:
        nk = k.shape[2] // min(block_k, k.shape[2])
        kv_indices, kv_counts = union_block_map_gqa(kv_indices, kv_counts,
                                                    group, nk)
    kw = dict(causal=causal, window=window, scale=scale, block_q=block_q,
              block_k=block_k)
    kw["route"] = sparse_route(q.dtype, q.shape[3], v.shape[3],
                               min(block_q, q.shape[2]),
                               min(block_k, k.shape[2]), _aligned(q, k, v))
    rm = sparse_rowmax(q, k, kv_indices, kv_counts, **kw)
    return sparse_attend(q, k, v, kv_indices, kv_counts, rm,
                         threshold=threshold, **kw)
