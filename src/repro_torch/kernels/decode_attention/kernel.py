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
per ``block_k`` tile, masked scores at -1e30; a ring that ``block_k``
does not divide is one tile). There is no fallback from the kernel to
the plain version.

With ``partial=True`` #1 and #3 hand out a partial softmax that another
rank's slice of the ring can be combined with (``ops.combine_partials``):
a float32 output and its log-sum-exp (#1) or row sum (#3). Each launch
is a custom op (``torch.ops.repro_torch.decode_attention_*``), so fake
tensors and ``FlopCounterMode`` see it; :func:`need` is its accounting.

``LAUNCHES`` counts kernel launches per kernel (plain calls do not
count), so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.utils.flop_counter

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
    "decode_attention_fused": [_P] * 7 + [_I] * 9 + [_F, _I, _F, _P],
    "decode_attention_rowmax": [_P] * 4 + [_I] * 9 + [_F, _P],
    "decode_attention_attend": [_P] * 8 + [_I] * 10 + [_F, _I, _F, _P],
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
        # the Pallas kernel asserts here; a ring that block_k does not
        # divide (max_len 1064) is one tile, the exact threshold rule of
        # the reference's jnp path, which its models decode through
        bk = s
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


def _emit(acc, l, q, partial=False):
    b, hq = q.shape[:2]
    out = torch.where(l == 0.0, 0.0, acc / torch.where(l == 0.0, 1.0, l))
    out = out.reshape(b, hq, acc.shape[-1])
    return out if partial else out.to(q.dtype)


def fused_plain(q, k, v, mask, *, threshold=None, scale=None, block_k=512,
                partial=False):
    """Plain version of the fused kernel (#1). ``partial``: (float32
    output, its log-sum-exp m + log l [B, Hq], NEG_INF where l == 0)."""
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
    out = _emit(acc, l, q, partial)
    if not partial:
        return out
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(l))
    return out, lse.reshape(b, hq)


def rowmax_plain(q, k, mask, *, scale=None, block_k=512):
    """Plain version of the row-max kernel (#2): float32 [B, Hq]."""
    b, hq, hkv, s, d, _, bk = _check(q, k, None, mask, block_k)
    scale = d ** -0.5 if scale is None else scale
    m = torch.full((b, hkv, hq // hkv), NEG_INF, device=q.device)
    for _, sc, mt in _tiles(q, k, mask, scale, bk):
        m = torch.maximum(m, torch.where(mt, sc, NEG_INF).amax(-1))
    return m.reshape(b, hq)


def attend_plain(q, k, v, mask, rowmax, *, threshold=None, scale=None,
                 block_k=512, partial=False):
    """Plain version of the attend kernel (#3) given pass 1's row max.
    ``partial``: (float32 output, its row sum l [B, Hq])."""
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
    out = _emit(acc, l, q, partial)
    return (out, l.reshape(b, hq)) if partial else out


def decode_attention_plain(q, k, v, mask, *, threshold=None, scale=None,
                           block_k=512, exact_two_pass=False):
    if not exact_two_pass:
        return fused_plain(q, k, v, mask, threshold=threshold, scale=scale,
                           block_k=block_k)
    rm = rowmax_plain(q, k, mask, scale=scale, block_k=block_k)
    return attend_plain(q, k, v, mask, rm, threshold=threshold, scale=scale,
                        block_k=block_k)


# ---------------------------------------------------------------------------
# what a launch needs: the dry run's accounting and the card's bound
# ---------------------------------------------------------------------------

def need(b: int, hq: int, hkv: int, s: int, d: int, dv: int, *,
         pv: bool, itemsize: int = 2, out_itemsize: Optional[int] = None,
         stats_in: int = 0, stats_out: int = 0) -> Tuple[int, int]:
    """(bytes, operations) of one launch over every ring row: q, K (and V
    with ``pv``) and the uint8 mask read once, the output written once
    (``out_itemsize`` bytes an element, the inputs' by default; none
    without ``pv``), plus ``stats_in`` / ``stats_out`` float32 [B, Hq]
    vectors (a row max read, a log-sum-exp or row sum written); 2 D
    operations per (query row, key) score and 2 Dv per weighted V row
    (``pv``). The operations are what ``FlopCounterMode`` counts on the
    plain route of the same shapes."""
    out_itemsize = itemsize if out_itemsize is None else out_itemsize
    nbytes = (b * hq * d + b * hkv * s * (d + (dv if pv else 0))) \
        * itemsize + b * hq * s + (b * hq * dv * out_itemsize if pv else 0) \
        + 4 * b * hq * (stats_in + stats_out)
    flops = 2 * b * hq * s * (d + (dv if pv else 0))
    return nbytes, flops


def _shape_need(q, k, v, *, pv, partial=False, stats_in=0):
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    return need(b, hq, hkv, s, d, v.shape[3] if v is not None else d,
                pv=pv, itemsize=q.element_size(),
                out_itemsize=4 if partial else None, stats_in=stats_in,
                stats_out=int(partial or not pv))


def call_need_fused(q, k, v, mask, scale, block_k, has_thr, thr, partial,
                    **_) -> Tuple[int, int]:
    """:func:`need` of one call of the #1 op, from its arguments."""
    return _shape_need(q, k, v, pv=True, partial=partial)


def call_need_rowmax(q, k, mask, scale, block_k, **_) -> Tuple[int, int]:
    """:func:`need` of one call of the #2 op (writes the row max)."""
    return _shape_need(q, k, None, pv=False)


def call_need_attend(q, k, v, mask, rm, scale, block_k, has_thr, thr,
                     partial, **_) -> Tuple[int, int]:
    """:func:`need` of one call of the #3 op (reads the row max)."""
    return _shape_need(q, k, v, pv=True, partial=partial, stats_in=1)


# ---------------------------------------------------------------------------
# the launches, as custom ops: ``FakeTensorMode`` runs their shape
# functions and ``FlopCounterMode`` counts them by :func:`need` (a ctypes
# launch is invisible to both), so the dry run traces the card's route
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor) -> Optional[int]:
    return t.data_ptr() if t.numel() else None


def _outputs(q, dv, partial):
    """(out, partial out, statistic): the normalised output in q's dtype,
    or a float32 output and a float32 [B, Hq] statistic; the unused ones
    empty."""
    b, hq = q.shape[:2]
    if partial:
        return (q.new_empty(0), q.new_empty((b, hq, dv), dtype=torch.float32),
                q.new_empty((b, hq), dtype=torch.float32))
    return q.new_empty((b, hq, dv)), q.new_empty(0, dtype=torch.float32), \
        q.new_empty(0, dtype=torch.float32)


@torch.library.custom_op("repro_torch::decode_attention_fused",
                         mutates_args=())
def _fused_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, scale: float, block_k: int, has_thr: bool,
              thr: float, partial: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of #1 -> (output, log-sum-exp): the output in q's dtype
    and an empty second tensor, or with ``partial`` float32 and its
    log-sum-exp."""
    b, hq, hkv, s, d, dv, bk = _check(q, k, v, mask, block_k)
    out, pout, lse = _outputs(q, dv, partial)
    err = _entry("decode_attention_fused")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        _ptr(out), _ptr(pout), _ptr(lse), int(q.dtype == torch.bfloat16), b,
        hq, hkv, s, d, dv, bk, cluster_size(s, bk), scale, int(has_thr), thr,
        build.stream(q.device))
    build.raise_on(err, "decode_attention_fused")
    LAUNCHES["decode_attention_fused"] += 1
    return (pout, lse) if partial else (out, lse)


@_fused_op.register_fake
def _(q, k, v, mask, scale, block_k, has_thr, thr, partial):
    out, pout, lse = _outputs(q, v.shape[3], partial)
    return (pout, lse) if partial else (out, lse)


@torch.library.custom_op("repro_torch::decode_attention_rowmax",
                         mutates_args=())
def _rowmax_op(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor,
               scale: float, block_k: int) -> torch.Tensor:
    """One launch of #2 -> the row max, float32 [B, Hq]."""
    b, hq, hkv, s, d, _, bk = _check(q, k, None, mask, block_k)
    out = q.new_empty((b, hq), dtype=torch.float32)
    err = _entry("decode_attention_rowmax")(
        q.data_ptr(), k.data_ptr(), mask.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, hq, hkv, s, d, bk,
        two_pass_cluster_size(s), int(score_route(k) == "vec"), scale,
        build.stream(q.device))
    build.raise_on(err, "decode_attention_rowmax")
    LAUNCHES["decode_attention_rowmax"] += 1
    return out


@_rowmax_op.register_fake
def _(q, k, mask, scale, block_k):
    return q.new_empty(q.shape[:2], dtype=torch.float32)


@torch.library.custom_op("repro_torch::decode_attention_attend",
                         mutates_args=())
def _attend_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor, rm: torch.Tensor, scale: float,
               block_k: int, has_thr: bool, thr: float, partial: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of #3 -> (output, row sum), as :func:`_fused_op`."""
    b, hq, hkv, s, d, dv, bk = _check(q, k, v, mask, block_k)
    out, pout, lsum = _outputs(q, dv, partial)
    err = _entry("decode_attention_attend")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        rm.data_ptr(), _ptr(out), _ptr(pout), _ptr(lsum),
        int(q.dtype == torch.bfloat16), b, hq, hkv, s, d, dv, bk,
        two_pass_cluster_size(s), int(score_route(k) == "vec"), scale,
        int(has_thr), thr, build.stream(q.device))
    build.raise_on(err, "decode_attention_attend")
    LAUNCHES["decode_attention_attend"] += 1
    return (pout, lsum) if partial else (out, lsum)


@_attend_op.register_fake
def _(q, k, v, mask, rm, scale, block_k, has_thr, thr, partial):
    out, pout, lsum = _outputs(q, v.shape[3], partial)
    return (pout, lsum) if partial else (out, lsum)


def _flops_of(call_need):
    def formula(*args, out_val=None, **kwargs) -> int:
        return call_need(*args, **kwargs)[1]
    return formula


for _op, _need in ((torch.ops.repro_torch.decode_attention_fused,
                    call_need_fused),
                   (torch.ops.repro_torch.decode_attention_rowmax,
                    call_need_rowmax),
                   (torch.ops.repro_torch.decode_attention_attend,
                    call_need_attend)):
    torch.utils.flop_counter.register_flop_formula(_op, get_raw=True)(
        _flops_of(_need))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _thr(threshold) -> Tuple[bool, float]:
    return (False, 0.0) if threshold is None else (True, float(threshold))


def fused(q, k, v, mask, *, threshold=None, scale=None, block_k=512,
          partial=False):
    """Kernel #1 on CUDA tensors, its plain version on CPU tensors ->
    the output in q's dtype, or with ``partial`` (float32 output, its
    log-sum-exp [B, Hq]) for :func:`ops.combine_partials`."""
    if build.route(q) == "plain":
        return fused_plain(q, k, v, mask, threshold=threshold, scale=scale,
                           block_k=block_k, partial=partial)
    _, _, _, _, d, dv, _ = _check(q, k, v, mask, block_k)
    build.check_launch("decode_attention", (q, k, v), (mask,), (d, dv),
                       MAX_HEAD_DIM)
    scale = d ** -0.5 if scale is None else scale
    out, lse = torch.ops.repro_torch.decode_attention_fused(
        q, k, v, mask, float(scale), int(block_k), *_thr(threshold),
        bool(partial))
    return (out, lse) if partial else out


def rowmax(q, k, mask, *, scale=None, block_k=512):
    """Kernel #2 on CUDA tensors, its plain version on CPU tensors."""
    if build.route(q) == "plain":
        return rowmax_plain(q, k, mask, scale=scale, block_k=block_k)
    _, _, _, _, d, _, _ = _check(q, k, None, mask, block_k)
    build.check_launch("decode_attention", (q, k), (mask,), (d,),
                       MAX_HEAD_DIM)
    scale = d ** -0.5 if scale is None else scale
    return torch.ops.repro_torch.decode_attention_rowmax(
        q, k, mask, float(scale), int(block_k))


def attend(q, k, v, mask, rm, *, threshold=None, scale=None, block_k=512,
           partial=False):
    """Kernel #3 on CUDA tensors, its plain version on CPU tensors ->
    the output in q's dtype, or with ``partial`` (float32 output, its row
    sum [B, Hq])."""
    if build.route(q) == "plain":
        return attend_plain(q, k, v, mask, rm, threshold=threshold,
                            scale=scale, block_k=block_k, partial=partial)
    b, hq, _, _, d, dv, _ = _check(q, k, v, mask, block_k)
    build.check_launch("decode_attention", (q, k, v), (mask, rm), (d, dv),
                       MAX_HEAD_DIM)
    if rm.dtype != torch.float32 or tuple(rm.shape) != (b, hq):
        raise ValueError("rowmax must be float32 [B, Hq]")
    scale = d ** -0.5 if scale is None else scale
    out, lsum = torch.ops.repro_torch.decode_attention_attend(
        q, k, v, mask, rm, float(scale), int(block_k), *_thr(threshold),
        bool(partial))
    return (out, lsum) if partial else out


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
