"""Chunkwise mLSTM kernel for Hopper, with its plain version.

Ports ``repro/kernels/mlstm_chunk/kernel.py::_mlstm_kernel``: the
chunkwise-parallel mLSTM forward, sequential over chunks of L = min(chunk,
S) tokens, quadratic gate-decay attention inside a chunk and the (C, n, m)
matrix-memory state carried between chunks. The kernel is hand-written
CUDA C++ in ``repro_torch/csrc/mlstm_chunk.cu`` (see the note there for
the bound and the design), with two routes chosen before the launch
(``kernel_route``): bf16 streams with Dk and Dv multiples of 64 up to 256
and a chunk length L that is a multiple of 64 run on the tensor cores
(wgmma + TMA); float32 streams and every other shape on the CUDA cores.

Beyond the Pallas kernel, both routes take an optional carried state
``state = (C [B,H,Dk,Dv], n [B,H,Dk], m [B,H])`` (float32; None = zeros
and m = -1e30, the Pallas kernel's start) and return the final state on
request, as the model's chunk loop needs; with no state they compute
exactly ``_mlstm_kernel``. Both write h in float32 (the Pallas kernel
casts it to q's dtype; ``ops.mlstm_chunk`` does that). S need not be a
multiple of L: a short last chunk is the Pallas kernel's padded chunk
without its pad rows, which change neither the real rows nor the state.

The device of the tensors decides the route: CUDA tensors launch the
kernel (or raise), CPU tensors take the plain PyTorch version, which
repeats the Pallas kernel's arithmetic chunk by chunk. There is no
fallback from the kernel to the plain version.

``LAUNCHES`` counts kernel launches by route (plain calls do not count).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
SOURCE = "mlstm_chunk.cu"
MAX_HEAD_DIM = 256          # a 64-row q tile of Dk + 1 floats in shared memory
MAX_CHUNK = 256             # gate arrays of one chunk in shared memory

# launches per route: the tensor-core kernel and the CUDA-core kernel
LAUNCHES = {"mlstm_chunk_wgmma": 0, "mlstm_chunk_simt": 0}
WGMMA_TILE = 64             # the tensor-core route's strip and column tile

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "mlstm_chunk_simt": ("mlstm_chunk_fwd", [_P] * 12 + [_I] * 6 + [_F, _P]),
    "mlstm_chunk_wgmma": ("mlstm_chunk_fwd_wgmma",
                          [_P] * 12 + [_I] * 5 + [_F, _I, _P]),
}
SMS = 132                   # streaming multiprocessors of an H100 SXM


def launches() -> int:
    """Launches of kernel #7 over both routes."""
    return sum(LAUNCHES.values())


def t_split(bh: int, dv: int, sms: int = SMS) -> int:
    """CTAs per (batch x head, 64 value columns) of the tensor-core
    route: 2 (the pair splits each chunk's t strips and both carry the
    state) while the doubled grid still fits one wave of the card's
    SMs, else 1."""
    return 2 if 2 * bh * (dv // WGMMA_TILE) <= sms else 1


def kernel_route(dtype: torch.dtype, dk: int, dv: int, chunk_len: int,
                 aligned: bool = True) -> str:
    """The kernel a CUDA call takes, decided before the launch:
    ``"mlstm_chunk_wgmma"`` for bf16 streams with Dk and Dv multiples of
    64 up to 256, a chunk length L = min(chunk, S) that is a multiple of
    64 (the strips of the wgmma tiles; a short last chunk is fine) and
    16-byte aligned q/k/v (what TMA takes), else ``"mlstm_chunk_simt"``
    (float32 streams, other head dims, other chunk lengths)."""
    if dtype == torch.bfloat16 and aligned and \
            chunk_len % WGMMA_TILE == 0 and 0 < chunk_len <= MAX_CHUNK and \
            all(x % WGMMA_TILE == 0 and 0 < x <= MAX_HEAD_DIM
                for x in (dk, dv)):
        return "mlstm_chunk_wgmma"
    return "mlstm_chunk_simt"


def _check(q, k, v, log_i, log_f, chunk, state) -> Tuple[int, ...]:
    """Shapes as the Pallas wrapper takes them -> (b, h, s, dk, dv, L)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("mlstm_chunk expects q/k [B,H,S,Dk], v [B,H,S,Dv]")
    b, h, s, dk = q.shape
    dv = v.shape[3]
    if tuple(k.shape) != (b, h, s, dk) or tuple(v.shape[:3]) != (b, h, s):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if tuple(log_i.shape) != (b, h, s) or tuple(log_f.shape) != (b, h, s):
        raise ValueError(f"gates must be [B,H,S]={(b, h, s)}, got "
                         f"{tuple(log_i.shape)}, {tuple(log_f.shape)}")
    if state is not None:
        C, n, m = state
        if tuple(C.shape) != (b, h, dk, dv) or tuple(n.shape) != (b, h, dk) \
                or tuple(m.shape) != (b, h):
            raise ValueError("state must be C [B,H,Dk,Dv], n [B,H,Dk], "
                             "m [B,H]")
    if s < 1 or chunk < 1:
        raise ValueError(f"need S >= 1 and chunk >= 1, got {s}, {chunk}")
    return b, h, s, dk, dv, min(chunk, s)


def mlstm_chunk_plain(q, k, v, log_i, log_f, *, chunk: int = 256,
                      scale: float = 1.0, state: Optional[State] = None,
                      return_state: bool = False):
    """Plain version of the chunk kernel (#7): ``_mlstm_kernel``'s
    arithmetic, chunk by chunk, from ``state`` -> h [B,H,S,Dv] float32
    (and the final (C, n, m) when ``return_state``)."""
    b, h, s, dk, dv, L = _check(q, k, v, log_i, log_f, chunk, state)
    dev = q.device
    if state is None:
        C = torch.zeros((b, h, dk, dv), device=dev)
        n = torch.zeros((b, h, dk), device=dev)
        m = torch.full((b, h), NEG_INF, device=dev)
    else:
        C, n, m = (t.float() for t in state)
    out = torch.empty((b, h, s, dv), device=dev)
    for c0 in range(0, s, L):
        c1 = min(c0 + L, s)
        qc = q[:, :, c0:c1].float()
        kc = k[:, :, c0:c1].float() * scale
        vc = v[:, :, c0:c1].float()
        li = log_i[:, :, c0:c1].float()
        f_cum = torch.cumsum(log_f[:, :, c0:c1].float(), -1)
        f_tot = f_cum[..., -1]
        # intra-chunk decay D[t, u] = F[t] - F[u] + li[u], causal
        dmat = f_cum[..., :, None] - f_cum[..., None, :] + li[..., None, :]
        causal = torch.ones((c1 - c0, c1 - c0), dtype=torch.bool,
                            device=dev).tril()
        dmat = torch.where(causal, dmat, NEG_INF)
        inter_log = f_cum + m[..., None]
        m_row = torch.maximum(dmat.amax(-1), inter_log)
        w = torch.exp(dmat - m_row[..., None])
        sc = torch.einsum("bhtd,bhud->bhtu", qc, kc) * w
        inter_w = torch.exp(inter_log - m_row)
        num = torch.einsum("bhtu,bhud->bhtd", sc, vc) + inter_w[..., None] \
            * torch.einsum("bhtk,bhkv->bhtv", qc, C)
        qn = torch.einsum("bhtk,bhk->bht", qc, n)
        den = sc.sum(-1) + inter_w * qn
        den = torch.maximum(den.abs(), torch.exp(-m_row))
        out[:, :, c0:c1] = num / den[..., None]
        # ---- state update to the end of the chunk ----
        wr_log = f_tot[..., None] - f_cum + li
        m_new = torch.maximum(f_tot + m, wr_log.amax(-1))
        f_eff = torch.exp(f_tot + m - m_new)
        kw = kc * torch.exp(wr_log - m_new[..., None])[..., None]
        C = f_eff[..., None, None] * C + torch.einsum("bhuk,bhuv->bhkv", kw,
                                                      vc)
        n = f_eff[..., None] * n + kw.sum(-2)
        m = m_new
    return (out, (C, n, m)) if return_state else out


def mlstm_chunk_kernel(q, k, v, log_i, log_f, *, chunk: int = 256,
                       scale: float = 1.0, state: Optional[State] = None,
                       return_state: bool = False):
    """Kernel #7 on CUDA tensors, its plain version on CPU tensors (the
    reference's arguments minus ``interpret``, plus ``state`` and
    ``return_state``) -> h [B,H,S,Dv] float32 (and the final (C, n, m)
    float32 when ``return_state``)."""
    if build.route(q) == "plain":
        return mlstm_chunk_plain(q, k, v, log_i, log_f, chunk=chunk,
                                 scale=scale, state=state,
                                 return_state=return_state)
    b, h, s, dk, dv, L = _check(q, k, v, log_i, log_f, chunk, state)
    gates = (log_i, log_f) + (tuple(state) if state is not None else ())
    build.check_launch("mlstm_chunk", (q, k, v), gates, (dk,), MAX_HEAD_DIM)
    if any(t.dtype != torch.float32 for t in gates):
        raise ValueError("mlstm_chunk gates and state must be float32")
    if L > MAX_CHUNK:
        raise ValueError(f"chunk {L} exceeds {MAX_CHUNK}")
    dev = q.device
    out = torch.empty((b, h, s, dv), dtype=torch.float32, device=dev)
    if return_state:
        final = (torch.empty((b, h, dk, dv), device=dev),
                 torch.empty((b, h, dk), device=dev),
                 torch.empty((b, h), device=dev))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    st_in = state if state is not None else (None, None, None)
    st_out = final if return_state else (None, None, None)
    name = kernel_route(q.dtype, dk, dv, L, all(t.data_ptr() % 16 == 0
                                               for t in (q, k, v)))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
            log_f.data_ptr(), *map(ptr, st_in), out.data_ptr(),
            *map(ptr, st_out))
    fn = build.entry(SOURCE, *_ARGTYPES[name])
    if name == "mlstm_chunk_wgmma":
        err = fn(*ptrs, b * h, s, dk, dv, L, scale, t_split(b * h, dv),
                 build.stream(dev))
    else:
        err = fn(*ptrs, int(q.dtype == torch.bfloat16), b * h, s, dk, dv, L,
                 scale, build.stream(dev))
    build.raise_on(err, name)
    LAUNCHES[name] += 1
    return (out, final) if return_state else out
