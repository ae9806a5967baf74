"""RG-LRU recurrent block of RecurrentGemma / Griffin (PyTorch port of
``repro.models.rglru``).

    r_t = sigmoid(x_t W_a)            # recurrence gate
    i_t = sigmoid(x_t W_x)            # input gate
    a_t = exp(c * r_t * log(sigmoid(Lambda)))      (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Block layout: in-projections to a gate and an rnn branch, a causal
depthwise conv of width 4 on the rnn branch, the RG-LRU, gelu(gate) * h,
the out-projection. Decode carries the conv tail ``[B, 3, C]`` (model
dtype) and ``h`` ``[B, C]`` (float32).

The linear recurrence runs as a log-depth scan in torch ops (a
Hillis-Steele prefix of the pairs (a, b) under (a1, b1) . (a2, b2) =
(a1 a2, b1 a2 + b2), inside chunks of 512 tokens with ``h`` carried
between chunks), as the reference runs ``lax.associative_scan`` inside
chunks: a few dozen kernels per chunk, not a Python loop per token.
Results differ from the reference's only by the association of the
products.

Parameters are named as the reference's leaves: the dense projections
``w_in_gate``/``w_in_rnn``/``w_a``/``w_x``/``w_out`` are ``nn.Linear``
weights ([d_out, d_in], the reference's transposed); ``conv_w`` [4, C]
and ``conv_b`` [C] keep the model dtype and ``lam`` [C] float32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.models.common import _linear, dense_init_, gelu

CONV_WIDTH = 4
LRU_C = 8.0
SCAN_CHUNK = 512


class RGLRU(nn.Module):
    def __init__(self, d_model: int, d_rnn: int, dtype, device=None):
        super().__init__()
        self.w_in_gate = _linear(d_model, d_rnn, dtype, device)
        self.w_in_rnn = _linear(d_model, d_rnn, dtype, device)
        self.conv_w = nn.Parameter(torch.empty((CONV_WIDTH, d_rnn),
                                               dtype=dtype, device=device))
        self.conv_b = nn.Parameter(torch.empty((d_rnn,), dtype=dtype,
                                               device=device))
        self.w_a = _linear(d_rnn, d_rnn, dtype, device)
        self.w_x = _linear(d_rnn, d_rnn, dtype, device)
        self.lam = nn.Parameter(torch.empty((d_rnn,), dtype=torch.float32,
                                            device=device))
        self.w_out = _linear(d_rnn, d_model, dtype, device)


def rglru_init_(p: RGLRU, generator: torch.Generator) -> None:
    """The reference's ``rglru_init`` distributions: N(0, 1/d_in) dense
    weights, N(0, 1/4) conv taps, zero conv bias, and ``lam`` so that
    a = sigmoid(lam)^c spans [0.9, 0.999] over the channels."""
    for lin in (p.w_in_gate, p.w_in_rnn, p.w_a, p.w_x, p.w_out):
        dense_init_(lin, generator)
    d_rnn = p.lam.shape[0]
    with torch.no_grad():
        p.conv_w.copy_(torch.randn(p.conv_w.shape, generator=generator,
                                   device=p.conv_w.device)
                       / math.sqrt(CONV_WIDTH))
        p.conv_b.zero_()
        a = torch.linspace(0.9, 0.999, d_rnn, device=p.lam.device)
        p.lam.copy_(torch.logit(torch.exp(torch.log(a) / LRU_C)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 buf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv of width CONV_WIDTH over x [B, S, C]; ``buf``
    [B, CONV_WIDTH-1, C] is the context before x (zeros when None)."""
    bsz, s, c = x.shape
    if buf is None:
        buf = x.new_zeros((bsz, CONV_WIDTH - 1, c))
    xp = torch.cat([buf.to(x.dtype), x], 1)              # [B, S+3, C]
    out = torch.zeros((bsz, s, c), dtype=torch.float32, device=x.device)
    for i in range(CONV_WIDTH):
        out = out + xp[:, i:i + s].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _lru_gates(p: RGLRU, xc: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, float32."""
    r = torch.sigmoid(F.linear(xc, p.w_a.weight).float())
    i = torch.sigmoid(F.linear(xc, p.w_x.weight).float())
    log_a = LRU_C * r * F.logsigmoid(p.lam.float())
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xc.float())
    return a, b


def _lru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
              ) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h0, by a log-depth
    inclusive scan of the (a, b) pairs; h = B_t + A_t h0."""
    s = a.shape[1]
    d = 1
    while d < s:
        a_prev, b_prev = a[:, :s - d], b[:, :s - d]
        b = torch.cat([b[:, :d], b_prev * a[:, d:] + b[:, d:]], 1)
        a = torch.cat([a[:, :d], a_prev * a[:, d:]], 1)
        d *= 2
    return b + a * h0[:, None]


def _lru_scan_chunked(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                      chunk: int = SCAN_CHUNK) -> torch.Tensor:
    """:func:`_lru_scan` inside chunks of ``chunk`` tokens, carrying h
    between chunks (bounds the scan's intermediates to O(chunk))."""
    hs, h = [], h0.float()
    for lo in range(0, a.shape[1], chunk):
        hc = _lru_scan(a[:, lo:lo + chunk], b[:, lo:lo + chunk], h)
        hs.append(hc)
        h = hc[:, -1]
    return torch.cat(hs, 1)


def _out(p: RGLRU, gate: torch.Tensor, h: torch.Tensor,
         dtype) -> torch.Tensor:
    return F.linear((gate * h).to(dtype), p.w_out.weight)


def rglru_apply_scan(p: RGLRU, x: torch.Tensor,
                     h0: Optional[torch.Tensor] = None,
                     conv_buf: Optional[torch.Tensor] = None,
                     chunk: int = SCAN_CHUNK
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence block, x [B, S, D] -> (out [B, S, D], h_last [B, C]
    float32, conv tail [B, 3, C])."""
    bsz = x.shape[0]
    gate = gelu(F.linear(x, p.w_in_gate.weight).float())
    xr = F.linear(x, p.w_in_rnn.weight)
    xc = _causal_conv(xr, p.conv_w, p.conv_b, conv_buf)
    a, b = _lru_gates(p, xc)
    if h0 is None:
        h0 = torch.zeros((bsz, a.shape[-1]), device=x.device)
    h = _lru_scan_chunked(a, b, h0, chunk)
    prev = conv_buf if conv_buf is not None else \
        xr.new_zeros((bsz, CONV_WIDTH - 1, xr.shape[-1]))
    new_buf = torch.cat([prev.to(xr.dtype), xr], 1)[:, -(CONV_WIDTH - 1):]
    return _out(p, gate, h, x.dtype), h[:, -1], new_buf


def rglru_chunk_step(p: RGLRU, x: torch.Tensor, h0: torch.Tensor,
                     conv_buf: torch.Tensor, valid: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ragged mid-prompt chunk with carried state: x [B, C, D], h0
    [B, C_rnn] float32, conv_buf [B, 3, C_rnn], valid [B, C] bool. Pad
    positions carry the recurrence through unchanged (a = 1, b = 0), so
    ``h_last`` is the state after each lane's last valid token, and the
    conv tail advances to each lane's last 3 valid rows (gathered per
    lane; a lane with no valid token keeps its tail)."""
    gate = gelu(F.linear(x, p.w_in_gate.weight).float())
    xr = F.linear(x, p.w_in_rnn.weight)
    xc = _causal_conv(xr, p.conv_w, p.conv_b, conv_buf)
    a, b = _lru_gates(p, xc)
    v = valid[..., None]
    a = torch.where(v, a, 1.0)
    b = torch.where(v, b, 0.0)
    h = _lru_scan_chunked(a, b, h0.float())
    # ext[b, j] = buf[j] for j < 3, else xr[j - 3]; rows length ..
    # length + 2 are the lane's last three valid ones
    length = valid.sum(1)
    ext = torch.cat([conv_buf.to(xr.dtype), xr], 1)
    idx = length[:, None] + torch.arange(CONV_WIDTH - 1, device=x.device)
    new_buf = torch.gather(
        ext, 1, idx[..., None].expand(-1, -1, ext.shape[-1]))
    return _out(p, gate, h, x.dtype), h[:, -1], new_buf


def rglru_decode_step(p: RGLRU, x: torch.Tensor, h: torch.Tensor,
                      conv_buf: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One token: x [B, 1, D], h [B, C] float32, conv_buf [B, 3, C] ->
    (out [B, 1, D], h, conv_buf)."""
    gate = gelu(F.linear(x, p.w_in_gate.weight).float())
    xr = F.linear(x, p.w_in_rnn.weight)
    xc = _causal_conv(xr, p.conv_w, p.conv_b, conv_buf)
    a, b = _lru_gates(p, xc)
    h_new = a[:, 0] * h + b[:, 0]
    new_buf = torch.cat([conv_buf.to(xr.dtype), xr], 1)[:, 1:]
    return _out(p, gate, h_new[:, None], x.dtype), h_new, new_buf
