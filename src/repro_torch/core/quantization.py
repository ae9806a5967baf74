"""A^3 fixed-point quantization and the two-LUT exponent (paper SSIII-A/B),
PyTorch port of ``repro.core.quantization``.

Values stay in float32 but are rounded and clipped to the fixed-point
grid (fake quantization). Every grid is built in float32 whatever the
input dtype — a bf16 mantissa cannot hold ``x * 2^f`` — and the result
is cast back to the input dtype. ``torch.round`` rounds half to even, as
``jnp.round`` does.

The exponent unit decomposes ``e^x = e^{x_hi} * e^{x_lo}`` over the split
fixed-point fraction so two small LUTs replace one huge one (SSIII-A).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch


def quantize_fixed_point(x: torch.Tensor, int_bits: int,
                         frac_bits: int) -> torch.Tensor:
    """Round-to-nearest fixed point with ``int_bits``/``frac_bits`` + sign,
    range [-(2^i - 2^-f), 2^i - 2^-f]; rounded in float32, returned in
    the input dtype."""
    x = torch.as_tensor(x)
    scale = 2.0 ** frac_bits
    limit = 2.0 ** int_bits - 2.0 ** (-frac_bits)
    q = torch.round(x.float() * scale) / scale
    return torch.clamp(q, -limit, limit).to(x.dtype)


class LutExp(NamedTuple):
    """Two-LUT exponent for non-positive fixed-point inputs.

    ``x <= 0`` is ``-k * 2^-frac_bits`` with ``k`` an unsigned integer of
    ``total_bits`` bits, split into high/low halves that index one table
    each: e^{-(hi+lo)·2^-f} = LUT_hi[hi] · LUT_lo[lo].
    """
    hi_table: torch.Tensor       # [2^hi_bits]
    lo_table: torch.Tensor       # [2^lo_bits]
    frac_bits: int
    lo_bits: int
    total_bits: int
    out_frac_bits: int

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """exp(x) for x <= 0 through the two tables; index and output
        register arithmetic in float32, result in the input dtype."""
        x = torch.as_tensor(x)
        scale = 2.0 ** self.frac_bits
        kmax = 2 ** self.total_bits - 1
        k = torch.clamp(torch.round(-x.float() * scale), 0, kmax).long()
        lo = k & ((1 << self.lo_bits) - 1)
        hi = k >> self.lo_bits
        y = (self.hi_table.to(x.device)[hi]
             * self.lo_table.to(x.device)[lo]).float()
        # the multiplier's output register keeps out_frac_bits fraction bits
        oscale = 2.0 ** self.out_frac_bits
        return (torch.round(y * oscale) / oscale).to(x.dtype)

    @property
    def table_entries(self) -> int:
        return self.hi_table.shape[0] + self.lo_table.shape[0]


def make_lut_exp(frac_bits: int, total_bits: int,
                 lo_bits: Optional[int] = None,
                 out_frac_bits: Optional[int] = None,
                 dtype=torch.float32) -> LutExp:
    """Build the two tables (reference ``make_lut_exp``): ``frac_bits``
    fraction bits of the non-positive input, ``total_bits`` of index."""
    if lo_bits is None:
        lo_bits = total_bits // 2
    hi_bits = total_bits - lo_bits
    if out_frac_bits is None:
        out_frac_bits = frac_bits
    step = 2.0 ** (-frac_bits)
    lo_idx = torch.arange(2 ** lo_bits, dtype=dtype)
    hi_idx = torch.arange(2 ** hi_bits, dtype=dtype)
    lo_table = torch.exp(-lo_idx * step)
    hi_table = torch.exp(-hi_idx * step * (2.0 ** lo_bits))
    return LutExp(hi_table=hi_table, lo_table=lo_table, frac_bits=frac_bits,
                  lo_bits=lo_bits, total_bits=total_bits,
                  out_frac_bits=out_frac_bits)


@functools.lru_cache(maxsize=None)
def cached_lut_exp(frac_bits: int, total_bits: int) -> LutExp:
    """One shared :func:`make_lut_exp` per ``(frac_bits, total_bits)``."""
    return make_lut_exp(frac_bits=frac_bits, total_bits=total_bits)


def softmax_fixed_point(scores: torch.Tensor, frac_bits: int,
                        lut: Optional[LutExp] = None,
                        mask: Optional[torch.Tensor] = None,
                        axis: int = -1) -> torch.Tensor:
    """Softmax with the paper's quantized exponent path: subtract the max,
    exponentiate through the LUT pair, keep the weights at 2*frac_bits
    fraction bits. Computed in float32, returned in the input dtype."""
    if lut is None:
        # 2f fraction bits of the score register + 5 integer bits
        # (e^-32 underflows any fixed-point weight register)
        lut = cached_lut_exp(2 * frac_bits, 2 * frac_bits + 5)
    scores = torch.as_tensor(scores)
    out_dtype = scores.dtype
    s = scores.float()
    neg_inf = torch.finfo(torch.float32).min
    if mask is not None:
        s = torch.where(mask, s, neg_inf)
    mx = s.amax(dim=axis, keepdim=True)
    e = lut(s - mx)
    if mask is not None:
        e = torch.where(mask, e, 0.0)
    denom = e.sum(dim=axis, keepdim=True)
    w = e / torch.clamp(denom, min=torch.finfo(torch.float32).tiny)
    scale = 2.0 ** (2 * frac_bits)
    return (torch.round(w * scale) / scale).to(out_dtype)


# ---------------------------------------------------------------------------
# int8 block quantization (the serving cache's ``kv_quant=int8``):
# symmetric round-to-nearest, q = round(x / s), s = amax / 127 per block
# ---------------------------------------------------------------------------

def quantize_int8_block(x: torch.Tensor, axes: Tuple[int, ...]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` to int8 with one float32 scale per block; ``axes`` are the
    dimensions reduced into each scale, kept at size 1 in ``scale``."""
    xf = torch.as_tensor(x).float()
    amax = torch.amax(xf.abs(), dim=tuple(axes), keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8_block(q: torch.Tensor, scale: torch.Tensor,
                          dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8_block` (scale broadcasts)."""
    return (q.float() * scale).to(dtype)
