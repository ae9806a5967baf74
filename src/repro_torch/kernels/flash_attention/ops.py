"""Public entry point for fused attention (port of
``repro.kernels.flash_attention.ops``).

The reference's ``use_kernel``/``interpret`` switch is gone: the tensors'
device decides (CUDA tensors -> the hand-written kernel, CPU tensors ->
its plain version). ``attention_ref`` stays the dense oracle.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    return flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                           block_q=block_q, block_k=block_k)
