"""Public entry: the chunkwise mLSTM recurrent core (port of
``repro.kernels.mlstm_chunk.ops``).

The reference's ``use_kernel``/``interpret`` switch is gone: the tensors'
device decides (CUDA tensors -> the hand-written kernel, CPU tensors ->
its plain version). ``mlstm_chunk_ref`` stays the sequential oracle.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_kernel


def mlstm_chunk(q, k, v, log_i, log_f, *, chunk: int = 256,
                scale: float = 1.0) -> torch.Tensor:
    """q/k [B,H,S,Dk], v [B,H,S,Dv], gates [B,H,S] float32 -> h
    [B,H,S,Dv] in q's dtype, from the zero state (as the Pallas kernel)."""
    return mlstm_chunk_kernel(q, k, v, log_i, log_f, chunk=chunk,
                              scale=scale).to(q.dtype)
