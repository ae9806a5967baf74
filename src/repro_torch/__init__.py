"""PyTorch + CUDA port of the A^3 serving stack (``src/repro`` is the
JAX reference). Entry points run on the card unless the caller asks for
the CPU; see :func:`resolve_device`."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) raises
    when no card is present: only an explicit ``"cpu"`` runs on the CPU,
    there is no silent fallback. Float32 matmuls and convolutions are
    pinned to full precision (no TF32), as the reference computes them."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
