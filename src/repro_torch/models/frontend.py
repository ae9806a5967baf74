"""Modality frontend stubs of the port (counterpart of
``repro.models.frontend``): the ``[audio]`` / ``[vlm]`` archs specify the
transformer backbone only, and the frontend supplies precomputed frame /
patch embeddings.

* musicgen-medium: EnCodec tokenizer -> 4 parallel codebooks at 50 Hz.
  The four codebook embeddings are summed into one frame embedding
  (MusicGen's "delay" interleaving collapses to a single stream for the
  backbone); :func:`audio_frame_embeds` returns pseudo-frames.
* internvl2-2b: InternViT-300M patch encoder. :func:`vision_patch_embeds`
  returns pseudo patch embeddings already projected to the LM width; the
  text tokens follow them (prefix-LM layout collapsed to causal decode).

Each function draws from an explicit ``torch.Generator`` and returns
tensors on that generator's device. They make pseudo-data with the
reference's distributions, not the reference's numbers: ``jax.random``
and ``torch.Generator`` are different streams.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.decoder import DTYPES


def audio_frame_embeds(generator: torch.Generator, batch: int, frames: int,
                       cfg: ModelConfig,
                       num_codebooks: Optional[int] = None) -> torch.Tensor:
    """Stub EnCodec frontend: [B, frames, d_model] summed codebook
    embeddings, the sum of ``nc`` standard normals over sqrt(nc) (unit
    variance), in ``cfg.dtype``."""
    nc = num_codebooks or cfg.num_codebooks
    shape = (batch, frames, cfg.d_model)
    out = torch.zeros(shape, dtype=torch.float32, device=generator.device)
    for _ in range(nc):
        out += torch.randn(shape, generator=generator,
                           device=generator.device)
    return (out / math.sqrt(float(nc))).to(DTYPES[cfg.dtype])


def vision_patch_embeds(generator: torch.Generator, batch: int, patches: int,
                        cfg: ModelConfig) -> torch.Tensor:
    """Stub InternViT frontend: [B, patches, d_model] patch embeddings."""
    x = torch.randn((batch, patches, cfg.d_model), generator=generator,
                    device=generator.device)
    return x.to(DTYPES[cfg.dtype])


def vlm_sequence(generator: torch.Generator, batch: int, seq_len: int,
                 num_patches: int, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The [vision patches; text] layout of the internvl2 examples ->
    (patch embeddings [B, num_patches, D], text tokens
    [B, seq_len - num_patches] int32)."""
    vis = vision_patch_embeds(generator, batch, num_patches, cfg)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq_len - num_patches),
                         generator=generator, device=generator.device,
                         dtype=torch.int32)
    return vis, toks
