"""Carry weights from the JAX reference's parameter tree into the port.

The reference tree (``repro.models.decoder.init_params``) is nested dicts
of arrays: ``embed`` [Vp, d], ``final_norm.scale``, ``lm_head`` [d, Vp]
and per segment ``seg{i}`` the layer parameters stacked on a leading
``layers`` axis. Its dense weights are ``[d_in, d_out]`` and used as
``x @ W``; the port's ``nn.Linear`` weights are ``[d_out, d_in]``, so
they are transposed on the way in. Values are copied bit for bit.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models.decoder import Decoder


def _put(dst: torch.Tensor, src: Any, transpose: bool = False) -> None:
    arr = np.asarray(src)
    t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
    if transpose:
        t = t.t()
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: {tuple(t.shape)} into "
                         f"{tuple(dst.shape)}")
    dst.copy_(t.to(dst.dtype))


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device="cuda") -> Decoder:
    """The reference parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) -> a :class:`Decoder` on ``device``.

    Arrays pass through float32, which holds bf16 and f32 values
    exactly, so a bf16 tree arrives bit-identical."""
    model = Decoder(cfg, device=resolve_device(device))
    with torch.no_grad():
        _put(model.embed, tree["embed"])
        _put(model.final_norm.scale, tree["final_norm"]["scale"])
        if not cfg.tie_embeddings:
            _put(model.lm_head.weight, tree["lm_head"], transpose=True)
        for si, seg_mod in enumerate(model.segs):
            st = tree[f"seg{si}"]
            for l, blk in enumerate(seg_mod.layers):
                _put(blk.ln1.scale, st["ln1"]["scale"][l])
                _put(blk.ln2.scale, st["ln2"]["scale"][l])
                for name in ("wq", "wk", "wv", "wo"):
                    _put(getattr(blk.attn, name).weight,
                         st["attn"][name][l], transpose=True)
                for name in ("w_gate", "w_up", "w_down"):
                    if name in st["ffn"]:
                        _put(getattr(blk.ffn, name).weight,
                             st["ffn"][name][l], transpose=True)
    return model
