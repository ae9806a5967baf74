"""Carry weights from the JAX reference's parameter tree into the port.

The reference tree (``repro.models.decoder.init_params``) is nested dicts
of arrays: ``embed`` [Vp, d], ``final_norm.scale``, ``lm_head`` [d, Vp]
and per segment ``seg{i}`` the layer parameters stacked on a leading
``layers`` axis. Its dense weights are ``[d_in, d_out]`` and used as
``x @ W``; the port's ``nn.Linear`` weights are ``[d_out, d_in]``, so
they are transposed on the way in. Values are copied bit for bit. The
xLSTM leaves keep their own layout except the dense projections: mLSTM
``wq``/``wk``/``wv``/``w_o``/``w_out`` and sLSTM ``wx``/``w_out`` are
transposed; the gates ``w_i``/``w_f``/``b_i``/``b_f``, the recurrent
``wr``, the bias ``b`` and the norm scales go over as they are. The
RG-LRU's dense ``w_in_gate``/``w_in_rnn``/``w_a``/``w_x``/``w_out`` are
transposed, its ``conv_w``/``conv_b``/``lam`` go over as they are. A GELU
FFN has no ``w_gate``. An MoE keeps the reference's layout for its
``router`` [d, E] and expert stacks [E, d_in, d_out]; its ``shared``
SwiGLU is transposed as a dense FFN is. All of that is one rule: an
``nn.Linear``'s ``.weight`` is transposed, every other parameter keeps the
reference's layout (:func:`reference_leaf`).

A training state's parameters go over the same way
(:func:`train_state_from_numpy`: gradients on, fresh AdamW moments), and
so does any tree shaped like the parameters — a tree of gradients lands
on the parameter names of the port. MemN2N's parameters keep their
layout (:func:`memn2n_from_numpy`).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.models.decoder import Decoder


def reference_leaf(name: str) -> Tuple[Tuple[str, ...], Optional[int],
                                       bool]:
    """Where a port parameter lives in the reference tree -> (path, layer,
    transposed). ``segs.{i}.layers.{l}.<rest>`` is row ``l`` of the
    stacked leaf ``seg{i}/<rest>``; every other name is a leaf of its own
    (``layer`` None). A ``.weight`` is an ``nn.Linear``'s, stored
    ``[d_out, d_in]`` where the reference keeps ``[d_in, d_out]``
    (``transposed``); every other parameter has the reference's layout.
    This is the one layout map: :func:`params_from_numpy` carries values
    over by it and ``sharding.rules`` derives the port's specs from it."""
    parts = name.split(".")
    transposed = parts[-1] == "weight"
    if transposed:
        parts = parts[:-1]
    if parts[0] == "segs":
        return (f"seg{parts[1]}", *parts[4:]), int(parts[3]), transposed
    return tuple(parts), None, transposed


def _reference_value(tree: Mapping[str, Any], name: str):
    """The value of port parameter ``name`` in the reference tree, in the
    port's layout (numpy, float32)."""
    path, layer, transposed = reference_leaf(name)
    arr = tree
    for key in path:
        arr = arr[key]
    arr = np.asarray(arr if layer is None else arr[layer]).astype(np.float32)
    return arr.T if transposed else arr


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device="cuda") -> Decoder:
    """The reference parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) -> a :class:`Decoder` on ``device``.

    Arrays pass through float32, which holds bf16 and f32 values
    exactly, so a bf16 tree arrives bit-identical."""
    model = Decoder(cfg, device=resolve_device(device))
    with torch.no_grad():
        for name, p in model.named_parameters():
            t = torch.from_numpy(np.ascontiguousarray(
                _reference_value(tree, name)))
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} into "
                                 f"{tuple(p.shape)}")
            p.copy_(t.to(p.dtype))
    return model


def train_state_from_numpy(tree: Mapping[str, Any], run, device="cuda",
                           mesh=None):
    """The parameters of a reference ``TrainState`` (numpy) -> the port's
    :class:`~repro_torch.train.step.TrainState`: the model with gradients
    on and a zero AdamW state. On ``mesh`` each rank keeps its shard of
    what :func:`params_from_numpy` gives (``sharding.rules`` layout)."""
    from repro_torch.train.step import make_train_state
    return make_train_state(params_from_numpy(tree, run.model, device), run,
                            mesh)


def memn2n_from_numpy(tree: Mapping[str, Any], device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    """The reference's MemN2N parameters (``embeddings``, ``temporal``,
    ``query_embed``, ``w_final``; numpy) -> the port's name -> tensor
    dict, float32 and in the same layout."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(tree[name], dtype=np.float32)
                                   ).to(dev)
            for name in ("embeddings", "temporal", "query_embed", "w_final")}
