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
SwiGLU is transposed as a dense FFN is.

A training state's parameters go over the same way
(:func:`train_state_from_numpy`: gradients on, fresh AdamW moments), and
so does any tree shaped like the parameters — a tree of gradients lands
on the parameter names of the port. MemN2N's parameters keep their
layout (:func:`memn2n_from_numpy`).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import BlockKind, ModelConfig
from repro_torch.models.decoder import Decoder
from repro_torch.models.mixer import build_segments

# per block kind: (tree key, transposed dense leaves, leaves as they are)
_MIXER_LEAVES = {
    BlockKind.ATTENTION: ("attn", ("wq", "wk", "wv", "wo"), ()),
    BlockKind.RGLRU: ("rnn", ("w_in_gate", "w_in_rnn", "w_a", "w_x", "w_out"),
                      ("conv_w", "conv_b", "lam")),
    BlockKind.MLSTM: ("mlstm", ("wq", "wk", "wv", "w_o", "w_out"),
                      ("w_i", "w_f", "b_i", "b_f", "ln_scale")),
    BlockKind.SLSTM: ("slstm", ("wx", "w_out"), ("wr", "b", "ln_scale")),
}


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
        for si, (seg, seg_mod) in enumerate(zip(build_segments(cfg),
                                                model.segs)):
            st = tree[f"seg{si}"]
            key, dense, plain = _MIXER_LEAVES[seg.kind]
            for l, blk in enumerate(seg_mod.layers):
                _put(blk.ln1.scale, st["ln1"]["scale"][l])
                mix = getattr(blk, key)
                for name in dense:
                    _put(getattr(mix, name).weight, st[key][name][l],
                         transpose=True)
                for name in plain:
                    _put(getattr(mix, name), st[key][name][l])
                if seg.ffn == "none":
                    continue
                _put(blk.ln2.scale, st["ln2"]["scale"][l])
                if blk.ffn is not None:
                    _put_ffn(blk.ffn, st["ffn"], l)
                else:
                    moe = st["moe"]
                    for name in ("router", "w_gate", "w_up", "w_down"):
                        _put(getattr(blk.moe, name), moe[name][l])
                    if blk.moe.shared is not None:
                        _put_ffn(blk.moe.shared, moe["shared"], l)
    return model


def _put_ffn(ffn, tree: Mapping[str, Any], l: int) -> None:
    for name in ("w_gate", "w_up", "w_down"):
        if name in tree:
            _put(getattr(ffn, name).weight, tree[name][l], transpose=True)


def train_state_from_numpy(tree: Mapping[str, Any], run, device="cuda"):
    """The parameters of a reference ``TrainState`` (numpy) -> the port's
    :class:`~repro_torch.train.step.TrainState`: the model with gradients
    on and a zero AdamW state."""
    from repro_torch.train.step import make_train_state
    return make_train_state(params_from_numpy(tree, run.model, device), run)


def memn2n_from_numpy(tree: Mapping[str, Any], device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    """The reference's MemN2N parameters (``embeddings``, ``temporal``,
    ``query_embed``, ``w_final``; numpy) -> the port's name -> tensor
    dict, float32 and in the same layout."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(np.array(tree[name], dtype=np.float32)
                                   ).to(dev)
            for name in ("embeddings", "temporal", "query_embed", "w_final")}
