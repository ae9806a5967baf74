"""Logical-axis sharding rules: parameters -> specs -> DTensor placements
(PyTorch port of ``repro.sharding.rules``).

Parallelism mapping, as in the reference:
  * ``data`` mesh axis  — DP over the batch + FSDP (ZeRO-3) over one
    weight dim; SP (sequence sharding) when the batch is too small.
  * ``model`` mesh axis — TP over heads / FFN width; EP over MoE experts
    when the expert count divides the axis.
  * ``pod`` mesh axis   — outer pure-DP axis (gradients cross pods once
    per step; optionally int8-compressed).

A spec is a tuple with ``PartitionSpec``'s meaning: per tensor dim
``None``, a mesh axis name, or a tuple of axis names (the major axis
first). Rules are intent-based: each weight leaf gets logical axes
("fsdp" | "tp" | "ep" | None) per dim from a name table, the intents are
lowered to mesh axes, and an assignment whose mesh-axis size does not
divide the dim is dropped (e.g. 8 grok experts on a 16-way model axis
fall back to TP inside each expert).

The tables speak of the reference's leaves. A port parameter's spec is
the reference leaf's, read through the one layout map
(``models.convert.reference_leaf``): the stacked layers axis dropped and
the two dims of an ``nn.Linear`` weight swapped.

The functions read only ``mesh.mesh_dim_names`` and ``mesh.shape``, so a
spec can be worked out for a mesh of any size without its ranks.
:func:`shardings_for` turns specs into DTensor placements, and
:func:`distribute` places a full tensor by them without a collective:
every rank cuts its own shard.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.config import ModelConfig, ShapeConfig, ShapeKind, \
    ShardingConfig
from repro_torch.models.convert import reference_leaf

Spec = Tuple[Any, ...]

# leaf name -> logical intent for the trailing (non-layer-stack) dims
_MATRIX_RULES: Dict[str, Optional[Tuple[Optional[str], ...]]] = {
    # attention / generic projections [D_in, D_out]
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    # FFN
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # recurrent blocks
    "w_in_gate": ("fsdp", "tp"), "w_in_rnn": ("fsdp", "tp"),
    "w_a": ("fsdp", "tp"), "w_x": ("fsdp", "tp"),
    "w_out": ("tp", "fsdp"), "wx": ("fsdp", "tp"),
    "w_o": ("fsdp", "tp"),
    # small per-channel tensors
    "conv_w": (None, "tp"), "conv_b": ("tp",), "lam": ("tp",),
    "w_i": ("fsdp", None), "w_f": ("fsdp", None),
    "b_i": (None,), "b_f": (None,), "b": ("tp",),
    "router": ("fsdp", None),
    "scale": (None,), "ln_scale": None,   # None -> replicate all dims
}

# MoE expert stacks [E, D_in, D_out]: EP on the expert dim when it
# divides the model axis, otherwise TP inside each expert.
_MOE_RULES: Dict[str, Tuple[Tuple[Optional[str], ...],
                            Tuple[Optional[str], ...]]] = {
    "w_gate": (("ep", "fsdp", None), (None, "fsdp", "tp")),
    "w_up": (("ep", "fsdp", None), (None, "fsdp", "tp")),
    "w_down": (("ep", None, "fsdp"), (None, "tp", "fsdp")),
}


def logical_to_mesh_axes(cfg: ShardingConfig) -> Dict[str, Optional[str]]:
    return {
        "fsdp": cfg.fsdp_axis if cfg.fsdp else None,
        "tp": cfg.tp_axis if cfg.tensor_parallel else None,
        "ep": cfg.ep_axis if cfg.expert_parallel else None,
    }


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (or anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def _sanitize(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
              mesh_shape: Dict[str, int]) -> Spec:
    """Drop assignments whose mesh-axis size doesn't divide the dim."""
    out = []
    for dim, ax in zip(shape, axes):
        if ax is None or ax not in mesh_shape or dim % mesh_shape[ax] != 0:
            out.append(None)
        else:
            out.append(ax)
    return tuple(out)


def _leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
               logical: Dict[str, Optional[str]],
               mesh_shape: Dict[str, int]) -> Spec:
    """The reference's spec of its leaf ``path`` of ``shape`` (a stacked
    segment leaf has its layers axis first)."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    stacked = path[0].startswith("seg")          # leading layers axis

    if name == "embed":       # [Vp, D]: vocab TP, width FSDP
        return _sanitize(tuple(logical.get(a) for a in ("tp", "fsdp")),
                         shape, mesh_shape)
    if name == "lm_head":
        return _sanitize(tuple(logical.get(a) for a in ("fsdp", "tp")),
                         shape, mesh_shape)

    if parent == "moe" and name in _MOE_RULES and len(shape) - stacked == 3:
        primary, fallback = _MOE_RULES[name]
        e_dim = shape[1] if stacked else shape[0]
        ep_ax = logical.get("ep")
        use = primary if (ep_ax and e_dim % mesh_shape.get(ep_ax, 1) == 0) \
            else fallback
        axes = tuple(logical.get(a) if a else None for a in use)
        if stacked:
            axes = (None,) + axes
        return _sanitize(axes, shape, mesh_shape)

    intent = _MATRIX_RULES.get(name)
    if intent is None:
        return ()                                 # replicate unknown leaves
    axes = tuple(logical.get(a) if a else None for a in intent)
    if stacked:
        axes = (None,) + axes
    if len(axes) != len(shape):                   # rank mismatch -> replicate
        if len(axes) < len(shape):
            axes = axes + (None,) * (len(shape) - len(axes))
        else:
            axes = axes[: len(shape)]
    return _sanitize(axes, shape, mesh_shape)


def param_spec(name: str, shape: Tuple[int, ...],
               logical: Dict[str, Optional[str]],
               mesh_shape: Dict[str, int]) -> Spec:
    """The spec of port parameter ``name`` of ``shape``: the reference
    leaf's spec through the layout map."""
    path, layer, transposed = reference_leaf(name)
    ref_shape = tuple(shape)[::-1] if transposed else tuple(shape)
    if layer is not None:
        ref_shape = (1,) + ref_shape     # the stacked layers axis (None)
    spec = _leaf_spec(path, ref_shape, logical, mesh_shape)
    spec = tuple(spec) + (None,) * (len(ref_shape) - len(spec))
    if layer is not None:
        spec = spec[1:]
    return spec[::-1] if transposed else spec


def param_specs(model: nn.Module, sharding_cfg: ShardingConfig,
                mesh) -> Dict[str, Spec]:
    """Parameter name -> spec of every parameter of ``model`` (on any
    device, "meta" included)."""
    logical = logical_to_mesh_axes(sharding_cfg)
    mesh_shape = mesh_sizes(mesh)
    return {name: param_spec(name, tuple(p.shape), logical, mesh_shape)
            for name, p in model.named_parameters()}


class Sharding(NamedTuple):
    """Where a tensor lives on a mesh: one DTensor placement per mesh
    dim (the port's ``NamedSharding``)."""
    mesh: Any
    placements: Tuple[Any, ...]


def placements_for(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec``: ``Shard(d)`` on every mesh dim
    that shards tensor dim ``d``, ``Replicate()`` on the others. A dim
    over several mesh axes is ``Shard(d)`` on each, and DTensor splits it
    in mesh-dim order, so the axes must be named major first in mesh
    order, as ``PartitionSpec`` reads them."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for k in idx:
            out[k] = Shard(d)
    return tuple(out)


def shardings_for(tree_specs: Any, mesh) -> Any:
    """Specs (one, or a dict of them, nested) -> :class:`Sharding`s."""
    if isinstance(tree_specs, Mapping):
        return {k: shardings_for(v, mesh) for k, v in tree_specs.items()}
    return Sharding(mesh, placements_for(tree_specs, mesh))


def local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements``: each mesh dim
    that shards splits the current piece evenly, in mesh-dim order, as a
    DTensor lays it out. A piece that is the whole tensor is ``full``
    itself; any other is a copy of its own."""
    coord = mesh.get_coordinate()
    piece = full
    for k, pl in enumerate(placements):
        if pl.is_shard() and mesh.size(k) > 1:
            piece = piece.chunk(mesh.size(k), dim=pl.dim)[coord[k]]
    return piece if piece.numel() == full.numel() else piece.clone(
        memory_format=torch.contiguous_format)


def distribute(full: torch.Tensor, sharding: Sharding):
    """A DTensor of ``full``'s values laid out by ``sharding``, cut on
    each rank from its own copy of ``full`` (no collective)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(
        local_shard(full.detach(), sharding.mesh, sharding.placements),
        sharding.mesh, sharding.placements, run_check=False,
        shape=full.shape, stride=full.stride())


def distribute_parameters(module: nn.Module, sharding_cfg: ShardingConfig,
                          mesh) -> nn.Module:
    """Make every parameter of ``module`` a DTensor laid out by
    :func:`param_specs` on ``mesh``; each rank keeps its shard of the
    full tensor it had (no collective) -> ``module``."""
    shardings = shardings_for(param_specs(module, sharding_cfg, mesh), mesh)
    for name, p in list(module.named_parameters()):
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        owner.register_parameter(leaf, nn.Parameter(
            distribute(p.detach(), shardings[name]),
            requires_grad=p.requires_grad))
    return module


# ---------------------------------------------------------------------------
# activation / input shardings
# ---------------------------------------------------------------------------

def _dp_axes(mesh_shape: Dict[str, int],
             cfg: Optional[ShardingConfig] = None) -> Tuple[str, ...]:
    names = cfg.dp_axes if cfg is not None else ("pod", "data", "ep")
    return tuple(a for a in names if a in mesh_shape)


def batch_spec(shape: ShapeConfig, mesh,
               sharding_cfg: Optional[ShardingConfig] = None) -> Spec:
    """Spec of [B, S] token inputs.

    Batch shards over (pod, data) when divisible; a batch too small for
    the data axis (long-context decode, B=1) switches to sequence
    parallelism: S shards over (data, model).
    """
    mesh_shape = mesh_sizes(mesh)
    dp_axes = _dp_axes(mesh_shape, sharding_cfg)
    dp = math.prod(mesh_shape[a] for a in dp_axes)
    if shape.global_batch % dp == 0 and shape.global_batch >= dp:
        return (dp_axes if len(dp_axes) > 1 else dp_axes[0], None)
    # SP fallback: sequence over (data, model)
    sp_axes = tuple(a for a in ("data", "model") if a in mesh_shape)
    sp = math.prod(mesh_shape[a] for a in sp_axes)
    if shape.seq_len % sp == 0:
        return (None, sp_axes)
    return (None, None)


def act_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
              sharding_cfg: Optional[ShardingConfig] = None
              ) -> Dict[str, Spec]:
    """Specs of the model's activation constraint points.

    hidden [B, S, D]: batch over (pod, data); if the batch is too small
      (long-context decode) the sequence shards over (data, model).
    q/k/v [B, H, S, Dh]: heads over model when divisible, otherwise the
      q sequence shards over model (attention sequence parallelism) and
      k/v stay head-replicated.
    """
    mesh_shape = mesh_sizes(mesh)
    dp_axes = _dp_axes(mesh_shape, sharding_cfg)
    dp = math.prod(mesh_shape[a] for a in dp_axes)
    tp_name = sharding_cfg.tp_axis if sharding_cfg else "model"
    model = mesh_shape.get(tp_name, 1)
    dp_spec = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes
                                                else None)
    b, s = shape.global_batch, shape.seq_len
    batch_ok = b % dp == 0 and b >= dp
    is_decode = shape.kind == ShapeKind.DECODE

    specs: Dict[str, Spec] = {}
    if batch_ok:
        specs["hidden"] = (dp_spec, None, None)
        hq, hkv = cfg.num_heads, cfg.num_kv_heads
        q_heads = tp_name if hq % model == 0 else None
        kv_heads = tp_name if hkv % model == 0 else None
        q_seq = None
        if q_heads is None and not is_decode and s % model == 0:
            q_seq = tp_name
        specs["q"] = (dp_spec, q_heads, q_seq, None)
        specs["kv"] = (dp_spec, kv_heads, None, None)
    elif not is_decode:
        fsdp_name = sharding_cfg.fsdp_axis if sharding_cfg else "data"
        sp_axes = tuple(a for a in (fsdp_name, tp_name) if a in mesh_shape)
        sp = math.prod(mesh_shape[a] for a in sp_axes)
        if s % sp == 0:
            specs["hidden"] = (None, sp_axes, None)
            specs["q"] = (None, None, sp_axes, None)
            specs["kv"] = (None, None, sp_axes, None)
    else:
        # decode with a tiny batch: replicate hidden; the cache's ring
        # shards over (data, model) (cache_specs)
        specs["hidden"] = (None, None, None)
    if is_decode and batch_ok:
        ring = tp_name if s % model == 0 else None
        specs["kv_cache"] = (dp_spec, None, ring, None)
        specs["q"] = (dp_spec,
                      tp_name if cfg.num_heads % model == 0 else None,
                      None, None)
        # A^3 sharded-selection stages: batch over dp, block axis over
        # the model axis
        specs["a3_blocks"] = (dp_spec, None, ring, None, None)
        specs["a3_prefix"] = (dp_spec, None, ring, None, None, None)
        specs["a3_greedy"] = (dp_spec, None, ring, None, None)
        specs["a3_scores"] = (dp_spec, None, ring, None)
    return specs


def cache_specs(cache_shape: Any, shape: ShapeConfig, mesh,
                sharding_cfg: Optional[ShardingConfig] = None) -> Any:
    """Specs of a decode cache (the reference's layout: per segment a
    dict of ``[L, B, ...]`` tensors).

    Attention K/V rings [L, B, Hkv, W, Dh]: batch over (pod, data) when
    divisible, ring length over model; for B=1 long context the ring
    shards over (data, model). Recurrent states [L, B, ...]: batch over
    (pod, data) when divisible.
    """
    mesh_shape = mesh_sizes(mesh)
    dp_axes = _dp_axes(mesh_shape, sharding_cfg)
    dp = math.prod(mesh_shape[a] for a in dp_axes)
    tp_name = sharding_cfg.tp_axis if sharding_cfg else "model"
    model = mesh_shape.get(tp_name, 1)
    dp_spec = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes
                                                else None)

    def spec(leaf) -> Spec:
        shp = tuple(leaf.shape)
        batch_ok = len(shp) >= 2 and shp[1] % dp == 0 and shp[1] >= dp
        if len(shp) == 5:                       # attention K/V ring
            w = shp[3]
            if batch_ok:
                ring = tp_name if w % model == 0 else None
                return (None, dp_spec, None, ring, None)
            fsdp_name = sharding_cfg.fsdp_axis if sharding_cfg else "data"
            axes = tuple(a for a in (fsdp_name, tp_name)
                         if a in mesh_shape)
            sp = math.prod(mesh_shape[a] for a in axes)
            if w % sp == 0:
                return (None, None, None, axes, None)
            return (None, None, None, None, None)
        # recurrent state [L, B, ...]
        axes = [None] * len(shp)
        if batch_ok:
            axes[1] = dp_spec
        return tuple(axes)

    def walk(tree):
        if isinstance(tree, Mapping):
            return {k: walk(v) for k, v in tree.items()}
        return spec(tree)

    return walk(cache_shape)
