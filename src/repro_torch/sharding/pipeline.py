"""GPipe-style pipeline-parallel microbatch schedule over a ``pipe`` mesh
axis, with neighbour sends and receives (PyTorch port of
``repro.sharding.pipeline``).

Not used by the production meshes ((data, model) and (pod, data,
model)), but kept as a substrate feature: stages hold disjoint layer
slices, microbatches stream through with point-to-point transfers
between neighbours, and the bubble fraction is (P-1)/(M+P-1) as usual.

The stage function must be shape-preserving ([mb, S, D] -> [mb, S, D]).
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist


def _stage_params(stage_params: Mapping[str, Any], stage: int):
    """This stage's slice of each leaf: a DTensor sharded over the pipe
    axis holds it locally, a full tensor is indexed."""
    from torch.distributed.tensor import DTensor
    return {k: (v.to_local()[0] if isinstance(v, DTensor) else v[stage])
            for k, v in stage_params.items()}


def pipeline_forward(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Mapping[str, Any],   # leaves with a leading [P_stages] axis
    x: torch.Tensor,                   # [M_microbatches, mb, S, D], every rank
    mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """Runs M microbatches through P stages, stage i on the rank at pipe
    coordinate i; returns the final outputs in microbatch order [M, mb,
    S, D] on every rank.

    The reference's ticks: over M + P - 1 ticks stage 0 ingests
    microbatch t, every other stage takes what its predecessor sent, a
    stage outside its active window passes its buffer on unchanged, and
    each tick's output goes round the ring to the next stage; the last
    stage keeps its finished microbatches and then gives them to every
    rank."""
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    params = _stage_params(stage_params, stage)
    ranks = dist.get_process_group_ranks(group)
    nxt_rank = ranks[(stage + 1) % n_stages]
    prev_rank = ranks[(stage - 1) % n_stages]

    m = x.shape[0]
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(m + n_stages - 1):
        inp = x[min(t, m - 1)] if stage == 0 else buf
        active = 0 <= t - stage < m
        y = stage_fn(params, inp) if active else buf
        if n_stages > 1:
            recv = torch.empty_like(y)
            # both transfers in one batch: no send/receive order to
            # deadlock on
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y.contiguous(), nxt_rank, group),
                    dist.P2POp(dist.irecv, recv, prev_rank, group)]):
                req.wait()
            buf = recv
        else:
            buf = y
        if stage == n_stages - 1 and active:
            outs[t - (n_stages - 1)] = y
    # only the last stage's outputs are real
    dist.broadcast(outs, src=ranks[n_stages - 1], group=group)
    return outs
