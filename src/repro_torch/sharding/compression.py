"""Int8 gradient compression with error feedback for the cross-pod
all-reduce (PyTorch port of ``repro.sharding.compression``).

On a multi-pod mesh the ``pod`` axis crosses the slowest link of the
system. The gradient is compressed before the cross-pod reduction and the
quantization residual kept locally ("error feedback"), added back into
the next step's gradient so the bias does not accumulate (Seide et al.,
1-bit SGD lineage).

Scheme per leaf:
  scale  = all_reduce_max(|g + e|) / 127   (one scalar collective; taken
           as amax * float32(1/127), which is what XLA computes for the
           reference's ``amax / 127.0`` under jit, where it always runs)
  q      = round((g + e) / scale)  in int8
  g_hat  = all_reduce_sum(q) * scale / n_pods   (int8 on the wire,
                                                 summed as int32)
  e'     = (g + e) - dequant(q)             (kept local, fed back)

``torch.round`` and ``jnp.round`` both round half to even, so the int8
payload is the reference's bit for bit.
"""
from __future__ import annotations

from typing import Dict, Hashable, Mapping, Optional, Tuple

import torch
import torch.distributed as dist


def compress_int8(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    q = torch.round(g.float() / scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def psum_compressed(grads: Mapping[str, torch.Tensor], group=None,
                    err: Optional[Mapping[str, torch.Tensor]] = None, *,
                    scale_key: Optional[Mapping[str, Hashable]] = None,
                    amax_group=None
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """All-reduce ``grads`` (name -> this rank's gradient) over ``group``
    (a process group; a mesh dim's is ``mesh.get_group("pod")``; None the
    default group) with int8 compression and error feedback -> (mean
    gradient in each leaf's dtype, new float32 error state).

    Each leaf has its own scale, the amax of the whole leaf. A caller
    whose tensors are pieces of the reference's leaves says so:
    ``scale_key`` (name -> key) gives the tensors of one key one scale
    (the layers of one of the reference's stacked leaves), and
    ``amax_group`` (default ``group``) is the group the amax is taken
    over, one that also spans the other shards of a sharded leaf. The
    amaxes go in one collective."""
    n = dist.get_world_size(group)
    key = scale_key or {name: name for name in grads}
    # error feedback folds into the gradient BEFORE the amax: the scale
    # must cover g + e, otherwise feedback can exceed the int8 grid,
    # clip, and re-enter the residual every step instead of draining
    gf = {name: g.float() if err is None else g.float() + err[name]
          for name, g in grads.items()}
    keys = list(dict.fromkeys(key[name] for name in grads))
    local = {}
    for name, t in gf.items():
        m = t.abs().max()
        local[key[name]] = m if key[name] not in local else torch.maximum(
            local[key[name]], m)
    amax = torch.stack([local[k] for k in keys])
    dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                    group=group if amax_group is None else amax_group)
    scales = dict(zip(keys, torch.clamp(amax * (1.0 / 127.0), min=1e-12)))
    mean, new_err = {}, {}
    for name, g in grads.items():
        scale = scales[key[name]]
        q = compress_int8(gf[name], scale)
        new_err[name] = gf[name] - decompress_int8(q, scale)
        # int8 payload, accumulated in int32 (no overflow across pods)
        total = q.to(torch.int32)
        dist.all_reduce(total, group=group)
        mean[name] = (total.float() * scale / n).to(g.dtype)
    return mean, new_err
