"""AdamW + cosine schedule + global-norm clipping (PyTorch port of
``repro.optim.adamw``).

Over a name -> tensor mapping (``dict(model.named_parameters())``
order). The update runs under ``torch.no_grad()`` as plain tensor ops,
leaf by leaf, in float32 (the reference's cast points): no
``torch.optim``, whose fused and foreach kernels would change the order
of operations and the clipping. Optimizer state dtypes follow
``OptimizerConfig.m_dtype`` / ``v_dtype`` (a bf16 first moment included);
each parameter is cast back to its own dtype.

One difference in style: the reference returns new arrays, while
:func:`adamw_update` writes the new parameters and moments **in place**
into the tensors it was given (a full-width model does not have the
memory for a second copy) and returns the same mappings. The step
counter, the schedule and the clip factor stay on the device: an update
reads nothing back to the host.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from repro_torch.config import OptimizerConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

Tree = Mapping[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor               # int32 scalar, on the params' device
    m: Dict[str, torch.Tensor]       # name -> first moment
    v: Dict[str, torch.Tensor]       # name -> second moment


def cosine_schedule(cfg: OptimizerConfig, step: torch.Tensor
                    ) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * lr (float32)."""
    step_f = torch.as_tensor(step).float()
    warm = cfg.lr * step_f / max(cfg.warmup_steps, 1)
    progress = (step_f - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    progress = torch.clamp(progress, 0.0, 1.0)
    floor = cfg.lr * cfg.min_lr_ratio
    cos = floor + 0.5 * (cfg.lr - floor) * (1 + torch.cos(math.pi
                                                          * progress))
    return torch.where(step_f < cfg.warmup_steps, warm, cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    sq = sum(torch.sum(torch.square(t.float())) for t in tree.values())
    return torch.sqrt(sq)


def adamw_init(params: Tree, cfg: OptimizerConfig) -> OptState:
    m_dt, v_dt = DTYPES[cfg.m_dtype], DTYPES[cfg.v_dtype]
    m = {n: torch.zeros(p.shape, dtype=m_dt, device=p.device)
         for n, p in params.items()}
    v = {n: torch.zeros(p.shape, dtype=v_dt, device=p.device)
         for n, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=m, v=v)


@torch.no_grad()
def adamw_update(grads: Tree, state: OptState, params: Tree,
                 cfg: OptimizerConfig
                 ) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step -> (params, new state, {"grad_norm", "lr"}).
    ``params`` and the state's moments are updated in place; ``grads``
    holds a gradient for every name of ``params``."""
    step = state.step + 1
    lr = cosine_schedule(cfg, step)

    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    step_f = step.float()
    bc1 = 1.0 - torch.pow(b1, step_f)
    bc2 = 1.0 - torch.pow(b2, step_f)

    for name, p in params.items():
        m, v = state.m[name], state.v[name]
        gf = grads[name].float() * clip
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (delta + cfg.weight_decay * pf)
        p.copy_(pf)
        m.copy_(m_new)
        v.copy_(v_new)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(step, state.m, state.v), metrics
