"""Train step: loss -> autograd -> AdamW, with microbatch gradient
accumulation and per-layer remat (PyTorch port of ``repro.train.step``,
single device).

The reference's mesh machinery — ``param_specs``, activation shardings,
the ``shard_map`` over a pod axis with int8-compressed gradients — waits
for a device mesh in the port (ROADMAP queue 1, launch and analysis
tooling); the port's ``ShardingConfig`` refuses the fields that would
ask for it.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import RunConfig
from repro_torch.models import decoder
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update


class TrainState(NamedTuple):
    model: decoder.Decoder
    opt: OptState


def make_train_state(model: decoder.Decoder, run: RunConfig) -> TrainState:
    """``model`` with gradients on, and a zero AdamW state for it."""
    model.requires_grad_(True)
    return TrainState(model, adamw_init(dict(model.named_parameters()),
                                        run.optimizer))


def init_train_state(run: RunConfig, generator: torch.Generator,
                     device="cuda") -> TrainState:
    """Random weights drawn from ``generator`` (the reference's
    distributions), gradients on, zero AdamW state."""
    return make_train_state(decoder.init_params(run.model, generator, device),
                            run)


def empty_train_state(run: RunConfig, device="cuda") -> TrainState:
    """A state of the right shapes with uninitialised weights: the target
    a checkpoint restores into."""
    return make_train_state(decoder.Decoder(run.model,
                                            device=resolve_device(device)),
                            run)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


def _grads_one(model, cfg, batch, remat, attn_chunk, ce_chunk=512):
    total, _ = decoder.lm_loss(model, cfg, batch["tokens"], batch["labels"],
                               remat=remat, attn_chunk=attn_chunk,
                               ce_chunk=ce_chunk)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()))
    return total.detach(), dict(zip(params, grads))


def _grads_accumulated(model, cfg, batch, remat, attn_chunk, n_micro):
    """Gradient accumulation over microbatches, in float32, each
    microbatch's grads divided by ``n_micro`` and the loss averaged.

    As in the reference, ``_grads_one`` is called without ``ce_chunk``
    here, so a microbatched step always takes the default chunk of 512
    tokens whatever ``ShardingConfig.ce_chunk`` says."""
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} is not a multiple of {n_micro} "
                         f"microbatches")
    mb = b // n_micro
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in model.named_parameters()}
    loss = torch.zeros((), device=model.device)
    for i in range(n_micro):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        l_i, g_i = _grads_one(model, cfg, micro, remat, attn_chunk)
        for n, g in g_i.items():
            acc[n] += g.float() / n_micro
        loss = loss + l_i / n_micro
    return loss, acc


def make_train_step(run: RunConfig
                    ) -> Callable[[TrainState, Dict],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step: ``step(state, batch) -> (state, metrics)``, with
    ``batch`` {"tokens", "labels"} [B, S] (numpy or tensors; moved to the
    model's device) and metrics {"loss", "grad_norm", "lr"} as device
    tensors. The state's parameters and moments are updated in place."""
    cfg = run.model
    remat = run.sharding.remat
    attn_chunk = run.sharding.attn_chunk
    ce_chunk = run.sharding.ce_chunk
    n_micro = run.sharding.microbatches

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        dev = state.model.device
        batch = {k: _as_tensor(batch[k], dev) for k in ("tokens", "labels")}
        if n_micro > 1:
            loss, grads = _grads_accumulated(state.model, cfg, batch, remat,
                                             attn_chunk, n_micro)
        else:
            loss, grads = _grads_one(state.model, cfg, batch, remat,
                                     attn_chunk, ce_chunk)
        _, opt, opt_metrics = adamw_update(
            grads, state.opt, dict(state.model.named_parameters()),
            run.optimizer)
        return TrainState(state.model, opt), {"loss": loss, **opt_metrics}

    return step
