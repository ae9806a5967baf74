"""Train step: loss -> autograd -> AdamW, with microbatch gradient
accumulation, per-layer remat and, on a device mesh, sharded state and
optional int8-compressed cross-pod gradients (PyTorch port of
``repro.train.step``).

Without a mesh the step runs on one device. With one
(``make_train_step(run, mesh)``, a ``DeviceMesh`` from
``launch.mesh.make_mesh``) it computes what the single-device step
computes over the same global batch, ZeRO-3 style:

* parameters, AdamW moments and the error-feedback state are DTensors
  laid out by ``sharding.rules.param_specs``: each rank holds only its
  shards;
* each rank takes its rows of the global batch by ``batch_spec`` (every
  rank is handed the same global batch); a rank that shares its rows
  with others along the model axis computes them as they do;
* each layer's weights are gathered just in time, inside the layer and
  so again in its remat recompute, and dropped after use; the gather's
  backward reduce-scatters the gradients into the shard layout;
* each rank's loss term is weighted so that the sum over ranks is the
  global loss, so the summed gradients are the global gradient; the MoE
  routes every row of the batch (``models.common.batch_rows``) as the
  single-device step does;
* the global-norm clip takes one all-reduce and counts every element
  once;
* with ``grad_compression`` on a mesh with a ``pod`` axis, gradients
  are summed within each pod only, then averaged across pods by
  ``sharding.compression.psum_compressed`` with error feedback, and the
  loss is averaged over pods (the reference's per-pod ``shard_map``).

Not done yet: the model-axis compute split (which heads a rank computes
where ``act_specs`` shards them); ranks along the model axis compute the
same rows in full, and only the storage is split.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.config import RunConfig
from repro_torch.models import decoder
from repro_torch.models.common import batch_rows
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update


class TrainState(NamedTuple):
    model: decoder.Decoder
    opt: OptState
    err: Optional[Dict[str, torch.Tensor]] = None  # error feedback (pods)


def make_train_state(model: decoder.Decoder, run: RunConfig,
                     mesh=None) -> TrainState:
    """``model`` with gradients on, and a zero AdamW state for it. With a
    ``mesh`` each parameter becomes a DTensor laid out by the rules (this
    rank keeps its shard of ``model``'s full tensor), the moments are
    sharded as the parameters, and ``grad_compression`` adds a float32
    error-feedback state sharded the same way."""
    model.requires_grad_(True)
    err = None
    if mesh is not None:
        from repro_torch.sharding.rules import distribute_parameters
        distribute_parameters(model, run.sharding, mesh)
        if run.sharding.grad_compression:
            err = {n: torch.zeros_like(p, dtype=torch.float32,
                                       requires_grad=False)
                   for n, p in model.named_parameters()}
    return TrainState(model, adamw_init(dict(model.named_parameters()),
                                        run.optimizer), err)


def init_train_state(run: RunConfig, generator: torch.Generator,
                     device="cuda", mesh=None) -> TrainState:
    """Random weights drawn from ``generator`` (the reference's
    distributions), gradients on, zero AdamW state; sharded on ``mesh``
    (every rank draws the same weights and keeps its shards)."""
    return make_train_state(decoder.init_params(run.model, generator, device),
                            run, mesh)


def empty_train_state(run: RunConfig, device="cuda", mesh=None
                      ) -> TrainState:
    """A state of the right shapes (and layout, on ``mesh``) with
    uninitialised weights: the target a checkpoint restores into."""
    return make_train_state(decoder.Decoder(run.model,
                                            device=resolve_device(device)),
                            run, mesh)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device)


def _grads_one(model, cfg, batch, remat, attn_chunk, ce_chunk=512):
    """(loss, name -> grad) of one batch. A leaf the loss does not reach
    gets a zero gradient, as ``jax.value_and_grad`` gives it: the untied
    ``embed`` table of a batch of precomputed ``embeds``, which AdamW then
    still decays."""
    total, _ = decoder.lm_loss(model, cfg, batch.get("tokens"),
                               batch["labels"],
                               inputs_embeds=batch.get("embeds"),
                               remat=remat, attn_chunk=attn_chunk,
                               ce_chunk=ce_chunk)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(total, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return total.detach(), dict(zip(params, grads))


def _grads_accumulated(model, cfg, batch, remat, attn_chunk, n_micro):
    """Gradient accumulation over microbatches, in float32, each
    microbatch's grads divided by ``n_micro`` and the loss averaged.

    As in the reference, ``_grads_one`` is called without ``ce_chunk``
    here, so a microbatched step always takes the default chunk of 512
    tokens whatever ``ShardingConfig.ce_chunk`` says."""
    b = batch["labels"].shape[0]
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


def make_train_step(run: RunConfig, mesh=None
                    ) -> Callable[[TrainState, Dict],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The train step: ``step(state, batch) -> (state, metrics)``, with
    ``batch`` {"tokens", "labels"} [B, S] or, for the frontend archs,
    {"embeds" [B, S, D], "labels"} (numpy or tensors; moved to the
    model's device) and metrics {"loss", "grad_norm", "lr"} as device
    tensors. The state's parameters and moments are updated in place.
    With a ``mesh`` the state must be sharded on it
    (``make_train_state(model, run, mesh)``) and ``batch`` is the global
    batch, the same on every rank.

    ``grad_compression`` needs a mesh with a ``pod`` axis: the reference
    ignores it without one, the port raises."""
    if run.sharding.grad_compression and (
            mesh is None or "pod" not in mesh.mesh_dim_names):
        raise ValueError("grad_compression needs a mesh with a 'pod' axis")
    if mesh is not None:
        return _sharded_step(run, mesh)
    cfg = run.model
    remat = run.sharding.remat
    attn_chunk = run.sharding.attn_chunk
    ce_chunk = run.sharding.ce_chunk
    n_micro = run.sharding.microbatches

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        dev = state.model.device
        batch = {k: _as_tensor(batch[k], dev)
                 for k in ("tokens", "embeds", "labels") if k in batch}
        if n_micro > 1:
            loss, grads = _grads_accumulated(state.model, cfg, batch, remat,
                                             attn_chunk, n_micro)
        else:
            loss, grads = _grads_one(state.model, cfg, batch, remat,
                                     attn_chunk, ce_chunk)
        _, opt, opt_metrics = adamw_update(
            grads, state.opt, dict(state.model.named_parameters()),
            run.optimizer)
        return TrainState(state.model, opt, state.err), \
            {"loss": loss, **opt_metrics}

    return step


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

class _Rows:
    """The batch rows of the ranks that sum their gradients together:
    ``count`` blocks laid out over ``submesh`` (major axis first), this
    rank's the ``index``-th (the plan ``models.common.batch_rows``
    carries)."""

    def __init__(self, submesh, index: int, count: int):
        self.submesh, self.index, self.count = submesh, index, count

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """[b, ...] of this rank -> [count * b, ...] of every block; the
        backward sums each block's gradient over the ranks."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        n = self.submesh.ndim
        dt = DTensor.from_local(x, self.submesh, [Shard(0)] * n,
                                run_check=False)
        return dt.redistribute(self.submesh, [Replicate()] * n).to_local(
            grad_placements=[Partial()] * n)

    def own(self, y: torch.Tensor) -> torch.Tensor:
        b = y.shape[0] // self.count
        return y[self.index * b:(self.index + 1) * b]


def _dims_of(entry) -> Tuple[str, ...]:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def _sharded_step(run: RunConfig, mesh):
    from torch.distributed.tensor import Partial, Replicate
    from torch.nn.utils.stateless import _reparametrize_module
    from repro_torch.models.convert import reference_leaf
    from repro_torch.sharding.compression import psum_compressed
    from repro_torch.sharding.rules import batch_spec, mesh_sizes

    cfg, sh = run.model, run.sharding
    names = tuple(mesh.mesh_dim_names)
    sizes = mesh_sizes(mesh)
    coord = dict(zip(names, mesh.get_coordinate()))
    compress = sh.grad_compression
    # gradients and loss terms are summed over these mesh dims (all but
    # the pods when the pods exchange compressed gradients)
    group_dims = tuple(n for n in names if not (compress and n == "pod"))
    group_size = math.prod(sizes[n] for n in group_dims)
    n_pods = sizes["pod"] if compress else 1
    batch_dims = _dims_of(batch_spec(run.shape, mesh, sh)[0])
    row_dims = tuple(n for n in batch_dims if n in group_dims)
    n_blocks = math.prod(sizes[n] for n in batch_dims)
    n_row_blocks = math.prod(sizes[n] for n in row_dims)
    rep = group_size // n_row_blocks      # ranks computing the same rows

    def block_of(c: Dict[str, int]) -> int:
        idx = 0
        for n in batch_dims:
            idx = idx * sizes[n] + c[n]
        return idx

    block = block_of(coord)
    # the blocks of the ranks this rank sums with (its own among them)
    group_blocks = sorted({block_of({**coord, **dict(zip(row_dims, c))})
                           for c in itertools.product(
                               *(range(sizes[n]) for n in row_dims))})
    row_index = 0
    for n in row_dims:
        row_index = row_index * sizes[n] + coord[n]
    rows = (_Rows(mesh[row_dims], row_index, n_row_blocks)
            if n_row_blocks > 1 else None)

    full_pl = (Replicate(),) * len(names)
    grad_pl = tuple(Partial() if n in group_dims else Replicate()
                    for n in names)

    def gather(p):
        """The full tensor of a sharded parameter, its gradient summed
        over ``group_dims`` and cut to ``p``'s layout in the backward."""
        return p.redistribute(mesh, full_pl).to_local(grad_placements=grad_pl)

    @contextlib.contextmanager
    def layer_context(blk):
        full = {n: gather(p) for n, p in blk.named_parameters()}
        with _reparametrize_module(blk, full), batch_rows(rows):
            yield

    remat = sh.remat
    attn_chunk = sh.attn_chunk
    n_micro = sh.microbatches
    ce_chunk = sh.ce_chunk if n_micro == 1 else 512   # as _grads_accumulated

    def grads_of(model, batch) -> Tuple[torch.Tensor, Dict]:
        """(this rank's loss term, name -> local gradient shard) of one
        global (micro)batch."""
        b = batch["labels"].shape[0]
        if b % n_blocks:
            raise ValueError(f"batch {b} does not split into {n_blocks} "
                             f"blocks of rows")
        per = b // n_blocks
        mine = {k: v[block * per:(block + 1) * per] for k, v in batch.items()}
        cnt = sum((batch["labels"][g * per:(g + 1) * per] != -1).float().sum()
                  for g in group_blocks)
        params = dict(model.named_parameters())
        top = {n: gather(p) for n, p in params.items()
               if not n.startswith("segs.")}
        with _reparametrize_module(model, top):
            h, aux = decoder.forward_hidden(
                model, cfg, mine.get("tokens"), mine.get("embeds"),
                remat=remat, attn_chunk=attn_chunk,
                layer_context=layer_context)
            nll, _ = decoder.chunked_nll(model, cfg, h, mine["labels"],
                                         ce_chunk)
            term = nll / (torch.clamp(cnt, min=1.0) * rep) \
                + aux["moe_aux_loss"] / group_size
            grads = torch.autograd.grad(term, list(params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        out = {}
        for (n, p), g in zip(params.items(), grads):
            if tuple(g.placements) != tuple(p.placements):
                g = g.redistribute(mesh, p.placements)
            out[n] = g.to_local()
        return term.detach(), out

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        model = state.model
        dev = model.device
        if dev.type == "cuda":      # the watchdog runs steps on a thread
            torch.cuda.set_device(dev)
        batch = {k: _as_tensor(batch[k], dev)
                 for k in ("tokens", "embeds", "labels") if k in batch}
        params = dict(model.named_parameters())
        if n_micro > 1:
            b = batch["labels"].shape[0]
            if b % n_micro:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"{n_micro} microbatches")
            mb = b // n_micro
            term = torch.zeros((), device=dev)
            grads = {n: torch.zeros_like(p.to_local(), dtype=torch.float32)
                     for n, p in params.items()}
            for i in range(n_micro):
                t_i, g_i = grads_of(model, {k: v[i * mb:(i + 1) * mb]
                                            for k, v in batch.items()})
                for n, g in g_i.items():
                    grads[n] += g.float() / n_micro
                term = term + t_i / n_micro
        else:
            term, grads = grads_of(model, batch)
        with torch.no_grad():
            if compress:
                # one scale per reference leaf, its amax over every shard
                # and pod of it (all ranks)
                err = {n: e.to_local() for n, e in state.err.items()}
                grads, new_err = psum_compressed(
                    grads, mesh.get_group("pod"), err,
                    scale_key={n: reference_leaf(n)[0] for n in grads},
                    amax_group=dist.group.WORLD)
                for n, e in new_err.items():
                    err[n].copy_(e)
            loss = term.clone()
            dist.all_reduce(loss)
            loss = loss / n_pods
            local = {n: p.to_local() for n, p in params.items()}
            m = {n: t.to_local() for n, t in state.opt.m.items()}
            v = {n: t.to_local() for n, t in state.opt.v.items()}
        # a replicated element is counted on the first rank that holds it
        owner = {n: all(coord[names[k]] == 0 for k, pl in
                        enumerate(p.placements) if not pl.is_shard())
                 for n, p in params.items()}

        def grad_norm(tree):
            sq = torch.zeros((), dtype=torch.float32, device=dev)
            for n, t in tree.items():
                if owner[n]:
                    sq = sq + torch.sum(torch.square(t.float()))
            dist.all_reduce(sq)
            return torch.sqrt(sq)

        _, opt, opt_metrics = adamw_update(
            grads, OptState(state.opt.step, m, v), local, run.optimizer,
            grad_norm=grad_norm)
        return TrainState(model, OptState(opt.step, state.opt.m,
                                          state.opt.v), state.err), \
            {"loss": loss, **opt_metrics}

    return step
