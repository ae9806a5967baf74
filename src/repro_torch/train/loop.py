"""Training loop: data pipeline + train step + checkpointing + watchdog,
wired for restart-from-checkpoint fault tolerance (PyTorch port of
``repro.train.loop``).

``train_loop`` is the single-invocation loop; ``train_with_recovery``
wraps it in the restart supervisor so an injected failure (tests) or a
real crash resumes from the latest checkpoint with the data pipeline
seeked to the right step. With ``mesh=`` both run the sharded step
(``train.step``): every rank draws the same batches and initial weights
from the seed, and the checkpoints hold the logical arrays.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.config import RunConfig
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import Watchdog, run_with_restarts
from repro_torch.train.step import TrainState, empty_train_state, \
    init_train_state, make_train_step


def seeded_state(run: RunConfig, device="cuda", mesh=None) -> TrainState:
    """The loop's default initial state: weights drawn from a generator
    on ``device`` seeded with ``run.seed`` (sharded on ``mesh``)."""
    dev = resolve_device(device)
    return init_train_state(run, torch.Generator(device=dev).manual_seed(
        run.seed), dev, mesh)


def train_loop(
    run: RunConfig,
    *,
    mesh=None,
    device="cuda",
    num_steps: Optional[int] = None,
    state: Optional[TrainState] = None,
    start_step: int = 0,
    ckpt: Optional[CheckpointManager] = None,
    hooks: Optional[List[Callable[[int, Dict], None]]] = None,
    fail_at_step: Optional[int] = None,       # test hook: inject a crash
) -> Dict[str, Any]:
    """Steps ``start_step .. num_steps - 1`` on ``SyntheticLM`` batches
    -> {"state", "losses", "final_step"}. ``state`` (default:
    :func:`seeded_state` on ``device`` and ``mesh``) is trained in place. Each step
    runs under the watchdog, which times it up to the loss's ``.item()``;
    every ``save_every`` steps the state and the data cursor
    (``extra={"data": pipeline.state}``) are checkpointed."""
    cfg = run.model
    num_steps = num_steps or run.optimizer.total_steps
    step_fn = make_train_step(run, mesh)
    if state is None:
        state = seeded_state(run, device, mesh)
    if ckpt is None:
        ckpt = CheckpointManager(run.checkpoint, mesh=mesh)
    watchdog = Watchdog(run.fault.step_timeout_s)

    pipeline = SyntheticLM(run.shape.global_batch, run.shape.seq_len,
                           cfg.vocab_size, seed=run.seed,
                           start_step=start_step)
    losses: List[float] = []
    try:
        for step in range(start_step, num_steps):
            batch = next(pipeline)
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")

            def do_step(state=state, batch=batch):
                new_state, metrics = step_fn(state, batch)
                # block on the loss: a hung kernel manifests here
                return new_state, metrics["loss"].item(), metrics

            state, loss, metrics = watchdog.run(do_step)
            losses.append(float(loss))
            if hooks:
                m = {k: v for k, v in metrics.items()}
                for h in hooks:
                    h(step, m)
            if (step + 1) % run.checkpoint.save_every == 0:
                ckpt.save(step + 1, state, extra={"data": pipeline.state})
    finally:
        pipeline.close()
        ckpt.wait()
    return {"state": state, "losses": losses, "final_step": num_steps}


def train_with_recovery(run: RunConfig, *, mesh=None, device="cuda",
                        num_steps: Optional[int] = None,
                        fail_at_step: Optional[int] = None,
                        init_state: Optional[Callable[[], TrainState]] = None,
                        ) -> Dict[str, Any]:
    """Restart supervisor around train_loop. Restores the latest
    checkpoint (params + opt state + data cursor) on each restart; an
    attempt with no checkpoint to restore starts from ``init_state()``
    (default: :func:`seeded_state` on ``device`` and ``mesh``)."""
    ckpt = CheckpointManager(run.checkpoint, mesh=mesh)
    restarts: List[int] = []
    if init_state is None:
        def init_state():
            return seeded_state(run, device, mesh)

    def body(attempt: int):
        latest = ckpt.latest_step()
        if latest is not None:
            state, _ = ckpt.restore(empty_train_state(run, device, mesh))
            start = latest
        else:
            state, start = init_state(), 0
        # only inject the failure on the first attempt
        fail = fail_at_step if attempt == 0 else None
        return train_loop(run, mesh=mesh, device=device,
                          num_steps=num_steps,
                          state=state, start_step=start, ckpt=ckpt,
                          fail_at_step=fail)

    out = run_with_restarts(body, run.fault.max_restarts,
                            on_restart=lambda a, e: restarts.append(a))
    out["restarts"] = restarts
    return out
