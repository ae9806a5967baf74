"""Checkpoint manager: step-granular, async (PyTorch port of
``repro.train.checkpoint``, on the reference's on-disk format).

Format: one ``step_%09d`` directory per step containing
  manifest.json   — ``step``, ``extra`` and per leaf its ``name``,
                    ``file``, ``shape`` and ``dtype``
  leaf_%05d.npy   — the full array; bfloat16 stored as its raw 16-bit
                    words (``uint16``) with ``"dtype": "bfloat16"`` in the
                    manifest, as the reference stores it

Writes go to a ``.tmp`` directory and an atomic rename, so an interrupted
save never leaves a half-written step behind. ``save`` copies every leaf
to the host at once (a consistent snapshot, also under ``async_save``);
the writer thread then only writes files. ``keep`` bounds the steps kept.

Leaf names are the port's own: a :class:`TrainState` flattens to its
model's parameter names under ``params`` and ``opt::step``,
``opt::m::<name>``, ``opt::v::<name>``; nested dicts join their keys
with ``::``. A checkpoint of the JAX trainer is not expected to load.
``restore`` writes into the target's tensors in place, cast to each
target's dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from repro_torch.config import CheckpointConfig
from repro_torch.train.step import TrainState

_SEP = "::"


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) pairs of a TrainState, module, NamedTuple or dict of
    tensors, in a fixed order."""
    join = (lambda k: f"{prefix}{_SEP}{k}") if prefix else (lambda k: k)
    if isinstance(tree, TrainState):
        yield from _flatten({"params": tree.model, "opt": tree.opt}, prefix)
    elif isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield join(name), p
    elif isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        yield from _flatten(tree._asdict(), prefix)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, join(str(k)))
    else:
        yield prefix, tree


def _to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` on the host -> (array to save, dtype name)."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _from_file(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(np.dtype(dtype), copy=False))


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        # no directory given: a fresh one of this manager's own, so that no
        # two runs meet in a shared default and restore each other's steps
        self.directory = cfg.directory or tempfile.mkdtemp(
            prefix="repro_torch_ckpt_")
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- paths ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def all_steps(self) -> List[int]:
        steps = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    steps.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save -------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             blocking: Optional[bool] = None):
        blocking = (not self.cfg.async_save) if blocking is None else blocking
        # host copy NOW (consistent snapshot), the write may be async
        host = [(name, *_to_host(leaf)) for name, leaf in _flatten(state)]

        def write():
            tmp = self._step_dir(step) + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "extra": extra or {}, "leaves": []}
            for i, (name, arr, dtype) in enumerate(host):
                fn = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"].append(
                    {"name": name, "file": fn, "shape": list(arr.shape),
                     "dtype": dtype})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
        else:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.cfg.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def restore(self, target: Any, step: Optional[int] = None
                ) -> Tuple[Any, Dict]:
        """Restore the checkpoint at ``step`` (default: the latest) into
        ``target`` (a TrainState, module, NamedTuple or dict of tensors),
        in place -> (target, extra). Raises FileNotFoundError without a
        checkpoint, KeyError for a leaf the checkpoint lacks and
        ValueError on a shape mismatch, before writing anything."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_name = {leaf["name"]: leaf for leaf in manifest["leaves"]}
        loaded = []
        for name, tgt in _flatten(target):
            meta = by_name.get(name)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            arr = _from_file(np.load(os.path.join(d, meta["file"])),
                             meta["dtype"])
            if tuple(arr.shape) != tuple(tgt.shape):
                raise ValueError(
                    f"shape mismatch for {name}: ckpt {tuple(arr.shape)} "
                    f"vs target {tuple(tgt.shape)}")
            loaded.append((tgt, arr))
        with torch.no_grad():
            for tgt, arr in loaded:
                tgt.copy_(arr)
        return target, manifest["extra"]
