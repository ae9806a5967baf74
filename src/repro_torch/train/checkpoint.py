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
``opt::m::<name>``, ``opt::v::<name>`` (and ``err::<name>`` with an
error-feedback state); nested dicts join their keys with ``::``, as the
reference's do, so a checkpoint of a reference tree of arrays restores
into a port dict of the same keys. A checkpoint of the JAX trainer's
state is not expected to load (other names, stacked layers).
``restore`` writes into the target's tensors in place, cast to each
target's dtype.

On a mesh (``CheckpointManager(cfg, mesh=...)``) leaves may be DTensors.
``save`` writes the *logical* array as the reference does: every rank
joins each leaf's gather on the calling thread, global rank 0 alone
writes (the async writer thread runs no collective), and the other
ranks wait for its write in the next ``wait`` (a barrier). ``restore``
then places each leaf by the target's own layout, whatever mesh wrote
it ("elastic resharding"): every rank reads the logical array and keeps
its shard, with no collective.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from repro_torch.config import CheckpointConfig
from repro_torch.train.step import TrainState

_SEP = "::"


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) pairs of a TrainState, module, NamedTuple or dict of
    tensors, in a fixed order."""
    join = (lambda k: f"{prefix}{_SEP}{k}") if prefix else (lambda k: k)
    if isinstance(tree, TrainState):
        parts = {"params": tree.model, "opt": tree.opt}
        if tree.err is not None:
            parts["err"] = tree.err
        yield from _flatten(parts, prefix)
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


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self._writes = mesh is None or dist.get_rank() == 0
        # no directory given: a fresh one of this manager's own, so that no
        # two runs meet in a shared default and restore each other's steps
        # (on a mesh, rank 0's, shared with every rank)
        directory = [cfg.directory or (tempfile.mkdtemp(
            prefix="repro_torch_ckpt_") if self._writes else None)]
        if mesh is not None and cfg.directory is None:
            dist.broadcast_object_list(directory, src=0)
        self.directory = directory[0]
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
        # host copy NOW (consistent snapshot), the write may be async; a
        # DTensor's gather is a collective every rank joins, here
        host = []
        for name, leaf in _flatten(state):
            if _is_dtensor(leaf):
                leaf = leaf.full_tensor()
            if self._writes:
                host.append((name, *_to_host(leaf)))

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
            if self._writes:
                write()
            self._barrier()
        else:
            self.wait()
            if self._writes:
                self._thread = threading.Thread(target=write, daemon=True)
                self._thread.start()

    def wait(self):
        """Join a pending write; on a mesh every rank then waits for rank
        0's."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._barrier()

    def _barrier(self):
        if self.mesh is not None:
            dist.barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.cfg.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def restore(self, target: Any, step: Optional[int] = None,
                shardings: Optional[Mapping[str, Any]] = None
                ) -> Tuple[Any, Dict]:
        """Restore the checkpoint at ``step`` (default: the latest) into
        ``target`` (a TrainState, module, NamedTuple or dict of tensors),
        in place -> (target, extra). A DTensor leaf takes its shard of the
        logical array. With ``shardings`` (a dict shaped as ``target``,
        leaves :class:`~repro_torch.sharding.rules.Sharding`) the target
        is a dict whose leaves give only names, shapes and dtypes (meta
        tensors will do), and the result is a new dict of DTensors laid
        out by ``shardings``. Raises FileNotFoundError without a
        checkpoint, KeyError for a leaf the checkpoint lacks and
        ValueError on a shape mismatch, before writing anything."""
        from repro_torch.sharding.rules import distribute, local_shard
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
            loaded.append((name, tgt, arr))
        if shardings is not None:
            shd = dict(_flatten_shardings(shardings))
            out: Dict[str, Any] = {}
            for name, tgt, arr in loaded:
                s = shd[name]
                dev = (torch.device(s.mesh.device_type) if tgt.is_meta
                       else tgt.device)
                _insert(out, name, distribute(
                    arr.to(device=dev, dtype=tgt.dtype), s))
            return out, manifest["extra"]
        with torch.no_grad():
            for _, tgt, arr in loaded:
                if _is_dtensor(tgt):
                    tgt.to_local().copy_(local_shard(
                        arr, tgt.device_mesh, tgt.placements))
                else:
                    tgt.copy_(arr)
        return target, manifest["extra"]


def _flatten_shardings(tree: Any, prefix: str = ""
                       ) -> Iterator[Tuple[str, Any]]:
    from repro_torch.sharding.rules import Sharding
    if isinstance(tree, Sharding):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _flatten_shardings(v, f"{prefix}{_SEP}{k}" if prefix
                                      else str(k))


def _insert(tree: Dict[str, Any], name: str, leaf: Any) -> None:
    *outer, last = name.split(_SEP)
    for k in outer:
        tree = tree.setdefault(k, {})
    tree[last] = leaf
