"""Per-rank accounting of one traced step for the dry-run roofline
(PyTorch port of ``repro.launch.hlo_analysis``).

The reference parses the compiled per-device HLO text. The port has no
HLO: it reads the stream of ops that the dispatcher runs while one rank
executes the step, under ``FakeTensorMode`` in the dry run (no memory, no
launches) or for real. :class:`OpStream` is a ``TorchDispatchMode`` that
sees every aten op, every collective and every custom kernel op, and
counts per rank:

* matmul FLOPs: ``FlopCounterMode``'s count (``mm``, ``bmm``,
  ``addmm``, convolutions, ...), kernel ops by their registered formula
  (``kernels.decode_attention.kernel.need`` for #1-#3,
  ``kernels.mlstm_chunk.kernel.need`` for #7);
* HBM bytes: every op's input plus output bytes (views move nothing);
  a kernel op by its formula;
* collectives: operand bytes per kind and wire bytes with the
  reference's ring factors (all-reduce 2(n-1)/n, all-gather and
  reduce-scatter (n-1)/n, others 1), per process group;
* op counts: each collective kind and each kernel op;
* peak live bytes: the bytes resident when the stream starts (the
  tensors handed to :meth:`OpStream.resident`) plus the storages made
  since and not yet freed, at their most. A storage is freed when its
  last tensor is (views share it, autograd's saved tensors hold it). A
  functional collective's output is one buffer with the tensor its
  ``wait_tensor`` hands back (another storage under ``FakeTensorMode``):
  it is counted once and freed when the last tensor of either is.

Everything is per rank: the trace is one rank's program, as the
reference's HLO is one device's.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Callable, Dict, Iterable, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# op name (``OpOverloadPacket`` name) -> reference collective kind
_COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "collective-permute",
    "c10d.allreduce_": "all-reduce",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_": "all-gather",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "collective-permute",
}
_WAIT = "_c10d_functional.wait_tensor"
_SKIP = (_WAIT, "c10d.barrier")

def _kernel_needs() -> Dict[str, Callable[..., Tuple[int, int]]]:
    """Kernel op -> its (bytes, FLOPs) from the op's arguments; the FLOPs
    are also registered with ``FlopCounterMode``."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.mlstm_chunk import kernel as mk
    return {"repro_torch.mlstm_chunk": mk.call_need,
            "repro_torch.decode_attention_fused": dk.call_need_fused,
            "repro_torch.decode_attention_rowmax": dk.call_need_rowmax,
            "repro_torch.decode_attention_attend": dk.call_need_attend}


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(x)[0]
               if isinstance(t, torch.Tensor))


def _group(args, kwargs) -> Tuple[str, int]:
    """(group key, size) of a collective's arguments: a functional op's
    group name (with its size), or a c10d op's process group."""
    flat = tuple(args) + tuple(kwargs.values())
    names = [a for a in flat if isinstance(a, str)]
    if names:                            # the group name comes last
        pg = dist.distributed_c10d._resolve_process_group(names[-1])
        return names[-1], pg.size()
    for a in flat:
        if isinstance(a, (dist.ProcessGroup, torch.ScriptObject)):
            pg = a if isinstance(a, dist.ProcessGroup) else \
                dist.ProcessGroup.unbox(a)
            return pg.group_name, pg.size()
    return "world", dist.get_world_size()


@dataclasses.dataclass
class HloStats:
    """The reference's stats of one rank's step, plus what the port's
    stream also sees (HBM bytes, kernel ops, peak)."""
    dot_flops: float
    collective_bytes: Dict[str, float]
    collective_wire_bytes: float
    collective_counts: Dict[str, int]
    hbm_bytes: float = 0.0
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    group_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    resident_bytes: int = 0
    peak_bytes: int = 0
    ops: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


class OpStream(TorchDispatchMode):
    """Count one rank's op stream (see the module docstring). Use with
    ``FlopCounterMode`` inside it: ``with OpStream() as s,
    FlopCounterMode(display=False) as fc: ...; s.stats(fc)``."""

    def __init__(self):
        super().__init__()
        self.hbm = 0.0
        self.coll_bytes: Dict[str, float] = defaultdict(float)
        self.coll_counts: Dict[str, int] = defaultdict(int)
        self.group_bytes: Dict[str, float] = defaultdict(float)
        self.kernel_counts: Dict[str, int] = defaultdict(int)
        self.kernel_flops: Dict[str, float] = defaultdict(float)
        self.wire = 0.0
        self.ops = 0
        self._live: Dict[int, list] = {}     # storage -> [bytes, storages]
        self._resident: set = set()
        self.resident_bytes = 0
        self.live_bytes = 0
        self.peak_live = 0
        self._needs = _kernel_needs()

    # -- memory ---------------------------------------------------------
    def resident(self, tensors: Iterable[torch.Tensor]) -> int:
        """Count ``tensors``' storages (each once) as resident for the
        whole stream -> their bytes."""
        for t in tensors:
            if hasattr(t, "to_local"):
                t = t.to_local()
            st = t.untyped_storage()
            if st._cdata not in self._resident:
                self._resident.add(st._cdata)
                self.resident_bytes += st.nbytes()
        return self.resident_bytes

    def _release(self, key: int) -> None:
        buf = self._live.pop(key, None)
        if buf is not None:
            buf[1] -= 1
            if buf[1] == 0:
                self.live_bytes -= buf[0]

    def _hold(self, st, buf: list) -> None:
        key = st._cdata
        self._live[key] = buf
        buf[1] += 1
        weakref.finalize(st, self._release, key)

    def _track(self, out) -> None:
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._resident:
                continue            # a view, or an in-place op's self
            self._hold(st, [st.nbytes(), 0])
            self.live_bytes += st.nbytes()
        self.peak_live = max(self.peak_live, self.live_bytes)

    def _waited(self, out, args) -> None:
        """``wait_tensor``'s result joins its input's buffer (it is the
        collective's output, not a new one)."""
        buf = self._live.get(args[0].untyped_storage()._cdata)
        st = out.untyped_storage()
        if buf is None:
            self._track(out)
        elif st._cdata not in self._live:
            self._hold(st, buf)

    # -- the stream -----------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket._qualified_op_name.replace("::", ".")
        if name == _WAIT:
            self._waited(out, args)
        if name in _SKIP or not any(isinstance(t, torch.Tensor)
                                    for t in tree_flatten(out)[0]):
            return out          # waits; metadata queries (prim.device)
        self.ops += 1
        if name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            key, n = _group(args, kwargs)
            b = _bytes(args[0])
            self.coll_bytes[kind] += b
            self.coll_counts[kind] += 1
            self.group_bytes[key] += b
            if kind == "all-reduce":
                self.wire += b * 2 * (n - 1) / max(n, 1)
            elif kind in ("all-gather", "reduce-scatter"):
                self.wire += b * (n - 1) / max(n, 1)
            else:
                self.wire += b
            self.hbm += _bytes(args) + _bytes(out)
        elif name in self._needs:
            nbytes, flops = self._needs[name](*args, **kwargs)
            self.kernel_counts[name] += 1
            self.kernel_flops[name] += flops
            self.hbm += nbytes
        elif not func.is_view:
            self.hbm += _bytes(args) + _bytes(out)
        self._track(out)
        return out

    def stats(self, flop_counter=None) -> HloStats:
        """The counts so far; ``flop_counter`` a ``FlopCounterMode`` that
        ran inside this stream."""
        flops = float(flop_counter.get_total_flops()) if flop_counter \
            else 0.0
        return HloStats(
            dot_flops=flops, collective_bytes=dict(self.coll_bytes),
            collective_wire_bytes=self.wire,
            collective_counts=dict(self.coll_counts), hbm_bytes=self.hbm,
            op_counts={**self.coll_counts, **self.kernel_counts},
            kernel_flops=dict(self.kernel_flops),
            group_bytes=dict(self.group_bytes),
            resident_bytes=self.resident_bytes,
            peak_bytes=self.resident_bytes + self.peak_live, ops=self.ops)

    def group_ranks(self) -> Dict[str, Tuple[int, ...]]:
        """The global ranks of every group a collective ran on."""
        out = {}
        for key in self.group_bytes:
            if key == "world":
                out[key] = tuple(range(dist.get_world_size()))
            else:
                pg = dist.distributed_c10d._resolve_process_group(key)
                out[key] = tuple(dist.get_process_group_ranks(pg))
        return out


def analyze_step(fn: Callable[[], object], resident: Iterable = ()
                 ) -> Tuple[HloStats, Dict[str, Tuple[int, ...]], object]:
    """Run ``fn()`` under an :class:`OpStream` and ``FlopCounterMode``
    -> (stats, the ranks of each collective's group, ``fn``'s result)."""
    from torch.utils.flop_counter import FlopCounterMode
    stream = OpStream()
    stream.resident(resident)
    with stream, FlopCounterMode(display=False) as fc:
        result = fn()
    return stream.stats(fc), stream.group_ranks(), result

