"""Roofline terms of a dry-run cell (PyTorch port of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh), in seconds, per rank:

  compute    = FLOPs / peak FLOP/s
  memory     = HBM bytes / HBM bandwidth
  collective = sum over process groups of the group's collective bytes
               over its link's bandwidth

FLOPs, bytes and collective bytes come from one rank's op stream
(``repro_torch.launch.hlo_analysis``), so every number is per device, as
the reference's per-device HLO is.

The constants are NVIDIA H100 SXM datasheet figures, not measurements:
989 TFLOP/s dense bf16, 3.35 TB/s of HBM3, 450 GB/s a direction of
NVLink for a group whose ranks lie in one 8-GPU node, and 50 GB/s (one
400 Gb/s NIC per GPU) for a group that spans nodes. Ranks are numbered
node by node (rank // 8 is the node).

collective_bytes is the sum of collective operand sizes (the reference's
definition); ``wire_bytes`` applies ring factors (an all-reduce moves
2(n-1)/n x its bytes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Sequence

# ---- H100 SXM datasheet constants ------------------------------------
PEAK_FLOPS_BF16 = 989e12          # dense, per GPU
HBM_BW = 3.35e12                  # bytes/s per GPU
NVLINK_BW = 450e9                 # bytes/s a direction, inside a node
NIC_BW = 50e9                     # bytes/s, one 400 Gb/s NIC per GPU
NODE_GPUS = 8


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    wire_bytes: float
    model_flops: float                 # 6 N_active D (2 N_active D inference)
    compute_s: float
    memory_s: float
    collective_s: float
    op_counts: Dict[str, int]

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — catches remat/redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful FLOPs / (chips x peak x max-term step time) — the MFU
        this program would reach if it ran exactly at its largest
        term."""
        t = max(self.compute_s, self.memory_s, self.collective_s)
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS_BF16 * t)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["bottleneck"] = self.bottleneck
        d["useful_flop_ratio"] = self.useful_flop_ratio
        d["roofline_fraction"] = self.roofline_fraction
        return d


def link_bw(ranks: Sequence[int]) -> float:
    """The bandwidth a collective over ``ranks`` runs at: NVLink when the
    group lies in one node, the NIC when it spans nodes."""
    return NVLINK_BW if len({r // NODE_GPUS for r in ranks}) <= 1 \
        else NIC_BW


def collective_seconds(group_bytes: Mapping[str, float],
                       group_ranks: Mapping[str, Sequence[int]]) -> float:
    return sum(b / link_bw(group_ranks[g]) for g, b in group_bytes.items()
               if b)


def analyze(arch: str, shape: str, mesh_name: str, chips: int, stats,
            group_ranks: Mapping[str, Sequence[int]],
            model_flops: float) -> Roofline:
    """The roofline of one rank's ``stats`` (``hlo_analysis.HloStats``)."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=stats.dot_flops, bytes_per_device=stats.hbm_bytes,
        collective_bytes=stats.total_collective_bytes,
        wire_bytes=stats.collective_wire_bytes, model_flops=model_flops,
        compute_s=stats.dot_flops / PEAK_FLOPS_BF16,
        memory_s=stats.hbm_bytes / HBM_BW,
        collective_s=collective_seconds(stats.group_bytes, group_ranks),
        op_counts=dict(stats.op_counts),
    )
