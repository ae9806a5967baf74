"""The port's training dry run (``repro_torch.launch.dryrun``), its op
accounting (``launch.hlo_analysis``) and roofline (``launch.roofline``).

* Units, mirroring ``tests/test_hlo_analysis.py``: a matmul's FLOPs and
  bytes, a Python layer loop, a remat recompute, the peak counter on a
  hand-counted sequence of allocations, the collectives of a fake world;
  the roofline's arithmetic; kernel #7's formulas on ``PERF.md`` row 7's
  shape (its 0.0251 ms bytes bound) and its custom op under
  ``FakeTensorMode`` / ``FlopCounterMode``.
* The dry run of the compute-split cells of ``test_torch_mesh_split.py``
  in a fake world (4 and 8 ranks, this process rank 0) counts what a real
  gloo rank counts there (held equal to these numbers in that file), and
  the one-device trace counts what ``FlopCounterMode`` counts around a
  real step.
* The CLI: ``--list`` prints what the reference's prints; one production
  cell, internlm2-1.8b ``train_4k`` on (16, 16), traces in fake mode.

The fake worlds run in subprocesses: a default process group must not
outlive its test.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro_torch.kernels.mlstm_chunk import kernel as mk  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.hlo_analysis import HloStats, \
    analyze_step  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _python(code: str, timeout: float = 300) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.path.join(ROOT, "tests"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


# ---------------------------------------------------------------------------
# the op stream
# ---------------------------------------------------------------------------

def test_matmul_flops_and_bytes():
    m, k, n = 64, 128, 32
    with FakeTensorMode():
        a, b = torch.empty(m, k), torch.empty(k, n)
        st, _, _ = analyze_step(lambda: a @ b)
    assert st.dot_flops == 2 * m * k * n
    assert st.hbm_bytes == 4 * (m * k + k * n + m * n)
    assert st.peak_bytes == 4 * m * n and st.ops == 1


def test_layer_loop_counts_every_layer():
    """A Python loop over L layers is L products (the reference's scan
    trip count)."""
    L, d = 7, 32
    with FakeTensorMode():
        ws, x = torch.empty(L, d, d), torch.empty(d, 1)

        def f():
            h = x
            for i in range(L):
                h = ws[i] @ h
            return h
        st, _, _ = analyze_step(f)
    assert st.dot_flops == L * 2 * d * d


def test_remat_recompute_is_counted():
    """A checkpointed layer's forward runs twice (the recompute in the
    backward), and the backward's two products once each."""
    m, d = 16, 32
    with FakeTensorMode():
        x = torch.empty(m, d, requires_grad=True)
        w = torch.empty(d, d, requires_grad=True)

        def f():
            y = checkpoint(lambda t: torch.tanh(t @ w), x,
                           use_reentrant=False)
            y.sum().backward()
        st, _, _ = analyze_step(f)
    assert st.dot_flops == 4 * 2 * m * d * d


def test_peak_counts_live_storages():
    """Resident 1 KiB; then a (4 KiB), its sum (4 B), a temporary (8 KiB)
    and b = the temporary + the sum (8 KiB) at once: the peak; a view and
    an in-place write into the resident tensor add nothing, and c (2 KiB)
    comes after a and the temporary are freed."""
    with FakeTensorMode():
        base = torch.empty(256)

        def f():
            base.copy_(torch.empty(256))
            a = torch.empty(1024)
            b = torch.empty(2048) + a.sum()
            _ = b.view(2, 1024)
            del a
            c = torch.empty(512)
            return b, c
        st, _, out = analyze_step(f, [base])
    assert st.resident_bytes == 1024
    assert st.peak_bytes == 1024 + 4096 + 4 + 8192 + 8192


def test_collectives_of_a_fake_world():
    """The model-axis f / g pair and a gather on a (2, 4) fake world:
    operand bytes, ring factors, counts and the group's ranks."""
    out = _python("""
import json, torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import ActShardings
fake_world(8)
mesh = make_mesh((2, 4), ("data", "model"), "cpu")
sh = ActShardings(size=4, index=0, group=mesh.get_group("model").group_name)
with FakeTensorMode():
    x = torch.empty(64, 128, requires_grad=True)
    w = torch.empty(32, 128, requires_grad=True)
    def f():
        y = sh.leave(torch.nn.functional.linear(sh.enter(x), w))
        sh.gather(y, 0).sum().backward()
    st, groups, _ = analyze_step(f)
print(json.dumps([st.collective_bytes, st.collective_counts,
                  st.collective_wire_bytes, sorted(groups.values())]))
""")
    cb, cc, wire, groups = json.loads(out.strip().splitlines()[-1])
    b = 64 * 32 * 4
    # forward: all-reduce y, all-gather y; backward: reduce-scatter of
    # the gathered gradient, all-reduce of x's gradient (x's bytes)
    assert cc == {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 1}
    assert cb == {"all-reduce": b + 64 * 128 * 4, "all-gather": b,
                  "reduce-scatter": 4 * b}
    assert wire == pytest.approx((b + 64 * 128 * 4) * 2 * 3 / 4
                                 + b * 3 / 4 + 4 * b * 3 / 4)
    assert groups == [[0, 1, 2, 3]]


_GATHER_PEAK = """
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import common
fake_world(8)
mesh = make_mesh((2, 4), ("data", "model"), "cpu")
g = mesh.get_group("model").group_name
c10d = common._c10d()
with FakeTensorMode():
    x = torch.empty(64, 128)

    def direct():
        y = c10d.wait_tensor(c10d.all_gather_into_tensor(x, 4, g))
        return (y * 2).sum()

    def movedim():
        y = common._all_gather(x, 1, 4, g)
        return (y * 2).sum()

    def held():
        a = c10d.all_gather_into_tensor(x.movedim(1, 0).contiguous(), 4, g)
        y = c10d.wait_tensor(a).movedim(0, 1)
        return (y * 2).sum()
    out = {}
    for f in (direct, movedim, held):
        st, _, _ = analyze_step(f, [x])
        out[f.__name__] = [st.resident_bytes, st.peak_bytes]
print(json.dumps(out))
"""


def test_peak_counts_a_collective_output_once():
    """An all-gather of a 32 KiB [64, 128] block over 4 ranks: its 128 KiB
    output stays live from the collective to its last reader, whether it
    is read as ``wait_tensor`` hands it back, through ``_all_gather``'s
    ``movedim`` or through a view while the collective's own handle is
    still held. Each peak is the resident input, the output once, the
    doubled copy made while it is live and the 4-byte sum."""
    got = json.loads(_python(_GATHER_PEAK).strip().splitlines()[-1])
    x, y = 64 * 128 * 4, 4 * 64 * 128 * 4
    want = [x, x + 2 * y + 4]
    assert got == {"direct": want, "movedim": want, "held": want}


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

def test_roofline_arithmetic():
    st = HloStats(dot_flops=989e12, collective_bytes={"all-reduce": 1e9},
                  collective_wire_bytes=1.5e9,
                  collective_counts={"all-reduce": 2}, hbm_bytes=6.7e12,
                  op_counts={"all-reduce": 2},
                  group_bytes={"in": 450e9, "across": 50e9})
    groups = {"in": tuple(range(8, 16)), "across": (0, 16, 32)}
    r = roofline.analyze("a", "s", "16x16", 256, st, groups, 989e12 * 128)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(2.0)       # 1 s NVLink + 1 s NIC
    assert r.bottleneck == "memory"
    assert r.useful_flop_ratio == pytest.approx(0.5)
    assert r.roofline_fraction == pytest.approx(128 / 256 / 2.0)
    d = r.to_dict()
    assert d["bottleneck"] == "memory" and d["chips"] == 256
    assert roofline.link_bw(range(8)) == 450e9
    assert roofline.link_bw([7, 8]) == 50e9


# ---------------------------------------------------------------------------
# kernel #7
# ---------------------------------------------------------------------------

def test_mlstm_formula_gives_row_7_bound():
    """PERF.md row 7 (B=4, H=4, S=2048, D=256, chunk 256, bf16, zero
    state): 0.0251 ms of bytes at 3.35 TB/s, above its operations."""
    nbytes, flops = mk.need(4, 4, 2048, 256, 256, 256, False)
    assert round(nbytes / roofline.HBM_BW * 1e3, 4) == 0.0251
    assert flops / roofline.PEAK_FLOPS_BF16 < nbytes / roofline.HBM_BW


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_op_is_counted_by_its_formula(with_state):
    """The launch op under fake tensors: its shape function, its FLOPs in
    ``FlopCounterMode``, its bytes and count in the op stream, and no
    launch."""
    b, h, s, d = 2, 3, 300, 64
    before = dict(mk.LAUNCHES)
    with FakeTensorMode():
        q = torch.empty(b, h, s, d, dtype=torch.bfloat16)
        g = torch.empty(b, h, s)
        st = (torch.empty(b, h, d, d), torch.empty(b, h, d),
              torch.empty(b, h)) if with_state else (None,) * 3
        res, _, out = analyze_step(lambda: torch.ops.repro_torch.mlstm_chunk(
            q, q, q, g, g, *st, 128, 0.125, True))
    want = mk.need(b, h, s, 128, d, d, with_state, return_state=True)
    assert [tuple(t.shape) for t in out] == [(b, h, s, d), (b, h, d, d),
                                             (b, h, d), (b, h)]
    assert res.dot_flops == want[1]
    assert res.kernel_flops == {"repro_torch.mlstm_chunk": want[1]}
    assert res.hbm_bytes == want[0]
    assert res.op_counts == {"repro_torch.mlstm_chunk": 1}
    assert mk.LAUNCHES == before


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

_SPLIT = """
import json
from test_torch_mesh_worker import configs, SPLIT_CELLS, BATCH, SPLIT_SEQ
from repro_torch import config as C
from repro_torch.launch.dryrun import run_cell
shape = C.ShapeConfig("t", C.ShapeKind.TRAIN, SPLIT_SEQ, BATCH)
out = {}
for case, (name, ms, ep) in SPLIT_CELLS.items():
    rec = run_cell(configs()[name], shape, mesh_shape=ms, device="cpu",
                   verbose=False, sharding_cfg=C.ShardingConfig(
                       remat="full", expert_parallel=ep))
    out[case] = [rec["flops_per_device"], rec["chips"],
                 rec["memory"]["peak_device_bytes"]]
rec = run_cell(configs()["tiny"], shape, mesh_shape=(), device="cpu",
               verbose=False)
out["one"] = [rec["flops_per_device"], rec["chips"], 0]
print(json.dumps(out))
"""


def test_dry_run_counts_what_a_rank_counts():
    """The fake-world trace of each split cell: the reference's (and the
    gloo rank's) per-device FLOPs; the MoE cells the single device's count
    over the ranks (``test_torch_mesh_split._moe_flops``, held there on
    the gloo ranks); one device the real step's count."""
    from test_torch_mesh_split import _moe_flops, _single_device_flops
    got = json.loads(_python(_SPLIT).strip().splitlines()[-1])
    want = {"split_tiny_2x2": 104_857_600, "split_tiny_2x4": 52_428_800,
            "split_tiny-6h_2x4": 60_817_408,
            "split_moe_2x2": _moe_flops(4),
            "split_moe_2x4": _moe_flops(8),
            "split_moe-tp_2x2": _moe_flops(4),
            "one": _single_device_flops("tiny")}
    for case, w in want.items():
        assert got[case][0] == pytest.approx(w, rel=1e-6), case
    assert got["split_tiny_2x4"][1] == 8
    # a rank of the (2, 4) mesh holds less than one of the (2, 2) mesh
    assert got["split_tiny_2x4"][2] < got["split_tiny_2x2"][2]


def test_dryrun_cli_list_matches_reference():
    env = dict(os.environ, PYTHONPATH=SRC)

    def listing(pkg):
        p = subprocess.run([sys.executable, "-m", f"{pkg}.launch.dryrun",
                            "--list"], env=env, capture_output=True,
                           text=True, timeout=300)
        assert p.returncode == 0, p.stderr[-2000:]
        return p.stdout
    assert listing("repro_torch") == listing("repro")


def test_production_cell_traces_in_fake_mode():
    """internlm2-1.8b ``train_4k`` on (16, 16): 256 fake ranks, each doing
    1/256 of the one-device step's products (every one is split), its
    peak far under the unsharded state."""
    out = _python("""
import json
from repro_torch.launch.dryrun import run_cell
rec = run_cell("internlm2-1.8b", "train_4k", device="cpu", verbose=False)
print(json.dumps(rec))
""", timeout=600)
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collective_bytes"] > 0 and rec["collective_s"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < rec["memory"]["peak_device_bytes"] < 80e9
    # 6 N D over the ranks' products: remat recomputes the forward
    assert 0.5 < rec["useful_flop_ratio"] < 1.0
