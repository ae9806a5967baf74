"""The serving cells of the port's dry run (``repro_torch.launch.dryrun``)
at production size and its command line. The cells of the gloo meshes
are traced in ``test_torch_mesh_serve.py``, beside the counts of the
gloo ranks and of the reference they are held to.

* The frontend archs refuse the chunked, blocked and gather cells as the
  reference does; ``main`` records a failing cell and exits 1.
* One production cell, internlm2-1.8b ``decode_32k`` on (16, 16),
  completes in fake mode on the CPU (in a subprocess: a default process
  group must not outlive its test), and ``--one-device`` traces the same
  cell on one device, whose count the 256 ranks' counts add up to.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")

from repro_torch import config as C  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _python(code: str, timeout: float = 600) -> str:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC, os.path.join(ROOT, "tests"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        p = subprocess.run([sys.executable, "-c", code,
                            os.path.join(tmp, "one.json")], env=env,
                           capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


@pytest.mark.parametrize("lower", ["lower_decode_block",
                                   "lower_prefill_chunk",
                                   "lower_gather_pages"])
def test_frontend_archs_refuse_token_cells(lower):
    cfg = C.smoke_variant(C.get_arch("musicgen-medium"))
    shape = C.SHAPE_SUITE["decode_32k"]
    with pytest.raises(ValueError, match="frontend archs"):
        getattr(dryrun, lower)(cfg, shape, None, C.ShardingConfig(),
                               device="cpu")


def test_main_records_a_failing_cell_and_exits_1(monkeypatch, capsys):
    def fail(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(dryrun, "run_cell", fail)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                     "--a3", "conservative", "--select-shards", "16"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "FAIL internlm2-1.8b x decode_32k (16x16): RuntimeError('boom')" \
        in out and "dry-run: 0/1 cells OK" in out


def test_production_decode_cell_traces_in_fake_mode():
    """internlm2-1.8b ``decode_32k`` on (16, 16): 256 fake ranks, each its
    8 lanes' ring rows, the #1 partials combined over the model axis; and
    the same cell on one device through ``main --one-device``, whose
    count is the ranks' counts summed (no work replicated)."""
    out = _python("""
import json, sys
from repro_torch.launch.dryrun import main, run_cell
rec = run_cell("internlm2-1.8b", "decode_32k", device="cpu", verbose=False)
main(["--arch", "internlm2-1.8b", "--shape", "decode_32k", "--one-device",
      "--device", "cpu", "--out", sys.argv[1]])
print(json.dumps([rec, json.load(open(sys.argv[1]))]))
""")
    rec, one = json.loads(out.strip().splitlines()[-1])
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    assert rec["shape"] == "decode_32k" and rec["a3_mode"] == "off"
    assert rec["flops_per_device"] > 0 and rec["collective_bytes"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < rec["memory"]["peak_device_bytes"] < 80e9
    (one,) = one
    assert one["chips"] == 1 and one["mesh"] == "1"
    assert rec["flops_per_device"] * 256 == pytest.approx(
        one["flops_per_device"], rel=1e-6)
