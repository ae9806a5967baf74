"""The port's examples (``examples/quickstart_torch.py``,
``examples/serve_lm_torch.py``) run with ``--device cpu`` at small
arguments and print the reference examples' lines: the same lines in the
same order once every number is masked (their inputs come from numpy /
``torch.Generator`` seeds, not ``jax.random`` keys, so the numbers
differ). Quickstart's conservative A^3 keeps more candidates and errs no
more than the aggressive setting; serve_lm's scheduling variants
generate the same tokens.
"""
from __future__ import annotations

import importlib.util
import re
import runpy
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")


def _masked(text):
    """Lines with every number as ``#`` and runs of blanks as one."""
    return [re.sub(r"\s+", " ", NUMBER.sub("#", line)).strip()
            for line in text.splitlines()]


def _port_main(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _reference_output(name, args, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, *args])
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


def test_quickstart_prints_the_reference_lines(capsys, monkeypatch):
    _port_main("quickstart_torch")(["--device", "cpu"])
    got = capsys.readouterr().out
    want = _reference_output("quickstart", [], capsys, monkeypatch)
    assert _masked(got) == _masked(want)
    rows = re.findall(r"candidates\s+([\d.]+)/320\s+kept\s+([\d.]+)/320\s+"
                      r"max\|err\| ([\d.]+)\s+cos\(exact\) ([\d.]+)", got)
    (c_cand, c_kept, c_err, c_cos), (a_cand, a_kept, a_err, a_cos) = [
        tuple(map(float, r)) for r in rows]
    assert c_cand > a_cand and c_kept >= a_kept
    assert c_err <= a_err and c_cos >= a_cos


def test_serve_lm_prints_the_reference_lines(capsys, monkeypatch):
    args = ["--requests", "3", "--prompt-len", "20", "--max-new", "6"]
    _port_main("serve_lm_torch")(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    want = _reference_output("serve_lm", args, capsys, monkeypatch)
    assert _masked(got) == _masked(want)
    assert "chunked admission == whole-prompt admission" in got
    assert "blocked decode (T=8) == per-step decode" in got
    assert "WARNING" not in got
    assert got.count("18 tokens generated") == 4


def test_examples_need_the_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for name in ("quickstart_torch", "serve_lm_torch"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _port_main(name)([])
