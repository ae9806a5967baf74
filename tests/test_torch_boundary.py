"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and not the port's examples (``examples/*_torch.py``)
imports ``jax``, the JAX package (``repro`` /
``repro.*``) or ``ml_dtypes`` (the card's machine has none; the page
store moves bfloat16 as raw 16-bit words); ``repro_torch`` itself is
allowed."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "examples").glob("*_torch.py"))
BANNED = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(root, line) for root, line in _imported_roots(path)
           if root in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_package_is_covered():
    names = {p.name for p in FILES}
    assert {"engine.py", "decoder.py", "mixer.py", "kernel.py", "ops.py",
            "candidate_selection.py", "chip_smoke.py", "quantization.py",
            "post_scoring.py", "a3_attention.py", "xlstm.py", "rglru.py",
            "moe.py", "gemma3_4b.py", "deepseek_moe_16b.py",
            "page_store.py", "chaos.py", "telemetry.py", "adamw.py",
            "memn2n.py", "step.py", "loop.py", "checkpoint.py", "fault.py",
            "synthetic.py", "babi.py", "train.py", "train_lm_torch.py",
            "babi_memn2n_torch.py", "frontend.py", "musicgen_medium.py",
            "internvl2_2b.py", "quickstart_torch.py",
            "serve_lm_torch.py", "mesh.py", "rules.py", "compression.py",
            "pipeline.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in FILES}
    for family in ("decode_attention", "flash_attention", "a3_attention",
                   "mlstm_chunk"):
        for mod in ("kernel.py", "ops.py", "ref.py"):
            assert f"src/repro_torch/kernels/{family}/{mod}" in rel
