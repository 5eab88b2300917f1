"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports JAX or the JAX package (``repro``), not even a
module of it that imports no JAX itself."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or top.startswith("jax")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/kernels/segment_fold.py" in names
    assert "src/repro_torch/runtime/engine.py" in names
    for module in ("core/mapreduce.py", "data/__init__.py",
                   "data/pipeline.py", "data/stats.py", "kernels/cms.py",
                   "kernels/flash_attention.py",
                   "kernels/stripes.py", "kernels/_build.py",
                   "examples/quickstart.py",
                   "examples/streaming_analytics.py",
                   # the training slice
                   "optim/__init__.py", "optim/adamw.py",
                   "optim/compress.py", "checkpoint/__init__.py",
                   "checkpoint/store.py", "runtime/fault_tolerance.py",
                   "launch/steps.py", "launch/train.py",
                   "examples/train_lm.py", "core/aggregation.py",
                   # the MLA slice
                   "configs/deepseek_v2_236b.py", "models/attention.py",
                   "models/convert.py"):
        assert f"src/repro_torch/{module}" in names, module
    assert len(names) >= 30
    assert _forbidden("jax.numpy") and _forbidden("repro.core.plan")
    assert not _forbidden("repro_torch.core") and not _forbidden("numpy")
