"""The port stands alone: nothing under ``src/repro_torch/`` and nothing
in ``chip_smoke.py`` imports jax or the JAX package ``repro``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _banned(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_sees_the_package():
    names = {p.name for p in FILES}
    assert {"order_stats.py", "batch_torch.py", "runner.py",
            "chip_smoke.py", "rwkv_scan.py", "ssm.py", "layers.py",
            "transformer.py", "model.py", "engine.py", "registry.py",
            "rwkv6_3b.py", "convert.py", "attention.py",
            "flash_attention.py", "llama3p2_3b.py"} <= names
    assert _banned("repro.core") and _banned("jax.numpy")
    assert not _banned("repro_torch.core")
