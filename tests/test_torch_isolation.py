"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports jax or anything of the ``repro`` package (the
card's machine has no JAX), checked statically and by importing the
serving entry point in a fresh interpreter."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_forbidden_rule_tells_the_port_from_the_reference():
    assert _forbidden("repro") and _forbidden("repro.core.mtj")
    assert _forbidden("jax.numpy") and _forbidden("jax")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.core")
    assert not _forbidden("jaxtyping_free_name") and not _forbidden("torch")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_serving_import_loads_neither_jax_nor_reference():
    code = ("import sys, repro_torch.serving.vision, repro_torch.kernels.ops, "
            "repro_torch.serving.engine, repro_torch.kernels.flash_attention, "
            "repro_torch.configs, repro_torch.frontend, repro_torch.quickstart, "
            "repro_torch.variation, repro_torch.variation.calibrate, "
            "repro_torch.variation.yield_analysis, repro_torch.train.vision, "
            "repro_torch.lifetime, repro_torch.lifetime.drift, "
            "repro_torch.lifetime.schedule, repro_torch.lifetime.fleet, "
            "repro_torch.data.synthetic, repro_torch.launch.train, "
            "repro_torch.train_p2m_vision, repro_torch.serving.fleet, "
            "repro_torch.checkpoint.manager, repro_torch.obs, "
            "repro_torch.obs.__main__, repro_torch.serving.loadgen; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
