"""The PyTorch port imports without JAX and never imports the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))
SMOKE = ROOT / "chip_smoke.py"


def _modules():
    for p in PORT_FILES:
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _banned_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                yield f"{path.relative_to(ROOT)}:{node.lineno}: {name}"


def test_port_modules_exist():
    mods = list(_modules())
    for m in ("repro_torch.core.step", "repro_torch.kernels.kge_score.ops",
              "repro_torch.kernels.sparse_adagrad.ops", "repro_torch.launch.train",
              "repro_torch.kernels.flash_attention.ops", "repro_torch.models.transformer",
              "repro_torch.models.steps", "repro_torch.launch.serve",
              "repro_torch.models.ssm", "repro_torch.kernels.ssd_scan.ops",
              "repro_torch.kernels.ssd_scan.ref", "repro_torch.core.distributed",
              "repro_torch.core.graph_part", "repro_torch.core.rel_part",
              "repro_torch.embeddings.kvstore", "repro_torch.common.collectives",
              "repro_torch.launch.mesh", "repro_torch.optim.dense",
              "repro_torch.optim.api", "repro_torch.examples.train_lm_smoke"):
        assert m in mods


@pytest.mark.parametrize("path", PORT_FILES + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    assert path.exists(), path
    assert list(_banned_imports(path)) == []


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_version_sensitive_torch_symbols_only_in_compat():
    """``torch.testing._internal`` (the fake process group) and
    ``torch.utils.flop_counter`` are imported by ``common/compat.py`` alone."""
    compat = PORT / "common" / "compat.py"
    found = []
    for path in PORT_FILES + [SMOKE]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            if any(n.startswith(("torch.testing._internal", "torch.utils.flop_counter"))
                   for n in names):
                found.append(path)
    assert found and set(found) == {compat}
