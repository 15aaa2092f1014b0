"""Nothing of the benchmark imports JAX or the JAX package, by whole
top-level names (the port's name, ``repro_torch``, begins with the JAX
package's), and the command fails without a card."""

import ast
import os
import shutil
import subprocess
import sys

from _tiny import ROOT

from kgebench import harness

BENCH = ROOT / "kgebench"


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = set(_top_level_imports(f)) & set(harness.FORBIDDEN)
        assert not bad, f"{f}: imports {bad}"
        assert "benchmarks/" not in f.read_text() or f.parent.name == "tests", f


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return env


def test_a_tiny_run_loads_no_jax_module(tmp_path):
    """A whole run of a tiny cell on the CPU, in a fresh interpreter, then
    ``sys.modules``."""
    code = f"""
import sys, torch
sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(ROOT)!r}]
from _tiny import tiny
from kgebench import graph, harness
import pathlib
graph.CACHE_DIR = pathlib.Path({str(tmp_path)!r})
cell = tiny(harness.load_cell("transr-fb15k.train"))
out = harness.run_cell(cell, 3, 0.1, True, torch.device("cpu"), 0.0, window_steps=4)
assert out["correct"], out
print(harness.forbidden_modules())
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), timeout=300, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_fails_without_a_card_and_without_the_port(tmp_path):
    cmd = [sys.executable, "kgebench/run.py", "--workload", "rescal-fb15k.train",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, env=_env(),
                         timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    # a directory that holds only BENCHMARK.json and the benchmark's files
    shutil.copytree(BENCH, tmp_path / "kgebench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = _env()
    env["PYTHONPATH"] = ""
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path, env=env,
                         timeout=120)
    assert res.returncode != 0 and res.stdout == ""
