"""BENCHMARK.json and the benchmark's files agree, keep the contract's
names, and take a new cell as new files plus a manifest entry."""

import json
import re
import shutil

import pytest

from _tiny import ROOT, tiny

import torch

from kgebench import graph, harness

torch.set_num_threads(2)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(graph, "CACHE_DIR", tmp_path / "cache")


def test_manifest_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["kgebench"]
    assert MANIFEST["command"] == ["python3", "kgebench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51


def test_names_and_units():
    entries = (MANIFEST["configs"] + MANIFEST["workloads"]
               + MANIFEST["end_to_end"] + MANIFEST["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))


def test_every_cell_has_its_files_and_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (ROOT / "kgebench" / "metrics" / f"{m['name']}.py").is_file()
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= {w["name"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert (ROOT / "kgebench" / "reference" / f"{conf['model']}.py").is_file()
    for w in MANIFEST["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert set(cell.workload["limits"]) == set(harness.CHECKED)


def _contents(folder):
    return {f: f.read_bytes() for f in folder.rglob("*") if f.is_file()}


def test_a_new_config_cell_and_metric_are_new_files_and_entries(tmp_path, cache):
    """A copy of the benchmark plus a configuration file, a workload file and
    metric readers (one of the host's clock, one of a registry counter, one
    of the port's spans), and their manifest entries, no existing file
    edited, runs the new cell (tiny, on the CPU) and reports the new
    metrics."""
    shutil.copytree(ROOT / "kgebench", tmp_path / "kgebench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = tmp_path / "kgebench"
    before = _contents(bench)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    first = manifest["workloads"][0]
    conf = json.loads((ROOT / "kgebench/configs/rescal-fb15k.json").read_text())
    conf["name"] = "rescal-fb15k-b"
    (bench / "configs/rescal-fb15k-b.json").write_text(json.dumps(conf))
    manifest["configs"].append(dict(manifest["configs"][0], name="rescal-fb15k-b",
                                    file="kgebench/configs/rescal-fb15k-b.json"))
    new = dict(first, name="rescal-fb15k-b.train", config="rescal-fb15k-b",
               why="a copy under new names")
    manifest["workloads"].append(new)
    work = json.loads((bench / "workloads" / f"{first['name']}.json").read_text())
    work["config"] = "rescal-fb15k-b"
    (bench / "workloads/rescal-fb15k-b.train.json").write_text(json.dumps(work))
    (bench / "metrics/window_steps.py").write_text(
        "def read(rec):\n    return float(rec.steps)\n")
    (bench / "metrics/fused_proj_per_step.py").write_text(
        "def read(rec):\n"
        "    n = rec.counters.get('scores/rescal_proj_fused')\n"
        "    return None if n is None else n / rec.trace.steps\n")
    (bench / "metrics/traced_step_spans.py").write_text(
        "def read(rec):\n"
        "    if rec.spans is None:\n"
        "        return None\n"
        "    return float(sum(sp[0] == 'engine/step' for sp in rec.spans))\n")
    for name, unit, source in [("window_steps", "steps", "host_clock"),
                               ("fused_proj_per_step", "launches", "program_counter"),
                               ("traced_step_spans", "steps", "program_span")]:
        manifest["per_layer"].append(
            {"name": name, "unit": unit, "better": "higher", "source": source,
             "layer": "loop", "moves": "step_device_ms",
             "workloads": ["rescal-fb15k-b.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    assert {f: b for f, b in _contents(bench).items() if f in before} == before
    cell = tiny(harness.load_cell("rescal-fb15k-b.train", root=tmp_path))
    assert cell.bench == bench and cell.config["name"] == "rescal-fb15k-b"
    out = harness.run_cell(cell, 5, 0.1, False, torch.device("cpu"), 0.0,
                           window_steps=4)
    # the CPU runs no device op, so a metric read from the device trace is
    # left out of a CPU run's line
    assert out["correct"] and set(out["metrics"]) == {
        m["name"] for m in cell.end_to_end if m["source"] != "device_trace"}
    assert list(out)[-1] == "checks"
    out = harness.run_cell(cell, 6, 0.1, True, torch.device("cpu"), 0.0,
                           window_steps=4)
    assert out["metrics"]["window_steps"]["value"] == 3.0
    # the CPU takes the card's route: one fused projection op a step
    assert out["metrics"]["fused_proj_per_step"]["value"] == 1.0
    assert out["metrics"]["traced_step_spans"]["value"] == cell.workload["traced_steps"]


@pytest.mark.parametrize("key,value", [
    ("optimizer", "adam"), ("dtype", "bfloat16"), ("corrupt_both", False),
    ("loss", "ranking"), ("adversarial_temperature", 2.0),
    ("regularization_coef", 5e-8)])
def test_a_setting_the_benchmark_does_not_implement_is_refused(tmp_path, key, value):
    """A configuration stating a value that neither the program's path here
    nor the reference runs is refused, not run as something else."""
    (tmp_path / "kgebench/configs").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for sub in ("workloads", "traffic"):
        shutil.copytree(ROOT / "kgebench" / sub, tmp_path / "kgebench" / sub)
    for c in MANIFEST["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        conf[key] = value
        (tmp_path / c["file"]).write_text(json.dumps(conf))
    name = MANIFEST["workloads"][0]["name"]
    with pytest.raises(ValueError, match=key):
        harness.load_cell(name, root=tmp_path)
