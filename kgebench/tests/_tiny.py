"""Tiny versions of the benchmark's cells, for CPU tests."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny(cell):
    """Shrink a loaded cell in place to a size the CPU runs in a moment.

    The cells' limits were read at their own sizes on the card; at this size
    float32's rounding gaps are of other sizes, so the check takes 1e-5 for
    the three norms' gaps here: sound runs read under 1e-7, the planted
    faults 1e-3 and more."""
    c = cell.config
    c["dataset"].update(n_entities=300, n_relations=12, n_edges=6000, n_clusters=4)
    c.update(dim=8, rel_dim=8, batch_size=32, neg_sample_size=8, neg_group_size=16)
    cell.workload.update(warmup_steps=4, traced_steps=3)
    cell.workload["limits"].update(loss=1e-5, grad_norm=1e-5, param_change=1e-5)
    return cell


def cells():
    """Every cell ``BENCHMARK.json`` names, for the tests that take each."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in manifest["workloads"]]
