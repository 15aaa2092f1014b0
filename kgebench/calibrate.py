"""Read the numbers that ``correct`` compares, for the limits of a cell.

    python3 kgebench/calibrate.py --workload rescal-fb15k.train \
        --seeds 11,12,13 [--controls]

For each seed, in one process: the program's first checked steps from the
seed against the reference's (the sound readings, and each table's own
gaps); with ``--controls`` also, each against the float32 reference, the
control (the reference with its products in TF32, the precision below the
configuration's) and a planted fault (the reference with half of each batch
left out). The port has no TF32 path of its own. A step that leaves the
state unchanged reads 1 on ``param_change`` and ``grad_norm`` by their
definition and needs no run. Prints one JSON line a seed, then the largest
sound reading and the smallest control reading of each number. Needs the
card; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

NUMBERS = ("loss", "grad_norm", "param_change")


def leaf_gaps(got: dict, want: dict) -> dict:
    """Each table's gaps of its first gradient's and its change's norms,
    relative to the reference's norm of that table."""
    return {key: {n: abs(got[key][n] - w) / w if w else None
                  for n, w in want[key].items()}
            for key in ("grad_norms", "change_norms")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 kgebench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--controls", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from kgebench import harness

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    from repro_torch.kernels import build

    build.build(cell.workload["kernels"])
    harness.set_precision(cell.config)
    train = harness.graph_train(cell)
    clock = harness.Clock(dev)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = {"seed": seed}
        prog = harness.Program(cell.spec, train, seed, dev)
        check = harness.CheckHook(prog, cell.workload["check_steps"])
        prog.loop(cell.workload["check_steps"], hooks=[check])
        clock.sync()
        got = check.readings()
        batches = prog.batches[:cell.workload["check_steps"]]
        del prog, check
        gc.collect()
        torch.cuda.empty_cache()
        want, ref_batches = harness.reference_readings(cell, train, seed, dev)
        row["sound"] = harness.compare(got, want)
        row["sound_leaves"] = leaf_gaps(got, want)
        row["batch_ids"] = harness.batch_id_diff(batches, ref_batches)
        row["losses"] = got["losses"]
        if args.controls:
            for name, kw in (("reference_tf32", {"tf32": True}),
                             ("half_batch", {"fault": "half_batch"})):
                ctl, _ = harness.reference_readings(cell, train, seed, dev, **kw)
                row[name] = harness.compare(ctl, want)
                row[f"{name}_leaves"] = leaf_gaps(ctl, want)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {"lower (max sound)": {k: max(r["sound"][k] for r in rows) for k in NUMBERS}}
    for name in ("reference_tf32", "half_batch"):
        if args.controls:
            summary[f"upper {name} (min)"] = {k: min(r[name][k] for r in rows)
                                             for k in NUMBERS}
    summary["batch_ids (max)"] = max(r["batch_ids"] for r in rows)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
