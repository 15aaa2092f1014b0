"""Run one cell of the benchmark and print its result as the last line.

    python3 kgebench/run.py --workload rescal-fb15k.train --seed 7 \
        --seconds 10 --trace 0

from the root of a checkout that holds ``src/`` (the port) beside
``kgebench/``. Needs a CUDA card: without one, or with fewer cards than
the cell asks for, it exits with 2 and prints no result. Every run
profiles the device's activity over the cell's ``traced_steps`` after the
window, from which ``step_device_ms`` is read; ``--trace 1`` also hands the
readers the port's spans and counters over those steps and reports the
cell's per-layer metrics instead of its end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up runs from here to the first timed step

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 kgebench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    import torch

    from kgebench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2

    def log(msg):
        print(f"[{time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr,
              flush=True)

    seed = args.seed % 2**63
    out = harness.run_cell(cell, seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START, log=log)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    out["device"]["power_limit"] = harness.power_limit()
    log(f"card and power limit: {out['device']['power_limit']}")
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
