"""A cell's traced steps split by the port's spans: each phase's host and
device time, the device's idle time by what the trainer thread was doing,
the launches a step and the sampler's share of the step.

    python3 kgebench/phases.py --workload rescal-fb15k.train --seed 7

from the root of a checkout, on the card. It drives the cell's program as
``run.py`` does, with the port's registry tracing spans: ``--warmup``
steps, then ``--steps`` under torch.profiler with the device's activity
alone, as ``run.py --trace 1`` traces them. The idle split goes to stderr;
the last line is a JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def run(cell, seed: int, device, warmup: int, steps: int) -> dict:
    """``warmup`` steps of ``cell``'s program, then ``steps`` traced ones;
    the slice's numbers: ``spans.Attribution``'s, the metrics they feed,
    and the step's device time and idle share by ``run.py``'s readers."""
    from repro_torch.common import telemetry

    from kgebench import harness, load_module, spans
    from kgebench import trace as T

    harness.set_precision(cell.config)
    clock = harness.Clock(device)
    if clock.cuda:
        from repro_torch.kernels import build

        build.build(cell.workload["kernels"])
    prog = harness.Program(cell.spec, harness.graph_train(cell), seed, device)
    window = harness.WindowHook(clock, warmup, steps)
    with telemetry.active(trace=True) as reg:
        prog.loop(warmup + steps, hooks=[window])
    tr = T.from_profiler(window.prof, steps, window.tp1 - window.tp0)
    rec = harness.Record(spec=cell.spec, setup_s=0.0, window_s=0.0, steps=0,
                         step_ms=[], batches=[], trace=tr)
    out = {"steps": steps, "window_s": tr.window_s}
    for name in ("step_device_ms", "device_idle_share"):  # as run.py reads them
        out[name] = load_module(cell.bench / "metrics" / f"{name}.py").read(rec)
    _, att = spans.slice_attribution(spans.from_profiler(window.prof), reg.trace_json(),
                                     window.tp0, window.tp1,
                                     window.counts[1].get(spans.DROPPED, 0.0))
    if att is not None:
        out["attribution"] = vars(att)
        if clock.cuda:  # a CPU run has no device metric
            out["metrics"] = att.metrics()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 kgebench/phases.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--warmup", type=int, default=None,
                    help="steps before the traced ones (default: the cell's "
                         "warm-up and least window steps)")
    ap.add_argument("--steps", type=int, default=None,
                    help="traced steps (default: the cell's traced_steps)")
    args = ap.parse_args(argv)

    import torch

    from kgebench import harness

    if not torch.cuda.is_available():
        print("no CUDA device: the trace is of the card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    w = cell.workload
    t0 = time.perf_counter()
    out = run(cell, args.seed % 2**63, torch.device("cuda", 0),
              args.warmup or w["warmup_steps"] + w["min_window_steps"],
              args.steps or w["traced_steps"])
    att = out.get("attribution")
    if att is not None:
        for label, us in sorted(att["idle_us"].items(), key=lambda kv: -kv[1]):
            print(f"idle while the trainer was in {label}: {us / 1e3 / att['steps']:.4f} ms "
                  f"a step ({100 * us / att['window_us']:.3f}% of the window)",
                  file=sys.stderr)
    out.update(workload=args.workload, seed=args.seed, run_s=time.perf_counter() - t0,
               device=torch.cuda.get_device_name(0), power_limit=harness.power_limit())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
