"""End-to-end driver: FB15k-scale KGE training (paper Tables 5/8 analogue);
the twin of examples/train_fb15k_scale.py, through the port's CLI.

Trains TransE_l2 (or --model) on a synthetic graph with FB15k's exact shape
(14,951 entities / 1,345 relations / 592k triplets) for a few thousand steps
and reports filtered Hit@k / MR / MRR — the paper's evaluation protocol 1.

    PYTHONPATH=src python -m repro_torch.examples.train_fb15k_scale [--steps 3000]
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]  # the directory holding repro_torch


def env_with_src() -> dict:
    """This environment, with the port's source directory first on
    PYTHONPATH."""
    path = [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(path))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_fb15k_scale")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--model", default="transe_l2")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--trainers", type=int, default=1,
                    help="Hogwild trainer threads (paper §3.1)")
    ap.add_argument("--samplers", type=int, default=1,
                    help="sampler worker threads (paper §3.3)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="periodic MRR every K steps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    cmd = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--dataset", "fb15k", "--model", args.model,
        "--steps", str(args.steps), "--scale", str(args.scale),
        "--dim", "128", "--eval", "--eval-n", "1000",
        "--trainers", str(args.trainers), "--samplers", str(args.samplers),
        "--eval-every", str(args.eval_every), "--device", args.device,
    ]
    print(" ".join(cmd))
    subprocess.run(cmd, check=True, env=env_with_src())


if __name__ == "__main__":
    main()
