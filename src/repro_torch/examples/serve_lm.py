"""Serve a small LM with batched requests: prefill-free token-by-token decode
with KV/SSM caches, through the port's serve CLI (reduced config); the twin
of examples/serve_lm.py.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mamba2-2.7b
"""

import argparse
import subprocess
import sys

from repro_torch.examples.train_fb15k_scale import env_with_src


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_lm")
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", args.arch,
           "--batch", "4", "--prompt-len", "16", "--gen", "8",
           "--device", args.device]
    print(" ".join(cmd))
    subprocess.run(cmd, check=True, env=env_with_src())


if __name__ == "__main__":
    main()
