"""KGE training driver of the port (the paper's workload), single machine.

    PYTHONPATH=src python -m repro_torch.launch.train --dataset fb15k \\
        --model transe_l2 --steps 200

runs on the GPU through the port's CUDA kernels; ``--device cpu`` runs the
same code with the kernels' plain PyTorch versions. Without ``--device cpu``
and without a GPU it raises.

Switchable as in the JAX package's launch/train.py:
    --neg-mode joint|naive        (T1)
    --neg-deg-ratio 0.5           (T2)
    --no-overlap                  (T5 off; joint mode defers entity updates
                                   by default)

Not ported yet, and refused with the ROADMAP item that ports them: eval
(--eval, --eval-every), checkpoints (--ckpt-dir, --resume), Hogwild
(--trainers/--samplers > 1), the distributed path (--distributed,
--pipeline-depth, --push-every) and telemetry files (--metrics-out,
--trace-out).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

# flag -> ROADMAP item that ports it
NOT_PORTED = {
    "eval": "Queue A5 (eval)",
    "eval_every": "Queue A5 (eval)",
    "ckpt_dir": "Queue A5 (checkpoint)",
    "resume": "Queue A5 (checkpoint)",
    "trainers": "Queue A6 (Hogwild)",
    "samplers": "Queue A6 (Hogwild)",
    "distributed": "Queue A7 (distributed)",
    "pipeline_depth": "Queue A8 (pipelined I/O)",
    "push_every": "Queue A8 (pipelined I/O)",
    "metrics_out": "Queue A9 (benchmarks and telemetry files)",
    "trace_out": "Queue A9 (benchmarks and telemetry files)",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--dataset", default="fb15k", choices=["fb15k", "wn18", "freebase"])
    ap.add_argument("--model", default="transe_l2")
    ap.add_argument("--dim", type=int, default=0)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=0)
    ap.add_argument("--neg", type=int, default=0)
    ap.add_argument("--neg-mode", default="joint", choices=["joint", "naive"])
    ap.add_argument("--neg-deg-ratio", type=float, default=-1.0)
    ap.add_argument("--lr", type=float, default=0.0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="synthetic graph scale vs the paper's dataset")
    ap.add_argument("--no-overlap", action="store_true")
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    # accepted so that the reference's command lines fail loudly, not oddly
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--trainers", type=int, default=1)
    ap.add_argument("--samplers", type=int, default=1)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--pipeline-depth", type=int, default=0)
    ap.add_argument("--push-every", type=int, default=1)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--trace-out", default="")
    return ap


def make_config(args):
    """The dataset's config and synthetic graph, with the flags' overrides."""
    from repro_torch.configs import KGE_DATASETS
    from repro_torch.data.kg_synth import fb15k_like, freebase_like, wn18_like

    cfg = KGE_DATASETS[args.dataset]
    gen = {"fb15k": fb15k_like, "wn18": wn18_like, "freebase": freebase_like}[
        args.dataset]
    kg = gen(scale=args.scale if args.dataset != "freebase" else 0.001 * args.scale,
             seed=args.seed)
    upd = dict(model=args.model, n_entities=kg.n_entities,
               n_relations=kg.n_relations)
    if args.dim:
        upd["dim"] = args.dim
        upd["rel_dim"] = 0  # re-derived from the overridden dim
    if args.batch_size:
        upd["batch_size"] = args.batch_size
    if args.neg:
        upd["neg_sample_size"] = args.neg
    if args.lr:
        upd["lr"] = args.lr
    if args.neg_deg_ratio >= 0:
        upd["neg_deg_ratio"] = args.neg_deg_ratio
    if args.no_overlap:
        upd["overlap_update"] = False
    if args.model == "transr":
        upd["rel_dim"] = min(64, cfg.dim)
    return dataclasses.replace(cfg, **upd), kg


def train(args, hooks: Sequence = ()):
    """Single-machine training; returns ``(cfg, state)``. ``hooks`` run after
    the entry point's own LoggingHook."""
    from repro_torch.common.device import resolve_device
    from repro_torch.core.kge_model import (
        batch_to_device, init_state, naive_train_step, train_step,
    )
    from repro_torch.core.sampling import JointSampler, NaiveSampler
    from repro_torch.launch.engine import LoggingHook, train_loop

    defaults = build_parser().parse_args([])
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag) != getattr(defaults, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not yet ported to repro_torch: "
                f"ROADMAP {item}")
    dev = resolve_device(args.device)
    cfg, kg = make_config(args)
    print(f"graph: {kg.n_entities} entities, {kg.n_relations} relations, "
          f"{kg.triplets.shape[0]} triplets; device {dev}")

    # T5 overlap on the joint path only: the naive strawman keeps immediate
    # updates, matching the paper's baseline (and the JAX launch/train.py)
    overlap = cfg.overlap_update and args.neg_mode == "joint"
    state = init_state(cfg, torch.Generator().manual_seed(args.seed),
                       overlap=overlap, device=dev)
    rng = np.random.default_rng(args.seed)
    if args.neg_mode == "joint":
        sampler = JointSampler(kg.train, cfg.n_entities, cfg, rng)
        step = functools.partial(train_step, cfg)
    else:
        sampler = NaiveSampler(kg.train, cfg.n_entities, cfg, rng)
        step = functools.partial(naive_train_step, cfg)

    hooks = [LoggingHook(args.log_every, batch_size=cfg.batch_size), *hooks]
    state = train_loop(step, state,
                       lambda: (batch_to_device(sampler.sample(), dev), None),
                       args.steps, hooks=hooks)
    return cfg, state


def main(argv=None, hooks: Sequence = ()):
    return train(build_parser().parse_args(argv), hooks)


if __name__ == "__main__":
    main()
