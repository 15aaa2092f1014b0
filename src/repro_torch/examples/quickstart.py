"""Quickstart: train TransE with DGL-KE's joint negative sampling on a small
synthetic KG and evaluate filtered MRR; the twin of examples/quickstart.py.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse
import functools

import numpy as np
import torch

from repro_torch.common.config import KGEConfig
from repro_torch.common.device import resolve_device
from repro_torch.core import eval as E
from repro_torch.core.kge_model import batch_to_device, init_state, train_step
from repro_torch.core.sampling import JointSampler
from repro_torch.data.kg_synth import make_synthetic_kg
from repro_torch.launch.engine import LoggingHook, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--steps", type=int, default=900)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    kg = make_synthetic_kg(n_entities=2000, n_relations=40, n_edges=40_000,
                           n_clusters=8, seed=0)
    cfg = KGEConfig(
        model="transe_l2", n_entities=kg.n_entities, n_relations=kg.n_relations,
        dim=64, gamma=10.0, batch_size=512, neg_sample_size=128,
        neg_deg_ratio=0.5, lr=0.25, n_parts=1,
    )
    state = init_state(cfg, torch.Generator().manual_seed(0), device=dev)
    step = functools.partial(train_step, cfg)
    sampler = JointSampler(kg.train, cfg.n_entities, cfg, np.random.default_rng(0))
    state = train_loop(step, state,
                       lambda: (batch_to_device(sampler.sample(), dev), None),
                       n_steps=args.steps, hooks=[LoggingHook(log_every=100)])
    fm = E.build_filter_map(kg.triplets)
    ranks = E.ranks_against_all(cfg, state, kg.test[:500], filter_map=fm)
    met = E.metrics_from_ranks(ranks)
    print("filtered eval:", met)
    if not met.mrr > 0.2:
        raise SystemExit(f"TransE should learn the planted structure: MRR {met.mrr}")
    print("OK")
    return met


if __name__ == "__main__":
    main()
