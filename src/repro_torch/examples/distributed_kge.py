"""Distributed KGE on a world of 4 machines x 2 KVStore servers: METIS-like
vs random partitioning, the paper's Fig. 7 experiment at miniature scale;
the twin of examples/distributed_kge.py. Shows cut fraction, training loss,
and throughput.

    PYTHONPATH=src python -m repro_torch.examples.distributed_kge --device cpu

The world is 8 processes (``launch.mesh.run_world``): gloo on the CPU, or
NCCL with one rank per card, which needs 8 cards. Two sampler workers with
independent RNG streams feed each rank; every rank steps their batches in
one order (the runtime's ordered mode).
"""

import argparse
import time

from repro_torch.common.config import KGEConfig
from repro_torch.common.device import resolve_device
from repro_torch.core.distributed import (
    batch_to_rank, build_dist_train_step, init_dist_state, make_program,
)
from repro_torch.core.graph_part import cut_fraction, partition
from repro_torch.core.rel_part import relation_partition
from repro_torch.core.sampling import DistSampler
from repro_torch.data.kg_synth import make_synthetic_kg
from repro_torch.data.pipeline import worker_rngs
from repro_torch.launch.engine import Hook, MetricsHook, train_loop
from repro_torch.launch.mesh import run_world

MESH = (4, 2)  # machines x servers


class DropCounter(Hook):
    def __init__(self):
        self.drops = 0

    def on_step(self, i, state, metrics, stats):
        self.drops += stats["dropped"]


def run(grid, partitioner: str, kg, cfg, steps: int):
    """One partitioner's run on this rank: (cut, losses, steps/s, drops)."""
    book = partition(kg.train, cfg.n_entities, cfg.n_parts, method=partitioner)
    rp = relation_partition(kg.rel_counts(), cfg.n_parts)
    prog = make_program(cfg, book.rows_per_part, rp.slots_per_part, rp.n_shared)
    step = build_dist_train_step(prog, grid)

    # two sampler workers with independent RNG streams feed the trainer
    # (paper §3.3 / launch/runtime.py), in one order on every rank
    samplers = [DistSampler(kg.train, book, rp, cfg, r) for r in worker_rngs(0, 2)]

    def batch_fn(s):
        def make():
            db = s.sample()
            return batch_to_rank(db, grid), db.stats
        return make

    mh, dc = MetricsHook(["loss"]), DropCounter()
    state = init_dist_state(prog, grid, 0)
    t0 = time.time()
    train_loop(step, state, batch_fn(samplers[0]), steps, hooks=[mh, dc],
               n_samplers=2, sampler_factory=lambda wid: batch_fn(samplers[wid]),
               ordered=True)
    dt = time.time() - t0
    return cut_fraction(kg.train, book.part_of), mh.history["loss"], steps / dt, dc.drops


def rank_body(grid, steps: int):
    """Both partitioners on this rank of the world; rank 0's results."""
    kg = make_synthetic_kg(n_entities=4000, n_relations=60, n_edges=60_000,
                           n_clusters=16, seed=0)
    cfg = KGEConfig(model="transe_l2", n_entities=kg.n_entities,
                    n_relations=kg.n_relations, dim=64, batch_size=256,
                    neg_sample_size=64, lr=0.1, n_parts=grid.M, remote_capacity=256)
    return {name: run(grid, name, kg, cfg, steps) for name in ("metis", "random")}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.distributed_kge")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one rank per card) or cpu (gloo)")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # the spawned ranks import the body by this module's name, also when it
    # runs as __main__
    from repro_torch.examples import distributed_kge

    results = run_world(*MESH, distributed_kge.rank_body, (args.steps,), device=dev)
    for name, (cut, losses, rate, drops) in results.items():
        print(f"{name:7s}: cut {cut:5.1%}  loss {losses[0]:.3f}->{losses[-1]:.3f}  "
              f"{rate:5.1f} steps/s  dropped {drops}")
    cm, cr = results["metis"][0], results["random"][0]
    if not cm < cr:
        raise SystemExit("METIS-like partitioning must beat random on clustered "
                         f"graphs: cut {cm:.1%} vs {cr:.1%}")
    print("OK — min-cut partitioning reduces remote entity traffic "
          f"({cm:.1%} vs {cr:.1%} cut)")
    return results


if __name__ == "__main__":
    main()
