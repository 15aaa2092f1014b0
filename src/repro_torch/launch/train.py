"""KGE training entry point of the port (the paper's workload).

    PYTHONPATH=src python -m repro_torch.launch.train --dataset fb15k \\
        --model transe_l1 --steps 200 --eval --eval-n 2000 \\
        --ckpt-dir build/ckpt --save-every 100
    PYTHONPATH=src python -m repro_torch.launch.train --dataset fb15k \\
        --model transe_l1 --steps 300 --ckpt-dir build/ckpt --resume
    PYTHONPATH=src python -m repro_torch.launch.train --dataset fb15k \\
        --trainers 4 --samplers 4 --steps 200 \\
        --metrics-out build/m.jsonl --trace-out build/t.json
    PYTHONPATH=src python -m repro_torch.launch.train --dataset fb15k \\
        --distributed --mesh 2x2 --device cpu --steps 20 --scale 0.05
    PYTHONPATH=src python -m repro_torch.launch.train --dataset fb15k \\
        --distributed --mesh 2x2 --device cpu --steps 20 --scale 0.05 \\
        --pipeline-depth 1 --push-every 4
    PYTHONPATH=src python -m repro_torch.launch.train --dataset fb15k \\
        --distributed --mesh 2x2 --device cpu --steps 20 --scale 0.05 \\
        --trainers 2 --samplers 2

runs on the GPU through the port's CUDA kernels; ``--device cpu`` runs the
same code with the kernels' plain PyTorch versions. Without ``--device cpu``
and without a GPU it raises.

Switchable as in the JAX package's launch/train.py:
    --neg-mode joint|naive        (T1)
    --neg-deg-ratio 0.5           (T2)
    --no-overlap                  (T5 off; joint mode defers entity updates
                                   by default)
    --eval, --eval-every K        (filtered MRR/Hit@k on the first --eval-n
                                   test triplets, after training and every K
                                   steps; protocol 2 above 60,000 entities)
    --ckpt-dir, --save-every K, --resume
                                  (checkpoints in the JAX package's layout,
                                   every K steps and at the end; resume from
                                   the latest)
    --trainers N                  (§3.1 Hogwild trainer threads on one card;
                                   in joint mode each computes gradients
                                   against possibly stale tables and applies
                                   them to the latest; in naive mode, and
                                   with --distributed, trainers share the
                                   whole-step swap)
    --samplers N                  (§3.3 sampler workers feeding one bounded
                                   batch queue, each with its own RNG stream;
                                   with --distributed one queue each, and
                                   step t takes sampler t mod N's batch, so
                                   every rank steps one batch sequence and
                                   issues its collectives in one order)
    --metrics-out F, --trace-out F
                                  (JSONL telemetry snapshots every
                                   --log-every steps; a Chrome trace with one
                                   track per trainer and sampler)

    --distributed --mesh MxS      (the cluster path, core/distributed.py:
                                   M machines x S dim-striped KVStore
                                   servers, one process per rank, launched
                                   by this command; gloo on --device cpu,
                                   NCCL with one rank per card on cuda)
    --partitioner metis|random    (T3; distributed only)
    --remote-capacity R           (KVStore remote rows per machine a step)
    --pipeline-depth 1            (distributed only: the pull for batch t+1
                                   is issued before the push of batch t;
                                   one-step-stale reads)
    --push-every K                (distributed only: remote grads merge in
                                   per-peer buffers and leave in one
                                   deduplicated all_to_all every K steps)
    --use-kernel                  (accepted for the reference's command
                                   lines: the port's kernels are chosen by
                                   the device, so this trains on cuda and is
                                   refused on --device cpu)

Single-machine multi-trainer and pipelined I/O turn T5 overlap off (each
already overlaps updates with compute; the deferred buffers are
single-writer), as in the JAX package, and the two cannot be combined.
Distributed trainers keep T5 on, as JAX's do: their steps are serialised.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch


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
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--eval-n", type=int, default=2000)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="periodic eval every K steps; also enables the "
                         "final eval")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--trainers", type=int, default=1,
                    help="Hogwild trainer threads (paper §3.1)")
    ap.add_argument("--samplers", type=int, default=1,
                    help="sampler worker threads (paper §3.3)")
    ap.add_argument("--metrics-out", default="",
                    help="write JSONL telemetry snapshots here "
                         "(schema: docs/TELEMETRY.md)")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON here (one track "
                         "per trainer and sampler)")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--mesh", default="4x2",
                    help="distributed: machines x servers, e.g. 2x2")
    ap.add_argument("--partitioner", default="metis", choices=["metis", "random"])
    ap.add_argument("--remote-capacity", type=int, default=0)
    ap.add_argument("--use-kernel", action="store_true",
                    help="the reference's kernel switch: the port's kernels "
                         "run on every CUDA tensor, so this needs --device cuda")
    ap.add_argument("--pipeline-depth", type=int, default=0, choices=[0, 1],
                    help="distributed only: 1 = double-buffered KVStore pull "
                         "prefetch (issue the pull for batch t+1 before the "
                         "push of batch t; one-step-stale reads)")
    ap.add_argument("--push-every", type=int, default=1,
                    help="distributed only: coalesce remote grad pushes in "
                         "per-peer merge buffers and flush them as one "
                         "deduplicated all_to_all every K steps")
    return ap


def _pipelined(args) -> bool:
    return args.pipeline_depth > 0 or args.push_every > 1


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
    if args.remote_capacity:
        upd["remote_capacity"] = args.remote_capacity
    upd["partitioner"] = args.partitioner
    if args.model == "transr":
        upd["rel_dim"] = min(64, cfg.dim)
    return dataclasses.replace(cfg, **upd), kg


def train(args, hooks: Sequence = ()):
    """Train; returns ``(cfg, state)``: the single-machine ``KGEState``, or
    with ``--distributed`` the global state dict (numpy, the reference's
    keys and shapes) gathered on rank 0. ``hooks`` run after the entry
    point's own logging, telemetry, checkpoint and eval hooks (on rank 0,
    with rank 0's state blocks, when distributed).

    With ``--metrics-out`` or ``--trace-out`` an enabled telemetry registry
    is installed for the run and the previous one restored after it."""
    from repro_torch.common import telemetry

    if _pipelined(args) and (args.trainers > 1 or args.samplers > 1):
        raise SystemExit("--pipeline-depth/--push-every are incompatible "
                         "with --trainers/--samplers > 1 (the lookahead is "
                         "single-consumer; see launch/engine.train_loop)")
    if args.use_kernel and args.device != "cuda":
        raise ValueError(
            "--use-kernel: the port's kernels run on CUDA tensors only, and "
            f"--device {args.device} runs their plain versions; drop "
            "--use-kernel, or train on --device cuda (where every step "
            "launches the kernels)")
    run = _train_distributed if args.distributed else _train
    if not (args.metrics_out or args.trace_out):
        return run(args, hooks)
    prev = telemetry.set_registry(
        telemetry.MetricsRegistry(enabled=True, trace=bool(args.trace_out)))
    try:
        return run(args, hooks)
    finally:
        telemetry.set_registry(prev)


def _train(args, hooks):
    from repro_torch.common.checkpoint import latest_step, restore_checkpoint
    from repro_torch.common.device import resolve_device
    from repro_torch.core import eval as E
    from repro_torch.core.kge_model import (
        batch_to_device, flush_state, init_state, make_hogwild_step,
        naive_train_step, train_step,
    )
    from repro_torch.core.sampling import JointSampler, NaiveSampler
    from repro_torch.data.pipeline import worker_rngs
    from repro_torch.launch.engine import (
        CheckpointHook, EvalHook, LoggingHook, TelemetryHook, train_loop,
    )

    dev = resolve_device(args.device)
    cfg, kg = make_config(args)
    print(f"graph: {kg.n_entities} entities, {kg.n_relations} relations, "
          f"{kg.triplets.shape[0]} triplets; device {dev}")

    hogwild = args.trainers > 1
    # T5 overlap on the joint path only: the naive strawman keeps immediate
    # updates, matching the paper's baseline (and the JAX launch/train.py).
    # Hogwild replaces it: the deferred buffers are single-writer.
    overlap = cfg.overlap_update and args.neg_mode == "joint" and not hogwild
    if hogwild and cfg.overlap_update and args.neg_mode == "joint":
        print(f"{args.trainers} trainers: T5 overlap off "
              "(Hogwild already overlaps updates with compute)")
    state = init_state(cfg, torch.Generator().manual_seed(args.seed),
                       overlap=overlap, device=dev)
    split_step = None
    if args.neg_mode == "joint":
        sampler_cls = JointSampler
        step = functools.partial(train_step, cfg)
        if hogwild:  # stale-gradient two-phase step (paper §3.1)
            split_step = make_hogwild_step(cfg)
    else:  # trainers share the whole-step swap
        sampler_cls = NaiveSampler
        step = functools.partial(naive_train_step, cfg)
    sampler = sampler_cls(kg.train, cfg.n_entities, cfg,
                          np.random.default_rng(args.seed))
    samplers = [sampler_cls(kg.train, cfg.n_entities, cfg, r)
                for r in worker_rngs(args.seed, max(1, args.samplers))]

    def sampler_factory(wid):
        s = samplers[wid]
        return lambda: (batch_to_device(s.sample(), dev), None)

    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state = restore_checkpoint(args.ckpt_dir, state)
        start = state.step
        print(f"resumed from step {start}")

    flush = functools.partial(flush_state, cfg)
    own = [LoggingHook(args.log_every, batch_size=cfg.batch_size, start=start)]
    if args.metrics_out or args.trace_out:
        own.append(TelemetryHook(metrics_out=args.metrics_out or None,
                                 trace_out=args.trace_out or None,
                                 every=max(1, args.log_every)))
    if args.ckpt_dir:
        own.append(CheckpointHook(args.ckpt_dir, args.save_every, flush))
    filter_map = {}

    def evaluate(state):
        flush(state)
        test = kg.test[: args.eval_n]
        if cfg.n_entities <= 60_000:
            if not filter_map:
                filter_map.update(E.build_filter_map(kg.triplets))
            ranks = E.ranks_against_all(cfg, state, test, filter_map=filter_map)
        else:
            ranks = E.ranks_protocol2(cfg, state, test,
                                      kg.degrees().astype(np.float64))
        print("eval:", E.metrics_from_ranks(ranks))

    if args.eval or args.eval_every:
        own.append(EvalHook(evaluate, eval_every=args.eval_every))
    state = train_loop(step, state,
                       lambda: (batch_to_device(sampler.sample(), dev), None),
                       args.steps, start=start, hooks=[*own, *hooks],
                       n_trainers=args.trainers, n_samplers=args.samplers,
                       sampler_factory=sampler_factory, split_step=split_step)
    return cfg, state


def _train_distributed(args, hooks):
    from repro_torch.common.device import resolve_device
    from repro_torch.launch.mesh import parse_mesh, run_world

    M, S = parse_mesh(args.mesh)
    dev = resolve_device(args.device)
    return run_world(M, S, _dist_rank, (args,), device=dev,
                     rank0_kwargs=dict(hooks=tuple(hooks)))


def _dist_rank(grid, args, hooks=()):
    """One rank of ``--distributed``: the reference's
    ``launch/train.py::_train_distributed`` on this rank's blocks. Rank 0
    prints, logs, writes the telemetry files and the checkpoints (the
    global state, gathered from every rank); ``hooks`` run on the rank
    they are given to (``train`` gives them to rank 0).

    With ``--trainers/--samplers`` above 1 every rank builds the same
    samplers from ``worker_rngs(seed, N)`` and steps in the ordered mode of
    the runtime: step t takes sampler ``t mod N``'s batch, and the steps,
    with their hooks (the checkpoint gathers among them), run in that
    order on every rank."""
    from repro_torch.common.checkpoint import (
        latest_step, restore_checkpoint, save_checkpoint,
    )
    from repro_torch.core.distributed import (
        batch_to_rank, build_pipelined_dist_step, dist_state_from_arrays,
        gather_dist_state, init_dist_state, make_program,
    )
    from repro_torch.core.graph_part import cut_fraction, partition
    from repro_torch.core.rel_part import relation_partition
    from repro_torch.core.sampling import DistSampler
    from repro_torch.data.pipeline import worker_rngs
    from repro_torch.launch.engine import (
        CheckpointHook, LoggingHook, TelemetryHook, train_loop,
    )

    lead = grid.rank == 0
    say = print if lead else (lambda *a, **k: None)
    cfg, kg = make_config(args)
    n_parts = grid.M
    cfg = dataclasses.replace(cfg, n_parts=n_parts)
    say(f"graph: {kg.n_entities} entities, {kg.n_relations} relations, "
        f"{kg.triplets.shape[0]} triplets; mesh {grid.M}x{grid.S}, "
        f"{grid.world} ranks on {grid.device.type}")
    book = partition(kg.train, cfg.n_entities, n_parts, method=args.partitioner,
                     seed=args.seed)
    say(f"partitioner={args.partitioner} cut={cut_fraction(kg.train, book.part_of):.3f}")
    rp = relation_partition(kg.rel_counts(), n_parts, seed=args.seed)
    if _pipelined(args) and cfg.overlap_update:
        say("pipelined KVStore I/O: T5 overlap off (the pipeline is its "
            "own single-writer one-step-stale overlap mechanism)")
        cfg = dataclasses.replace(cfg, overlap_update=False)
    prog = make_program(cfg, book.rows_per_part, rp.slots_per_part, rp.n_shared,
                        pipeline_depth=args.pipeline_depth,
                        push_every=args.push_every)
    sampler = DistSampler(kg.train, book, rp, cfg, np.random.default_rng(args.seed))
    # the eager step itself without --pipeline-depth/--push-every
    step = build_pipelined_dist_step(prog, grid)

    start = 0
    if args.resume and args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        like = {name: np.zeros(shape, dt)
                for name, (shape, dt) in prog.state_shapes().items()}
        state = dist_state_from_arrays(prog, grid,
                                       restore_checkpoint(args.ckpt_dir, like))
        start = state["step"]
        say(f"resumed from step {start}")
    else:
        state = init_dist_state(prog, grid, args.seed)

    def batch_fn(s):
        def make():
            db = s.sample()
            return batch_to_rank(db, grid), db.stats
        return make

    # per-worker DistSamplers with independent RNG streams (§3.3), the same
    # on every rank
    samplers = ([sampler] if args.samplers <= 1 else
                [DistSampler(kg.train, book, rp, cfg, r)
                 for r in worker_rngs(args.seed, args.samplers)])

    def save(ckpt_dir, i, st):
        full = gather_dist_state(prog, grid, st)  # every rank takes part
        if lead:
            save_checkpoint(ckpt_dir, i, full)

    own = []
    if lead:
        own.append(LoggingHook(args.log_every, batch_size=cfg.batch_size * n_parts,
                               start=start))
        if args.metrics_out or args.trace_out:
            own.append(TelemetryHook(metrics_out=args.metrics_out or None,
                                     trace_out=args.trace_out or None,
                                     every=max(1, args.log_every)))
    if args.ckpt_dir:
        own.append(CheckpointHook(args.ckpt_dir, args.save_every, save_fn=save))
    state = train_loop(step, state, batch_fn(sampler), args.steps, start=start,
                       hooks=[*own, *hooks], n_trainers=args.trainers,
                       n_samplers=args.samplers,
                       sampler_factory=lambda wid: batch_fn(samplers[wid]),
                       ordered=True)
    final = gather_dist_state(prog, grid, state)
    say("done")
    return cfg, final


def main(argv=None, hooks: Sequence = ()):
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.distributed and _pipelined(args):
        ap.error("--pipeline-depth/--push-every require --distributed "
                 "(they pipeline the KVStore collectives)")
    return train(args, hooks)


if __name__ == "__main__":
    main()
