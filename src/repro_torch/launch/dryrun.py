"""Dry run of the port's programs on the production grid: every (arch x
input shape) and the KGE step are counted on the meta device, with their
roofline terms on an H100 and whether they fit in its 80 GB. The twin of
the JAX package's launch/dryrun.py. Nothing is allocated, no weight is
drawn and no card is needed: parameters, optimizer state, batches and
caches are meta tensors of one rank's shapes.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k [--multi-pod] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun/

The KGE core has its own entry: --kge fb15k|wn18|freebase.

**The world.** The process joins a ``"fake"``-backend world of M x S ranks
as rank 0 (``common/compat.py``) and builds its real subgroups
(``launch/mesh.make_grid``); the production grid is (16, 16), or (32, 16)
for the reference's (2, 16, 16) (``mesh.make_production_grid``). Rank 0's
program is counted (``launch/hlo_analysis.py``): every aten op it
dispatches, each kernel of ``csrc/`` it reaches (on meta a wrapper returns
the kernel's outputs and reports the kernel's work, ``common/cost.py``),
and every collective it issues, at its group's size. The world is always
destroyed in a ``finally``; the dry run refuses to start where a default
process group exists.

**The row** carries the reference's keys (its ``Roofline.row()`` and
``dryrun.py``'s), with ``lower_s`` and ``compile_s`` replaced by one
``trace_s`` and ``xla_cost_analysis`` by ``torch_flop_counter`` (torch's
own ``FlopCounterMode`` total of the same run), and adds ``fits_hbm``
(``bytes_per_device`` within ``H100_SXM.hbm_bytes``), ``matmul_flops``
(the flop formulas' part: the reference's ``dot``/``convolution``) and
``kernels`` (launches, FLOPs and bytes of each kernel of ``csrc/``). Every
time in it is modelled from the data sheet's rates, not measured.

**Per-rank counts on a grid of S > 1 servers.** The reference shards
attention, the dense FFN, the embeddings and the caches over ``model`` as
a GSPMD layout; the port keeps them whole on every rank, each rank on its
machine's rows (a stated divergence, ROADMAP Queue C), and splits only
the MoE experts over the model group. So a rank of an (M, S) grid counts,
for every layer but the experts, what a rank of (M, 1) counts: the same
matmul FLOPs, where the reference's device counts about 1/S of them. For
a dense config the port's matmul FLOPs at (M, S) equal the port's at
(M, 1) (but for the vocab's padding to 128 S) and S times the
reference's at (M, S) (``tests/test_torch_dryrun.py``; ROADMAP Queue C
has the production grid's counts). The KGE step is explicit blocks
in both packages and counts the same at any grid.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common import compat
from repro_torch.common.config import INPUT_SHAPES
from repro_torch.common.hw import H100_SXM
from repro_torch.common.shard import divisible
from repro_torch.launch.hlo_analysis import (
    CollectiveStat, CostMode, HloCost, KernelRecord, Trace, trace,
)
from repro_torch.launch.mesh import make_grid, make_production_grid
from repro_torch.launch.roofline import format_row, roofline_from_cost


@contextlib.contextmanager
def fake_world(M: int, S: int):
    """Rank 0's grid of a ``"fake"``-backend world of M x S ranks, on the
    meta device; the world is destroyed on the way out, whatever
    happened."""
    compat.init_fake_world(M * S)
    try:
        yield make_grid(M, S, "meta")
    finally:
        dist.destroy_process_group()


def _grid_name(M: int, S: int) -> str:
    return f"{M}x{S}"


# ---------------------------------------------------------------- the counts
def count_arch(cfg, shape, grid=None, use_flash: bool = False,
               keep_ops: bool = False) -> Trace:
    """One train step, prefill or decode step of ``cfg`` at ``shape`` on
    this rank of ``grid`` (None: no grid), counted on meta tensors.

    A train step of mb >= 4 microbatches is counted (unless ``keep_ops``
    asks for its op list) from steps of 2 and 3 of the same microbatches:
    every microbatch after the first dispatches the same ops (the first
    starts the gradient sums), so each count is affine in mb, C(mb) = C(2)
    + (mb - 2)(C(3) - C(2)) (``tests/test_torch_dryrun.py`` holds it equal
    to the full count). Eager code dispatches every layer and microbatch;
    this keeps a full-size step's count within a minute."""
    from repro_torch.models.steps import effective_microbatches
    from repro_torch.models.transformer import Model

    if shape.kind == "train" and not keep_ops:
        mb = effective_microbatches(cfg, shape, Model(cfg, grid))
        if mb >= 4:
            rows = shape.global_batch // mb
            two, three = (_count_arch(
                dataclasses.replace(cfg, microbatches=k),
                dataclasses.replace(shape, global_batch=k * rows), grid, use_flash, False)
                for k in (2, 3))
            return extrapolated(two, three, mb - 2)
    return _count_arch(cfg, shape, grid, use_flash, keep_ops)


def _count_arch(cfg, shape, grid, use_flash: bool, keep_ops: bool) -> Trace:
    from repro_torch.models.steps import (
        abstract_inputs, build_prefill_step, build_serve_step, build_train_step,
        input_defs, serve_abstract_args, train_abstract_args,
    )
    from repro_torch.models.transformer import Model

    model = Model(cfg, grid)
    total = grid.world if grid is not None else 1
    if shape.kind == "train":
        step, _ = build_train_step(model, shape=shape)
        args = train_abstract_args(model, shape)
    elif shape.kind == "prefill":
        step = build_prefill_step(model, use_flash=use_flash)
        args = (model.abstract_params(),
                abstract_inputs(input_defs(cfg, shape, model), grid))
    else:  # decode
        step = build_serve_step(model)
        args = serve_abstract_args(model, shape)
    return trace(step, *args, total_devices=total, keep_ops=keep_ops)


def extrapolated(a: Trace, b: Trace, n: int) -> Trace:
    """The count a + n (b - a) of every additive quantity of two traces
    of one program that differ by one repeated part (``count_arch``); the
    peak of live bytes, the larger of the two."""
    def lin(x, y):
        return x + n * (y - x)

    mode = CostMode(total_devices=a.mode.total_devices)
    ca, cb = a.cost, b.cost
    mode.cost = HloCost(flops=lin(ca.flops, cb.flops),
                        hbm_bytes=lin(ca.hbm_bytes, cb.hbm_bytes))
    for kind in cb.collectives:
        sa = ca.collectives.get(kind, CollectiveStat(kind))
        sb = cb.collectives[kind]
        mode.cost.collectives[kind] = CollectiveStat(
            kind, lin(sa.count, sb.count), lin(sa.bytes, sb.bytes),
            lin(sa.raw_bytes, sb.raw_bytes))
    for name, rb in b.mode.kernels.items():
        ra = a.mode.kernels.get(name, KernelRecord())
        mode.kernels[name] = KernelRecord(lin(ra.launches, rb.launches),
                                          lin(ra.flops, rb.flops), lin(ra.bytes, rb.bytes))
    for field in ("matmul_flops", "n_ops", "cross_node_bytes"):
        setattr(mode, field, lin(getattr(a.mode, field), getattr(b.mode, field)))
    # what a repeat holds live is the same in every repeat: no growth
    mode.peak_bytes = max(a.mode.peak_bytes, b.mode.peak_bytes)
    return Trace(mode=mode,
                 torch_flop_counter=lin(a.torch_flop_counter, b.torch_flop_counter),
                 argument_bytes=lin(a.argument_bytes, b.argument_bytes),
                 output_bytes=lin(a.output_bytes, b.output_bytes),
                 alias_bytes=lin(a.alias_bytes, b.alias_bytes))


def kge_program(dataset: str, M: int, S: int, model: str = "",
                overrides: dict | None = None):
    """The reference's ``dryrun_kge`` sizing (src/repro/launch/dryrun.py
    :113-140) for an M x S grid: (cfg, program)."""
    from repro_torch.configs import KGE_DATASETS
    from repro_torch.core.distributed import make_program

    cfg = KGE_DATASETS[dataset]
    if model:
        cfg = dataclasses.replace(cfg, model=model,
                                  rel_dim=64 if model == "transr" else 0)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cfg = dataclasses.replace(cfg, n_parts=M)
    mult = 2 * S if cfg.model in ("complex", "rotate") else S
    if cfg.dim % mult:
        # complex-pair layout needs even dim slices per KVStore server
        cfg = dataclasses.replace(cfg, dim=divisible(cfg.dim, mult),
                                  rel_dim=0 if cfg.model != "transr" else cfg.rel_dim)
    rows = divisible(-(-cfg.n_entities // M), 8)
    rel_slots = max(8, divisible(-(-cfg.n_relations // M), 8))
    return cfg, make_program(cfg, rows, rel_slots, n_shared=8)


def count_kge(prog, grid, keep_ops: bool = False) -> Trace:
    """One ``_device_step`` of ``prog`` on this rank of ``grid``, counted
    on meta tensors: this rank's state blocks and batch row."""
    from repro_torch.core.distributed import (
        BATCH_IDS, LAYOUT, build_dist_train_step,
    )

    state = {}
    for name, (shape, dtype) in prog.state_shapes().items():
        if name == "step":
            state[name] = 0
            continue
        rows, cols = LAYOUT[name]
        shape = list(shape)
        if rows:
            shape[0] //= grid.M
        if cols:
            shape[-1] //= grid.S
        state[name] = torch.empty(shape, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype,
                                  device="meta")
    batch = {name: torch.empty(shape[1:], device="meta",
                               dtype=torch.int32 if name in BATCH_IDS else torch.int64)
             for name, shape in prog.batch_shapes().items()}
    step = build_dist_train_step(prog, grid)
    return trace(step, state, batch, total_devices=grid.world, keep_ops=keep_ops)


def kge_model_flops(cfg) -> float:
    """The reference's KGE model FLOPs (src/repro/launch/dryrun.py:165-167):
    the score GEMMs of positives and negatives, forward and backward."""
    b, k, d = cfg.batch_size, cfg.neg_sample_size, cfg.dim
    return cfg.n_parts * (2 * 2.0 * b * k * d + 3 * 2.0 * b * d) * 3


# ---------------------------------------------------------------- the rows
def _row(traced: Trace, rl, trace_s: float) -> dict:
    row = rl.row()
    row["trace_s"] = trace_s
    row["memory_analysis"] = {
        "argument_bytes": traced.argument_bytes,
        "output_bytes": traced.output_bytes,
        "temp_bytes": traced.temp_bytes,
        "alias_bytes": traced.alias_bytes,
    }
    row["torch_flop_counter"] = {"flops": traced.torch_flop_counter}
    row["fits_hbm"] = traced.bytes_per_device <= H100_SXM.hbm_bytes
    row["matmul_flops"] = traced.mode.matmul_flops
    row["kernels"] = {k: dataclasses.asdict(r) for k, r in traced.mode.kernels.items()}
    return row


def _write_ops(path: str, traced: Trace) -> None:
    if path:
        with open(path, "w") as f:
            f.write("\n".join(traced.mode.ops) + "\n")


def dryrun_arch(arch_name: str, shape_name: str, multi_pod: bool,
                use_flash: bool = False, microbatches: int = 0,
                hlo_out: str = "", overrides: dict | None = None) -> dict:
    from repro_torch.configs import get_arch

    cfg = get_arch(arch_name)
    if microbatches:
        cfg = dataclasses.replace(cfg, microbatches=microbatches)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = INPUT_SHAPES[shape_name]
    ok, why = cfg.supports_shape(shape)
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "skipped": why}

    M, S = make_production_grid(multi_pod=multi_pod)
    with fake_world(M, S) as grid:
        t0 = time.time()
        traced = count_arch(cfg, shape, grid, use_flash=use_flash,
                            keep_ops=bool(hlo_out))
        trace_s = time.time() - t0
    _write_ops(hlo_out, traced)
    rl = roofline_from_cost(traced, arch_name, shape_name, _grid_name(M, S), M * S,
                            model_flops=cfg.model_flops(shape))
    print(format_row(rl), f"(trace {trace_s:.1f}s)")
    return _row(traced, rl, trace_s)


def dryrun_kge(dataset: str, multi_pod: bool, model: str = "",
               hlo_out: str = "", overrides: dict | None = None) -> dict:
    """Dry run of the paper's distributed KGE train step on the grid."""
    M, S = make_production_grid(multi_pod=multi_pod)
    cfg, prog = kge_program(dataset, M, S, model, overrides)
    with fake_world(M, S) as grid:
        t0 = time.time()
        traced = count_kge(prog, grid, keep_ops=bool(hlo_out))
        trace_s = time.time() - t0
    _write_ops(hlo_out, traced)
    rl = roofline_from_cost(traced, f"kge-{dataset}-{cfg.model}", "kge_step",
                            _grid_name(M, S), M * S, kge_model_flops(cfg))
    print(format_row(rl), f"(trace {trace_s:.1f}s)")
    return _row(traced, rl, trace_s)


def _overrides(text: str) -> dict:
    """``k=v,k=v`` with int, float or str values, as the reference parses."""
    overrides = {}
    for kv in [x for x in text.split(",") if x]:
        k, v = kv.split("=")
        for cast in (int, float, str):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v
    return overrides


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="train_4k", choices=list(INPUT_SHAPES))
    ap.add_argument("--kge", default="", help="KGE dataset dry-run")
    ap.add_argument("--kge-model", default="")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--use-flash", action="store_true")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--set", default="", help="cfg overrides k=v,k=v (int/float/str)")
    ap.add_argument("--out", default="")
    ap.add_argument("--hlo-out", default="")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape and every KGE dataset; --out names a "
                         "directory for one JSON row each")
    return ap


def run_one(args) -> dict:
    """One row of the CLI's arguments; an exception becomes the
    reference's error row."""
    try:
        if args.kge:
            return dryrun_kge(args.kge, args.multi_pod, args.kge_model, args.hlo_out,
                              _overrides(args.set))
        return dryrun_arch(args.arch, args.shape, args.multi_pod, args.use_flash,
                           args.microbatches, args.hlo_out,
                           overrides=_overrides(args.set))
    except Exception as e:
        row = {
            "arch": args.arch or f"kge-{args.kge}", "shape": args.shape,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
        print("FAILED:", row["error"], file=sys.stderr)
        print(row["traceback"], file=sys.stderr)
        return row


def _write(path: str, row: dict) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(row, f, indent=2, default=float)


def run_all(args) -> int:
    """Every arch x shape, then every KGE dataset; one JSON file a row in
    ``--out`` (a directory) when given. Exit 1 if any row failed."""
    from repro_torch.configs import ARCHS, KGE_DATASETS

    jobs = [dict(arch=a, shape=s, kge="") for a in ARCHS for s in INPUT_SHAPES]
    jobs += [dict(arch="", shape=args.shape, kge=d) for d in KGE_DATASETS]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    failed = 0
    for job in jobs:
        one = argparse.Namespace(**{**vars(args), **job, "hlo_out": ""})
        row = run_one(one)
        failed += "error" in row
        if args.out:
            name = f"kge_{job['kge']}" if job["kge"] else f"{job['arch']}__{job['shape']}"
            _write(os.path.join(args.out, name + ".json"), row)
    return 1 if failed else 0


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if args.all:
        return run_all(args)
    row = run_one(args)
    _write(args.out, row)
    return 0 if "error" not in row else 1


if __name__ == "__main__":
    sys.exit(main())
