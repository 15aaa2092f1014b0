"""Rank bodies of the port's distributed tests.

``launch.mesh.run_world`` spawns ranks 1.. as fresh processes that import
the body's module: this one imports torch and the port only, never JAX or
a test module (which import JAX), so the children stay free of both. Each
body returns rank 0's result; results of other ranks reach rank 0 through
an all_gather.
"""

import contextlib
import dataclasses
import hashlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as D
from repro_torch.core.distributed import (
    batch_to_rank,
    build_dist_train_step,
    build_pipelined_dist_step,
    dist_state_from_arrays,
    gather_dist_state,
    init_dist_state,
    run_batches,
)
from repro_torch.core.sampling import DistBatch
from repro_torch.embeddings.kvstore import KVStoreSpec, pull_remote, push_remote_grads
from repro_torch.embeddings.store import ReplicatedStore
from repro_torch.launch import engine, train


def run_cases(grid, cases):
    """``run_batches`` for each (prog, arrays, batches) case, in one world."""
    return [run_batches(grid, *case) for case in cases]


def _gather_to_list(grid, x):
    parts = [torch.empty_like(x) for _ in range(grid.world)]
    dist.all_gather(parts, x.contiguous())
    return [p.numpy() for p in parts]


def kvstore_pull(grid, table, req, n_parts, rp):
    """Each machine pulls ``req[m]`` from its peers' blocks of ``table``."""
    rows = table.shape[0] // n_parts
    block = torch.from_numpy(table[grid.m * rows:(grid.m + 1) * rows])
    spec = KVStoreSpec(machine_axis=grid.machine_group, n_parts=n_parts,
                       remote_capacity=n_parts * rp)
    return _gather_to_list(grid, pull_remote(block, torch.from_numpy(req[grid.m]), spec))


def kvstore_push(grid, grads, req, n_parts, rp):
    """Each machine returns ``grads[m]`` for the rows of ``req[m]`` to
    their owners; every owner's (ids, grad rows)."""
    spec = KVStoreSpec(machine_axis=grid.machine_group, n_parts=n_parts,
                       remote_capacity=n_parts * rp)
    ids, g = push_remote_grads(torch.from_numpy(grads[grid.m]),
                               torch.from_numpy(req[grid.m]), spec)
    return _gather_to_list(grid, ids), _gather_to_list(grid, g)


def replicated_apply(grid, table, ids, grads, lr):
    """Each machine applies ``grads[m]`` at ``ids[m]`` to its replica;
    every replica's table and accumulator."""
    store = ReplicatedStore.create(torch.from_numpy(table.copy()), lr=lr,
                                   machine_axis=grid.machine_group)
    store.apply_sparse_grads(torch.from_numpy(ids[grid.m]),
                             torch.from_numpy(grads[grid.m]))
    return _gather_to_list(grid, store.table), _gather_to_list(grid, store.gsq)


def store_cases(grid, pull_args, push_args, replicated_args):
    """The store module's world: one KVStore pull, one push, one replicated
    update."""
    return (kvstore_pull(grid, *pull_args), kvstore_push(grid, *push_args),
            replicated_apply(grid, *replicated_args))


def _steps_by_hand(grid, step, prog, arrays, batches, lookahead):
    """Step ``batches`` by hand; the global state after each step (rank 0)."""
    state = dist_state_from_arrays(prog, grid, arrays)
    after = []
    for i in range(len(batches) - lookahead):
        b = batch_to_rank(batches[i], grid)
        if lookahead:
            state, _ = step(state, b, batch_to_rank(batches[i + 1], grid))
        else:
            state, _ = step(state, b)
        after.append(gather_dist_state(prog, grid, state))
    return after


def pipeline_cases(grid, cases, trace=None, eager=None):
    """The pipelined step's world: ``run_batches`` with rank 0's counters
    for each (prog, arrays, batches) case; with ``trace``, a depth-1 case
    stepped by hand with the global state after each step (the staleness
    contract); with ``eager``, a depth-0, push_every-1 case through both
    builders (the eager step)."""
    runs = [run_batches(grid, *case, counters=True) for case in cases]
    traced = both = None
    if trace is not None:
        prog, arrays, batches = trace
        traced = _steps_by_hand(grid, build_pipelined_dist_step(prog, grid), prog,
                                arrays, batches, lookahead=True)
    if eager is not None:
        prog, arrays, batches = eager
        both = [_steps_by_hand(grid, build(prog, grid), prog, arrays, batches,
                               lookahead=False)
                for build in (build_dist_train_step, build_pipelined_dist_step)]
    return runs, traced, both


# ---------------------------------------------------------------------------
# the distributed CLI with several trainers and samplers
# ---------------------------------------------------------------------------
def batch_digest(db) -> str:
    """A digest of every field of a whole ``DistBatch``."""
    h = hashlib.sha1()
    for f in dataclasses.fields(db):
        v = getattr(db, f.name)
        h.update(np.ascontiguousarray(v).tobytes() if isinstance(v, np.ndarray)
                 else repr(v).encode())
    return h.hexdigest()


class StepRecorder(engine.Hook):
    """Each step this rank runs, in hook order: (step number, the digest of
    its whole batch, the trainer that stepped it); and its metrics."""

    def __init__(self):
        self.steps, self.metrics = [], []

    def on_step(self, i, state, metrics, stats):
        self.steps.append((i, stats["digest"], stats.get("trainer")))
        self.metrics.append({k: float(v) for k, v in metrics.items()})


@contextlib.contextmanager
def _digests_in_stats():
    """``DistBatch.stats`` also carries ``batch_digest`` of the batch."""
    plain = DistBatch.stats
    DistBatch.stats = property(lambda db: {**plain.fget(db), "digest": batch_digest(db)})
    try:
        yield
    finally:
        DistBatch.stats = plain


@contextlib.contextmanager
def _recorded_gathers(log):
    """Every ``gather_dist_state`` call appends the step of its state."""
    plain = D.gather_dist_state

    def gather(prog, grid, state):
        log.append(int(state["step"]))
        return plain(prog, grid, state)

    D.gather_dist_state = gather
    try:
        yield
    finally:
        D.gather_dist_state = plain


def cli_runs(grid, argvs):
    """The train CLI's rank body (``train._dist_rank``) for each argv, one
    after the other in this world, with a ``StepRecorder`` on every rank.
    Rank 0 returns, per argv, (cfg, the final global state, rank 0's step
    metrics, every rank's record): a record is the rank's steps and the
    step of each gather it took part in (checkpoint saves, the final one)."""
    out = []
    for argv in argvs:
        rec, gathers = StepRecorder(), []
        with _digests_in_stats(), _recorded_gathers(gathers):
            cfg, final = train._dist_rank(grid, train.build_parser().parse_args(argv),
                                          hooks=(rec,))
        records = [None] * grid.world
        dist.all_gather_object(records, (rec.steps, gathers))
        out.append((cfg, final, rec.metrics, records))
        dist.barrier()  # rank 0's checkpoints are on disk for the next run
    return out


def failing_sampler_run(grid, prog, batches, fail_at):
    """Two trainers and two samplers in the ordered mode over ``batches``;
    rank 1's sampler 1 raises instead of making its ``fail_at``-th batch."""
    made = [0, 0]

    def factory(wid):
        def make():
            made[wid] += 1
            if grid.rank == 1 and wid == 1 and made[wid] == fail_at:
                raise RuntimeError("sampler failed on purpose")
            return batch_to_rank(batches[(2 * (made[wid] - 1) + wid) % len(batches)],
                                 grid), None
        return make

    step = build_dist_train_step(prog, grid)
    engine.train_loop(step, init_dist_state(prog, grid, 0), None, len(batches),
                      n_trainers=2, n_samplers=2, sampler_factory=factory,
                      ordered=True)


def lm_world_cases(grid, cases, train_cases=()):
    """The LM zoo's mesh program on this grid, one case after another: for
    each (cfg, JAX's global weights as numpy arrays, prefill tokens (B, T),
    the ``use_flash`` settings, decode token arrays (B, steps)), this
    rank's model (``build_model(cfg, grid)``, its slice of the weights)
    runs its machine's rows (``machine_rows``) of every batch. Returns, for
    each case, {"prefill": [(logits (B, T, V), each MoE layer's expert
    choices (B*T, k)) for each use_flash], "decode": [teacher-forced
    logits (B, steps, V) for each decode batch]}, gathered over the
    machines; with ``train_cases``, (that list, ``lm_train_cases``'s)."""
    out = _lm_serve_cases(grid, cases)
    return (out, lm_train_cases(grid, train_cases)) if train_cases else out


def lm_train_cases(grid, cases):
    """``build_train_step(build_model(cfg, grid), lr, shape)`` from JAX's
    global weights, one step a global batch, for each (cfg, weights as
    numpy arrays, lr, InputShape, [global batches as dicts of numpy
    arrays]). Returns, for each case, {"losses": [each step's loss],
    "params": the parameters after the last step, each expert slice
    gathered over the model group (JAX's global arrays), "spread": the
    largest difference of any parameter entry between the ranks that hold
    it (0.0 when every rank took the same step)}."""
    # one thread on every rank: rank 0 runs in the calling process with its
    # threads, and a reduction split over threads rounds differently
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return [_lm_train_case(grid, *case) for case in cases]
    finally:
        torch.set_num_threads(threads)


def _lm_train_case(grid, cfg, arrays, lr, shape, batches):
    from repro_torch.common import collectives
    from repro_torch.models.steps import build_train_step
    from repro_torch.models.transformer import build_model, params_from_arrays
    from repro_torch.models.layers import tree_leaves, tree_map

    model = build_model(cfg, grid=grid)
    params = params_from_arrays(model, arrays)
    step, opt = build_train_step(model, lr=lr, shape=shape)
    state = opt.init(params)
    losses = []
    for b in batches:
        params, state, met = step(params, state, {k: torch.from_numpy(v)
                                                  for k, v in b.items()})
        losses.append(float(met["loss"]))

    def whole(d, p):
        if d.parts == 1:
            return p
        return collectives.all_gather_plain(p, grid.model_group, axis=d.axis)

    spread = 0.0
    for d, p in zip(tree_leaves(model.defs), tree_leaves(params)):
        group = grid.machine_group if d.parts > 1 else None
        hi, lo = p.clone(), p.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        spread = max(spread, float((hi - lo).max()))
    full = tree_map(whole, model.defs, params)
    return {"losses": losses, "spread": spread,
            "params": tree_map(lambda t: t.numpy(), full)}


def _lm_serve_cases(grid, cases):
    from repro_torch.models.transformer import (
        build_model, forward_routes, gather_rows, machine_rows, params_from_arrays,
    )

    out = []
    for cfg, arrays, tokens, flash, decodes in cases:
        model = build_model(cfg, grid=grid)
        params = params_from_arrays(model, arrays)
        B, T = tokens.shape
        rows = machine_rows(grid, B)
        res = {"prefill": [], "decode": []}
        for use_flash in flash:
            logits, sets = forward_routes(model, params,
                                          {"tokens": torch.from_numpy(tokens[rows])},
                                          use_flash=use_flash)
            sets = [gather_rows(grid, s.reshape(-1, T, s.shape[-1]), B).reshape(B * T, -1)
                    for s in sets]
            res["prefill"].append((gather_rows(grid, logits, B), sets))
        for tok in decodes:
            B, steps = tok.shape
            rows = machine_rows(grid, B)
            local = torch.from_numpy(tok[rows])
            caches = model.init_caches(local.shape[0], steps)
            logits = []
            with torch.no_grad():
                for i in range(steps):
                    lg, caches = model.decode_step(params, caches, local[:, i:i + 1], i)
                    logits.append(lg[:, 0])
            res["decode"].append(gather_rows(grid, torch.stack(logits, dim=1), B))
        out.append(res)
    return out
