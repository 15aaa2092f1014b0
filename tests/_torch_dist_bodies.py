"""Rank bodies of the port's distributed tests.

``launch.mesh.run_world`` spawns ranks 1.. as fresh processes that import
the body's module: this one imports torch and the port only, never JAX or
a test module (which import JAX), so the children stay free of both. Each
body returns rank 0's result; results of other ranks reach rank 0 through
an all_gather.
"""

import torch
import torch.distributed as dist

from repro_torch.core.distributed import run_batches
from repro_torch.embeddings.kvstore import KVStoreSpec, pull_remote, push_remote_grads
from repro_torch.embeddings.store import ReplicatedStore


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
