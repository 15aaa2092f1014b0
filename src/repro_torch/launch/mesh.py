"""Process meshes: the JAX package's ``launch/mesh.py::make_mesh`` as a
world of ``torch.distributed`` processes.

The reference's mesh ``(data=M, model=S)`` becomes a world of ``M * S``
ranks, one process each, with ``rank = m * S + s`` (``make_mesh((M, S),
("data", "model"))`` lays device ``(m, s)`` at ``m * S + s``, so the two
agree device for device). Every rank creates two kinds of subgroup, all of
them, in the same order:

  * the **machine group** of server ``s`` — ranks ``s, S + s, ...``: the
    KVStore's all_to_all axis (the reference's ``"data"`` axis);
  * the **model group** of machine ``m`` — ranks ``m*S .. m*S + S - 1``: the
    dim-striped KVStore servers (``ShardCtx``'s axis, ``"model"``).

``run_world`` starts a world: rank 0 runs in the calling process (so its
result, its hooks and its kernel launch counts stay there), ranks 1.. in
processes of ``torch.multiprocessing``'s spawn context, which meet at a
``file://`` rendezvous in a temporary directory. CPU worlds use gloo; CUDA
worlds NCCL, one rank per card. Every ``init_process_group`` gets a
timeout, so a rank that dies makes its peers fail instead of hang, and the
children are joined with a bound and terminated when rank 0 fails.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
import traceback
from typing import Callable, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"MxS"`` -> (machines M, servers S)."""
    parts = text.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"--mesh takes MxS (machines x servers), e.g. 2x2; "
                         f"got {text!r}")
    return int(parts[0]), int(parts[1])


@dataclasses.dataclass
class ProcessGrid:
    """This rank's place in the ``(M, S)`` world, and its two groups."""

    M: int  # machines: graph partitions
    S: int  # dim-striped KVStore servers per machine
    rank: int
    machine_group: object  # ranks s, S+s, ...: the KVStore all_to_all axis
    model_group: object  # ranks m*S .. m*S+S-1: the dim-striped servers
    device: torch.device

    @property
    def m(self) -> int:
        return self.rank // self.S

    @property
    def s(self) -> int:
        return self.rank % self.S

    @property
    def world(self) -> int:
        return self.M * self.S


def make_grid(M: int, S: int, device) -> ProcessGrid:
    """Create every subgroup (on every rank, in one order) after
    ``init_process_group``; return this rank's grid."""
    if dist.get_world_size() != M * S:
        raise ValueError(f"mesh {M}x{S} needs a world of {M * S} ranks, "
                         f"got {dist.get_world_size()}")
    rank = dist.get_rank()
    machine = model = None
    for s in range(S):
        g = dist.new_group([m * S + s for m in range(M)])
        if rank % S == s:
            machine = g
    for m in range(M):
        g = dist.new_group([m * S + s for s in range(S)])
        if rank // S == m:
            model = g
    return ProcessGrid(M=M, S=S, rank=rank, machine_group=machine,
                       model_group=model, device=torch.device(device))


def check_devices(M: int, S: int, device) -> torch.device:
    """The world's device type; a CUDA world needs one card per rank."""
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if M * S > n:
            raise RuntimeError(
                f"--mesh {M}x{S} on --device cuda needs {M * S} CUDA devices "
                f"(one rank per card); this machine has {n}. Pass a mesh of at "
                f"most {n} ranks, or --device cpu for a gloo world on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"distributed worlds run on cuda or cpu, not {dev}")
    return dev


def _init(rank: int, M: int, S: int, init_method: str, device_type: str,
          timeout_s: float) -> ProcessGrid:
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
    extra = {"device_id": device} if device_type == "cuda" else {}
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo", init_method=init_method,
        rank=rank, world_size=M * S,
        timeout=datetime.timedelta(seconds=timeout_s), **extra)
    return make_grid(M, S, device)


def _finish() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, M, S, init_method, device_type, timeout_s, n_threads, fn,
               args):
    """A spawned rank: join the world, run ``fn(grid, *args)``, leave."""
    torch.set_num_threads(n_threads)
    try:
        grid = _init(rank, M, S, init_method, device_type, timeout_s)
        fn(grid, *args)
        dist.barrier()
    except BaseException:
        traceback.print_exc()
        os._exit(1)
    finally:
        _finish()


def run_world(M: int, S: int, fn: Callable, args: Sequence = (), device="cpu",
              timeout_s: float = DEFAULT_TIMEOUT_S, rank0_kwargs=None):
    """Run ``fn(grid, *args)`` on every rank of an ``M x S`` world; return
    rank 0's result. ``fn`` and ``args`` must pickle (a module-level
    function of an importable module): the other ranks are spawned.
    ``rank0_kwargs`` go to rank 0's call only (they need not pickle)."""
    import torch.multiprocessing as mp

    dev = check_devices(M, S, device)
    world = M * S
    tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    n_threads = max(1, torch.get_num_threads() // world)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, M, S, init_method, dev.type, timeout_s,
                               n_threads, fn, tuple(args)))
             for r in range(1, world)]
    for p in procs:
        p.start()
    ok = False
    try:
        grid = _init(0, M, S, init_method, dev.type, timeout_s)
        out = fn(grid, *args, **(rank0_kwargs or {}))
        dist.barrier()
        ok = True
    finally:
        _finish()
        for p in procs:
            p.join(timeout=timeout_s if ok else 5.0)
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [(r, p.exitcode) for r, p in enumerate(procs, 1) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks failed (rank, exit code): {bad}")
    return out
