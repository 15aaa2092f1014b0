"""Grid arithmetic shared by the KGE core and the LM zoo: the part of the
JAX package's common/shard.py that the port has a use for.

The reference places arrays by GSPMD layout over a ``Mesh``; the port
places tensors by process (``launch/mesh.py``: a ``ProcessGrid`` of M
machines x S servers, rank ``m * S + s``), so only the arithmetic carries
over. Every function takes a ``ProcessGrid`` or an ``(M, S)`` pair (or
None, the reference's ``mesh=None``). The machines are the reference's
``("pod", "data")`` batch axes flattened, and the servers its ``model``
axis.

Not ported, with no counterpart here: ``named`` and ``tree_shardings``
(a ``NamedSharding`` is a layout the compiler reads; a rank holds its own
tensors), ``constraint`` (``with_sharding_constraint``: eager tensors are
placed where they are made) and ``mesh_devices_grid`` (a world has one
device a rank; ``ProcessGrid.device`` names it).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

Grid = Union[Tuple[int, int], object]


def _shape(grid: Grid) -> Tuple[int, int]:
    if isinstance(grid, tuple):
        return grid
    return grid.M, grid.S


def divisible(n: int, k: int) -> int:
    """Round n up to a multiple of k."""
    return ((n + k - 1) // k) * k


def batch_axes(grid: Grid) -> Tuple[str, ...]:
    """The axes the global batch splits over: the machines (the
    reference's ``("pod", "data")``, flattened into one)."""
    return ("data",)


def axis_size(grid: Grid, *names: str) -> int:
    """The product of the named axes' sizes: ``"data"`` (or ``"pod"``,
    which the machines hold) is M, ``"model"`` S; unknown names count 1,
    as the reference's do."""
    M, S = _shape(grid)
    out = 1
    if "data" in names or "pod" in names:
        out *= M
    if "model" in names:
        out *= S
    return out


def local_batch(global_batch: int, grid: Optional[Grid]) -> int:
    """The rows of a global batch that one machine takes."""
    if grid is None:
        return global_batch
    return global_batch // axis_size(grid, *batch_axes(grid))
