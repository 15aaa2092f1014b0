"""Collectives of the distributed path, over plain ``torch.distributed``.

The reference runs its distributed step inside ``shard_map(...,
check_vma=False)`` (``repro/core/distributed.py``). There every device's
copy of a replicated value counts as its own, so the transposes are:

    psum         -> psum (an all_reduce of the cotangents)
    all_gather   -> sum reduce-scatter
    all_to_all   -> the inverse all_to_all (split and concat axes swapped)

The ``torch.autograd.Function``s below give exactly these backwards, so the
port's gradients equal the reference's. On a mesh of S > 1 dim-striped
servers every gradient that passes through a psum over the server axis is
therefore S times the unsharded one (Adagrad cancels S in the step, not in
its accumulator). This is the reference's behaviour, held by the 1x2 case
of ``tests/test_torch_distributed.py``.

The LM zoo's MoE layer over a model group (``models/moe.py``) is the
exception. There JAX's ``shard_map(check_vma=False)`` around ``_moe_local``
(``src/repro/models/moe.py:147-153``) gives gradients equal to those of
the model without a mesh: ``jax.value_and_grad(model.loss)`` of the
reduced Mixtral in f32, under ``build_model(cfg, mesh=mesh8)`` (4 x 2)
and under ``build_model(cfg)`` from the same weights, agrees in every
leaf (norm ratio 1.0000, largest difference 1.1e-6), with E = 4 (experts
split over the ranks) and E = 3 (d_ff split). So its combine takes
``psum_replicated`` (the sum, whose backward hands the replicated
output's cotangent to each rank once) and its replicated inputs
``replicated_input`` (the identity, whose backward sums each rank's
partial cotangent over the group): Megatron's pair of conjugate
operators. ``psum`` keeps the KGE reference's transpose.

Gathers and all-to-alls are tiled, as every call of the reference is: the
blocks of the group's ranks are concatenated in rank order. A group of one
rank goes through the same calls. ``reduce_scatter`` is an all_reduce and a
slice, which every backend (gloo included) runs.

Every plain collective hands an active cost analysis (``common/cost.py``)
its kind, its group's size and its bytes, as the reference's HLO names
them (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``;
``reduce_scatter`` counts as one reduce-scatter, not as its all_reduce).
On meta tensors (the dry run, in a ``"fake"``-backend world) a collective
returns its output's shape and moves nothing: ``torch.distributed`` is
not called.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.common import cost


def _record(kind: str, group, out: torch.Tensor, operand: torch.Tensor) -> None:
    if cost.ACTIVE is not None:
        ranks = dist.get_process_group_ranks(
            dist.group.WORLD if group is None else group)
        cost.ACTIVE.collective(kind, ranks,
                               out.numel() * out.element_size(),
                               operand.numel() * operand.element_size())


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.detach().contiguous().clone()
    if not y.is_meta:
        dist.all_reduce(y, group=group)
    return y


# ---------------------------------------------------------------------------
# plain collectives (no autograd)
# ---------------------------------------------------------------------------
def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, in a new tensor."""
    y = _all_reduce(x, group)
    _record("all-reduce", group, y, x)
    return y


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the group (no gradient)."""
    return all_reduce_sum(x, group) / dist.get_world_size(group)


def all_gather_plain(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis``, in rank order."""
    n = dist.get_world_size(group)
    xs = x.detach().movedim(axis, 0).contiguous()
    parts = [torch.empty_like(xs) for _ in range(n)]
    if not xs.is_meta:
        dist.all_gather(parts, xs, group=group)
    out = torch.cat(parts, 0)
    _record("all-gather", group, out, xs)
    return out.movedim(0, axis)


def reduce_scatter_plain(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """This rank's block along ``axis`` of the sum over the group."""
    xs = _all_reduce(x.movedim(axis, 0), group)
    c = xs.shape[0] // dist.get_world_size(group)
    r = dist.get_rank(group)
    out = xs[r * c:(r + 1) * c]
    _record("reduce-scatter", group, out, xs)
    return out.movedim(0, axis)


def all_to_all_plain(x: torch.Tensor, group, split_axis: int = 0,
                     concat_axis: int = 0) -> torch.Tensor:
    """Tiled all_to_all: ``x`` is cut into group-size blocks along
    ``split_axis``, block j goes to rank j, and the blocks that arrive are
    concatenated along ``concat_axis`` in rank order."""
    n = dist.get_world_size(group)
    xs = x.detach().movedim(split_axis, 0)
    if xs.shape[0] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    send = xs.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:])).contiguous()
    recv = torch.empty_like(send)
    if not send.is_meta:
        dist.all_to_all_single(recv, send, group=group)
    _record("all-to-all", group, recv, send)
    # recv[i]: rank i's block, laid out as x with the split axis first
    y = recv.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(y.shape)
    return y.reshape(shape[:concat_axis] + [shape[concat_axis] * shape[concat_axis + 1]]
                     + shape[concat_axis + 2:])


# ---------------------------------------------------------------------------
# differentiable collectives, with the reference's transposes
# ---------------------------------------------------------------------------
class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return all_gather_plain(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_plain(g, ctx.group, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return all_to_all_plain(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return all_to_all_plain(g, ctx.group, concat_axis, split_axis), None, None, None


class _PsumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; its backward is again a sum over the group."""
    return _Psum.apply(x, group)


def all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Tiled all_gather along ``axis``; its backward a sum reduce-scatter."""
    return _AllGather.apply(x, group, axis % x.dim())


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """Tiled all_to_all; its backward the inverse all_to_all."""
    return _AllToAll.apply(x, group, split_axis % x.dim(), concat_axis % x.dim())


def psum_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group of partial results whose sum every rank then
    holds as one replicated value; its backward passes the cotangent on
    unchanged (each rank's copy counts once), where ``psum``'s sums it
    over the group. The MoE combine on the LM training route (module
    docstring: the ``mesh8`` comparison)."""
    return _PsumReplicated.apply(x, group)


def replicated_input(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, equal on every rank of the group, as the input of a
    computation that each rank does on its own part (its experts); its
    backward sums the ranks' partial cotangents over the group, so every
    rank's gradient upstream is the whole one."""
    return _ReplicatedInput.apply(x, group)
