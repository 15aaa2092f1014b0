"""The reference's products, in float32 or, for the control, in TF32.

TF32 keeps float32's exponent and 10 of its 23 mantissa bits. A TF32 product
rounds both operands to it and accumulates in float32; its backward products
round the incoming gradient and the saved operand the same way. Here that is
done explicitly, around float32 products with cuBLAS's own TF32 off, so the
control's precision does not depend on which kernel cuBLAS picks (a batched
product of single rows runs as a gemv, which TF32 mode leaves in float32).
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Operand(torch.autograd.Function):
    """Rounds going forward; passes the gradient through unchanged."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    """Unchanged going forward; rounds the gradient going backward, the
    operand that the product's backward products take."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def _tf32_matmul(a, b):
    return _Output.apply(torch.matmul(_Operand.apply(a), _Operand.apply(b)))


def matmul_of(tf32: bool):
    """``torch.matmul``, or the same product in TF32 for the control."""
    return _tf32_matmul if tf32 else torch.matmul
