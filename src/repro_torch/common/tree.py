"""Small tree utilities: a port of the JAX package's common/tree.py.

The port's trees are nested dicts of tensors (``models/layers.py``
``tree_map``/``tree_leaves``); these functions read and build them as the
reference's read and build pytrees. ``tree_any_nan`` and ``global_norm``
return 0-d tensors on the leaves' device, as JAX returns 0-d arrays.
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import tree_leaves, tree_map


def tree_size(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    return tree_map(lambda x: x * s, tree)


def tree_any_nan(tree) -> torch.Tensor:
    flags = [torch.isnan(x).any() for x in tree_leaves(tree) if x.is_floating_point()]
    if not flags:
        return torch.tensor(False)
    return torch.stack(flags).any()


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))
