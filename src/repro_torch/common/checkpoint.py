"""Checkpoints of the port's state, in the JAX package's layout (its
common/checkpoint.py).

Each field of the state is an ``.npy`` file under ``step_<10 digits>/``,
named as JAX's ``tree_flatten_with_path`` names the leaves of its
``KGEState``, and ``metadata.json`` records each leaf's file, dtype and
shape and the step. A field that is None is no leaf, as in a JAX pytree;
the int ``step`` is saved as a 0-d int32 and int64 ids as int32, as the JAX
state holds them. So a checkpoint saved by either package restores in the
other:

    save_checkpoint(dir, step, state)            # flush deferred grads first
    state = restore_checkpoint(dir, like_state)  # shapes checked, on its device

A state may also be a flat dict of tensors or numpy arrays (the
distributed path's global state, under the reference's keys): its keys name
the leaves, as JAX names a dict's, and a dict restores as a dict.

A save writes a ``.tmp`` directory, renames it into place and keeps the
newest ``keep`` steps.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, Mapping, Optional

import numpy as np
import torch


def _leaves(state) -> Dict[str, object]:
    if isinstance(state, Mapping):
        return {k: v for k, v in state.items() if v is not None}
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if getattr(state, f.name) is not None}


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    arr = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
    return arr.astype(np.int32) if arr.dtype == np.int64 else arr


def save_checkpoint(ckpt_dir: str, step: int, state, keep: int = 3) -> str:
    """Atomically write a step directory; prune to the newest ``keep``."""
    out = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = out + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    meta = {"step": step, "leaves": {}}
    for key, leaf in _leaves(state).items():
        arr = _to_numpy(leaf)
        fname = key + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        meta["leaves"][key] = {"file": fname, "dtype": str(arr.dtype),
                               "shape": list(arr.shape)}
    with open(os.path.join(tmp, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=1)
    if os.path.exists(out):
        shutil.rmtree(out)
    os.rename(tmp, out)
    _prune(ckpt_dir, keep)
    return out


def _steps(ckpt_dir: str):
    """Step directories, oldest first; a ``.tmp`` left by a failed save is
    not one."""
    return sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _prune(ckpt_dir: str, keep: int):
    for d in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return int(steps[-1].split("_")[1]) if steps else None


def restore_checkpoint(ckpt_dir: str, like, step: Optional[int] = None):
    """A state like ``like`` (e.g. a freshly initialised one) with the saved
    values: each tensor with ``like``'s shape (checked), dtype and device,
    each numpy array with its shape and dtype, the int ``step`` as an int.
    ``step`` defaults to the latest."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    src = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(src, "metadata.json")) as f:
        meta = json.load(f)
    values = {}
    for key, leaf in _leaves(like).items():
        info = meta["leaves"].get(key)
        if info is None:
            raise KeyError(f"checkpoint at step {step} is missing leaf {key!r}")
        arr = np.load(os.path.join(src, info["file"]))
        shape = tuple(np.shape(leaf))
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"expected {shape}")
        if torch.is_tensor(leaf):
            values[key] = torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
        elif isinstance(leaf, np.ndarray):
            values[key] = arr.astype(leaf.dtype)
        else:
            values[key] = int(arr)
    if isinstance(like, Mapping):
        return {**like, **values}
    return dataclasses.replace(like, **values)
