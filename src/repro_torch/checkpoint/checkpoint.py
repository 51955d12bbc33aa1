"""Tree checkpoints in the JAX package's file format (counterpart of
``repro/checkpoint/checkpoint.py``): one ``.npz`` of the leaves, keyed by
their path, and a JSON manifest with ``keys``, ``dtypes``, ``shapes`` and
``metadata``.

Paths are spelled as ``jax.tree_util`` spells them, so a file written here
loads with the JAX package's ``load_pytree`` and the other way round: a
record field is ``.name``, a list or tuple item ``[i]`` and a dict entry
``['key']``, joined by ``/`` (``.client_opts/[0]/.m/['layers']/['w']``).
Records are dataclasses, walked in field order; dicts are walked in sorted
key order, as JAX walks them.  ``None`` is an empty subtree.

Leaves are numpy arrays, torch tensors or host integers.  npz cannot store
bfloat16, so bf16 leaves are widened to fp32 (losslessly; the manifest
records the widened dtype, as JAX's does).  :func:`load_pytree` returns
the arrays as saved; ``convert.split_state_from_jax(like=)`` narrows a
training state's bf16 tensors again.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Iterator, Tuple

import numpy as np
import torch


def key_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf of ``tree``, in JAX's order and with
    JAX's path strings."""
    def join(part):
        return f"{prefix}/{part}" if prefix else part

    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from key_paths(getattr(tree, f.name), join(f".{f.name}"))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from key_paths(tree[k], join(f"[{k!r}]"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from key_paths(v, join(f"[{i}]"))
    elif tree is not None:
        yield prefix, tree


def to_numpy(leaf) -> np.ndarray:
    """A leaf as a numpy array that npz can store: torch tensors are copied
    to the host, bf16 (torch's or ml_dtypes') widened to fp32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def save_pytree(path: str, tree: Any, metadata: dict | None = None) -> None:
    """Write ``path + '.npz'`` (the leaves) and ``path + '.json'`` (the
    manifest)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    keyed = {k: to_numpy(v) for k, v in key_paths(tree)}
    np.savez(path + ".npz", **keyed)
    manifest = {
        "keys": sorted(keyed.keys()),
        "dtypes": {k: str(v.dtype) for k, v in keyed.items()},
        "shapes": {k: list(v.shape) for k, v in keyed.items()},
        "metadata": metadata or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def _rebuild(like: Any, load, prefix: str = "") -> Any:
    def join(part):
        return f"{prefix}/{part}" if prefix else part

    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), load, join(f".{f.name}"))
            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _rebuild(v, load, join(f"[{k!r}]"))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, load, join(f"[{i}]"))
                          for i, v in enumerate(like))
    if like is None:
        return None
    return load(prefix, like)


def load_pytree(path: str, like: Any) -> Any:
    """The tree saved at ``path``, in the structure of ``like``: each leaf
    of ``like`` replaced by the numpy array saved under its path, in the
    dtype it was saved in.  A path missing from the file raises
    ``KeyError``."""
    with np.load(path + ".npz") as data:
        return _rebuild(like, lambda key, leaf: np.array(data[key]))
