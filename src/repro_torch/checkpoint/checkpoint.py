"""Checkpointing of nested tensors: npz payload + json manifest.

The port's copy of ``repro.checkpoint.checkpoint``, with its file layout:
``arrays.npz`` holds the flattened leaves under stable path keys
(``"state/0"``, ``"ledger/3"``, ``"objective"``: dict keys, and the
field index of a dataclass or the index of a tuple, joined by ``/``, as
the reference's pytree paths are), and ``manifest.json`` their shapes
and dtypes.  No ``torch.save`` and no pickle: the payload is plain
arrays.  Restore validates shapes, casts to the template's dtype, puts
each leaf on the template leaf's device and rebuilds the nest.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """``{path key: leaf}`` of a nest of dicts (sorted keys, as the
    reference's pytrees flatten them), dataclasses and tuples/lists of
    tensors."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], key(k)))
        return out
    if dataclasses.is_dataclass(tree):
        children = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, (tuple, list)):
        children = list(tree)
    else:
        return {prefix: tree}
    out = {}
    for i, child in enumerate(children):
        out.update(_flatten_with_paths(child, key(i)))
    return out


def _unflatten(like, leaves: dict, prefix: str = ""):
    """Rebuild ``like``'s nest with ``leaves`` (by path key)."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, key(k)) for k, v in like.items()}
    if dataclasses.is_dataclass(like):
        return type(like)(*(_unflatten(getattr(like, f.name), leaves, key(i))
                            for i, f in enumerate(dataclasses.fields(like))))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(c, leaves, key(i))
                          for i, c in enumerate(like))
    return leaves[prefix]


def save(path: str, tree) -> None:
    os.makedirs(path, exist_ok=True)
    leaves = {k: v.detach().cpu().numpy()
              for k, v in _flatten_with_paths(tree).items()}
    np.savez(os.path.join(path, "arrays.npz"), **leaves)
    spec = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in leaves.items()}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(spec, f, indent=1, sort_keys=True)


def restore(path: str, like):
    """Restore into the structure of ``like`` (shape validated; dtype and
    device taken from ``like``'s leaves)."""
    restored = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, ref in _flatten_with_paths(like).items():
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs "
                    f"model {tuple(ref.shape)}")
            restored[key] = torch.as_tensor(arr, dtype=ref.dtype,
                                            device=ref.device)
    return _unflatten(like, restored)
