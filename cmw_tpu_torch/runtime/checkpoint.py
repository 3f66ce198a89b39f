"""Checkpoint / resume of the whole control-loop state.

PyTorch counterpart of `cmw_tpu/runtime/checkpoint.py`: the loop state is
one tree of NamedTuples (LoopState: integrators, contact plan, SQP/ADMM warm
start, MANN autoregression state, plant), so a checkpoint is its leaves in
an npz file with a manifest (`FORMAT_VERSION`, the tree's layout, `meta`).
A long sweep can be split across jobs and a session resumed bit for bit.

Leaves are tensors (any shape and dtype; `[B, ...]` in a LoopState), None
(`rb` on the kinematic plant) and `torch.Generator`s (the plant's noise
stream, saved as its state). Files of the JAX package are not read.
"""

from __future__ import annotations

import json

import numpy as np
import torch

_MANIFEST_KEY = "__cmw_manifest__"
FORMAT_VERSION = 1


def _flatten(tree, leaves):
    """Appends tree's leaves to `leaves` depth first; returns its layout as a
    string (NamedTuple and field names, `None` and the leaf kinds)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        fields = ", ".join(f"{k}={_flatten(v, leaves)}" for k, v in zip(tree._fields, tree))
        return f"{type(tree).__name__}({fields})"
    if tree is None:
        return "None"
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        leaves.append(tree)
        return "*" if isinstance(tree, torch.Tensor) else "generator"
    raise TypeError(f"checkpoint: unsupported leaf {type(tree).__name__}")


def save(path: str, state, meta: dict | None = None) -> None:
    """Save a tree of NamedTuples (tensors, generators, None) to `path` (npz)
    with its layout and `meta`."""
    leaves = []
    treedef = _flatten(state, leaves)
    arrays = {
        f"leaf_{i}": (leaf.get_state() if isinstance(leaf, torch.Generator) else leaf.detach()).cpu().numpy()
        for i, leaf in enumerate(leaves)
    }
    manifest = {"version": FORMAT_VERSION, "treedef": treedef, "n_leaves": len(leaves), "meta": meta or {}}
    arrays[_MANIFEST_KEY] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def _rebuild(like, it):
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, it) for v in like))
    if like is None:
        return None
    data = next(it)
    if isinstance(like, torch.Generator):
        gen = torch.Generator(device=like.device)
        gen.set_state(torch.from_numpy(data))
        return gen
    return torch.from_numpy(data).to(like.device)


def load(path: str, like):
    """Restore a tree saved by `save`. `like` (e.g. `ctl.initial_state(B)`)
    supplies the layout, which must match the file's, and each leaf's
    device; shapes and dtypes come from the file."""
    with np.load(path) as data:
        manifest = json.loads(bytes(data[_MANIFEST_KEY]).decode())
        leaves = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    treedef = _flatten(like, [])
    if manifest["treedef"] != treedef:
        raise ValueError(f"{path}: checkpoint layout {manifest['treedef']} does not match the template's {treedef}")
    return _rebuild(like, iter(leaves))


def load_meta(path: str) -> dict:
    with np.load(path) as data:
        return json.loads(bytes(data[_MANIFEST_KEY]).decode())["meta"]
