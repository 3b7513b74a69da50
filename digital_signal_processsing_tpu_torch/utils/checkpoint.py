"""Checkpoint and resume of training and streaming state.

Counterpart of ``digital_signal_processsing_tpu/utils/checkpoint.py``, in its
``.npz`` layout: ``save_training_state`` writes ``taps``, ``step``,
``num_leaves``, ``leaf_i`` and a structure tag ``treedef``; ``save_pytree``
writes ``num_leaves`` and ``leaf_i``. Each file is written beside its path
and renamed over it, so a reader never sees a torn file.

A state is a tree of the port's own types: tensors and arrays (the leaves,
with Python scalars), tuples, lists, dicts (keys in sorted order),
NamedTuples (``models.adaptive.AdamState``) and dataclasses
(``ops.streaming.MovingAverageState``). A load takes its structure from a
template, puts each leaf where the template's is (a tensor on its device), and
refuses a file whose leaves or structure differ from the template's
(``ValueError`` naming "leaves") or whose leaf has another dtype than the
template's (``ValueError`` naming "dtype"): it never casts, so a resumed run
continues bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, leaves: list) -> str:
    """Append ``tree``'s leaves in order; return its structure as a string."""
    if _is_namedtuple(tree):
        parts = [f"{f}={_flatten(getattr(tree, f), leaves)}" for f in tree._fields]
        return f"{type(tree).__name__}({', '.join(parts)})"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        parts = [f"{f.name}={_flatten(getattr(tree, f.name), leaves)}"
                 for f in dataclasses.fields(tree)]
        return f"{type(tree).__name__}({', '.join(parts)})"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_flatten(v, leaves) for v in tree)
        return f"({inner},)" if isinstance(tree, tuple) else f"[{inner}]"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}" for k in sorted(tree)) + "}"
    if tree is None:
        return "None"
    leaves.append(tree)
    return "*"


def _unflatten(template, leaves):
    """``template``'s structure with ``leaves`` (an iterator) in place of its own."""
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, f), leaves) for f in template._fields))
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template) if f.init
        })
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, leaves) for v in template)
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if template is None:
        return None
    leaf = next(leaves)
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(leaf).to(template.device)
    if isinstance(template, np.ndarray | np.generic):
        return leaf
    return type(template)(leaf.item())


def _as_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _dtype(leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.empty(0, dtype=leaf.dtype).numpy().dtype
    return np.dtype(leaf.dtype) if hasattr(leaf, "dtype") else None


def _write(path: Path, payload: dict) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def _read_leaves(z, template, tag: str | None) -> list:
    leaves: list = []
    structure = _flatten(template, leaves)
    n = int(z["num_leaves"])
    if n != len(leaves):
        raise ValueError(f"checkpoint has {n} leaves, the template has {len(leaves)}: another "
                         "optimizer or state")
    if tag is not None and tag != structure:
        raise ValueError("checkpoint leaves are laid out in another structure than the "
                         f"template's:\n  saved:    {tag}\n  template: {structure}")
    got = [z[f"leaf_{i}"] for i in range(n)]
    for i, (leaf, want) in enumerate(zip(got, leaves)):
        dt = _dtype(want)
        if dt is not None and leaf.dtype != dt:
            raise ValueError(f"checkpoint leaf {i} has dtype {leaf.dtype}, the template expects "
                             f"{dt}: refusing a lossy cast; re-save the checkpoint or fix the "
                             "template")
    return got


def save_training_state(path, taps, opt_state, step: int) -> None:
    """Atomically persist (taps, optimizer state, step); ``opt_state`` a tree such
    as ``AdaptiveFir.opt_state()``."""
    leaves: list = []
    structure = _flatten(opt_state, leaves)
    payload = {
        "taps": _as_array(taps),
        "step": np.asarray(step, np.int64),
        "num_leaves": np.asarray(len(leaves), np.int64),
        "treedef": np.frombuffer(structure.encode(), dtype=np.uint8),
    }
    for i, leaf in enumerate(leaves):
        payload[f"leaf_{i}"] = _as_array(leaf)
    _write(Path(path), payload)


def load_training_state(path, opt_state_template):
    """``(taps, opt_state, step)``: taps a CPU tensor, the state in the template's
    structure and places."""
    with np.load(Path(path)) as z:
        tag = bytes(z["treedef"].tobytes()).decode(errors="replace") if "treedef" in z else None
        leaves = _read_leaves(z, opt_state_template, tag)
        taps = torch.from_numpy(np.array(z["taps"]))
        step = int(z["step"])
    return taps, _unflatten(opt_state_template, iter(leaves)), step


def save_pytree(path, tree) -> None:
    """Atomically persist any state tree (streaming states, parameters)."""
    leaves: list = []
    _flatten(tree, leaves)
    payload = {"num_leaves": np.asarray(len(leaves), np.int64)}
    for i, leaf in enumerate(leaves):
        payload[f"leaf_{i}"] = _as_array(leaf)
    _write(Path(path), payload)


def load_pytree(path, template):
    """Restore a tree saved by :func:`save_pytree`; ``template`` supplies the
    structure (a freshly initialised state, say) and each leaf's device."""
    with np.load(Path(path)) as z:
        leaves = _read_leaves(z, template, None)
    return _unflatten(template, iter(leaves))


__all__ = ["save_training_state", "load_training_state", "save_pytree", "load_pytree"]
