"""Checkpoints in the reference's format: one `.npz` of tensors keyed by
pytree path, with a `.json` of metadata beside it, each written atomically.

Keys are the reference's: `params/stack/sub_0/mixer/wq`, `opt/step`,
`opt/mu/...` for a `TrainState`, or `embed/embedding`, ... for a bare
params tree; the port's lists of groups / layers are stored in the
reference's stacked [G, ...] / [L, ...] layout (`convert.params_to_numpy`),
so each package reads the other's files.

bf16 leaves: the reference's `np.savez` stores a bf16 leaf as 2-byte void
bits, which its own `load_checkpoint` cannot cast back (numpy has no cast
from void to bfloat16). The port reads such a leaf's bits as bf16, and
writes its own bf16 leaves as their float32 values (exact), which both
loaders cast back to the same bf16 bits.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.convert import _to_tensor, stack_lists, tensor_to_numpy


def _is_namedtuple(obj: Any) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _walk(tree: Any, path: Tuple[str, ...] = (), index: Tuple[int, ...] = ()
          ) -> Iterator[Tuple[str, Tuple[int, ...], Tuple[int, ...], Any]]:
    """(key, list indices, sizes of the lists, leaf) for every leaf: a list
    adds an index, not a key part (its entries are stacked under one key)."""
    if _is_namedtuple(tree):
        for f in tree._fields:
            yield from _walk(getattr(tree, f), path + (f,), index)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (str(k),), index)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            for key, idx, sizes, leaf in _walk(v, path, index + (i,)):
                yield key, idx, (len(tree),) + sizes, leaf
    else:
        yield "/".join(path), index, (), tree


def _saved(t: torch.Tensor) -> np.ndarray:
    """A leaf as the file holds it: bf16 as its float32 values (exact)."""
    return tensor_to_numpy(t.float() if t.dtype == torch.bfloat16 else t)


def _numpy_tree(state: Any) -> Any:
    """The state as nested dicts of host arrays in the reference's stacked
    layout (NamedTuple fields by name)."""
    if _is_namedtuple(state):
        return {f: _numpy_tree(getattr(state, f)) for f in state._fields}
    return stack_lists(state, _saved)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, dict):
        return {key: leaf for k, v in tree.items()
                for key, leaf in _flatten(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tree}


def _atomic_write(path: str, write) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_checkpoint(path: str, state: Any,
                    metadata: Dict | None = None) -> None:
    """Write `state` (a `TrainState` or any tree of tensors) to `path` and
    `metadata` to `path + ".json"`, each through a temporary file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(_numpy_tree(state))

    def write_npz(tmp):
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
    _atomic_write(path, write_npz)
    if metadata is not None:
        def write_json(tmp):
            with open(tmp, "w") as f:
                json.dump(metadata, f, indent=2)
        _atomic_write(path + ".json", write_json)


def _rebuild(like: Any, leaves: Iterator[torch.Tensor]) -> Any:
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if isinstance(like, list):
        return [_rebuild(v, leaves) for v in like]
    return next(leaves)


def load_checkpoint(path: str, like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure, dtypes and devices of `like`. Raises
    KeyError for a tensor the file lacks and ValueError for a shape that
    differs (the stacked shape, as the reference reports it)."""
    data = np.load(path)
    arrays: Dict[str, np.ndarray] = {}
    out = []
    for key, idx, sizes, leaf in _walk(like):
        if key not in arrays:
            if key not in data:
                raise KeyError(f"checkpoint missing tensor '{key}'")
            arrays[key] = data[key]
        arr = arrays[key]
        want = tuple(sizes) + tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for '{key}': ckpt {arr.shape} "
                             f"vs model {want}")
        out.append(_to_tensor(arr[idx] if idx else arr, leaf.device)
                   .to(leaf.dtype))
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return _rebuild(like, iter(out)), meta
