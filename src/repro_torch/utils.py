"""Shared utilities: logging, timing, pytree helpers."""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, Iterator

import numpy as np
import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "[%(asctime)s %(levelname)s %(name)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("REPRO_LOG_LEVEL", "INFO").upper())


def get_logger(name: str = "repro_torch") -> logging.Logger:
    """A child of the shared `repro_torch` logger (handler + level configured
    above, overridable via the REPRO_LOG_LEVEL env var). Pass a bare
    component name ("bench.load") or a fully-qualified one
    ("repro_torch.serving"); both land under the `repro_torch` hierarchy so
    `set_log_level` / `--verbose` control everything at once."""
    if name != "repro_torch" and not name.startswith("repro_torch."):
        name = f"repro_torch.{name}"
    return logging.getLogger(name)


def set_log_level(level: int | str) -> None:
    """Set the level of the whole `repro_torch` logger hierarchy (the `--verbose`
    flag implementation: CLIs call `set_log_level("DEBUG")`)."""
    logger.setLevel(level.upper() if isinstance(level, str) else level)


def add_verbosity_flag(parser) -> None:
    """Attach the shared `-v/--verbose` argparse flag (repeatable)."""
    parser.add_argument(
        "-v", "--verbose", action="count", default=0,
        help="increase log verbosity (-v: DEBUG); default level INFO, "
             "or the REPRO_LOG_LEVEL env var")


def configure_logging(verbose: int = 0) -> None:
    """Apply a parsed `--verbose` count to the shared logger."""
    if verbose > 0:
        set_log_level(logging.DEBUG)


@contextlib.contextmanager
def timed(name: str, sink: Dict[str, float] | None = None) -> Iterator[None]:
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    logger.debug("%s took %.3fs", name, dt)


def tree_leaves(tree: Any) -> list:
    """Array leaves of nested dicts / lists / tuples / NamedTuples (the
    port's parameter and cache containers), in insertion order."""
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same nested dicts / lists), in a tree of the same
    shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _itemsize(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.dtype(leaf.dtype).itemsize


def tree_size_bytes(tree: Any) -> int:
    """Total bytes of all leaves (torch tensors or numpy arrays)."""
    return sum(int(np.prod(tuple(l.shape))) * _itemsize(l)
               for l in tree_leaves(tree))


def tree_param_count(tree: Any) -> int:
    return sum(int(np.prod(tuple(l.shape))) for l in tree_leaves(tree))


def pretty_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"


def dataclass_to_json(obj: Any) -> str:
    return json.dumps(dataclasses.asdict(obj), indent=2, default=str)


def stable_hash(*ints: int) -> int:
    """Deterministic 64-bit mix (splitmix64-style) for reproducible pseudo-randomness."""
    h = 0x9E3779B97F4A7C15
    for v in ints:
        h ^= (v + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        h = (h * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h


def stable_uniform(*ints: int) -> float:
    """Deterministic uniform in [0, 1) from integer keys."""
    return stable_hash(*ints) / float(1 << 64)


_SM64_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM64_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM64_M2 = np.uint64(0x94D049BB133111EB)


def stable_hash_array(*keys) -> np.ndarray:
    """Vectorized `stable_hash`: bitwise-identical to the scalar version.

    Each key may be a scalar int or an int array; arrays broadcast. The hot
    use is hashing one (salt, tick) pair against thousands of neuron ids in a
    single call instead of a per-id Python loop.
    """
    with np.errstate(over="ignore"):
        arrs = np.broadcast_arrays(*[np.asarray(k, dtype=np.uint64) for k in keys])
        h = np.full(arrs[0].shape, _SM64_GAMMA, dtype=np.uint64)
        for v in arrs:
            h ^= v + _SM64_GAMMA
            h *= _SM64_M1
            h ^= h >> np.uint64(27)
            h *= _SM64_M2
            h ^= h >> np.uint64(31)
    return h


def stable_uniform_array(*keys) -> np.ndarray:
    """Vectorized `stable_uniform`: uniforms in [0, 1), one per broadcast key."""
    return stable_hash_array(*keys) / float(1 << 64)
