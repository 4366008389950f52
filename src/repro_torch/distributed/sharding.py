"""Sharding rules: a PartitionSpec per parameter / cache leaf, by path, and
their placement on a `torch.distributed` device mesh (DTensor).

Conventions (the reference's `repro.distributed.sharding`, MaxText-style
logical axes resolved per leaf with divisibility checks):
  * "model" axis — tensor parallel: FFN hidden (d_ff), attention heads,
    vocab, MoE experts, SSM inner dim.
  * "data" axis — batch parallel + FSDP: the d_model (or other non-TP) dim
    of each weight is sharded over data as ZeRO-style FSDP; optimizer
    moments take the same specs.
  * "pod" axis — composes with "data" for batch / FSDP sharding.

A candidate dim is only sharded when its size divides the axis size;
otherwise the next candidate is tried, else the dim stays replicated.

The rules read each leaf in the reference's layout, where a scanned stack's
leaves carry a leading [G, ...] (or [L, ...]) axis; the port holds such a
stack as a list of per-layer leaves (`repro_torch.convert`). So a leaf
reached through a list is judged by its stacked shape (one leading dim per
list it sits in, as `training.optimizer._reference_ndim` counts), and its
spec is the stacked spec without those leading entries. Where the
reference's spec puts a mesh axis on a stack axis (its MoE test counts the
stack axis, so a dense FFN [G, d, f] takes the expert rules, and a stacked
norm scale [G, d] takes the generic fallback), the per-layer leaf cannot
carry it: a dense FFN leaf takes the dense rules, any other leaf drops the
stack entry (ROADMAP §3, declared divergences).

Specs need no process group: `abstract_mesh` names axes and sizes, and
every spec function takes it or a `DeviceMesh`. `make_mesh` builds the
device mesh, `placements` turns a spec into DTensor placements,
`distribute_tree` places a tree's tensors and `full_tree` gathers them.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

Axis = Optional[Any]          # None, an axis name, or a tuple of names


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (sharded over their product, major first). A 1-tuple is
    kept as the bare name, as `jax.sharding.PartitionSpec` prints it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no devices behind them: enough for every
    spec function, for any world size (full-size models on (16, 16))."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def abstract_mesh(axis_sizes: Sequence[int],
                  axis_names: Sequence[str]) -> AbstractMesh:
    return AbstractMesh(tuple(int(s) for s in axis_sizes), tuple(axis_names))


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of an `AbstractMesh` or a `DeviceMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cuda"):
    """A `DeviceMesh` of the initialised process group's ranks, row-major
    over `axis_names` (`init_device_mesh`)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(int(s) for s in axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def _batch_axes(mesh, batch_size: int) -> Axis:
    shape = mesh_shape(mesh)
    axes = dp_axes(mesh)
    total = math.prod(shape[a] for a in axes)
    return axes if batch_size % total == 0 else (
        ("data",) if batch_size % shape["data"] == 0 else None)


def batch_spec(mesh, batch_size: int, ndim: int) -> PartitionSpec:
    """Shard the leading batch dim over (pod, data) when divisible."""
    return P(_batch_axes(mesh, batch_size), *([None] * (ndim - 1)))


# rule table: (path regex, [(axis_kind, candidate dims from the END)...])
# dims are negative indices; first divisible candidate wins.
_RULES: List[Tuple[str, List[Tuple[str, Sequence[int]]]]] = [
    (r"embed/embedding$",        [("model", (-2,)), ("data", (-1,))]),
    (r"embed/lm_head$",          [("model", (-1,)), ("data", (-2,))]),
    (r"projector/w[12]$",        [("model", (-1,)), ("data", (-2,))]),
    (r"frontend_proj$",          [("model", (-1,)), ("data", (-2,))]),
    # attention
    (r"(mixer|attn|self_attn|cross_attn)/w[qkv]$", [("model", (-1,)), ("data", (-2,))]),
    (r"(mixer|attn|self_attn|cross_attn)/wo$",     [("model", (-2,)), ("data", (-1,))]),
    (r"(mixer|attn|self_attn|cross_attn)/b[qkv]$", [("model", (-1,))]),
    # dense FFN
    (r"ffn/w_(up|gate)$",        [("model", (-1,)), ("data", (-2,))]),
    (r"ffn/w_down$",             [("model", (-2,)), ("data", (-1,))]),
    # MoE: experts first, then expert-ffn dim
    (r"ffn/router$",             [("data", (-2,))]),
    (r"ffn/w_(up|gate)$",        [("model", (-1,)), ("data", (-2,))]),   # covered above
    # mamba
    (r"mixer/in_proj$",          [("model", (-1,)), ("data", (-2,))]),
    (r"mixer/conv_w$",           [("model", (-1,))]),
    (r"mixer/conv_b$",           [("model", (-1,))]),
    (r"mixer/x_proj$",           [("model", (-2,))]),
    (r"mixer/dt_proj$",          [("model", (-1,))]),
    (r"mixer/dt_bias$",          [("model", (-1,))]),
    (r"mixer/A_log$",            [("model", (-2,))]),
    (r"mixer/D$",                [("model", (-1,))]),
    (r"mixer/out_proj$",         [("model", (-2,)), ("data", (-1,))]),
    # xLSTM
    (r"mixer/w[qkvo]$|mixer/w_o$", [("model", (-1,)), ("data", (-2,))]),
    (r"mixer/w_[if]$",           [("data", (-2,))]),
    (r"mixer/(w_z|w_i|w_f)$",    [("data", (-2,))]),
    (r"mixer/r_[zifo]$",         [("model", (-3,))]),
    (r"mixer/b_[zifo]$",         []),
]

# MoE expert tensors get a dedicated rule applied before the generic ffn ones.
_MOE_RULES: List[Tuple[str, List[Tuple[str, Sequence[int]]]]] = [
    (r"ffn/w_(up|gate)$", [("model", (-3, -1)), ("data", (-1, -2))]),   # [E, d, f]
    (r"ffn/w_down$",      [("model", (-3, -2)), ("data", (-2, -1))]),   # [E, f, d]
]

_FFN_WEIGHT = re.compile(r"ffn/(w_(up|gate|down))$")


def _spec_for(path_str: str, shape: Tuple[int, ...], mesh,
              is_moe_expert: bool) -> PartitionSpec:
    ndim = len(shape)
    if ndim == 0:
        return P()
    sizes = mesh_shape(mesh)
    assignment: Dict[int, str] = {}

    def try_assign(axis_name: str, candidates: Sequence[int]) -> None:
        if axis_name not in sizes:
            return
        size = sizes[axis_name]
        for c in candidates:
            dim = ndim + c if c < 0 else c
            if dim < 0 or dim >= ndim or dim in assignment:
                continue
            if shape[dim] % size == 0 and shape[dim] >= size:
                assignment[dim] = axis_name
                return

    rules = _MOE_RULES + _RULES if is_moe_expert else _RULES
    matched = False
    for pattern, axes in rules:
        if re.search(pattern, path_str):
            for axis_name, candidates in axes:
                try_assign(axis_name, candidates)
            matched = True
            break
    if not matched and ndim >= 2:
        try_assign("model", (-1, -2))
        try_assign("data", (-2, -1))
    return P(*[assignment.get(d) for d in range(ndim)])


def _is_namedtuple(obj: Any) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def map_stacked(fn, tree: Any, path: Tuple[str, ...] = (),
                stack: Tuple[int, ...] = ()) -> Any:
    """`fn(path_str, stack_sizes, leaf)` over the leaves of the port's nested
    dicts / lists / NamedTuples, in a tree of the same structure. A list adds
    its length to `stack_sizes` (the leaf's leading dims in the reference's
    stacked layout), not a path part; NamedTuple fields are path parts by
    name, as the reference's pytree paths name them. None stays None."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(map_stacked(fn, getattr(tree, f), path + (f,),
                                        stack) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: map_stacked(fn, v, path + (str(k),), stack)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_stacked(fn, v, path, stack + (len(tree),)) for v in tree]
    return fn("/".join(path), stack, tree)


def param_specs(params: Any, mesh, replicate_below: int = 0) -> Any:
    """PartitionSpec tree matching a params (or moment) tree of the port:
    each leaf's spec is the reference's spec of its stacked shape without
    the stack entries (see the module docstring for the two leaves where
    the reference shards a stack axis).

    replicate_below: leaves with fewer elements (counted in the stacked
    layout, as the reference counts them) are fully replicated — at small
    model scale per-layer TP all-reduces cost more than the redundant
    compute they save.
    """
    def spec(path, stack, leaf):
        depth = len(stack)
        shape = tuple(stack) + tuple(leaf.shape)
        if replicate_below and math.prod(shape) < replicate_below:
            return P(*([None] * leaf.ndim))
        is_moe = bool(_FFN_WEIGHT.search(path)) and len(shape) >= 3
        ref = _spec_for(path, shape, mesh, is_moe)
        if not any(ref[:depth]):
            return P(*ref[depth:])
        if _FFN_WEIGHT.search(path) and leaf.ndim == 2:
            # a dense FFN leaf the reference's MoE test took for an expert
            # tensor: the dense rules on the per-layer leaf
            return _spec_for(path, tuple(leaf.shape), mesh, False)
        return P(*ref[depth:])

    return map_stacked(spec, params)


def cache_specs(cache: Any, mesh, batch_size: int, shard_seq: bool = False,
                no_model: bool = False) -> Any:
    """Decode-cache sharding: batch over data axes; KV-heads/inner over model.

    Judged, as the reference's, on the stacked leaves:
      KVCache k/v [G, B, S, KV, hd]; SWACache pos [G, B, W];
      Mamba conv [G, B, dc-1, di] / ssm [G, B, di, N];
      mLSTM C [G, B, H, hd, hd], n [G, B, H, hd], m [G, B, H]; sLSTM [G, B, H, hd].
    The port's per-layer leaf takes the spec without its stack entries
    (never sharded here: the batch dim is at 1 in the stacked layout).
    """
    sizes = mesh_shape(mesh)
    b_axes = _batch_axes(mesh, batch_size)
    model_size = sizes["model"]

    def stacked_spec(path_str: str, shape: Tuple[int, ...]) -> PartitionSpec:
        ndim = len(shape)
        # find batch dim: dim 1 for stacked caches ([G, B, ...]); dim 0 for
        # unstacked (encdec DecoderCache mem_k: [L, B, F, KV, hd] also stacked)
        out: List[Axis] = [None] * ndim
        bdim = 1 if ndim >= 2 else 0
        if ndim >= 2 and shape[bdim] == batch_size and b_axes:
            out[bdim] = b_axes
        if no_model:        # replicated-compute variant: batch only
            return P(*out)
        leaf_name = path_str.split("/")[-1]
        is_kv = leaf_name in ("k", "v") and ndim == 5
        is_scale = leaf_name.endswith("_scale") and ndim == 4   # int8 KV scales
        if is_scale:
            if shard_seq and shape[2] % model_size == 0:
                out[2] = "model"
            elif shape[3] % model_size == 0:
                out[3] = "model"
            return P(*out)
        if shard_seq and is_kv and shape[2] % model_size == 0:
            # shard the KV SEQUENCE dim — attention reduces over it, so the
            # partitioner emits small softmax-stat all-reduces instead of
            # resharding the whole cache (distributed flash-decode semantics)
            out[2] = "model"
            return P(*out)
        if ndim <= 3:                      # small bookkeeping leaves: batch only
            return P(*out)
        # model axis on a heads-like dim when divisible (prefer KV over hd)
        for d in ([ndim - 2, ndim - 1] if ndim >= 4 else [ndim - 1]):
            if d <= bdim:
                continue
            if is_kv and d == 2:           # never the sequence dim here
                continue
            if shape[d] % model_size == 0 and shape[d] >= model_size:
                out[d] = "model"
                break
        return P(*out)

    def spec(path, stack, leaf):
        ref = stacked_spec(path, tuple(stack) + tuple(leaf.shape))
        assert not any(ref[:len(stack)]), (path, ref)
        return P(*ref[len(stack):])

    return map_stacked(spec, cache)


# -- placement on a DeviceMesh ---------------------------------------------------

def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`: per mesh dim, `Shard(d)` for
    the tensor dim whose entry names it, else `Replicate()`. A dim sharded
    over several axes (("pod", "data")) must name them in the mesh's order
    (major first, as the reference's spec reads)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a is not None)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"spec {spec} names axes {unknown} that mesh "
                             f"{names} lacks")
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec} shards dim {d} over {axes}, not in "
                             f"the mesh's order {names}")
        for a in axes:
            if a in dim_of:
                raise ValueError(f"spec {spec} names mesh axis {a!r} twice")
            dim_of[a] = d
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate()
                 for n in names)


def _zip_map(fn, tree: Any, specs: Any) -> Any:
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(_zip_map(fn, getattr(tree, f), getattr(specs, f))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """Each tensor of `tree` as a DTensor on `mesh`, placed by its spec in
    `specs` (a tree of the same structure). Every rank passes the same
    whole tensors; rank 0's values are the ones scattered."""
    from torch.distributed.tensor import distribute_tensor
    return _zip_map(lambda t, s: distribute_tensor(t, mesh,
                                                   placements(s, mesh)),
                    tree, specs)


def full_tree(tree: Any) -> Any:
    """`tree` with every DTensor gathered to its whole tensor (on every
    rank); other leaves unchanged."""
    from torch.distributed.tensor import DTensor

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t
    return map_stacked(lambda _, __, t: full(t), tree)
