"""Explicit redistributions for the few places where DTensor has no sharding
strategy for an op of the model, or cannot keep a sharding through it.

Each helper is the identity on a plain tensor, so the one-device path runs
the same ops as before. On a DTensor it redistributes as its docstring says
and then runs the op: nothing here catches a propagation error and runs
the op another way. Every call site carries a comment naming the op.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def replicated(t: torch.Tensor) -> torch.Tensor:
    """`t` replicated on every mesh dim (an all-gather / all-reduce of each
    sharded or partial dim); a plain tensor unchanged."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh,
                          [Replicate()] * t.device_mesh.ndim)


def reduced(t: torch.Tensor) -> torch.Tensor:
    """`t` with its partial sums reduced (an all-reduce of each `Partial`
    mesh dim, which becomes replicated) and its shards kept; a plain
    tensor unchanged. A partial sum met by a sharded operand (a bias, a
    norm's scale) would otherwise have to be turned into a partial itself,
    which some torch versions refuse."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in t.placements])


def write_rows_(dst: torch.Tensor, cols: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """dst[b, cols[b, t]] = src[b, t] for every row b, in place; returns
    `dst`. Under sharding each rank writes its own shard of `dst` (an
    indexed write, `index_put_`, has no DTensor strategy on some torch
    versions): `src` is taken in `dst`'s placements and `cols` in its
    rows'. `dst` may be sharded on its rows and on dims past its second,
    never on the second (the one `cols` indexes) nor partial."""
    if not is_dtensor(dst):
        rows = torch.arange(dst.shape[0], device=dst.device)[:, None]
        dst[rows, cols] = src
        return dst
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, places = dst.device_mesh, list(dst.placements)
    if any(p.is_partial() or (isinstance(p, Shard) and p.dim == 1)
           for p in places):
        raise ValueError(f"cannot write rows into placements {places}")
    row_places = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                  for p in places]

    def local(t, want):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, want).to_local()
    d = dst.to_local()
    rows = torch.arange(d.shape[0], device=d.device)[:, None]
    d[rows, local(cols, row_places)] = local(src, places)
    return dst


def batch_placed(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`t` with its leading (batch) dim sharded as `like`'s and every other
    dim replicated: the activations' layout that the reference's
    partitioner propagates from a batch-sharded input. DTensor picks a
    strategy op by op and may leave activations sharded on their hidden
    dim, whose reshapes the backward then cannot shard; the model pins its
    activations here at each layer's boundary."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    want = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in like.placements]
    if list(t.placements) == want:
        return t
    return t.redistribute(t.device_mesh, want)


def whole(t: torch.Tensor) -> torch.Tensor:
    """The whole of `t` as a plain tensor, the same on every rank (for
    integer bookkeeping outside autograd); a plain tensor unchanged."""
    return replicated(t).to_local() if is_dtensor(t) else t


def elementwise(fn: Callable[[torch.Tensor], torch.Tensor],
                t: torch.Tensor) -> torch.Tensor:
    """`fn`, an elementwise op with no DTensor strategy (e.g.
    `F.logsigmoid`), on each rank's shard of `t`, which keeps its
    placements; partial sums are reduced first. Differentiable."""
    if not is_dtensor(t):
        return fn(t)
    from torch.distributed.tensor import DTensor, Replicate
    places = [Replicate() if p.is_partial() else p for p in t.placements]
    if list(places) != list(t.placements):
        t = t.redistribute(t.device_mesh, places)
    return DTensor.from_local(fn(t.to_local()), t.device_mesh, places,
                              shape=t.shape, stride=t.stride())


def split_last(t: torch.Tensor, n: int) -> torch.Tensor:
    """`t` [..., n * m] viewed as [..., n, m]. A DTensor sharded on its last
    dim over mesh dims whose sizes do not divide `n` (2 KV heads over a
    model axis of 4) cannot keep that sharding through the view: those
    mesh dims are replicated first."""
    shape = tuple(t.shape[:-1]) + (n, t.shape[-1] // n)
    if not is_dtensor(t):
        return t.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    last = t.ndim - 1
    mesh = t.device_mesh
    over = [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == last]
    if over and n % math.prod(mesh.size(i) for i in over):
        t = t.redistribute(mesh, [Replicate() if i in over else p
                                  for i, p in enumerate(t.placements)])
    return t.reshape(shape)


def rows(t: torch.Tensor, start: int, length: int) -> torch.Tensor:
    """Rows [start, start + length) of `t`'s leading dim; a DTensor's slice
    comes back in `t`'s placements. (A reshape of a sharded batch dim into
    microbatches leaves strided shards that the matmuls have no strategy
    for: the batch, a few integers a row, is replicated and each slice
    sharded again.)"""
    if not is_dtensor(t):
        return t[start:start + length]
    return replicated(t)[start:start + length].redistribute(
        t.device_mesh, t.placements)


def pin(t: torch.Tensor) -> torch.Tensor:
    """`t` unchanged, but a DTensor's gradient is redistributed here to
    `t`'s placements, so that the backward of the view before it (rows
    merged or split) meets the layout the forward had."""
    if not is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh, t.placements)


def rows_and_heads(fn: Callable, ref: torch.Tensor, args: Sequence,
                   head_dims: Sequence[Optional[int]], n_heads: int,
                   out_head_dims: Sequence[Optional[int]],
                   row_dims: Optional[Sequence[Optional[int]]] = None):
    """`fn(*args)` for computations independent per batch row (dim 0) and
    per head (attention over KV heads, the SSM recurrences): under
    sharding, each rank runs `fn` on plain tensors holding its own rows and
    heads, and the outputs come back as DTensors. DTensor would otherwise
    flatten a sharded head dim into the batch of its batched products,
    which some torch versions refuse.

    `ref` (a DTensor) names the mesh and the mesh dims sharding the batch
    (its `Shard(0)` dims); every other mesh dim shards the heads where the
    product of their sizes divides `n_heads`, and is replicated otherwise.
    `head_dims[i]` is arg i's head dim (None: rows only); plain tensor args
    are taken as replicated, None args pass through; `row_dims[i]` is 0,
    or None for an arg without rows (a weight split by heads only).
    `fn` returns a tensor
    or a tuple of them; `out_head_dims` gives each one's head dim (a dim
    that merges heads with a trailing size, e.g. [B, T, H * hd], counts:
    its blocks are whole heads). A plain `ref` runs `fn(*args)`."""
    if not is_dtensor(ref):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = ref.device_mesh
    rows = [isinstance(p, Shard) and p.dim == 0 for p in ref.placements]
    heads, span = [False] * mesh.ndim, 1
    for i in range(mesh.ndim):
        if not rows[i] and n_heads % (span * mesh.size(i)) == 0:
            heads[i], span = True, span * mesh.size(i)

    def places(head_dim, row_dim=0):
        return [Shard(row_dim) if rows[i] and row_dim is not None else
                Shard(head_dim) if heads[i] and head_dim is not None
                else Replicate() for i in range(mesh.ndim)]

    def local(t, head_dim, row_dim):
        if t is None:
            return None
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, places(head_dim, row_dim)).to_local()

    row_dims = row_dims or [0] * len(args)
    out = fn(*(local(a, h, r) for a, h, r in zip(args, head_dims, row_dims)))
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = tuple(DTensor.from_local(o, mesh, places(h), run_check=False)
                    for o, h in zip(outs, out_head_dims))
    return wrapped if isinstance(out, tuple) else wrapped[0]
