"""Sequence-pipelined recurrent prefill: the mLSTM over a sequence sharded
across the ranks of one mesh axis.

Recurrent mixers cannot shard the time axis the way attention can: the
state recurrence is sequential. This pipelines the recurrence over
sequence shards instead:
  * the q/k/v/gate projections, the bulk of the FLOPs, run on each rank's
    SEQUENCE shard with no collective at all;
  * the per-step recurrence runs as a P-stage pipeline: the rank holding
    shard s waits for the final `MLSTMState` of shard s - 1 (a point-to-
    point receive on the axis's sub-group), scans its chunk from it, and
    sends its own final state to shard s + 1. The payload is one local-
    batch state, B/dp * H * hd^2 floats, instead of an all-reduce of
    [B, T, d].

The reference simulates the pipeline inside one SPMD program: every shard
scans at every stage, a `ppermute` hands states along, and selects keep
each shard's own stage. The port runs the same function as a real
pipeline (ROADMAP §3, declared divergences). Forward only, as the
reference.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.dtensor import whole
from repro_torch.distributed.sharding import P, mesh_shape, placements
from repro_torch.models import ssm

Params = Dict[str, torch.Tensor]


def sequence_spec(mesh, batch_size: int, axis: str = "model") -> P:
    """[B, T, d] with T over `axis` and B over the other axes when their
    product divides it (the reference's `spec_x`)."""
    shape = mesh_shape(mesh)
    dp = tuple(a for a in shape if a != axis)
    b_axes = dp if dp and batch_size % math.prod(shape[a] for a in dp) == 0 \
        else None
    return P(b_axes, axis, None)


def pipelined_mlstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                            mesh, axis: str = "model") -> torch.Tensor:
    """mLSTM over x [B, T, d] (a DTensor, or a whole tensor the same on
    every rank) with T sharded over `axis` of `mesh`: projections
    collective-free, the recurrence a pipeline of one send and one receive
    of an `MLSTMState` a stage. `p` is replicated (whole tensors or
    DTensors). Returns y [B, T, d] as a DTensor in `sequence_spec`'s
    placements. Raises ValueError when the axis does not divide T."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    n_stages = mesh_shape(mesh)[axis]
    B, T, _ = x.shape
    if T % n_stages:
        raise ValueError(f"sequence of {T} over {n_stages} stages")
    place = placements(sequence_spec(mesh, B, axis), mesh)
    if isinstance(x, DTensor):
        xd = x.redistribute(mesh, place)
    else:
        xd = distribute_tensor(x, mesh, place)
    x_local = xd.to_local()
    p_local = {k: whole(v) for k, v in p.items()}

    b, t = x_local.shape[0], x_local.shape[1]
    q, k, v, i_log, f_log, o = ssm._mlstm_gates(p_local, x_local, cfg)
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    carry = ssm.mlstm_init_state(b, cfg, x_local.device)
    if stage > 0:
        # shard stage - 1's final state
        for a in carry:
            dist.recv(a, group=group, group_src=stage - 1)
    tm = [a.transpose(0, 1) for a in (q, k, v, i_log, f_log)]
    final, ys = ssm._scan(ssm._mlstm_step, carry, tm, t)
    if stage < n_stages - 1:
        for a in final:
            dist.send(a.contiguous(), group=group, group_dst=stage + 1)
    y = (ys.reshape(b, t, -1) * o) @ p_local["out_proj"].to(x_local.dtype)
    return DTensor.from_local(y, mesh, place, shape=xd.shape,
                              stride=xd.stride())
