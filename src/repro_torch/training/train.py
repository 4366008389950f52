"""Training step: loss -> gradients -> AdamW, with optional gradient
accumulation over microbatches.

`make_train_step(model, opt_cfg, microbatches)` returns a function
(train_state, batch) -> (train_state, metrics). Gradients come from
autograd on leaf copies of the params (`requires_grad`), one microbatch at
a time, so peak activation memory is one microbatch's; with more than one
they are summed in float32 and divided by the count, as the loss is, and
the aux metrics are averaged. `train_loop` is a plain host loop.

Sharded training: the same step runs on DTensor leaves (params, moments
and batch placed by `distributed.sharding`), its plain tensors (positions,
masks, the schedule's scalars) taken as replicated
(`implicit_replication`). The gradients leave autograd with the placements
the backward gave them (`Partial` sums over the batch axes, a replicated
copy of an FSDP weight) and are redistributed to their params' placements
before AdamW, so the updated state keeps the params' placements: the
counterpart of the reference's `out_shardings`. The metrics come back as
whole (replicated) tensors.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.dtensor import is_dtensor, rows
from repro_torch.models.model import Model
from repro_torch.training.optimizer import (AdamWConfig, AdamWState,
                                            adamw_update, init_adamw)
from repro_torch.utils import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_train_state(model: Model, generator: Optional[torch.Generator],
                     opt_cfg: AdamWConfig) -> TrainState:
    params = model.init_params(generator)
    return TrainState(params=params, opt=init_adamw(params, opt_cfg))


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    """The batch as n microbatches along its first axis (DTensor leaves in
    the batch's placements)."""
    B = next(iter(batch.values())).shape[0]
    assert B % n == 0, f"batch {B} not divisible by microbatches {n}"
    m = B // n
    return [{k: rows(v, i * m, m) for k, v in batch.items()}
            for i in range(n)]


def sharded(params: Any):
    """A context for ops over `params`: DTensor leaves take plain tensors
    as replicated (`implicit_replication`); a plain tree needs nothing."""
    if not is_dtensor(tree_leaves(params)[0]):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its param's placements (DTensor leaves)."""
    if is_dtensor(p) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def grads_of(model: Model, params: Any, batch: Dict[str, torch.Tensor]):
    """(loss, aux, grads) of `model.loss_fn` at `params`, the gradients in
    the params' tree, dtypes and (DTensor leaves) placements."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad(), sharded(params):
        loss, aux = model.loss_fn(leaves, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(_like_param(g, p) if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, flat))
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            tree_map(lambda _: next(it), params))


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if is_dtensor(t) else t


def make_train_step(model: Model, opt_cfg: AdamWConfig, microbatches: int = 1):
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with sharded(state.params):
            return _step(state, batch)

    def _step(state, batch):
        if microbatches == 1:
            loss, aux, grads = grads_of(model, state.params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(grads)[0].device)
            auxes = []
            for mb in _split_microbatches(batch, microbatches):
                l, a, g = grads_of(model, state.params, mb)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
                auxes.append(a)
            loss = loss / microbatches
            grads = tree_map(lambda g: g / microbatches, grads)
            aux = {k: torch.stack([a[k] for a in auxes]).mean()
                   for k in auxes[0]}
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state.opt, state.params, opt_cfg)
        metrics = {k: _whole(v) for k, v in
                   {"loss": loss, **aux, **opt_metrics}.items()}
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step


def train_loop(model: Model, data_iter, steps: int, opt_cfg: AdamWConfig,
               seed: int = 0, microbatches: int = 1, log_every: int = 10,
               callback=None):
    """Single-process training loop from the model's seeded init
    (`torch.Generator(model.device).manual_seed(seed)`); returns (state,
    history of the logged steps' float metrics)."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    state = init_train_state(model, gen, opt_cfg)
    step_fn = make_train_step(model, opt_cfg, microbatches)
    history = []
    for step in range(steps):
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            if callback:
                callback(step, m)
    return state, history
