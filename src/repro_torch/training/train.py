"""Training step: loss -> gradients -> AdamW, with optional gradient
accumulation over microbatches.

`make_train_step(model, opt_cfg, microbatches)` returns a function
(train_state, batch) -> (train_state, metrics). Gradients come from
autograd on leaf copies of the params (`requires_grad`), one microbatch at
a time, so peak activation memory is one microbatch's; with more than one
they are summed in float32 and divided by the count, as the loss is, and
the aux metrics are averaged. `train_loop` is a plain host loop.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

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
    """The batch as n microbatches along its first axis."""
    def split(a):
        B = a.shape[0]
        assert B % n == 0, f"batch {B} not divisible by microbatches {n}"
        return a.reshape((n, B // n) + tuple(a.shape[1:]))
    split_batch = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split_batch.items()} for i in range(n)]


def grads_of(model: Model, params: Any, batch: Dict[str, torch.Tensor]):
    """(loss, aux, grads) of `model.loss_fn` at `params`, the gradients in
    the params' tree and dtypes."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, aux = model.loss_fn(leaves, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, flat))
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(model: Model, opt_cfg: AdamWConfig, microbatches: int = 1):
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if microbatches == 1:
            loss, aux, grads = grads_of(model, state.params, batch)
        else:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device),
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
        metrics = {"loss": loss, **aux, **opt_metrics}
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
