"""AdamW with a warmup + cosine learning-rate schedule, written out as plain
functions over the params tree (no `torch.optim`), in the reference's order
of operations, so one step compares leaf by leaf with
`repro.training.optimizer.adamw_update`.

Weight decay applies to matrices, which the reference decides by each
leaf's `ndim >= 2` in ITS layout, where a scanned stack's leaves carry the
[G, ...] / [L, ...] axis: a layer's norm scale there is [G, d], 2-D, and is
decayed. The port holds those stacks as lists (`convert`), so a leaf
reached through a list counts one dimension more, and the same leaves are
decayed as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.utils import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor     # scalar int32
    mu: Any                # first moment, like params
    nu: Any                # second moment, like params


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    moment_dtype: str = "float32"   # bf16 halves the moments' memory


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to `lr_peak`, then a cosine down to `lr_min_ratio *
    lr_peak` at `total_steps`; float32, as the reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr_peak * cos)


def init_adamw(params: Any, cfg: AdamWConfig) -> AdamWState:
    mdt = getattr(torch, cfg.moment_dtype)
    leaf = tree_leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def _reference_ndim(tree: Any, depth: int = 0) -> Any:
    """Each leaf's ndim in the reference's stacked layout: its own plus one
    per list it sits in."""
    if isinstance(tree, dict):
        return {k: _reference_ndim(v, depth) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_reference_ndim(v, depth + 1) for v in tree]
    return tree.ndim + depth


def adamw_update(grads: Any, state: AdamWState, params: Any,
                 cfg: AdamWConfig) -> Tuple[Any, AdamWState, dict]:
    """Returns (new_params, new_state, {"grad_norm", "lr"}). Gradients are
    clipped by their global norm, moments updated and bias-corrected in
    float32 with the float32 step, matrices decayed, and the moments
    stored in `cfg.moment_dtype`."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip_norm / (gnorm + 1e-9), 1.0)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, mu, nu, ndim):
        g = g.float() * scale
        mu32 = b1 * mu.float() + (1 - b1) * g
        nu32 = b2 * nu.float() + (1 - b2) * torch.square(g)
        mhat = mu32 / bc1
        vhat = nu32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        newp = p.float() - lr * delta
        return newp.to(p.dtype), mu32.to(mdt), nu32.to(mdt)

    out = tree_map(upd, params, grads, state.mu, state.nu,
                   _reference_ndim(params))
    # `out`'s leaves are (param, mu, nu) tuples
    new_p, mu, nu = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    return (new_p, AdamWState(step=step, mu=mu, nu=nu),
            {"grad_norm": gnorm, "lr": lr})
