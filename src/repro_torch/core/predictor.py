"""Per-layer activation predictor (paper Fig. 3 step 1; à la Deja Vu /
LLMFlash), in torch.

A small bottleneck MLP maps the pre-FFN hidden state to per-neuron
activation logits; neurons with sigmoid(logit) > threshold are predicted
active. Trained with Adam on (hidden_state, activation_mask) pairs from
traces, on the device the caller names (the card by default).

Adam is written out as the reference writes it (the same moments, bias
corrections and `eps` placement), not `torch.optim.Adam`, whose update is
arranged and rounded differently; the batches come from
`np.random.default_rng(seed).permutation`, so the port and the reference
see the same batch order. The init draws from a `torch.Generator`, so its
numbers differ from the reference's `jax.random` draws; a parity test
starts `_fit` from the reference's own init, converted with
`repro_torch.convert.predictor_params_from_numpy`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import promoted_matmul

ArrayLike = Union[np.ndarray, torch.Tensor]


class PredictorParams(NamedTuple):
    w1: torch.Tensor   # [d_model, d_hidden]
    b1: torch.Tensor   # [d_hidden]
    w2: torch.Tensor   # [d_hidden, n_neurons]
    b2: torch.Tensor   # [n_neurons]


@dataclasses.dataclass
class PredictorConfig:
    d_model: int
    n_neurons: int
    d_hidden: int = 128
    threshold: float = 0.5
    lr: float = 1e-3
    pos_weight: float = 2.0   # recall matters more: a missed neuron corrupts output


def init_predictor(cfg: PredictorConfig,
                   generator: torch.Generator) -> PredictorParams:
    """Normal weights scaled by 1/sqrt(fan-in), zero biases, float32, drawn
    from `generator` on its device."""
    dev = generator.device
    s1 = 1.0 / np.sqrt(cfg.d_model)
    s2 = 1.0 / np.sqrt(cfg.d_hidden)
    return PredictorParams(
        w1=torch.randn((cfg.d_model, cfg.d_hidden), generator=generator,
                       device=dev) * s1,
        b1=torch.zeros(cfg.d_hidden, device=dev),
        w2=torch.randn((cfg.d_hidden, cfg.n_neurons), generator=generator,
                       device=dev) * s2,
        b2=torch.zeros(cfg.n_neurons, device=dev),
    )


def predictor_logits(params: PredictorParams, h: torch.Tensor) -> torch.Tensor:
    """On the tensors' device; a bf16 `h` meets the float32 weights in
    float32, as `jnp.matmul` promotes."""
    z = torch.relu(promoted_matmul(h, params.w1) + params.b1)
    return z @ params.w2 + params.b2


def predict_mask(params: PredictorParams, h: torch.Tensor,
                 threshold: float = 0.5) -> torch.Tensor:
    return torch.sigmoid(predictor_logits(params, h)) > threshold


def predict_mask_np(params_np: Tuple[np.ndarray, ...], h: np.ndarray,
                    threshold: float = 0.5) -> np.ndarray:
    """Pure-numpy predictor inference for the serving thread's lookahead: the
    prefetch pipeline needs the speculative mask on HOST (to hand to the I/O
    worker) without a device launch between the decode's own. `params_np`
    is the PredictorParams tuple as numpy arrays (see `as_numpy_params`);
    sigmoid(logit) > t is evaluated as logit > logit(t).
    """
    w1, b1, w2, b2 = params_np
    z = np.maximum(h @ w1 + b1, 0.0)
    logits = z @ w2 + b2
    cut = np.log(threshold / (1.0 - threshold))
    return logits > cut


def as_numpy_params(params) -> Tuple[np.ndarray, ...]:
    """Host-side copies of predictor params for `predict_mask_np`."""
    return tuple(p.detach().cpu().numpy() if isinstance(p, torch.Tensor)
                 else np.asarray(p) for p in params)


def _loss(params: PredictorParams, h: torch.Tensor, y: torch.Tensor,
          pos_weight: float = 2.0) -> torch.Tensor:
    logits = predictor_logits(params, h)
    y = y.to(torch.float32)
    per = (torch.clamp_min(logits, 0) - logits * y
           + torch.log1p(torch.exp(-torch.abs(logits))))
    w = torch.where(y > 0, pos_weight, 1.0)
    return torch.mean(per * w)


def _adam_step(params: PredictorParams, mu: PredictorParams,
               nu: PredictorParams, step: torch.Tensor, h: torch.Tensor,
               y: torch.Tensor, lr: float, pos_weight: float):
    """One Adam step on the loss of (h, y), as the reference's `_adam_step`
    (`src/repro/core/predictor.py:85-98`): returns (params, mu, nu, step,
    loss). `step` is a float32 0-d tensor."""
    with torch.inference_mode(False), torch.enable_grad():
        leaves = [p.detach().requires_grad_(True) for p in params]
        loss = _loss(PredictorParams(*leaves), h, y, pos_weight)
        grads = torch.autograd.grad(loss, leaves)
    b1, b2, eps = 0.9, 0.999, 1e-8
    step = step + 1
    mu = PredictorParams(*(b1 * m + (1 - b1) * g for m, g in zip(mu, grads)))
    nu = PredictorParams(*(b2 * v + (1 - b2) * g * g
                           for v, g in zip(nu, grads)))
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    new = PredictorParams(*(
        p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        for p, m, v in zip(params, mu, nu)))
    return new, mu, nu, step, loss.detach()


@torch.inference_mode(False)
def _fit(params: PredictorParams, hiddens: ArrayLike, masks: ArrayLike,
         cfg: PredictorConfig, epochs: int = 5, batch_size: int = 256,
         seed: int = 0) -> Tuple[PredictorParams, float]:
    """Adam from `params` on [T, d_model] hiddens / [T, n] masks, on the
    params' device; the batch order is `default_rng(seed)`'s permutations,
    as in the reference. Runs outside inference mode (autograd needs it),
    so tensors a caller made under `torch.inference_mode` are read, and
    the params copied, not updated in place."""
    dev = params.w1.device
    params = PredictorParams(*(p.clone() for p in params))
    hiddens = torch.as_tensor(hiddens, device=dev)
    masks = torch.as_tensor(masks, device=dev)
    mu = PredictorParams(*(torch.zeros_like(p) for p in params))
    nu = mu
    step = torch.zeros((), dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    n = hiddens.shape[0]
    loss = None
    for _ in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=dev)
        for s in range(0, n, batch_size):
            idx = order[s:s + batch_size]
            params, mu, nu, step, loss = _adam_step(
                params, mu, nu, step, hiddens[idx], masks[idx], cfg.lr,
                cfg.pos_weight)
    return params, float("nan") if loss is None else float(loss)


def train_predictor(
    cfg: PredictorConfig,
    hiddens: ArrayLike,
    masks: ArrayLike,
    epochs: int = 5,
    batch_size: int = 256,
    seed: int = 0,
    *,
    device: DeviceLike = None,
) -> Tuple[PredictorParams, float]:
    """Fit on [T, d_model] hiddens / [T, n] masks with Adam on `device`
    (default cuda); the init draws from a generator seeded with `seed`."""
    dev = resolve_device(device)
    params = init_predictor(cfg, torch.Generator(device=dev).manual_seed(seed))
    return _fit(params, hiddens, masks, cfg, epochs=epochs,
                batch_size=batch_size, seed=seed)


def train_lookahead_predictors(
    hiddens_per_layer: ArrayLike,       # [L, T, d_model] pre-FFN hidden states
    masks_per_layer: ArrayLike,         # [L, T, n_neurons] activation masks
    d_hidden: int = 64,
    threshold: float = 0.35,
    pos_weight: float = 4.0,
    epochs: int = 4,
    lr: float = 1e-3,
    seed: int = 0,
    *,
    device: DeviceLike = None,
) -> list:
    """Cross-layer lookahead predictors for the asynchronous prefetch pipeline.

    Predictor k maps layer k's pre-FFN hidden state to layer k+1's activation
    mask — exactly the signal available one layer EARLY, so a background I/O
    worker can probe the cache and read flash for layer k+1 while the device
    still computes layer k's FFN. Returns L-1 `PredictorParams` (entry k
    predicts layer k+1 from layer k), trained on `device` (default cuda).

    Tuned to over-predict (low threshold, recall-weighted loss): a neuron the
    lookahead misses costs a synchronous top-up read on the serving thread,
    while an over-predicted neuron only inflates the prefetch read that is
    hidden behind compute anyway.
    """
    L = hiddens_per_layer.shape[0]
    params = []
    for k in range(L - 1):
        cfg = PredictorConfig(
            d_model=hiddens_per_layer.shape[-1],
            n_neurons=masks_per_layer.shape[-1], d_hidden=d_hidden,
            threshold=threshold, lr=lr, pos_weight=pos_weight)
        p, _ = train_predictor(cfg, hiddens_per_layer[k],
                               masks_per_layer[k + 1], epochs=epochs,
                               seed=seed + k, device=device)
        params.append(p)
    return params


def recall_precision(params: PredictorParams, hiddens: ArrayLike,
                     masks: ArrayLike,
                     threshold: float = 0.5) -> Tuple[float, float]:
    h = torch.as_tensor(hiddens, device=params.w1.device)
    pred = predict_mask(params, h, threshold).cpu().numpy()
    truth = np.asarray(masks.cpu() if isinstance(masks, torch.Tensor)
                       else masks, dtype=bool)
    tp = float(np.sum(pred & truth))
    recall = tp / max(float(truth.sum()), 1.0)
    precision = tp / max(float(pred.sum()), 1.0)
    return recall, precision

