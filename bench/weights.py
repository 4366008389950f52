"""Weights of a benchmark configuration, drawn on the device from the seed,
with the paper's activation sparsity planted in every FFN.

Random weights fire on most of a ReLU FFN's neurons. The paper's models
fire on few (Table 3: 9.49% on OPT-350M, 4.09% on OPT-1.3B), and fire in
groups that co-occur, which is what linked placement, the linking-aligned
cache and extent collapse exploit. So each layer's up-projection and
pre-FFN LayerNorm are shaped as follows, and everything else is drawn
plainly:

- One coordinate of the hidden state, `bias_channel` k, carries a constant:
  the pre-FFN LayerNorm has scale 0 and bias 1 there, so the normed input
  h2 has h2[k] = 1 for every token. Row k of w_up then adds a per-neuron
  offset -theta_j to every pre-activation: a negative bias that comes
  through the norm's bias, with no bias in the linear layer.
- The neurons fall into `groups` co-activation groups, assigned by a random
  permutation (so the identity layout scatters them). Column j of w_up is
  `group_weight` times its group's direction plus the rest in noise of its
  own, so a token whose hidden state points along a group's direction fires
  most of that group.
- Group popularity is skewed: group r's firing rate in a Gaussian model is
  min(p_max, A (r + 1)^-zipf), and its members' offset is that rate's
  normal quantile. A per-layer shift of the offsets, found by bisection on
  a fixed calibration batch layer after layer, makes the share of
  (token, neuron) pairs that fire equal the configuration's target.

Masks are never edited: the served path's oracle ((h2 @ w_up) > 0) and the
pack builder's calibration see this structure through the weights alone.
The result is a pure function of (configuration, seed) on a given device,
the same bits in every run.
"""
from __future__ import annotations

import hashlib
import statistics
from typing import Dict, List, Tuple

import torch

from reference.opt_reference import attention, layer_norm


def seed_for(cfg: Dict, seed: int, stream: int) -> int:
    """A 63-bit generator seed from the run's seed (any size), the
    configuration's name and a stream number."""
    h = hashlib.sha256(f"{cfg['name']}|{int(seed)}|{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def group_rates(target: float, groups: int, zipf: float, p_max: float) -> List[float]:
    """Firing rate of each popularity rank: min(p_max, A (r+1)^-zipf) with A
    such that the mean over the groups is `target`."""
    def mean(a):
        return sum(min(p_max, a * (r + 1) ** -zipf) for r in range(groups)) / groups
    lo, hi = 0.0, 1.0
    while mean(hi) < target:
        hi *= 2
    for _ in range(100):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if mean(mid) < target else (lo, mid)
    a = (lo + hi) / 2
    return [min(p_max, a * (r + 1) ** -zipf) for r in range(groups)]


def _randn(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).mul_(std)


def make_weights(cfg: Dict, seed: int, device) -> Tuple[Dict, Dict]:
    """(weights, report). `weights` is the dict the reference and the harness
    share ({"embedding", "lm_head", "final_norm", "layers": [...]}, bf16 on
    `device`); `report` holds each layer's activation share on the
    calibration batch and the shift that set it."""
    dt = getattr(torch, cfg["dtype"])
    d, f, L, V = cfg["d_model"], cfg["d_ff"], cfg["n_layers"], cfg["vocab_size"]
    sp, init = cfg["sparsity"], cfg["init"]
    G, k = int(sp["groups"]), int(sp["bias_channel"])
    alpha = float(sp["group_weight"])
    gen = torch.Generator(device=device).manual_seed(seed_for(cfg, seed, 0))

    embedding = _randn(gen, (V, d), init["embedding_std"]).to(dt)
    lm_head = _randn(gen, (d, V), d ** -0.5).to(dt)
    attn = _randn(gen, (L, 4, d, d), d ** -0.5).to(dt)
    down_std = init["down_std_scale"] / (sp["target"] * f) ** 0.5
    w_down = _randn(gen, (L, f, d), down_std).to(dt)
    gdir = _randn(gen, (L, G, d), d ** -0.5)
    group_of = torch.argsort(torch.rand((L, f), generator=gen, device=device),
                             dim=1) % G                          # [L, f]
    rank_of = torch.argsort(torch.rand((L, G), generator=gen, device=device),
                            dim=1)                               # [L, G]
    rates = group_rates(sp["target"], G, sp["zipf"], sp["p_max"])
    normal = statistics.NormalDist()
    theta_r = torch.tensor([normal.inv_cdf(1.0 - p) for p in rates],
                           dtype=torch.float32, device=device)
    ones = torch.ones(d, dtype=dt, device=device)
    zeros = torch.zeros(d, dtype=dt, device=device)
    norm2 = {"scale": ones.clone(), "bias": zeros.clone()}
    norm2["scale"][k] = 0
    norm2["bias"][k] = 1

    layers = []
    for l in range(L):
        w_up = _randn(gen, (d, f), d ** -0.5).mul_((1 - alpha ** 2) ** 0.5)
        w_up.add_(gdir[l][group_of[l]].T, alpha=alpha)
        w_up[k] = 0
        w_up = w_up.to(dt).float()            # the served bits; row k set below
        layers.append({
            "norm1": {"scale": ones.clone(), "bias": zeros.clone()},
            "wq": attn[l, 0], "wk": attn[l, 1], "wv": attn[l, 2],
            "wo": attn[l, 3],
            "norm2": {"scale": norm2["scale"].clone(),
                      "bias": norm2["bias"].clone()},
            "w_up": w_up,                     # float32 until calibrated
            "w_down": w_down[l],
        })
    del attn, gdir

    cgen = torch.Generator(device=device).manual_seed(seed_for(cfg, seed, 1))
    calib = torch.randint(0, V, (sp["calib_batch"], sp["calib_seqlen"]),
                          generator=cgen, device=device)
    shares, shifts = calibrate(layers, embedding, cfg, calib, theta_r,
                               group_of, rank_of)
    weights = {"embedding": embedding, "lm_head": lm_head,
               "final_norm": {"scale": ones.clone(), "bias": zeros.clone()},
               "layers": layers}
    return weights, {"calib_shares": shares, "shifts": shifts,
                     "target": sp["target"]}


def calibrate(layers: List[Dict], embedding: torch.Tensor, cfg: Dict,
              calib: torch.Tensor, theta_r: torch.Tensor,
              group_of: torch.Tensor, rank_of: torch.Tensor
              ) -> Tuple[List[float], List[float]]:
    """Set each layer's offsets (row `bias_channel` of w_up) so that its
    activation share on the calibration batch is the target, layer after
    layer in float32; casts w_up to the configuration's dtype."""
    dt = getattr(torch, cfg["dtype"])
    k, target = cfg["sparsity"]["bias_channel"], cfg["sparsity"]["target"]
    xs = [embedding.float()[t] for t in calib]
    shares, shifts = [], []
    for l, lw in enumerate(layers):
        theta = theta_r[rank_of[l][group_of[l]]]                 # [f]
        hs, pres = [], []
        for i, x in enumerate(xs):
            x = x + attention(layer_norm(x, lw["norm1"]), lw, cfg)
            hs.append(x)
            pres.append(layer_norm(x, lw["norm2"]) @ lw["w_up"])
        P = torch.cat(pres)                                      # row k is 0
        lo, hi = -8.0, 8.0
        for _ in range(50):
            mid = (lo + hi) / 2
            share = float((P > theta + mid).float().mean())
            lo, hi = (mid, hi) if share > target else (lo, mid)
        shift = (lo + hi) / 2
        lw["w_up"][k] = -(theta + shift)
        lw["w_up"] = lw["w_up"].to(dt)
        off = lw["w_up"][k].float()
        share = float((P + off > 0).float().mean())
        for i, x in enumerate(hs):
            xs[i] = x + torch.relu(pres[i] + off) @ lw["w_down"].float()
        shares.append(share)
        shifts.append(shift)
    return shares, shifts


def ffn_fingerprint(weights: Dict) -> str:
    """sha256 of every FFN matrix's bits, layer by layer: the key of the
    NeuronPack built from these weights."""
    h = hashlib.sha256()
    for lw in weights["layers"]:
        for name in ("w_up", "w_down"):
            t = lw[name].contiguous()
            h.update(t.view(torch.int16).cpu().numpy().tobytes()
                     if t.element_size() == 2 else t.cpu().numpy().tobytes())
    return h.hexdigest()
