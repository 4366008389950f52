"""The one traffic generator: a closed loop of sessions, from a mix's data
file and the run's seed.

A mix file (`bench/traffic/<mix>.json`) gives the number of sessions, the
slots the server keeps, the prompt and output length distributions and the
warm-up. Every seed gets the same multiset of lengths, the quantiles of the
distributions at evenly spaced points, dealt to the sessions in an order
drawn from the seed; the token ids are drawn from the seed. So two seeds
differ in order and content, not in the amount of work. A session sends its
next request as soon as the last one has finished, and every request is
decoded greedily. The first request of each session is cut short, as if
it had started some steps before (the harness sends them shortest first,
the order they would have come in), so that the sessions finish out of
step from the first step on: to lengths spread evenly over 1 to the mix's
`warmup.stagger_steps`, or, with `warmup.stagger` "equilibrium", to the
quantiles of the tokens a session has left when looked at on a random
step of the closed loop's steady state. The latter sends requests at the
steady state's rate from the first step on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np

# requests a session holds ready: more than any window at the mixes' rates
REQUESTS_PER_SESSION = 64


@dataclasses.dataclass
class PlannedRequest:
    uid: int
    session: int
    prompt: np.ndarray          # [T] int32
    max_new_tokens: int


def _quantiles(dist: Dict, n: int) -> np.ndarray:
    """n integer lengths at the distribution's quantiles (k + 0.5) / n."""
    lo, hi = float(dist["low"]), float(dist["high"])
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "uniform":
        x = lo + u * (hi - lo)
    elif dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def residual_lengths(lengths: np.ndarray, n: int) -> np.ndarray:
    """n lengths at the quantiles (k + 0.5) / n of the tokens left in a
    request seen on a random step of a closed loop whose requests have
    `lengths`: r tokens left has a weight of the number of lengths >= r."""
    r = np.arange(1, int(lengths.max()) + 1)
    weight = len(lengths) - np.searchsorted(np.sort(lengths), r, side="left")
    cdf = np.cumsum(weight) / weight.sum()
    return r[np.searchsorted(cdf, (np.arange(n) + 0.5) / n)]


def max_len(mix: Dict) -> int:
    """KV positions a slot needs: the mix's stated context, or its longest
    prompt plus its longest output."""
    if "max_context" in mix:
        return int(mix["max_context"])
    return int(mix["prompt_tokens"]["high"] + mix["output_tokens"]["high"])


def plan(mix: Dict, seed: int, vocab_size: int,
         per_session: int = REQUESTS_PER_SESSION) -> List[List[PlannedRequest]]:
    """Each session's stream of requests, in the order it sends them."""
    S = int(mix["sessions"])
    n = S * per_session
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0x7AFF1C])
    prompts = _quantiles(mix["prompt_tokens"], n)[rng.permutation(n)]
    outputs = _quantiles(mix["output_tokens"], n)[rng.permutation(n)]
    warm = mix["warmup"]
    if warm.get("stagger") == "equilibrium":
        first_out = residual_lengths(outputs, S)[rng.permutation(S)]
    else:
        stagger = int(warm["stagger_steps"])
        first_out = 1 + rng.permutation(S) * max(stagger - 1, 0) // max(S - 1, 1)
    streams: List[List[PlannedRequest]] = []
    for s in range(S):
        reqs = []
        for i in range(per_session):
            k = s * per_session + i
            T = int(prompts[k])
            out = int(first_out[s]) if i == 0 else int(outputs[k])
            tokens = rng.integers(0, vocab_size, T, dtype=np.int64)
            reqs.append(PlannedRequest(uid=k, session=s,
                                       prompt=tokens.astype(np.int32),
                                       max_new_tokens=out))
        streams.append(reqs)
    return streams
