"""How `correct` is decided: the tokens the timed path served, held
against the plain float32 reference of the configuration's architecture
(its module's `forward_logits`, `bench/arch/<arch>.py`).

Once the window has closed and the program's state is freed, a sample of
the requests (one a session, from sessions drawn from the seed, with the
longest request finished in the window in it; `sample_requests`) is run
through the reference once each, over its prompt and its served tokens. At every
served position the reference gives the gap by which the served token's
logit lies below its best logit; the numbers compared, each where the
cell's file (`bench/cells/<cell>.json`) gives it a limit, are the widest
gap and the mean of the squared gaps over the served positions. The mean
square is for a cell where the widest gap of sound runs comes near the
control's: it counts every position, and its large gaps most.
Greedy decoding in the program's precision serves the reference's best
token, or one whose logit is within rounding of it; a token altered, a
cache left unwritten or a row left out serves tokens far below it.

The control is the reference itself in the next precision below the
configuration's: every bf16 weight rounded through float8 (e4m3, one
scale a tensor); where decode reads a pack's int8 rows, it reads the
same int8 rows the reference reads, so that one rounding alone sets it
apart. At the same positions it reads the gap, under the float32
reference, of the token the control puts first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def no_tf32() -> None:
    """float32 products in float32: no TF32 on the tensor cores."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def served_gaps(ref_logits: torch.Tensor, served: Sequence[int]) -> torch.Tensor:
    """Per served token: how far its logit lies below the best logit."""
    tok = torch.as_tensor(list(served), device=ref_logits.device).long()
    return ref_logits.max(dim=1).values - ref_logits.gather(1, tok[:, None])[:, 0]


def sample_requests(rec, t0: float, t_end: float, seed: int,
                    k: int) -> List[Tuple[int, np.ndarray, List[int]]]:
    """(uid, prompt, served tokens) of the requests to check: from k
    sessions drawn from the seed (all, where there are no more), the one
    that served the longest request finished in the window among them,
    each session's longest request finished in the window, or, where it
    finished none, the one it has in flight. A session holds one slot at
    a time, so the sample spreads over the batch's rows."""
    def length(u):
        return (len(rec.by_uid[u]), len(rec.prompt[u]), -u)
    best: dict = {}
    for u, (t, reason) in rec.finish.items():
        if t0 <= t <= t_end and reason in ("length", "stop") and \
                u in rec.by_uid:
            s = rec.session[u]
            if s not in best or length(u) > length(best[s]):
                best[s] = u
    for u, toks in rec.by_uid.items():
        s = rec.session[u]
        if s not in best and u not in rec.finish and len(toks) >= 2 and \
                toks[-1].t >= t0:
            best[s] = u
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0x5A11])
    sessions = sorted(best)
    rng.shuffle(sessions)
    finished = [s for s in sessions if best[s] in rec.finish]
    if finished:
        top = max(finished, key=lambda s: length(best[s]))
        sessions = [top] + [s for s in sessions if s != top]
    return [(best[s], rec.prompt[best[s]],
             [t.tok for t in rec.by_uid[best[s]]]) for s in sessions[:k]]


def to_fp8(w: torch.Tensor) -> torch.Tensor:
    """w rounded through float8 e4m3 with one scale for the tensor."""
    w = w.float()
    s = w.abs().max().clamp_min(1e-30) / 448.0
    return (w / s).to(torch.float8_e4m3fn).float() * s


def check(cfg: Dict, cell, arch, weights: Dict, sample, device,
          control: bool = False) -> Tuple[Dict, Dict]:
    """(checks, extra): `checks` maps each number the cell's file gives a
    limit to its value and limit; `extra` counts what was compared and,
    with `control`, holds the control's readings. The numbers: the widest
    gap over the served positions (`logit_gap`) and the mean of their
    squares (`mean_sq_logit_gap`)."""
    no_tf32()
    packed = cell.mode == "offload" and cfg["pack"]["quantize"] == "int8"
    dec = arch.pack_rows(weights) if packed else None
    gaps, gaps_c = [], []
    with torch.inference_mode():
        for uid, prompt, served in sample:
            T = len(prompt)
            seq = torch.as_tensor(np.concatenate(
                [np.asarray(prompt, np.int64),
                 np.asarray(served[:-1], np.int64)]), device=device)
            pos = range(T - 1, T - 1 + len(served))
            ffn = dec.__getitem__ if dec else None
            ref = arch.forward_logits(weights, cfg, seq, pos, decode_from=T,
                                      decode_ffn=ffn)
            gaps.append(served_gaps(ref, served).float().cpu())
            if control:
                low = arch.forward_logits(weights, cfg, seq, pos,
                                          decode_from=T, decode_ffn=ffn,
                                          weight_map=to_fp8)
                top = low.argmax(dim=1).tolist()
                gaps_c.append(served_gaps(ref, top).float().cpu())
    values = numbers(gaps)
    checks = {k: {"value": values[k], "limit": float(lim)}
              for k, lim in cell.cell["limits"].items()}
    extra = {"tokens": sum(len(g) for g in gaps), "requests": len(sample)}
    if control:
        extra["control"] = numbers(gaps_c)
    return checks, extra


def numbers(gaps: List[torch.Tensor]) -> Dict[str, float]:
    """The compared numbers of the gaps at every served position (inf
    where nothing was served: a run with nothing to check fails)."""
    if not gaps or not sum(len(g) for g in gaps):
        return {"logit_gap": float("inf"), "mean_sq_logit_gap": float("inf")}
    g = torch.cat(gaps).double()
    return {"logit_gap": float(g.max()), "mean_sq_logit_gap": float((g * g).mean())}
