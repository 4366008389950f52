"""The check that decides `correct`, against runs it has to fail.

The control, the reference in the next precision below the
configuration's (float8 weights; the pack's int8 rows as the program
serves them), has to come out as not
correct. So does a run of the harness with the timed path broken
underneath it: a token altered where it is produced; a decode step that
leaves the KV cache as it was; half of the batch left out, the mean of
the other half taken in its place. (The exchange between chips has no
fault here: every cell runs on one card.) These run at a CPU test's size,
over a window of a fixed number of steps, so that a busy or a quiet host
runs the same work; `PERF.md` gives the readings of the control on the
card at the cells' own sizes."""
from __future__ import annotations

import traceback

import pytest

from bench_tiny import BENCH, load_json, run_tiny

# Limits at this size for the numbers each cell's file compares. Sound
# runs on the CPU read widest gaps of 0 to 0.0365 and mean squared gaps of
# 0 to 1.01e-6; the control 0.0436 to 0.579 and 4.8e-5 to 0.008 (10 to 24
# seeds a mode, 3 s windows); over 120 steps (5 seeds a mode) sound runs
# 0 to 0.0194 and, offload, 0 to 1.9e-7, the control 0.083 to 0.320 and
# 3.4e-4 to 1.0e-3, the faults 0.157 to 5.95. The cells' limits are set
# from the card's readings at their own sizes (`PERF.md`).
TINY_LIMITS = {"logit_gap": 0.06, "mean_sq_logit_gap": 1e-5}
CELLS = {"offload": "opt-350m.offload.chat4",
         "resident": "opt-1.3b.resident.longctx128"}
# a window of 120 steps: each session finishes several requests in it, and
# none runs out of the requests its mix plans (64 of 8 to 16 tokens)
STEPS = 120


def limits(mode):
    cell = load_json(BENCH / "cells" / f"{CELLS[mode]}.json")
    return {k: TINY_LIMITS[k] for k in cell["limits"]}


def run_checked(mode, tmp_path, **kw):
    """A tiny run over STEPS steps, and what to print beside an assertion:
    the run's exception, or its compared numbers, the control's and what
    was checked."""
    try:
        res, logs = run_tiny(mode, tmp_path, limits=limits(mode),
                             steps=STEPS, **kw)
    except Exception:                       # printed by the assertion
        return None, traceback.format_exc()
    run = [e["run"] for e in logs if "run" in e]
    said = {"checks": res["checks"], "control": res.get("control"),
            "attempted": res["attempted"], "failed": res["failed"],
            "run": {k: run[0][k] for k in ("steps", "served_tokens_checked",
                                           "requests_checked")} if run else None}
    return res, said


@pytest.mark.parametrize("mode", ["offload", "resident"])
def test_sound_runs_are_correct_and_the_control_is_not(mode, tmp_path):
    for seed in (2**31 + 3, 2**31 + 4):
        res, said = run_checked(mode, tmp_path, seed=seed, control=True)
        assert res is not None and res["correct"], said
        assert any(res["control"][k] > lim
                   for k, lim in limits(mode).items()), said


def token_altered(server, runtime):
    sample = server._sample_row
    n = {"calls": 0}

    def altered(handle, row):
        n["calls"] += 1
        tok = sample(handle, row)
        return (tok + 7) % row.shape[0] if n["calls"] % 4 == 0 else tok
    server._sample_row = altered


def kv_left_unchanged(monkeypatch):
    from repro_torch.models import transformer

    def fault(server, runtime):
        monkeypatch.setattr(transformer, "paged_kv_write_rows",
                            lambda cache, k, v, targets: cache)
    return fault


def half_batch_left_out(monkeypatch):
    from repro_torch.models import transformer

    def half(y):
        h = y.shape[0] // 2
        y = y.clone()
        y[h:] = y[:h].mean(dim=0, keepdim=True)
        return y

    def fault(server, runtime):
        if runtime is not None:
            apply = runtime.ffn_apply_batch

            def ffn_apply_batch(layer, h, masks=None):
                y, res = apply(layer, h, masks)
                return half(y), res
            runtime.ffn_apply_batch = ffn_apply_batch
        else:
            ffn = transformer.ffn_forward

            def ffn_forward(p, x, cfg, capture=False):
                y, pre = ffn(p, x, cfg, capture)
                return (half(y) if x.shape[1] == 1 else y), pre
            monkeypatch.setattr(transformer, "ffn_forward", ffn_forward)
    return fault


@pytest.mark.parametrize("mode", ["offload", "resident"])
@pytest.mark.parametrize("fault", ["token_altered", "kv_left_unchanged",
                                   "half_batch_left_out"])
def test_a_broken_timed_path_is_not_correct(mode, fault, tmp_path,
                                            monkeypatch):
    make = {"token_altered": lambda: token_altered,
            "kv_left_unchanged": lambda: kv_left_unchanged(monkeypatch),
            "half_batch_left_out": lambda: half_batch_left_out(monkeypatch)}
    res, said = run_checked(mode, tmp_path, seed=2**31 + 9,
                            fault=make[fault]())
    assert res is not None and not res["correct"], said
