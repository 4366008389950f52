"""The harness takes new cells as data: a cell, a traffic mix and a
per-layer metric added as new files and entries, in a copy of the
benchmark, are found and run with no edit to any file that was there."""
from __future__ import annotations

import json
import shutil

import pytest

import bench_tiny
from nlbench.spec import NAME_RE, UNIT_RE, check_names, load_cell, load_json

NEW_CELL = "opt-1.3b.offload.chat8"
METRIC = "server.tokens_per_step"
READER = '''"""server.tokens_per_step: tokens the server emitted a step in the window."""


def read(view):
    steps = view.stats1["decode_steps"] - view.stats0["decode_steps"]
    if steps <= 0:
        return None
    return (view.stats1["tokens_emitted"] - view.stats0["tokens_emitted"]) / steps
'''


def test_benchmark_names_and_units_use_the_accepted_characters():
    bench = load_json(bench_tiny.ROOT / "BENCHMARK.json")
    assert check_names(bench) == []
    assert not NAME_RE.match("bad name") and not UNIT_RE.match("tokens per s")
    assert UNIT_RE.match("tokens/s") and UNIT_RE.match("%")


def test_a_new_cell_mix_and_metric_are_data(tmp_path):
    root = tmp_path
    shutil.copy(bench_tiny.ROOT / "BENCHMARK.json", root)
    shutil.copytree(bench_tiny.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    # a new mix, a new per-layer metric, a new cell: files and entries only
    mix = load_json(root / "bench" / "traffic" / "chat4.json")
    mix.update(name="chat8", sessions=8, max_slots=8)
    (root / "bench" / "traffic" / "chat8.json").write_text(json.dumps(mix))
    (root / "bench" / "layer_metrics" / f"{METRIC}.py").write_text(READER)
    (root / "bench" / "cells" / f"{NEW_CELL}.json").write_text(json.dumps(
        {"mode": "offload", "limits": {"logit_gap": 0.05}}))
    bench = load_json(root / "BENCHMARK.json")
    bench["workloads"].append({"name": NEW_CELL, "config": "opt-1.3b",
                               "traffic": "chat8", "chips": 1,
                               "why": "the wider, sparser model offload"})
    bench["per_layer"].append({"name": METRIC, "unit": "tokens", "better":
                               "higher", "source": "program_counter",
                               "layer": "server", "moves": "flash_ms_per_tok",
                               "workloads": [NEW_CELL]})
    for m in bench["end_to_end"]:
        if m["name"] == "flash_ms_per_tok":
            m["workloads"].append(NEW_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert check_names(bench) == []
    after = {p: p.read_bytes() for p in before}
    assert after == before                      # nothing that was there changed

    cell = load_cell(NEW_CELL, root)
    assert cell.mode == "offload" and cell.config["name"] == "opt-1.3b"
    assert cell.traffic["sessions"] == 8
    assert METRIC in [m.name for m in cell.per_layer]
    assert "flash_ms_per_tok" in [m.name for m in cell.end_to_end]

    # run it at a CPU test's size: the new metric is read from its own file
    import time
    from nlbench.harness import run_cell
    cell.config = bench_tiny.tiny_config("opt-1.3b")
    cell.traffic = dict(bench_tiny.tiny_traffic(), name="chat8")
    res = run_cell(cell, 2**31 + 77, 0.3, True, "cpu", time.perf_counter(),
                   log=lambda obj: None, cache=tmp_path / "cache")
    assert res["correct"]
    assert res["metrics"][METRIC]["value"] > 0


def test_a_cell_runs_only_the_readers_it_declares(tmp_path):
    """A reader that another cell declares is not run in this one (here
    it would fail the run), so a reader a later change adds for its own
    cell leaves the cells that are there as they were."""
    root = tmp_path / "root"
    root.mkdir()
    shutil.copy(bench_tiny.ROOT / "BENCHMARK.json", root)
    shutil.copytree(bench_tiny.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (root / "bench" / "layer_metrics" / "not_mine.py").write_text(
        "def read(view):\n    raise AssertionError('not this cell')\n")
    bench = load_json(root / "BENCHMARK.json")
    bench["per_layer"].append({"name": "not_mine", "unit": "frac", "better":
                               "higher", "source": "program_counter",
                               "layer": "server", "moves": "out_tok_s",
                               "workloads": ["opt-1.3b.resident.longctx128"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("opt-350m.offload.chat4", root)
    assert "not_mine" not in [m.name for m in cell.per_layer]

    import time
    from nlbench.harness import run_cell
    cell.config = bench_tiny.tiny_config("opt-350m")
    cell.traffic = bench_tiny.tiny_traffic()
    res = run_cell(cell, 2**31 + 78, 0.3, True, "cpu", time.perf_counter(),
                   log=lambda obj: None, cache=tmp_path / "cache")
    assert res["correct"]
    assert set(res["metrics"]) <= {m.name for m in cell.per_layer}


def test_equilibrium_stagger_sends_at_the_steady_rate_for_every_seed():
    """First requests cut to the steady state's residual lengths: every
    seed gets the same multiset, whose mean is E[L^2] / (2 E[L]) of the
    mix's output lengths (49.8 tokens for longctx128's 64 to 128), and
    the mix whose file does not ask for it keeps its even stagger."""
    import numpy as np
    from nlbench import traffic
    mix = load_json(bench_tiny.BENCH / "traffic" / "longctx128.json")
    firsts = [sorted(s[0].max_new_tokens for s in
                     traffic.plan(mix, seed, 1000, per_session=2))
              for seed in (5, 2**33 + 1)]
    assert firsts[0] == firsts[1] and len(firsts[0]) == mix["sessions"]
    outs = traffic._quantiles(mix["output_tokens"], 4096).astype(float)
    assert np.mean(firsts[0]) == pytest.approx(
        np.mean(outs ** 2) / (2 * np.mean(outs)), rel=0.02)
    assert 1 <= min(firsts[0]) and max(firsts[0]) <= max(outs)
    chat = load_json(bench_tiny.BENCH / "traffic" / "chat4.json")
    got = sorted(s[0].max_new_tokens for s in traffic.plan(chat, 7, 100, 2))
    assert got == [1, 16, 32, 48]
