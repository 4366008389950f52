"""Tiny cells for the benchmark's CPU tests: the harness's pieces at
reduced widths, loaded the way `bench/run.py` loads them."""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from nlbench.spec import Cell, _metrics, load_json  # noqa: E402

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
            d_ff=256, vocab_size=4096)


def tiny_config(name: str = "opt-350m") -> dict:
    cfg = load_json(BENCH / "configs" / f"{name}.json")
    cfg.update(TINY)
    cfg["sparsity"] = dict(cfg["sparsity"], groups=8, calib_batch=2,
                           calib_seqlen=32)
    cfg["pack"] = dict(cfg["pack"], calib_tokens=256, calib_batch=4,
                       calib_seqlen=32)
    return cfg


def tiny_traffic(name: str = "chat4") -> dict:
    mix = load_json(BENCH / "traffic" / f"{name}.json")
    mix.update(sessions=4, max_slots=4,
               prompt_tokens={"dist": "uniform", "low": 8, "high": 16},
               output_tokens={"dist": "uniform", "low": 8, "high": 16},
               warmup={"min_steps": 4, "stagger_steps": 4},
               check={"sample_requests": 4})
    mix.pop("max_context", None)
    return mix


def tiny_cell(mode: str, limits=None) -> Cell:
    bench = load_json(ROOT / "BENCHMARK.json")
    name = {"offload": "opt-350m.offload.chat4",
            "resident": "opt-1.3b.resident.longctx128"}[mode]
    cfg = tiny_config("opt-350m" if mode == "offload" else "opt-1.3b")
    e2e = [m for m in _metrics(bench["end_to_end"], "e2e") if m.applies_to(name)]
    per = [m for m in _metrics(bench["per_layer"], "layer") if m.applies_to(name)]
    cell = {"mode": mode, "limits": dict(limits or {"logit_gap": 0.05})}
    return Cell(name=name, chips=1, config=cfg, traffic=tiny_traffic(),
                cell=cell, end_to_end=e2e, per_layer=per)


def run_tiny(mode: str, tmp_path, seed: int = 3, trace: bool = False,
             fault=None, control: bool = False, limits=None,
             seconds: float = 1.5, steps=None):
    import time
    from nlbench.harness import run_cell
    logs = []
    res = run_cell(tiny_cell(mode, limits), seed, seconds, trace, "cpu",
                   time.perf_counter(), log=logs.append, fault=fault,
                   control=control, cache=Path(tmp_path), steps=steps)
    return res, logs


def dumps(obj) -> str:
    return json.dumps(copy.deepcopy(obj), default=str)
