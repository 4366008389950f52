"""What a cell is made of, found by name from `BENCHMARK.json`.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
Each piece is a file of its own, so that a later change adds a cell, a
mix, a configuration or a per-layer metric by adding files and entries:

- the configuration: the `file` that its `configs` entry gives;
- the model's architecture: `bench/arch/<arch>.py`, named by the
  configuration's `arch` key: its weights, its reference, the program's
  config and parameters, and the shape counts the readers take;
- the traffic mix: `bench/traffic/<traffic>.json`;
- the cell's serving mode and correctness limits: `bench/cells/<cell>.json`;
- a per-layer metric: `bench/layer_metrics/<metric>.py`, whose
  `read(view)` returns the metric or None when it finds nothing to read.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]]
    bound: Optional[float] = None      # end-to-end metrics only
    layer: Optional[str] = None        # per-layer metrics only
    moves: Optional[str] = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    cell: Dict                 # mode, limits
    end_to_end: List[Metric]
    per_layer: List[Metric]
    bench: Path = BENCH        # the folder the pieces were found in

    @property
    def mode(self) -> str:
        return self.cell["mode"]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _metrics(entries: List[Dict], kind: str) -> List[Metric]:
    out = []
    for e in entries:
        out.append(Metric(name=e["name"], unit=e["unit"], better=e["better"],
                          source=e["source"], workloads=e.get("workloads"),
                          bound=e.get("bound") if kind == "e2e" else None,
                          layer=e.get("layer"), moves=e.get("moves")))
    return out


def load_cell(name: str, root: Path) -> Cell:
    """The cell `name` of `root/BENCHMARK.json`, with its pieces loaded."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / configs[w["config"]]["file"])
    bench_dir = root / "bench"
    if "arch" not in cfg or not (bench_dir / "arch" / f"{cfg['arch']}.py").is_file():
        raise FileNotFoundError(f"configuration {cfg['name']!r} names no "
                                f"architecture in bench/arch/ ('arch' key)")
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    cell = load_json(bench_dir / "cells" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=cfg, traffic=traffic,
                cell=cell, bench=bench_dir,
                end_to_end=[m for m in _metrics(bench["end_to_end"], "e2e")
                            if m.applies_to(name)],
                per_layer=[m for m in _metrics(bench["per_layer"], "layer")
                           if m.applies_to(name)])


def _load(path: Path, prefix: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def layer_reader(metric: str, bench: Path = BENCH) -> Callable:
    """`read(view)` of `bench/layer_metrics/<metric>.py`."""
    return _load(bench / "layer_metrics" / f"{metric}.py", "layer_metric_",
                 metric).read


def arch_module(arch: str, bench: Path = BENCH) -> ModuleType:
    """The module `bench/arch/<arch>.py` (see `bench/arch/opt.py` for what
    it gives)."""
    return _load(bench / "arch" / f"{arch}.py", "bench_arch_", arch)


def check_names(bench: Dict) -> List[str]:
    """Names and units that break the benchmark file's character rules."""
    bad = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            if not NAME_RE.match(e["name"]):
                bad.append(f"{group}: name {e['name']!r}")
            if "unit" in e and not UNIT_RE.match(e["unit"]):
                bad.append(f"{group}: unit {e['unit']!r}")
            for key in ("config", "traffic"):
                if key in e and not NAME_RE.match(e[key]):
                    bad.append(f"{group}: {key} {e[key]!r}")
            for r in e.get("reduced", []):
                if not NAME_RE.match(r):
                    bad.append(f"{group}: reduced {r!r}")
    return bad
