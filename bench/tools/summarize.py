#!/usr/bin/env python3
"""Summarize the result lines of runs kept by `runs.sh`:

    python3 bench/tools/summarize.py chiprun_out/<tag> [<tag dir> ...]

Per cell and trace mode: every run's seed, correctness, compared numbers
and metrics; then per metric the median and the spread, the distance
between the first and third quartiles (`statistics.quantiles(n=4)`) as a
share of the median.
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path


def runs(dirs):
    for d in dirs:
        for p in sorted(Path(d).glob("*.out")):
            cell, seed, tr = p.name[:-4].rsplit(".", 2)
            lines = p.read_text().strip().splitlines()
            if not lines:
                yield cell, int(seed), tr, None, p
                continue
            try:
                yield cell, int(seed), tr, json.loads(lines[-1]), p
            except json.JSONDecodeError:
                yield cell, int(seed), tr, None, p


def spread(values):
    q = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q[2] - q[0]) / med if med else float("nan")


def main(argv):
    groups = {}
    for cell, seed, tr, res, p in runs(argv):
        groups.setdefault((cell, tr), []).append((seed, res, p))
    for (cell, tr), items in sorted(groups.items()):
        print(f"== {cell} {tr} ({len(items)} runs)")
        per_metric = {}
        for seed, res, p in items:
            if res is None:
                print(f"  seed {seed}: no result ({p})")
                continue
            checks = {k: round(v["value"], 5) for k, v in res["checks"].items()}
            ms = {k: v["value"] for k, v in res["metrics"].items()}
            for k, v in ms.items():
                per_metric.setdefault(k, []).append(v)
            extra = f" control {res['control']}" if "control" in res else ""
            print(f"  seed {seed}: correct {res['correct']} {checks}{extra} "
                  + " ".join(f"{k}={v:.6g}" for k, v in ms.items())
                  + f" peak={res['device']['memory_peak_bytes']}")
        for k, vs in per_metric.items():
            if len(vs) >= 2:
                print(f"  {k}: median {statistics.median(vs):.6g} "
                      f"min {min(vs):.6g} max {max(vs):.6g} "
                      f"spread {spread(vs):.4f} (n={len(vs)})")


if __name__ == "__main__":
    main(sys.argv[1:])
