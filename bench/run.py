#!/usr/bin/env python3
"""The benchmark of `repro_torch`: run one cell once on this machine's cards.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name from `BENCHMARK.json` (see
`bench/nlbench/spec.py`), the model's architecture by the name its
configuration gives (`bench/arch/`). With `--trace 0` the result line
holds the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read in a run with the program's tracer on and a stretch of steps
under the profiler. Every run checks the tokens it served against the
plain reference of the architecture (`bench/reference/`), prints each
compared number beside its limit as the last lines of standard error, and
prints the result as one JSON object on the last line of standard output.
It exits non-zero, with no result, when the card or the program is
missing, or when JAX or the JAX package `repro` was loaded.

`--control 1` (not used by the benchmark's own runs) also reads the
lower-precision control at the same positions; it is how the limits were
set (`PERF.md`).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from nlbench import harness  # noqa: E402  (stdlib and numpy only)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_modules():
    """Import everything a run imports (no card needed), every
    architecture module with it."""
    from nlbench import correctness, profiling, spec  # noqa: F401
    import repro_torch.serving.server  # noqa: F401
    import repro_torch.serving.engine  # noqa: F401
    import repro_torch.store.packer  # noqa: F401
    import repro_torch.core.engine  # noqa: F401
    import repro_torch.obs  # noqa: F401
    import torch.profiler  # noqa: F401
    for path in sorted((BENCH / "arch").glob("*.py")):
        spec.arch_module(path.stem, BENCH)


def fail(msg: str, code: int = 2) -> int:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "BENCHMARK.json").is_file():
        return fail(f"no BENCHMARK.json at {ROOT}")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail("the program (src/repro_torch) is not in this checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from nlbench.spec import load_cell
    try:
        cell = load_cell(args.workload, ROOT)
    except (KeyError, FileNotFoundError) as e:
        return fail(str(e))
    harness.configure_env(ROOT)
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA card")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} present")
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda:0", T_START, control=bool(args.control))
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"loaded {bad}: the benchmark runs without JAX", 3)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    if "control" in result:
        print(f"control {json.dumps(result['control'])}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
