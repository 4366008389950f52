"""Nothing a run loads is JAX or the JAX package `repro`.

The check runs in a fresh process: this test process may already hold
`jax` (the repository's other tests import it), and the port's name,
`repro_torch`, begins with `repro`, so names are compared whole, by their
top-level part."""
from __future__ import annotations

import json
import subprocess
import sys

import bench_tiny

CODE = """
import json, sys
sys.path.insert(0, {bench!r}); sys.path.insert(0, {src!r})
import run
run.load_modules()
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def test_a_run_loads_neither_jax_nor_repro():
    code = CODE.format(bench=str(bench_tiny.BENCH),
                       src=str(bench_tiny.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=bench_tiny.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}, top


def test_forbidden_names_are_compared_whole():
    from nlbench.harness import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.serving",
                              "jaxtyping", "torch"]) == []
    assert forbidden_modules(["repro_torch", "repro.core.engine"]) == ["repro"]
    assert forbidden_modules(["jax.numpy", "flax"]) == ["flax", "jax"]


def test_run_without_the_program_exits_nonzero(tmp_path):
    """A directory with BENCHMARK.json and bench/ alone gives no result."""
    import shutil
    shutil.copy(bench_tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench_tiny.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "opt-350m.offload.chat4",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
