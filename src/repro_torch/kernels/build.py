"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. It is compiled with `nvcc`
for Hopper (`sm_90a`) into a shared library and loaded with `ctypes`; no
PyTorch headers are involved, so a build takes seconds. Builds happen at
first use, never at import, into `build/` at the repository root (or
`$REPRO_TORCH_BUILD_DIR`); the library's file name carries a hash of its
source and flags, so an edited source is rebuilt and a stale library is
never loaded. `build_all()` compiles every source at once, one `nvcc` per
source, in parallel. `Counts` is the launch bookkeeping every kernel's
wrapper keeps.

    python -m repro_torch.kernels.build --report swa_decode [--source F.cu]

builds one source (by default `csrc/<name>.cu`) and prints, per kernel,
`ptxas`'s registers, spills and shared memory and a count of the SASS
instructions that show how it moves data (global and shared loads by
width, `cp.async`, shuffles, exponentials, barriers), from `cuobjdump`.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()


@dataclasses.dataclass
class Counts:
    """One kernel's plain-integer call counters: `launches` goes up by one
    where its wrapper launches the CUDA kernel (and nowhere else),
    `plain_calls` where the dispatcher routes a CPU tensor to its plain
    version. A run resets them, drives the path, and reads them to show
    which route it took."""
    launches: int = 0
    plain_calls: int = 0

    def reset(self) -> None:
        self.launches = self.plain_calls = 0


_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    # src/repro_torch/kernels/build.py -> the repository root is parents[3]
    root = Path(env) if env else Path(__file__).resolve().parents[3] / "build"
    root.mkdir(parents=True, exist_ok=True)
    return root


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(str(Path(os.environ[var]) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels are built on the machine with the GPU")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def _compile_command(name: str, out: Path) -> List[str]:
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all() -> Dict[str, Path]:
    """Compile every `csrc/*.cu` that has no up-to-date library, all `nvcc`
    processes started together. Compiler output (with `-Xptxas -v`'s
    register and shared-memory report) goes to `build/<lib>.log`. Raises
    RuntimeError naming every source that failed to build."""
    todo, procs = {}, {}
    for name in sources():
        lib = _library_path(name)
        todo[name] = lib
        if not lib.exists():
            tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
            log = open(lib.with_suffix(".log"), "w")
            procs[name] = (subprocess.Popen(
                _compile_command(name, tmp), stdout=log,
                stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, todo[name])
        else:
            failed.append(f"{name} (nvcc exit {rc}, see "
                          f"{todo[name].with_suffix('.log')})")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "; ".join(failed))
    return todo


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            if name not in sources():
                raise ValueError(f"no CUDA source csrc/{name}.cu")
            path = _library_path(name)
            if not path.exists():
                build_all()
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib


# SASS opcodes (with their width suffix) that say how a kernel moves data
SASS_OPS = re.compile(r"\b(LDG\.E(?:\.[A-Z0-9_]+)*|LDS(?:\.[A-Z0-9_]+)*|"
                      r"STS(?:\.[A-Z0-9_]+)*|LDGSTS(?:\.[A-Z0-9_]+)*|"
                      r"SHFL\.[A-Z]+|MUFU\.[A-Z0-9]+|BAR\.[A-Z]+|"
                      r"LDL(?:\.[A-Z0-9_]+)*|STL(?:\.[A-Z0-9_]+)*|HMMA\S*|"
                      r"FFMA)\b")


def report(name: str, source: Optional[Path] = None) -> str:
    """Build `source` (default `csrc/<name>.cu`) with NVCC_FLAGS and return
    ptxas's per-kernel report and the SASS opcode counts per kernel."""
    src = Path(source) if source else CSRC / f"{name}.cu"
    out = build_dir() / f"report-{name}-{os.getpid()}.so"
    done = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{done.stdout}{done.stderr}")
    lines = [f"== {src}", "-- ptxas"]
    lines += [ln for ln in (done.stdout + done.stderr).splitlines()
              if "Compiling entry" in ln or "registers" in ln
              or "spill" in ln]
    sass = subprocess.run([str(Path(find_nvcc()).parent / "cuobjdump"),
                           "--dump-sass", str(out)], capture_output=True,
                          text=True, check=True).stdout
    kernel, ops = None, collections.Counter()

    def flush():
        if kernel is not None:
            lines.append(f"-- sass {kernel}: " + ", ".join(
                f"{op} {n}" for op, n in sorted(ops.items())))

    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            flush()
            kernel, ops = m.group(1), collections.Counter()
        elif kernel is not None:
            ops.update(SASS_OPS.findall(ln))
    flush()
    out.unlink()
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="build the port's CUDA kernels")
    ap.add_argument("--report", metavar="NAME",
                    help="print ptxas's and the SASS's summary of one kernel")
    ap.add_argument("--source", help="with --report: another .cu to build")
    args = ap.parse_args(argv)
    if args.report:
        print(report(args.report, args.source))
    else:
        for path in build_all().values():
            print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
