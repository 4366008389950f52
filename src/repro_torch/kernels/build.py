"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. It is compiled with `nvcc`
for Hopper (`sm_90a`) into a shared library and loaded with `ctypes`; no
PyTorch headers are involved, so a build takes seconds. Builds happen at
first use, never at import, into `build/` at the repository root (or
`$REPRO_TORCH_BUILD_DIR`); the library's file name carries a hash of its
source and flags, so an edited source is rebuilt and a stale library is
never loaded. `build_all()` compiles every source at once, one `nvcc` per
source, in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
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
