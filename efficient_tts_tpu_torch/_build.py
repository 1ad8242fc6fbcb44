"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `_build/<name>.<hash>.so`, where the hash
covers the source, the shared `csrc/*.cuh` headers and the flags, so an
edited source or header is rebuilt and an
unchanged one is reused. All sources compile in parallel (one nvcc each).
Nothing here runs at import time. A build and a load hold one lock, so
threads that reach a kernel's first use together build it once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_loaded: dict[str, ctypes.CDLL] = {}
# re-entrant: `load` builds while holding it
_lock = threading.RLock()


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{src.stem}.{h}.so"


def build(verbose: bool = False) -> dict:
    """Compile every stale `csrc/*.cu`; returns {name: {"path", "seconds",
    "log"}} where `log` holds nvcc's output (with `-Xptxas -v` when
    `verbose`, the registers and shared memory of each kernel)."""
    extra = ("-Xptxas", "-v") if verbose else ()
    with _lock:
        BUILD_DIR.mkdir(exist_ok=True)
        jobs = {}
        results = {}
        t0 = time.perf_counter()
        for src in sorted(SRC_DIR.glob("*.cu")):
            out = _target(src)
            if out.exists():
                results[src.stem] = {"path": out, "seconds": 0.0, "log": "cached"}
                continue
            tmp = out.with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}")
            cmd = [nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)]
            jobs[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
        for name, (proc, tmp, out) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
            os.replace(tmp, out)
            results[name] = {"path": out, "seconds": time.perf_counter() - t0, "log": log}
        return results


def load(name: str) -> ctypes.CDLL:
    """The shared library built from `csrc/<name>.cu`, built if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            out = _target(SRC_DIR / f"{name}.cu")
            if not out.exists():
                build()
            lib = _loaded[name] = ctypes.CDLL(str(out))
        return lib
