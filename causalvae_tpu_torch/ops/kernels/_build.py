"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a plain C
interface under ``<checkout>/build/kernels/`` at first use, and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes). The
library name carries a hash of the source and the flags, so an edited source
is rebuilt and a stale library is never loaded. Several sources build in
parallel: one ``nvcc`` process each, all started together. A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> list:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    """The CUDA compiler of the toolkit PyTorch finds (``$CUDA_HOME``, else
    ``nvcc`` on PATH, else the default install location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(nvcc)


def library_path(name: str) -> Path:
    """The library's path; its name hashes the source, every shared header
    (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def log_path(name: str) -> Path:
    """Compiler output (``-Xptxas=-v``: registers, shared memory, spills)."""
    return library_path(name).with_suffix(".log")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (default: all) that are not built yet, in
    parallel. Returns {name: seconds} for the ones compiled now."""
    names = list(sources() if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    times, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[n] = time.perf_counter() - t0
        log_path(n).write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib
