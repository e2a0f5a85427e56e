"""Build the CUDA kernels of ``dfq_tpu_torch/csrc`` and load them.

Each ``.cu`` source is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded with :mod:`ctypes` (no PyTorch headers, so a
build takes seconds). The build happens at first use, into
``build/cuda/`` at the repository root (listed in ``.gitignore``); a
library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is reused. All missing libraries
are compiled together, one ``nvcc`` process per source.

Every source is compiled with ``--fmad=false``: the kernels mirror the
JAX reference's rounding exactly and write each fused multiply-add they
need as ``__fmaf_rn``, so the compiler must not contract anything else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
SOURCES = (
    "matmul_int8_requant.cu", "dw3x3_int8_requant.cu", "fused_block_int8.cu",
    "conv_epilogue_int8.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every listed source whose library is missing, all at once;
    return ``{source: library path}``. Raises with nvcc's output when a
    build fails. ptxas's ``-v`` report (registers, shared memory,
    spills) is kept beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: _library_path(s) for s in sources}
    procs = []
    for s, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs.append((s, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for s, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{s}:\n{log}")
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    if errors:
        raise RuntimeError("nvcc failed\n" + "\n".join(errors))
    return paths


def sources_digest() -> str:
    """sha256 over ``NVCC_FLAGS`` and every source a library is built from
    (each ``.cuh`` and each of ``SOURCES``): what a prebuilt library must
    have been built from for the wrappers of this tree to call it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / s for s in SOURCES]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def load_prebuilt(paths: Dict[str, Path]) -> None:
    """Load ``{source: library}`` built elsewhere (an artifact's ``aot/``)
    as the libraries of those sources, so :func:`library` never builds
    them. The caller has checked that they were built from this tree's
    sources (:func:`sources_digest`)."""
    with _lock:
        for s, path in paths.items():
            _libs[s] = ctypes.CDLL(str(path))


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source (building all of them at first
    use)."""
    with _lock:
        if source not in _libs:
            for s, path in build().items():
                _libs[s] = ctypes.CDLL(str(path))
        return _libs[source]
