"""ctypes binding to the native int8 runtime (port of
``dfq_tpu/engine/native.py``).

The runtime is the JAX package's own C++ CPU code, ``native/src/dfqrt.cpp``
(the reference's ncnn backend analog: int8 x int8 -> int32, per-channel
weight scales, zero-point folding, OpenMP). :func:`build_native` compiles
it straight with ``g++`` and the flags of ``native/CMakeLists.txt``
(no cmake; OpenMP where the compiler has it, :func:`toolchain`), into
``build/native/`` at the repository root (listed in
``.gitignore``); the library's file name carries a hash of the sources,
the flags and the host's CPU model (``-march=native``), so an edited
source or another CPU is rebuilt and an unchanged one reused.
:class:`NativeModel` loads a ``.dfqparam``/``.dfqbin`` pair written by
:func:`dfq_tpu_torch.io.native_export.save_native_artifact` and runs it on
the host on NHWC float32 numpy input, through the C ABI of
``native/src/dfqrt.h``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
# native/CMakeLists.txt: C++17 and its Release flags; OpenMP where the
# compiler has it (its find_package(OpenMP) is optional too)
CXX_FLAGS = ("-std=c++17", "-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC")
OPENMP_FLAG = "-fopenmp"

_lock = threading.Lock()


def _takes_openmp(cxx: str) -> bool:
    """Whether ``cxx`` compiles and links an OpenMP library (what CMake's
    FindOpenMP tries)."""
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "omp.cpp"
        src.write_text("#include <omp.h>\nint dfq_threads() { return omp_get_max_threads(); }\n")
        return subprocess.run([cxx, OPENMP_FLAG, "-shared", "-fPIC", "-o", str(Path(d) / "omp.so"),
                               str(src)], capture_output=True).returncode == 0


@functools.lru_cache(maxsize=None)
def toolchain() -> Tuple[str, Tuple[str, ...]]:
    """``(compiler, flags)``: the first of ``$CXX``, ``g++`` on ``PATH``,
    ``/usr/bin/g++`` and ``c++`` that takes OpenMP, with ``CXX_FLAGS`` and
    ``-fopenmp`` (a ``$CXX`` without OpenMP, as some toolchains set for
    nvcc's host passes, is passed over). Where none takes OpenMP, the first
    of them without it, as ``native/CMakeLists.txt`` builds when it finds
    no OpenMP: the runtime then runs on one thread (:func:`openmp` says
    which)."""
    cands = [os.environ.get("CXX"), shutil.which("g++"), "/usr/bin/g++", shutil.which("c++")]
    cands = [c for i, c in enumerate(cands) if c and os.path.isfile(c) and c not in cands[:i]]
    if not cands:
        raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH")
    for cxx in cands:
        if _takes_openmp(cxx):
            return cxx, CXX_FLAGS + (OPENMP_FLAG,)
    return cands[0], CXX_FLAGS


def openmp() -> bool:
    """Whether the runtime is built with OpenMP (else it runs on one thread)."""
    return OPENMP_FLAG in toolchain()[1]


def _host_cpu() -> str:
    """The host's CPU model: ``-march=native`` builds for it alone."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path() -> Path:
    """``build/native/libdfqrt-<hash>.so``, the hash over ``dfqrt.cpp``,
    ``dfqrt.h``, the flags and the host's CPU model."""
    cxx, flags = toolchain()
    h = hashlib.sha256(" ".join((cxx,) + flags + (_host_cpu(),)).encode())
    for name in ("dfqrt.h", "dfqrt.cpp"):
        h.update((NATIVE_SRC / name).read_bytes())
    return BUILD_DIR / f"libdfqrt-{h.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> str:
    """Compile ``libdfqrt.so`` unless it is there (or ``force``); returns
    its path. The library is written to a name of this process's and then
    renamed, so concurrent builders never load half a file. A failed build
    raises with the compiler's output."""
    out = library_path()
    with _lock:
        if out.exists() and not force:
            return str(out)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cxx, flags = toolchain()
        cmd = [cxx, *flags, "-o", str(tmp), str(NATIVE_SRC / "dfqrt.cpp")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building libdfqrt failed: {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return str(out)


class NativeModel:
    """A native artifact loaded into the runtime; :meth:`forward` takes an
    NHWC float32 batch and returns the graph's outputs as float32 arrays."""

    def __init__(self, prefix: str, lib_path: Optional[str] = None):
        lib = ctypes.CDLL(lib_path or build_native())
        lib.dfqrt_load.restype = ctypes.c_void_p
        lib.dfqrt_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.dfqrt_free.argtypes = [ctypes.c_void_p]
        lib.dfqrt_forward.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.dfqrt_num_outputs.argtypes = [ctypes.c_void_p]
        lib.dfqrt_output_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.dfqrt_output_dims.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.dfqrt_output_data.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
        lib.dfqrt_last_error.restype = ctypes.c_char_p
        self._lib = lib
        self._handle = lib.dfqrt_load((prefix + ".dfqparam").encode(),
                                      (prefix + ".dfqbin").encode())
        if not self._handle:
            raise RuntimeError(f"dfqrt_load failed: {lib.dfqrt_last_error().decode()}")

    def forward(self, x: np.ndarray) -> List[np.ndarray]:
        x = np.ascontiguousarray(x, np.float32)
        dims = (ctypes.c_int * x.ndim)(*x.shape)
        rc = self._lib.dfqrt_forward(
            self._handle, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dims, x.ndim)
        if rc != 0:
            raise RuntimeError(f"dfqrt_forward failed: {self._lib.dfqrt_last_error().decode()}")
        outs = []
        for i in range(self._lib.dfqrt_num_outputs(self._handle)):
            nd = self._lib.dfqrt_output_ndim(self._handle, i)
            od = (ctypes.c_int * nd)()
            self._lib.dfqrt_output_dims(self._handle, i, od)
            buf = np.empty(tuple(od[j] for j in range(nd)), np.float32)
            self._lib.dfqrt_output_data(
                self._handle, i, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            outs.append(buf)
        return outs

    def close(self) -> None:
        """Free the runtime's model (also done when the object is collected)."""
        if getattr(self, "_handle", None):
            self._lib.dfqrt_free(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
