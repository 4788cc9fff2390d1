"""Build the package's CUDA sources at first use and load them with ctypes.

Each library is one shared object with a plain C interface, compiled by
``nvcc`` for Hopper (``sm_90a``) from sources inside this package and
written to ``acc_genomics_tpu_torch/_build/``.  The file name carries a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  A failed build or load raises with
the compiler's output: there is no fallback.

The port's native host library (``native/csrc/accnative.cpp``) is built
here too, with a C++ compiler, into the same directory and under an
inter-process lock (``build_native``, ``ensure_native``).

Pointers and the stream cross the C boundary as ``ctypes.c_void_p``;
callers set ``argtypes`` on the functions they use.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # keep denormals and IEEE division: the host engines and the
    # reference do, and the underflow contract depends on it
    "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v",
)
# the native host library's flags (OpenMP for its batch loops)
NATIVE_CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
                   "-fopenmp")


@dataclasses.dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: str
    built: bool  # False when an earlier build with the same hash was loaded
    seconds: float  # compile time (0 when loaded from an earlier build)
    log: str  # nvcc's output (registers, shared memory per kernel), kept in <library>.log


_libs: Dict[str, BuiltLibrary] = {}
_name_locks: Dict[str, threading.Lock] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """nvcc from PATH, then $CUDA_HOME, then the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of acc_genomics_tpu_torch need the CUDA toolkit"
    )


def _source_hash(paths: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class NativeBuild:
    path: str
    built: bool  # False when another process (or an earlier call) built it


@contextlib.contextmanager
def _file_lock(path: str):
    """Exclusive inter-process lock on ``path`` (created if missing)."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_native(build_dir: str = BUILD_DIR) -> NativeBuild:
    """Compile the native host library (``native/csrc/accnative.cpp``) into
    ``<build_dir>/libaccnative-<hash>.so`` (hash of the source and the
    flags), once across processes.

    The build runs under an ``flock`` on ``<build_dir>/native.lock`` and
    writes a temporary file that ``os.replace`` moves into place, so no
    process ever sees a half-written library.  ``$CXX`` is tried first,
    then the host's ``g++`` and ``c++`` (a ``$CXX`` without OpenMP cannot
    build it).  Raises with every compiler's output when none can."""
    src = os.path.join(PACKAGE_DIR, "native", "csrc", "accnative.cpp")
    h = hashlib.sha256(" ".join(NATIVE_CXXFLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, f"libaccnative-{h.hexdigest()[:16]}.so")
    with _file_lock(os.path.join(build_dir, "native.lock")):
        if os.path.exists(out):
            return NativeBuild(out, False)
        tmp = f"{out}.{os.getpid()}.tmp"
        logs, tried = [], []
        for cxx in (os.environ.get("CXX"), shutil.which("g++"),
                    shutil.which("c++")):
            if not cxx or cxx in tried:
                continue
            tried.append(cxx)
            cmd = [cxx, *NATIVE_CXXFLAGS, "-shared", "-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            if proc.returncode == 0:
                os.replace(tmp, out)
                return NativeBuild(out, True)
        if os.path.exists(tmp):
            os.remove(tmp)
    raise RuntimeError(
        "no C++ compiler could build the native host library "
        f"(tried {tried or 'none: no $CXX, g++ or c++'}):\n" + "\n".join(logs)
    )


def ensure_native(build_dir: str = BUILD_DIR) -> bool:
    """Build (``build_native``) and load the native host library (packers,
    host engines, fp64 recompute) into ``acc_genomics_tpu_torch.native``.
    Returns ``native.available()``; raises when it cannot be built."""
    from acc_genomics_tpu_torch import native

    with _lock:
        if native._lib is None:
            native.load(build_native(build_dir).path)
    return native.available()


def load_library(name: str, sources: Sequence[str],
                 headers: Sequence[str] = ()) -> BuiltLibrary:
    """Build (if needed) and load ``lib<name>-<hash>.so`` from ``sources``
    (paths relative to the package directory; ``headers`` are the files
    they include, hashed with them).  Libraries of different names build
    in parallel when called from several threads."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        paths = [os.path.join(PACKAGE_DIR, s) for s in sources]
        digest = _source_hash(paths + [os.path.join(PACKAGE_DIR, h) for h in headers])
        out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
        built, seconds, log = False, 0.0, ""
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {name}:\n"
                    f"{' '.join(cmd)}\n{log}"
                )
            with open(f"{out}.log", "w") as f:
                f.write(log)
            os.replace(tmp, out)
            built = True
        elif os.path.exists(f"{out}.log"):
            with open(f"{out}.log") as f:
                log = f.read()
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            raise RuntimeError(f"cannot load {out}: {e}") from e
        _libs[name] = BuiltLibrary(lib, out, built, seconds, log)
        return _libs[name]
