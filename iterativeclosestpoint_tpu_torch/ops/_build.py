"""Build and load the CUDA kernels (``csrc/*.cu``) with nvcc and ctypes.

Each source compiles on its own into a shared library with a plain C
interface under ``build/kernels/`` at the repository root, at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so <name>.cu

``<hash>`` covers the sources and flags, so an edited source never loads a
stale library. All nvcc processes start together and are waited for
together. ptxas's register, shared-memory and spill report is kept beside
each library as ``<name>-<hash>.log``. Nothing here runs at import time.

Mesh ranks are threads of one process (``parallel/mesh.py``), so two ranks
may reach a kernel first at the same moment: building and loading hold
one lock, and each build writes a temporary file named after its process
and thread before the atomic rename.
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

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("colsweep_fused", "colsweep", "brute_nn", "sweep_window")
# Each source's C entry points: a sweep's first-tie form (``_ft``) is a
# second instantiation of its kernel, in the same library.
ENTRY_POINTS = {
    "colsweep_fused": ("colsweep_fused", "colsweep_fused_ft"),
    "colsweep": ("colsweep", "colsweep_ft"),
    "brute_nn": ("brute_nn",),
    "sweep_window": ("slab_window", "zcol_window"),
}
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: every pointer and the stream as c_void_p (ctypes would cut
# a Python int to 32 bits otherwise).
_ARGTYPES = {
    "colsweep_fused": [_P, _P, _P, _P, _L, _I, _I, _I, _P, _P],
    "colsweep": [_P, _P, _P, _L, _I, _I, _I, _I, _P, _P, _P],
    "brute_nn": [_P, _I, _P, _I, _I, _I, _P, _P],
    "slab_window": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                    _P, _P],
}
_ARGTYPES["colsweep_fused_ft"] = _ARGTYPES["colsweep_fused"]
_ARGTYPES["colsweep_ft"] = _ARGTYPES["colsweep"]
_ARGTYPES["zcol_window"] = _ARGTYPES["slab_window"]

_LIBS: dict = {}
_LOCK = threading.RLock()  # guards building and _LIBS


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built"
    )


def _stem(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return f"{name}-{h.hexdigest()[:12]}"


def build_all() -> float:
    """Compile every source whose library is missing, all nvcc processes
    at once. Returns the seconds spent; raises with nvcc's output if any
    build fails."""
    with _LOCK:
        return _build_all()


def _build_all() -> float:
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = []
    for name in SOURCES:
        so = BUILD_DIR / f"{_stem(name)}.so"
        if so.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = so.with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """ptxas's report for the library ``name`` (after ``build_all``)."""
    return (BUILD_DIR / f"{_stem(name)}.log").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel source ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            so = BUILD_DIR / f"{_stem(name)}.so"
            if not so.exists():
                _build_all()
            lib = ctypes.CDLL(str(so))
            for entry in ENTRY_POINTS[name]:
                fn = getattr(lib, entry)
                fn.argtypes = _ARGTYPES[entry]
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
    return lib


def entry_point(entry: str):
    """The C function ``entry`` (a key of ``_ARGTYPES``), from the library
    of the source that defines it, built on first use."""
    src = next(n for n, entries in ENTRY_POINTS.items() if entry in entries)
    return getattr(library(src), entry)
