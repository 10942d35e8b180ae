"""ctypes bindings to the native C++ runtime (native/icp_native.cpp).

Provides the faithful CPU octree-ICP baseline (the honest comparator for
the >10x points/s/chip target, BASELINE.md) and a fast LAS record decoder.
The shared library is built on demand with the repo's ``native/Makefile``;
all entry points degrade gracefully when no toolchain is available.

The port's own copy of the JAX package's ``runtime/native.py``. It builds
the same source with the same Makefile and flags (host code, not the
card) and falls back the same way, so the LAS decoder and the baselines
agree across the two packages. Its library has a name of its own,
``native/libicpnative_torch.so``: a build of the JAX package's
``libicpnative.so`` (``make`` writes that file in place) never touches
it. Processes that start together build it once: the build holds an
exclusive lock on ``native/.libicpnative_torch.lock``, looks for the
library again once it holds the lock, and builds under a temporary name
that ``os.replace`` moves into place, so no loader opens a half-written
file.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libicpnative_torch.so"
_LOCK_PATH = _NATIVE_DIR / ".libicpnative_torch.lock"
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_failure = ""  # why the library is unavailable: make's output or the loader's

_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _build() -> bool:
    global _failure
    try:
        lock = open(_LOCK_PATH, "a")
    except OSError as e:
        _failure = f"cannot open the build lock {_LOCK_PATH}: {e}"
        return False
    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if _LIB_PATH.exists():  # another process built it meanwhile
            return True
        tmp = _NATIVE_DIR / f".libicpnative_torch.{os.getpid()}.tmp.so"
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR), f"TARGET={tmp.name}"],
                check=True,
                capture_output=True,
                text=True,
                timeout=300,
            )
            os.replace(tmp, _LIB_PATH)
        except subprocess.CalledProcessError as e:
            _failure = f"make exited {e.returncode}:\n{e.stdout}{e.stderr}"
            return False
        except (subprocess.SubprocessError, OSError) as e:
            _failure = f"make could not run or its output is missing: {e}"
            return False
        finally:
            tmp.unlink(missing_ok=True)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed, _failure
    if _lib is not None or _load_failed:
        return _lib
    if not _LIB_PATH.exists() and not _build():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:
        _failure = f"loading {_LIB_PATH} failed: {e}"
        _load_failed = True
        return None

    lib.octree_nn.argtypes = [
        _f64p, ctypes.c_int64, _f64p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, _i32p,
    ]
    lib.octree_nn.restype = None

    lib.octree_icp.argtypes = [
        _f64p, ctypes.c_int64, _f64p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _f64p, _f64p, ctypes.c_void_p,
    ]
    lib.octree_icp.restype = ctypes.c_int32

    lib.las_decode.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int32, _f64p, _f64p, _f64p,
    ]
    lib.las_decode.restype = None

    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def native_failure() -> str:
    """Why ``native_available()`` is false: the build's output (``make -C
    native``) or the loader's error; empty while the library loads."""
    _load()
    return _failure


def las_decode_native(
    records: np.ndarray, n: int, record_length: int, scale, offset
) -> np.ndarray:
    """Decode raw LAS point records (uint8 buffer) → (n,3) float64 via the
    C++ decoder (io/las.py's optional fast path for very large files)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    records = np.ascontiguousarray(records, np.uint8)
    out = np.empty((n, 3), np.float64)
    lib.las_decode(
        records, n, record_length,
        np.ascontiguousarray(scale, np.float64),
        np.ascontiguousarray(offset, np.float64), out,
    )
    return out


def octree_nn_baseline(
    target: np.ndarray,
    query: np.ndarray,
    max_points: int = 10,
    max_depth: int = 20,
) -> np.ndarray:
    """Octree 1-NN indices with the reference's structure parameters
    (icpengine.h:17-18 defaults 10/20)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    target = np.ascontiguousarray(target, np.float64)
    query = np.ascontiguousarray(query, np.float64)
    out = np.empty(len(query), np.int32)
    lib.octree_nn(target, len(target), query, len(query), max_points,
                  max_depth, out)
    return out


def octree_icp_baseline(
    source: np.ndarray,
    target: np.ndarray,
    max_iterations: int = 50,
    tolerance: float = 1e-6,
    sigma_multiplier: float = 3.0,
    mode: str = "gui",
    octree_max_points: int = 10,
    octree_max_depth: int = 20,
    return_registered: bool = False,
) -> Tuple[np.ndarray, np.ndarray, int, bool, Optional[np.ndarray]]:
    """Run the faithful C++ octree-ICP baseline.

    Returns (T (4,4), rmse_history (iters,), iterations, success,
    registered source or None).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    source = np.ascontiguousarray(source, np.float64)
    target = np.ascontiguousarray(target, np.float64)
    T = np.eye(4)
    hist = np.zeros(max_iterations, np.float64)
    reg = np.empty_like(source) if return_registered else None
    reg_ptr = reg.ctypes.data_as(ctypes.c_void_p) if return_registered else None
    ret = lib.octree_icp(
        source, len(source), target, len(target), max_iterations,
        tolerance, sigma_multiplier, 1 if mode == "gui" else 0,
        octree_max_points, octree_max_depth, T, hist, reg_ptr,
    )
    success = ret >= 0
    iters = ret if success else -ret - 1
    return T, hist[:iters], iters, success, reg
