"""Native (C++) runtime components, loaded via ctypes.

Two pieces live here (see ``src/``):

* ``datagen.cpp`` — the reference benchmark harness's LCG/Laplace data
  stream (reference: benches/benchmarks.rs:8-35), OpenMP-parallel with
  O(log k) LCG jumps; bit-identical to ``utils/datagen.py``'s
  vectorized-NumPy fallback but ~50x faster at 64M samples.
* ``oracle.cpp`` — an independent f64 CPU implementation of the full
  Picard algorithm (whiten + core loop + FastICA warm start) used as
  the conformance ground truth the device solver is validated against
  (BASELINE.md: Amari < 1e-3 vs the reference on all bench mixtures).

The library is compiled on first use with g++ (no pip/apt needed) and
cached next to the sources. Everything degrades gracefully: callers
check :func:`available` and fall back to the NumPy implementations.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_LIB_PATH = os.path.join(_DIR, "libpicard_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


_BASE_FLAGS = [
    "-O3", "-march=native", "-fno-math-errno", "-fopenmp", "-fPIC",
    "-std=c++17",
]
# rng.cpp must stay bit-identical to the pure-Python twin in
# utils/reference_rng.py: FMA contraction (on by default at -O3)
# would fork its ziggurat rejection decisions.
_PER_FILE_FLAGS = {"rng.cpp": ["-ffp-contract=off"]}
_SOURCES = ("datagen.cpp", "oracle.cpp", "rng.cpp")


def _build() -> bool:
    sources = [os.path.join(_SRC, f) for f in _SOURCES]
    newest_src = max(os.path.getmtime(s) for s in sources)
    if os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= newest_src:
        return True
    objects = []
    try:
        for src in sources:
            name = os.path.basename(src)
            obj = os.path.join(_DIR, name.replace(".cpp", ".o"))
            cmd = ["g++", *_BASE_FLAGS, *_PER_FILE_FLAGS.get(name, []),
                   "-c", src, "-o", obj]
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            objects.append(obj)
        link = ["g++", *_BASE_FLAGS, "-shared", "-o", _LIB_PATH, *objects,
                "-lmvec"]
        subprocess.run(link, check=True, capture_output=True, timeout=300)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        for obj in objects:
            try:
                os.remove(obj)
            except OSError:
                pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not _build():
            _build_failed = True
            return None
        lib = ctypes.CDLL(_LIB_PATH)

        lib.picard_lcg_laplace_fill.restype = ctypes.c_uint64
        lib.picard_lcg_laplace_fill.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_double), ctypes.c_size_t,
        ]
        lib.picard_lcg_uniform_centered_fill.restype = ctypes.c_uint64
        lib.picard_lcg_uniform_centered_fill.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_double), ctypes.c_size_t,
        ]

        d = ctypes.POINTER(ctypes.c_double)
        i = ctypes.POINTER(ctypes.c_int)
        lib.picard_oracle_core.restype = ctypes.c_int
        lib.picard_oracle_core.argtypes = [
            d, ctypes.c_int, ctypes.c_int, d,                    # x, n, t, cov
            ctypes.c_int, ctypes.c_double,                       # density, alpha
            ctypes.c_int, ctypes.c_int,                          # ortho, extended
            ctypes.c_int, ctypes.c_double, ctypes.c_int,         # max_iter, tol, m
            ctypes.c_int, ctypes.c_double,                       # ls_tries, lambda_min
            d, d, d, i, i, d,                                    # outputs
        ]
        lib.picard_oracle_center.restype = None
        lib.picard_oracle_center.argtypes = [d, ctypes.c_int, ctypes.c_int, d]
        lib.picard_oracle_whiten.restype = ctypes.c_int
        lib.picard_oracle_whiten.argtypes = [
            d, ctypes.c_int, ctypes.c_int, ctypes.c_int, d, d,
        ]
        lib.picard_oracle_ica_par.restype = ctypes.c_int
        lib.picard_oracle_ica_par.argtypes = [
            d, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, d,
        ]
        lib.picard_reference_normal_fill.restype = None
        lib.picard_reference_normal_fill.argtypes = [
            ctypes.c_uint64, d, ctypes.c_size_t,
        ]
        lib.picard_reference_u64_fill.restype = None
        lib.picard_reference_u64_fill.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True if the native library is (or can be) built and loaded."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def lcg_laplace(seed: int, count: int) -> tuple:
    """Native LCG Laplace stream; returns ``(samples, next_state)``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.empty(count, np.float64)
    state = lib.picard_lcg_laplace_fill(
        ctypes.c_uint64(seed), _ptr(out), ctypes.c_size_t(count)
    )
    return out, int(state)


def lcg_uniform_centered(seed: int, count: int) -> tuple:
    """Native uniform(-0.5, 0.5) stream; returns ``(samples, next_state)``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.empty(count, np.float64)
    state = lib.picard_lcg_uniform_centered_fill(
        ctypes.c_uint64(seed), _ptr(out), ctypes.c_size_t(count)
    )
    return out, int(state)


def reference_normal_matrix(seed: int, n_rows: int, n_cols: int):
    """Row-major StandardNormal fill from ``StdRng::seed_from_u64`` —
    the reference's random W-init stream (solver.rs:112-120), or
    ``None`` if the native library is unavailable (callers fall back
    to the pure-Python twin in :mod:`..utils.reference_rng`)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(n_rows * n_cols, np.float64)
    lib.picard_reference_normal_fill(
        ctypes.c_uint64(seed), _ptr(out), ctypes.c_size_t(out.size)
    )
    return out.reshape(n_rows, n_cols)


def reference_u64_stream(seed: int, count: int):
    """Raw ``StdRng`` u64 stream (ChaCha12 layer only), or ``None``."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(count, np.uint64)
    lib.picard_reference_u64_fill(
        ctypes.c_uint64(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_size_t(count),
    )
    return out


_DENSITY_CODE = {"tanh": 0, "exp": 1, "cube": 2}


def oracle_core(
    x: np.ndarray,
    covariance: Optional[np.ndarray],
    density: str = "tanh",
    alpha: float = 1.0,
    ortho: bool = True,
    extended: bool = True,
    max_iter: int = 500,
    tol: float = 1e-7,
    m: int = 7,
    ls_tries: int = 10,
    lambda_min: float = 0.01,
) -> dict:
    """Run the f64 oracle core loop on pre-rotated data ``x`` (n, t)."""
    if ls_tries < 1 or m < 1 or max_iter < 0:
        # The C side does not validate: ls_tries <= 0 would move
        # default-constructed 0x0 matrices into the optimizer state and
        # return uninitialized buffers with rc=0.
        raise ValueError(
            f"ls_tries ({ls_tries}) and m ({m}) must be >= 1, "
            f"max_iter ({max_iter}) >= 0"
        )
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    x = np.ascontiguousarray(x, np.float64)
    n, t = x.shape
    cov_ptr = None
    if covariance is not None:
        covariance = np.ascontiguousarray(covariance, np.float64)
        cov_ptr = _ptr(covariance)
    w = np.empty((n, n), np.float64)
    y = np.empty((n, t), np.float64)
    signs = np.empty(n, np.float64)
    n_iter = ctypes.c_int(0)
    converged = ctypes.c_int(0)
    gnorm = ctypes.c_double(0.0)
    rc = lib.picard_oracle_core(
        _ptr(x), n, t, cov_ptr,
        _DENSITY_CODE[density], alpha,
        int(ortho), int(extended),
        max_iter, tol, m, ls_tries, lambda_min,
        _ptr(w), _ptr(y), _ptr(signs),
        ctypes.byref(n_iter), ctypes.byref(converged), ctypes.byref(gnorm),
    )
    if rc != 0:
        raise RuntimeError(f"oracle core failed with code {rc}")
    return {
        "w": w, "y": y, "signs": signs,
        "n_iterations": n_iter.value,
        "converged": bool(converged.value),
        "gradient_norm": gnorm.value,
    }


def oracle_center(x: np.ndarray) -> tuple:
    """(centered, mean) via the native oracle."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    x = np.ascontiguousarray(x, np.float64).copy()
    n, t = x.shape
    mean = np.empty(n, np.float64)
    lib.picard_oracle_center(_ptr(x), n, t, _ptr(mean))
    return x, mean


def oracle_whiten(x: np.ndarray, n_components: int) -> tuple:
    """(whitened_data, K) via the native oracle; raises on singular."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    x = np.ascontiguousarray(x, np.float64)
    n, t = x.shape
    k = np.empty((n_components, n), np.float64)
    data = np.empty((n_components, t), np.float64)
    rc = lib.picard_oracle_whiten(_ptr(x), n, t, n_components, _ptr(k), _ptr(data))
    if rc != 0:
        raise RuntimeError("oracle whitening hit singular data")
    return data, k


def oracle_ica_par(
    x: np.ndarray, w_init: np.ndarray, n_iter: int,
    density: str = "tanh", alpha: float = 1.0,
) -> np.ndarray:
    """FastICA warm start via the native oracle."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    x = np.ascontiguousarray(x, np.float64)
    n, t = x.shape
    w = np.ascontiguousarray(w_init, np.float64).copy()
    rc = lib.picard_oracle_ica_par(
        _ptr(x), n, t, _DENSITY_CODE[density], alpha, n_iter, _ptr(w)
    )
    if rc != 0:
        raise RuntimeError("oracle FastICA hit a singular decorrelation")
    return w
