"""CPU fast Walsh-Hadamard transform: native C++ (built from
native/fwht.cpp at first use) plus a pure-NumPy reference.

Natural (Sylvester) ordering: H_N = H_2 ⊗ H_2 ⊗ ... ⊗ H_2, unnormalized
(H_N H_N = N I).  Must match the JAX mode-contraction transform in
sparc_ldpc_tpu/ops/fwht.py bit-for-bit in exact arithmetic (tested in
tests/test_oracle.py).  SURVEY.md §2 #8.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                       "native"))
_LIB = None


def _build_native(so_path: str) -> None:
    """Compile native/fwht.cpp with native/Makefile into a per-process
    temporary file, then rename it into place (atomic, so concurrent first
    uses — pytest-xdist workers — never load a half-written library)."""
    tmp = os.path.join(_NATIVE, f".libsparcfwht.so.{os.getpid()}.tmp")
    try:
        out = subprocess.run(["make", "-s", "-C", _NATIVE, f"OUT={tmp}"],
                             capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot build the native FWHT: {e}") from e
    if out.returncode != 0:
        raise RuntimeError("building the native FWHT failed (make -C "
                           f"native):\n{out.stdout}{out.stderr}")
    os.replace(tmp, so_path)


def _load_native():
    """The native library, built from source at first use (or when
    fwht.cpp is newer than the library).  Raises if it cannot be built:
    the oracle never falls back to NumPy silently."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = os.path.join(_NATIVE, "libsparcfwht.so")
    src = os.path.join(_NATIVE, "fwht.cpp")
    if (not os.path.exists(path)
            or os.path.getmtime(path) < os.path.getmtime(src)):
        _build_native(path)
    lib = ctypes.CDLL(path)
    lib.fwht_f64.argtypes = [ctypes.POINTER(ctypes.c_double),
                             ctypes.c_int64, ctypes.c_int64]
    lib.fwht_f64.restype = None
    lib.fwht_f32.argtypes = [ctypes.POINTER(ctypes.c_float),
                             ctypes.c_int64, ctypes.c_int64]
    lib.fwht_f32.restype = None
    _LIB = lib
    return _LIB


def fwht_np(x: np.ndarray) -> np.ndarray:
    """Pure-NumPy vectorized butterfly FWHT over the last axis (any batch)."""
    x = np.asarray(x)
    N = x.shape[-1]
    assert N & (N - 1) == 0, "length must be a power of two"
    y = x.copy()
    lead = x.shape[:-1]
    h = 1
    while h < N:
        y = y.reshape(lead + (N // (2 * h), 2, h))
        a = y[..., 0, :]
        b = y[..., 1, :]
        y = np.stack((a + b, a - b), axis=-2)
        h *= 2
    return y.reshape(lead + (N,))


def fwht(x: np.ndarray, force_numpy: bool = False) -> np.ndarray:
    """FWHT over the last axis; native C++ unless force_numpy (not
    in-place)."""
    x = np.ascontiguousarray(x)
    if x.dtype not in (np.float64, np.float32):
        x = x.astype(np.float64)
    if force_numpy:
        return fwht_np(x)
    lib = _load_native()
    out = x.copy()
    batch = int(np.prod(out.shape[:-1])) if out.ndim > 1 else 1
    n = out.shape[-1]
    if out.dtype == np.float64:
        lib.fwht_f64(out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                     batch, n)
    else:
        lib.fwht_f32(out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                     batch, n)
    return out


def has_native() -> bool:
    """True once the native library is built and loaded (raises if it
    cannot be built)."""
    return _load_native() is not None
