"""Fast Walsh-Hadamard transform as matrix products (SURVEY.md §2 #8, §7 M2).

Design
------
The classic FWHT is log2(N) radix-2 butterfly passes — pure bandwidth work,
~log2(N) full sweeps over device memory.  That design is right for CPUs (it
is what the reference lineage's C extension does; see native/fwht.cpp for
our oracle port), but an accelerator's matrix units do small dense matmuls
almost for free relative to memory bandwidth.

We instead use the Kronecker factorization of the Sylvester Hadamard matrix

    H_N = H_{f1} ⊗ H_{f2} ⊗ ... ⊗ H_{fk},     N = f1 f2 ... fk,

so the transform is k tensor-mode contractions with small dense +-1 matrices
(f_i <= 256).  For N = 2^21 with factors (128,128,128) this is 3 batched
matmuls (arithmetic intensity ~f/4 flops/byte) instead of 21
bandwidth-bound sweeps — a ~7x reduction in memory traffic.  XLA hands each
contraction to the GPU's GEMM library (cuBLAS) and fuses the moveaxis
transposes around it.

Ordering matches the oracle (natural/Sylvester): verified bit-for-bit in
tests/test_ops.py against oracle.fwht.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def factorize_pow2(N: int, max_log: int = 8) -> Tuple[int, ...]:
    """Split N = 2^k into the fewest factors each <= 2^max_log, balanced.

    Balanced factors maximize the minimum matmul dimension;
    e.g. 2^19 -> (128, 64, 64), 2^21 -> (128, 128, 128), 2^9 -> (32, 16).
    """
    assert N > 0 and (N & (N - 1)) == 0, "N must be a power of two"
    k = N.bit_length() - 1
    if k == 0:
        return (1,)
    nf = -(-k // max_log)
    base, rem = divmod(k, nf)
    logs = [base + 1] * rem + [base] * (nf - rem)
    return tuple(1 << e for e in logs)


@functools.lru_cache(maxsize=None)
def _hadamard_np(f: int) -> np.ndarray:
    H = np.array([[1.0]])
    while H.shape[0] < f:
        H = np.block([[H, H], [H, -H]])
    return H


def hadamard_factor(f: int, dtype=jnp.float32) -> jax.Array:
    """Dense +-1 Sylvester Hadamard matrix H_f as a device constant."""
    return jnp.asarray(_hadamard_np(f), dtype=dtype)


def fwht_mxu(x: jax.Array, max_log: int = 8,
             precision: str = "highest") -> jax.Array:
    """FWHT over the last axis via mode contractions (XLA matmul path).

    Works for any batch shape and any power-of-two length; jit/vmap/shard
    friendly (pure dot_generals, static shapes).

    precision (SparcConfig.transform_precision):
      "highest", "high", "default": the f32 operands go to the matmul with
                 that lax.Precision.  On an H100 "highest" is a cuBLAS
                 GEMM in f32 (rel. L2 error 3.6e-7 against the float64
                 FWHT at N=2^19 and 2^21), "high" a cuBLAS GEMM in TF32
                 (3.6e-4) and "default" XLA's Triton GEMM fusion in TF32
                 (3.6e-4).
      "bf16":    cast the data operand to bf16 (halves the bytes each
                 contraction moves), f32 accumulation.  The Hadamard
                 factors are exact in bf16 (+-1); only the data operand is
                 rounded (~0.4% rel), far below channel noise.
    On the CPU backend all three f32 precisions compute in full f32.
    """
    N = x.shape[-1]
    fs = factorize_pow2(N, max_log)
    lead = x.shape[:-1]
    out_dtype = x.dtype
    bf16 = precision == "bf16"
    prec = None if bf16 else {
        "highest": jax.lax.Precision.HIGHEST,
        "high": jax.lax.Precision.HIGH,
        "default": jax.lax.Precision.DEFAULT,
    }[precision]
    y = x.astype(jnp.bfloat16) if bf16 else x
    y = y.reshape(lead + fs)
    nb = len(lead)
    for i, f in enumerate(fs):
        if f == 1:
            continue
        H = hadamard_factor(f, y.dtype)
        axis = nb + i
        # contract mode i with H (symmetric); tensordot moves the result
        # axis to the end, move it back to keep natural ordering.
        if bf16:
            y = jax.lax.dot_general(
                y, H, (((axis,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
            y = jnp.moveaxis(y, -1, axis)
            if i < len(fs) - 1:
                y = y.astype(jnp.bfloat16)
        else:
            y = jnp.moveaxis(
                jnp.tensordot(y, H, axes=[[axis], [0]], precision=prec),
                -1, axis)
    return y.reshape(lead + (N,)).astype(out_dtype)


# ------------------------------------------------- transpose-free variants
#
# The fwht_mxu contraction order needs a moveaxis after every middle-mode
# contraction, which can materialize as a full-tensor transpose.  The
# transpose-free scheme contracts modes so that every dot touches only the
# two minor-most dims (plain batched-matmul forms: minor-dim contraction or
# penultimate-dim contraction), letting the output accumulate in *reversed*
# mode order:
#
#   natural (B, f1, f2, f3) -> contract f3 (minor), f2 (penult), f1 (penult)
#   -> (B, j3, j2, j1)   [fwht_to_rev]
#
# and symmetrically reversed-in -> natural-out [fwht_from_rev].  The mode
# reversal is absorbed into the operator's row index set (rev_indices) on the
# host, so the AMP loop never pays a transpose: forward gathers rows from the
# reversed layout, adjoint scatters into it (ops.operators.hadamard_operator).


def _dot_minor(x: jax.Array, H: jax.Array, prec) -> jax.Array:
    """Contract the last dim: (..., f) x (f, j) -> (..., j)."""
    return jax.lax.dot_general(x, H, (((x.ndim - 1,), (0,)), ((), ())),
                               precision=prec,
                               preferred_element_type=jnp.float32)


def _dot_penult(x: jax.Array, H: jax.Array, prec) -> jax.Array:
    """Contract dim -2: (..., f, k) x (f, j) -> (..., k, j)."""
    return jax.lax.dot_general(x, H, (((x.ndim - 2,), (0,)), ((), ())),
                               precision=prec,
                               preferred_element_type=jnp.float32)


def _prec_cast(precision: str):
    if precision == "bf16":
        return None, jnp.bfloat16
    return {
        "highest": jax.lax.Precision.HIGHEST,
        "high": jax.lax.Precision.HIGH,
        "default": jax.lax.Precision.DEFAULT,
    }[precision], None


def fwht_to_rev(x: jax.Array, max_log: int = 8,
                precision: str = "high") -> jax.Array:
    """Natural-layout input -> FWHT in reversed mode layout (transpose-free).

    x: (..., N); returns (..., N) where flat index (j1..jk) lives at
    reversed position (jk..j1).  Use rev_indices() to address the output.
    """
    N = x.shape[-1]
    fs = factorize_pow2(N, max_log)
    lead = x.shape[:-1]
    out_dtype = x.dtype
    prec, cast = _prec_cast(precision)
    y = x.astype(cast) if cast else x
    y = y.reshape(lead + fs)
    k = len(fs)
    for step, f in enumerate(reversed(fs)):     # contract f_k, ..., f_1
        if f == 1:                              # only for the N == 1 case
            continue
        H = hadamard_factor(f, y.dtype)
        if step == 0:
            y = _dot_minor(y, H, prec)
        else:
            # contracted mode sits at dim -(step+1)... after previous steps
            # the already-transformed modes occupy the minor positions; the
            # next mode to contract is always at dim -(step+1), and we fold
            # the minor transformed dims into one so it is penultimate.
            shape = y.shape
            folded = 1
            for d in shape[-step:]:
                folded *= d
            y = y.reshape(shape[: -step - 1] + (shape[-step - 1], folded))
            y = _dot_penult(y, H, prec)
            y = y.reshape(shape[: -step - 1] + shape[-step:] + (f,))
        if cast and step < k - 1:
            y = y.astype(cast)
    return y.reshape(lead + (N,)).astype(out_dtype)


def fwht_from_rev(x: jax.Array, max_log: int = 8,
                  precision: str = "high") -> jax.Array:
    """Reversed-layout input -> FWHT in natural layout (transpose-free).

    Exactly the mirror of fwht_to_rev: feeding it fwht_to_rev's output
    yields N * identity (FWHT is self-inverse up to scale N).
    """
    N = x.shape[-1]
    fs = factorize_pow2(N, max_log)
    lead = x.shape[:-1]
    out_dtype = x.dtype
    prec, cast = _prec_cast(precision)
    y = x.astype(cast) if cast else x
    y = y.reshape(lead + tuple(reversed(fs)))   # modes stored (fk .. f1)
    k = len(fs)
    for step, f in enumerate(fs):               # contract f_1, ..., f_k
        if f == 1:
            continue
        H = hadamard_factor(f, y.dtype)
        if step == 0:
            y = _dot_minor(y, H, prec)          # f1 is minor in rev layout
        else:
            shape = y.shape
            folded = 1
            for d in shape[-step:]:
                folded *= d
            y = y.reshape(shape[: -step - 1] + (shape[-step - 1], folded))
            y = _dot_penult(y, H, prec)
            y = y.reshape(shape[: -step - 1] + shape[-step:] + (f,))
        if cast and step < k - 1:
            y = y.astype(cast)
    return y.reshape(lead + (N,)).astype(out_dtype)


def rev_indices(idx: np.ndarray, N: int, max_log: int = 8) -> np.ndarray:
    """Host-side: natural flat indices -> their reversed-layout positions.

    i = (i1, ..., ik) at natural position sum_m i_m * prod_{m'>m} f_{m'}
    maps to reversed position sum_m i_m * prod_{m'<m} f_{m'}.
    """
    fs = factorize_pow2(N, max_log)
    idx = np.asarray(idx, dtype=np.int64)
    digits = []
    rem = idx
    for f in reversed(fs):          # peel minor digit first: i_k, ..., i_1
        digits.append(rem % f)
        rem //= f
    # digits = [i_k, i_{k-1}, ..., i_1]; reversed position: i_m gets stride
    # prod_{m'<m} f_{m'} (earlier modes become minor)
    pos = np.zeros_like(idx)
    stride = 1
    for dig, f in zip(reversed(digits), fs):    # i_1 first, stride 1
        pos += dig * stride
        stride *= f
    return pos


def fwht_butterfly(x: jax.Array) -> jax.Array:
    """Reference jnp butterfly FWHT (any N=2^k); for tests and tiny sizes."""
    N = x.shape[-1]
    lead = x.shape[:-1]
    y = x
    h = 1
    while h < N:
        y = y.reshape(lead + (N // (2 * h), 2, h))
        a = y[..., 0, :]
        b = y[..., 1, :]
        y = jnp.stack((a + b, a - b), axis=-2)
        h *= 2
    return y.reshape(lead + (N,))
