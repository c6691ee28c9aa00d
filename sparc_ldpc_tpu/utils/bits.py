"""Message bit <-> section index packing (SURVEY.md §2 #2, App. A.1).

Convention (binding for oracle and JAX paths): each section carries
``logM`` bits, MSB first.  Section ``l``'s index is

    c_l = sum_{b=0}^{logM-1}  bits[l*logM + b] << (logM - 1 - b)

i.e. ``bits`` is the big-endian binary expansion of ``c_l`` concatenated over
sections.  All functions are vectorized over a leading batch dimension and are
jittable (static logM).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def bits_to_indices(bits, logM: int):
    """(..., L*logM) {0,1} -> (..., L) int32 section indices. jnp."""
    b = jnp.asarray(bits, dtype=jnp.int32)
    shape = b.shape[:-1] + (b.shape[-1] // logM, logM)
    b = b.reshape(shape)
    weights = (1 << jnp.arange(logM - 1, -1, -1, dtype=jnp.int32))
    return jnp.sum(b * weights, axis=-1)


def indices_to_bits(indices, logM: int):
    """(..., L) int -> (..., L*logM) int32 {0,1}, MSB first. jnp."""
    idx = jnp.asarray(indices, dtype=jnp.int32)
    shifts = jnp.arange(logM - 1, -1, -1, dtype=jnp.int32)
    bits = (idx[..., None] >> shifts) & 1
    return bits.reshape(idx.shape[:-1] + (idx.shape[-1] * logM,))


def np_bits_to_indices(bits: np.ndarray, logM: int) -> np.ndarray:
    """NumPy mirror of bits_to_indices (oracle path; must match exactly)."""
    b = np.asarray(bits, dtype=np.int64)
    b = b.reshape(b.shape[:-1] + (b.shape[-1] // logM, logM))
    weights = 1 << np.arange(logM - 1, -1, -1, dtype=np.int64)
    return np.sum(b * weights, axis=-1).astype(np.int64)


def np_indices_to_bits(indices: np.ndarray, logM: int) -> np.ndarray:
    idx = np.asarray(indices, dtype=np.int64)
    shifts = np.arange(logM - 1, -1, -1, dtype=np.int64)
    bits = (idx[..., None] >> shifts) & 1
    return bits.reshape(idx.shape[:-1] + (idx.shape[-1] * logM,)).astype(np.int64)
