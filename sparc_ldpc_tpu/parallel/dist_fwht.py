"""Hand-collective distributed FWHT for section-sharded large L
(SURVEY.md §5 "long-context analog"; §2 #25 transform sharding).

GSPMD already shards the Kronecker mode contractions automatically (a
sharded mode becomes local matmuls + collectives).  This module is the
explicit alternative — the exact structural analog of ring attention for
sequence length: butterfly *super-stages* across the device axis with
`ppermute` neighbor exchange, local matmul transforms inside.

Math: with the length-N vector split into S contiguous shards (device s
holds rows [s·N/S, (s+1)·N/S)), Sylvester ordering gives

    H_N = H_S (x) H_{N/S}

so  FWHT_N(x) = cross-device H_S over the shard index  ∘  local FWHT_{N/S}.
The H_S factor is log2(S) hypercube butterfly stages: at stage `bit`,
device i exchanges its full local block with device i^bit (one bidirectional
ICI hop on a torus) and combines

    y_i <- y_i + y_{i^bit}         (i & bit == 0)
    y_i <- y_{i^bit} - y_i         (i & bit != 0)

Communication: (N/S)·log2(S) words per device vs ~N for the all-gather GSPMD
tends to emit around the row gather — 2.7x less at S=8, overlappable with
the local matmuls of the *next* AMP stage.

Used when SparcConfig.fwht_dist == "collective" and the model has a
section-sharded policy; default remains GSPMD ("gspmd").  Parity tested on
the 8-fake-device CPU mesh in tests/test_parallel.py (bitwise vs the
single-device transform in f32-highest).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.fwht import fwht_mxu


def dist_fwht(x: jax.Array, mesh: Mesh,
              data_axis: str = "data", section_axis: str = "section",
              precision: str = "high") -> jax.Array:
    """FWHT over the last axis of (B, N); N sharded over `section_axis`.

    x must have B divisible by the data-axis size and N by the section-axis
    size (both powers of two).  Returns the transform with the same
    sharding.  Degenerates to the plain local transform when the section
    axis has size 1.
    """
    S = mesh.shape[section_axis]
    if S == 1:
        return fwht_mxu(x, precision=precision)
    N = x.shape[-1]
    assert N % S == 0 and (S & (S - 1)) == 0, (N, S)

    def local(xs):                       # (B/D, N/S) per device
        y = fwht_mxu(xs, precision=precision)      # H_{N/S} locally
        idx = jax.lax.axis_index(section_axis)
        bit = 1
        while bit < S:                   # H_S across devices: hypercube
            perm = [(i, i ^ bit) for i in range(S)]
            recv = jax.lax.ppermute(y, section_axis, perm=perm)
            upper = (idx & bit) != 0
            y = jnp.where(upper, recv - y, y + recv)
            bit <<= 1
        return y

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=P(data_axis, section_axis),
        out_specs=P(data_axis, section_axis))(x)
