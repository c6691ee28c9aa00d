"""QC-LDPC belief propagation via circulant-structured message tensors.

SURVEY.md §7 hard-part 3 names the preferred accelerator layout for LDPC:
exploit quasi-cyclic block structure (circulant shifts) instead of
irregular edge lists.  For a QC code with base matrix
S ∈ {-1, 0..Z-1}^{J×K} (-1 = zero block, s >= 0 = identity circulant
shifted by s) the Tanner graph is a (J, K) grid of Z-sized permutation
blocks, so BP messages live on a dense (B, J, K, Z) tensor and *all* edge
routing is two static gathers along the Z axis (check coordinates zc <->
variable coordinates zv = (zc + s) mod Z).  No padded adjacency, no flat
edge ids, no masks beyond the (J, K) block grid — XLA sees static-shape
rolls + small-axis reductions, which lower to plain fused elementwise
work.

Two schedules:
  - "flooding": message-identical to ops.bp.bp_decode on the same graph
    (parity-tested); all check rows update simultaneously.
  - "layered" (row-layered / turbo-decoding message passing): block rows
    are processed sequentially within one iteration, with the variable
    totals updated after each layer.  Converges in roughly half the
    flooding iterations — only expressible in the QC layout, where a layer
    is a static (B, K, Z) slice.

The oracle twin is oracle/ldpc.py (flooding); layered correctness is
anchored by fixed-point and decode-success tests (tests/test_ldpc_qc.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .bp import BpResult, _phi


class QcBpTables(NamedTuple):
    """Static circulant structure, device-resident.

    gather_cv (J, K, Z) int32: variable z-index seen from check slot zc,
      i.e. (zc + shift) mod Z (identity for inactive blocks).
    gather_vc (J, K, Z) int32: inverse map, (zv - shift) mod Z.
    block_mask (J, K) bool: active circulant blocks.
    """
    gather_cv: jax.Array
    gather_vc: jax.Array
    block_mask: jax.Array
    Z: int
    J: int
    K: int

    @staticmethod
    def build(shifts: np.ndarray, Z: int) -> "QcBpTables":
        shifts = np.asarray(shifts, dtype=np.int64)
        J, K = shifts.shape
        active = shifts >= 0
        s = np.where(active, shifts, 0)
        zc = np.arange(Z)
        gcv = (zc[None, None, :] + s[:, :, None]) % Z
        gvc = (zc[None, None, :] - s[:, :, None]) % Z
        return QcBpTables(
            gather_cv=jnp.asarray(gcv, dtype=jnp.int32),
            gather_vc=jnp.asarray(gvc, dtype=jnp.int32),
            block_mask=jnp.asarray(active),
            Z=int(Z), J=int(J), K=int(K))

    @property
    def n(self) -> int:
        return self.K * self.Z

    @property
    def m(self) -> int:
        return self.J * self.Z


def _to_check_coords(tot_kz: jax.Array, t: QcBpTables) -> jax.Array:
    """(B, K, Z) variable-ordered -> (B, J, K, Z) at check coordinates."""
    return jnp.take_along_axis(
        tot_kz[:, None], t.gather_cv[None], axis=-1, mode="promise_in_bounds")


def _to_var_coords(m_cv: jax.Array, t: QcBpTables) -> jax.Array:
    """(B, J, K, Z) at check coordinates -> same graph edges at variable z."""
    return jnp.take_along_axis(
        m_cv, t.gather_vc[None], axis=-1, mode="promise_in_bounds")


def _check_rule(m_vc: jax.Array, bmask: jax.Array, method: str,
                alpha: float, beta: float, clip: float,
                axis: int) -> jax.Array:
    """Extrinsic check-node update over the K-block axis.

    m_vc: messages at check coordinates with blocks on `axis`; bmask
    broadcastable to m_vc marking active blocks.  Same rules (and the
    negative-count-parity sign product, see ops/bp.py) as the edge-table
    engine.
    """
    K = m_vc.shape[axis]
    mag = jnp.where(bmask, jnp.abs(m_vc), jnp.inf)
    neg = bmask & (m_vc < 0)
    sgn = jnp.where(neg, -1.0, 1.0)
    n_neg = jnp.sum(neg.astype(jnp.int32), axis=axis, keepdims=True)
    sign_prod = (1 - 2 * (n_neg & 1)).astype(m_vc.dtype)
    if method in ("minsum", "oms"):
        min1 = jnp.min(mag, axis=axis, keepdims=True)
        arg1 = jnp.argmin(mag, axis=axis)
        one_hot = jax.nn.one_hot(arg1, K, dtype=bool, axis=axis)
        min2 = jnp.min(jnp.where(one_hot, jnp.inf, mag), axis=axis,
                       keepdims=True)
        exc_min = jnp.where(mag == min1, min2, min1)
        if method == "oms":
            new_cv = (sign_prod * sgn) * jnp.maximum(exc_min - beta, 0.0)
        else:
            new_cv = alpha * (sign_prod * sgn) * exc_min
    elif method == "spa":
        ph = jnp.where(bmask, _phi(mag), 0.0)
        ph_sum = jnp.sum(ph, axis=axis, keepdims=True)
        new_cv = (sign_prod * sgn) * _phi(jnp.maximum(ph_sum - ph, 1e-7))
    else:
        raise ValueError(method)
    return jnp.where(bmask, jnp.clip(new_cv, -clip, clip), 0.0)


def _syndrome_ok(tot: jax.Array, t: QcBpTables) -> jax.Array:
    hard = (tot < 0)                                     # (B, K, Z)
    bits_at = _to_check_coords(hard.astype(jnp.int32), t)
    bits_at = jnp.where(t.block_mask[None, :, :, None], bits_at, 0)
    syn = jnp.sum(bits_at, axis=2) & 1                   # (B, J, Z)
    return ~jnp.any(syn != 0, axis=(1, 2))               # (B,)


def bp_decode_qc(
    llr: jax.Array,               # (B, n) with n = K*Z, variable order k*Z+zv
    tables: QcBpTables,
    iters: int = 64,
    method: str = "minsum",
    alpha: float = 0.8125,
    beta: float = 0.15,
    clip: float = 20.0,
    schedule: str = "flooding",
) -> BpResult:
    t = tables
    B = llr.shape[0]
    llr = jnp.clip(llr, -clip, clip).reshape(B, t.K, t.Z)
    bmask4 = t.block_mask[None, :, :, None]              # (1, J, K, 1)

    if schedule == "flooding":
        def step(state, _):
            m_cv, tot, done, it = state
            m_vc = _to_check_coords(tot, t) - m_cv       # (B, J, K, Z)
            m_vc = jnp.clip(m_vc, -clip, clip)
            new_cv = _check_rule(m_vc, bmask4, method, alpha, beta, clip,
                                 axis=2)
            incoming = _to_var_coords(new_cv, t)         # (B, J, K, Z) at zv
            incoming = jnp.where(bmask4, incoming, 0.0)
            new_tot = llr + jnp.sum(incoming, axis=1)    # (B, K, Z)
            ok = _syndrome_ok(new_tot, t)
            keep = done
            return (jnp.where(keep[:, None, None, None], m_cv, new_cv),
                    jnp.where(keep[:, None, None], tot, new_tot),
                    keep | ok,
                    it + jnp.where(keep, 0, 1).astype(it.dtype)), None

        m_cv0 = jnp.zeros((B, t.J, t.K, t.Z), dtype=llr.dtype)
        state0 = (m_cv0, llr, jnp.zeros((B,), bool),
                  jnp.zeros((B,), jnp.int32))
        (m_cv, tot, done, it), _ = jax.lax.scan(step, state0, None,
                                                length=iters)
    elif schedule == "layered":
        # Row-layered MPA: per block row j, read the *current* totals at
        # layer-j check coordinates, form extrinsic messages, update the
        # layer's check messages, write the refreshed totals straight back
        # (each circulant is a permutation, so the write is the inverse
        # gather).  Inactive blocks have shift 0 + zero messages: identity
        # round trip, totals untouched.
        bmask3 = t.block_mask[None, :, :, None]

        def sweep(m_cv, tot):
            for j in range(t.J):                         # static unroll
                g_cv = t.gather_cv[None, j]              # (1, K, Z)
                g_vc = t.gather_vc[None, j]
                bm = bmask3[:, j]                        # (1, K, 1)
                tot_at = jnp.take_along_axis(
                    tot, g_cv, axis=-1, mode="promise_in_bounds")
                m_vc = jnp.clip(tot_at - m_cv[:, j], -clip, clip)
                new_cv = _check_rule(m_vc, bm, method, alpha, beta, clip,
                                     axis=1)
                tot_at_new = m_vc + new_cv
                tot = jnp.take_along_axis(
                    tot_at_new, g_vc, axis=-1, mode="promise_in_bounds")
                m_cv = m_cv.at[:, j].set(new_cv)
            return m_cv, tot

        def step(state, _):
            m_cv, tot, done, it = state
            new_cv, new_tot = sweep(m_cv, tot)
            ok = _syndrome_ok(new_tot, t)
            keep = done
            return (jnp.where(keep[:, None, None, None], m_cv, new_cv),
                    jnp.where(keep[:, None, None], tot, new_tot),
                    keep | ok,
                    it + jnp.where(keep, 0, 1).astype(it.dtype)), None

        m_cv0 = jnp.zeros((B, t.J, t.K, t.Z), dtype=llr.dtype)
        state0 = (m_cv0, llr, jnp.zeros((B,), bool),
                  jnp.zeros((B,), jnp.int32))
        (m_cv, tot, done, it), _ = jax.lax.scan(step, state0, None,
                                                length=iters)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")

    tot_flat = tot.reshape(B, t.n)
    return BpResult(hard=(tot_flat < 0).astype(jnp.uint8),
                    posterior=tot_flat, iters=it, ok=done)
