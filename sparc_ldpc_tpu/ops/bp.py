"""LDPC belief propagation in JAX (SURVEY.md §2 #18-19, App. A.6).

Layout (SURVEY.md §7 hard-part 3): irregular edge lists lower to
scatter/segment ops XLA handles poorly, so the Tanner graph is stored as
*padded dense* adjacency arrays (design.ldpc_codes.Adjacency):

    check_nbr (m, max_dc): variable index per check slot (+ validity mask)
    var_edge  (n, max_dv): flat check-slot edge id per variable (+ mask)

Every BP iteration is then three static-shape dense gathers + rowwise
reductions over (B, m, max_dc) / (B, n, max_dv) tensors — elementwise work
that XLA fuses, batched over codewords (the 'data' mesh axis).  Check-node
exclude-self min uses the (min1, min2) trick rather than per-slot loops.

Flooding schedule; normalized min-sum ("minsum"), offset min-sum ("oms")
or sum-product ("spa"); syndrome early stop as a freeze mask (identical
semantics to the oracle's `break`).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..design.ldpc_codes import Adjacency, adjacency


class BpTables(NamedTuple):
    """Device-resident static graph tables."""
    check_nbr: jax.Array    # (m, max_dc) int32
    check_mask: jax.Array   # (m, max_dc) bool
    var_edge: jax.Array     # (n, max_dv) int32
    var_mask: jax.Array     # (n, max_dv) bool
    n: int
    m: int

    @staticmethod
    def build(code_or_adj) -> "BpTables":
        adj = (code_or_adj if isinstance(code_or_adj, Adjacency)
               else adjacency(code_or_adj.H))
        return BpTables(
            check_nbr=jnp.asarray(adj.check_nbr),
            check_mask=jnp.asarray(adj.check_mask),
            var_edge=jnp.asarray(adj.var_edge),
            var_mask=jnp.asarray(adj.var_mask),
            n=adj.var_edge.shape[0], m=adj.check_nbr.shape[0])


class BpResult(NamedTuple):
    hard: jax.Array        # (B, n) uint8 hard decisions
    posterior: jax.Array   # (B, n) total LLRs
    iters: jax.Array       # (B,) iterations used
    ok: jax.Array          # (B,) syndrome satisfied


def _phi(x: jax.Array) -> jax.Array:
    """phi(x) = -log tanh(x/2), self-inverse; clipped for f32."""
    x = jnp.clip(x, 1e-7, 40.0)
    return -jnp.log(jnp.tanh(x * 0.5))


def bp_decode(
    llr: jax.Array,               # (B, n)
    tables: BpTables,
    iters: int = 64,
    method: str = "minsum",
    alpha: float = 0.8125,
    beta: float = 0.15,
    clip: float = 20.0,
) -> BpResult:
    B = llr.shape[0]
    cn, cmask = tables.check_nbr, tables.check_mask
    ve, vmask = tables.var_edge, tables.var_mask
    m, max_dc = cn.shape
    llr = jnp.clip(llr, -clip, clip)

    def syndrome_ok(tot):
        hard = (tot < 0)
        bits_at = hard[:, cn] & cmask[None]              # (B, m, max_dc)
        syn = jnp.sum(bits_at, axis=-1) % 2              # (B, m)
        return ~jnp.any(syn != 0, axis=-1)               # (B,)

    def step(state, _):
        m_cv, tot, done, it = state
        # variable -> check (extrinsic): tot gathered at check slots
        m_vc = tot[:, cn] - m_cv                          # (B, m, max_dc)
        m_vc = jnp.clip(m_vc, -clip, clip)
        mag = jnp.where(cmask[None], jnp.abs(m_vc), jnp.inf)
        # sign product via negative-count parity: cheaper than jnp.prod
        # over the edge axis.
        neg = cmask[None] & (m_vc < 0)
        sgn = jnp.where(neg, -1.0, 1.0)
        n_neg = jnp.sum(neg.astype(jnp.int32), axis=-1, keepdims=True)
        sign_prod = (1 - 2 * (n_neg & 1)).astype(m_vc.dtype)  # (B, m, 1)
        if method in ("minsum", "oms"):
            min1 = jnp.min(mag, axis=-1, keepdims=True)
            arg1 = jnp.argmin(mag, axis=-1)
            mag2 = jnp.where(
                jax.nn.one_hot(arg1, max_dc, dtype=bool), jnp.inf, mag)
            min2 = jnp.min(mag2, axis=-1, keepdims=True)
            exc_min = jnp.where(mag == min1, min2, min1)
            if method == "oms":
                # offset min-sum (App. A.6): subtract a fixed offset,
                # floored at zero, instead of multiplicative normalization.
                new_cv = (sign_prod * sgn) * jnp.maximum(exc_min - beta, 0.0)
            else:
                new_cv = alpha * (sign_prod * sgn) * exc_min
        elif method == "spa":
            ph = jnp.where(cmask[None], _phi(mag), 0.0)
            ph_sum = jnp.sum(ph, axis=-1, keepdims=True)
            new_cv = (sign_prod * sgn) * _phi(jnp.maximum(ph_sum - ph, 1e-7))
        else:
            raise ValueError(method)
        new_cv = jnp.where(cmask[None], jnp.clip(new_cv, -clip, clip), 0.0)
        # variable totals: gather check->var messages by flat edge id
        flat = new_cv.reshape(B, -1)
        incoming = jnp.where(vmask[None], flat[:, ve], 0.0)   # (B, n, max_dv)
        new_tot = llr + jnp.sum(incoming, axis=-1)
        ok = syndrome_ok(new_tot)
        keep = done
        out = (
            jnp.where(keep[:, None, None], m_cv, new_cv),
            jnp.where(keep[:, None], tot, new_tot),
            keep | ok,
            it + jnp.where(keep, 0, 1).astype(it.dtype),
        )
        return out, None

    # done starts False: like the oracle, at least one update runs before the
    # syndrome check (parity of iteration semantics with oracle.ldpc).
    m_cv0 = jnp.zeros((B, m, max_dc), dtype=llr.dtype)
    done0 = jnp.zeros((B,), dtype=bool)
    state0 = (m_cv0, llr, done0, jnp.zeros((B,), jnp.int32))
    (m_cv, tot, done, it), _ = jax.lax.scan(step, state0, None, length=iters)
    return BpResult(hard=(tot < 0).astype(jnp.uint8), posterior=tot,
                    iters=it, ok=done)
