"""Batched matrix-free measurement operators (SURVEY.md §2 #6, #9, #10).

The L2->L3 contract (SURVEY.md §1): AMP touches A only through a forward /
adjoint matvec pair, batched over codewords:

    Ax: (B, ML) -> (B, n)       Ay: (B, n) -> (B, ML)

Operators are built from host-side plans (design.codebook) so the oracle and
JAX paths use *identical* index sets; only the transform backend differs.

Layout decisions (SURVEY.md §5 long-context analog):
  - columns are the first ML natural Hadamard columns — the embedding
    beta -> u is a zero-pad (usually the identity, since ML is a power of
    two), so the section ('model') sharding of beta carries straight into
    the transform with no gather;
  - the row subset is sorted, so the (B, n) gather out of (B, N) is a
    monotone static gather XLA lowers efficiently;
  - all cross-device communication is induced by GSPMD from shardings
    (a sharded mode contraction becomes a local matmul + psum) rather than
    hand-written collectives.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SparcConfig
from ..design.codebook import hadamard_plan, dct_plan
from .fwht import fwht_from_rev, fwht_mxu, fwht_to_rev, rev_indices


class BatchedOperator(NamedTuple):
    """Forward/adjoint pair plus static geometry.

    Optional N-space members (fast-transform operators only): keeping the
    AMP residual in the length-N transform domain replaces the per-iteration
    row gather (forward) and scatter (adjoint embed) with a single fused
    0/1-mask multiply — the adjoint's input simply *is* the masked residual.
      embed_y:   (B, n) -> (B, N)   one-time scatter of y before the loop
      resid_n:   (yN, beta, zN, coef) -> zN'   mask*(yN - A_full beta) + coef*zN
      adj_n:     (B, N) -> (B, ML)  adjoint straight from the N-space residual
    ||zN||^2 == ||z||^2 (off-row entries are zero), so tau tracking is
    unchanged.  amp_decode uses these when present.
    """
    Ax: Callable[[jax.Array], jax.Array]
    Ay: Callable[[jax.Array], jax.Array]
    n: int
    ML: int
    N: int
    embed_y: Optional[Callable[[jax.Array], jax.Array]] = None
    resid_n: Optional[Callable] = None
    adj_n: Optional[Callable[[jax.Array], jax.Array]] = None


def dense_operator(cfg: SparcConfig) -> BatchedOperator:
    """Explicit iid N(0,1/n) matrix — oracle-parity path for small configs.

    Uses the same seed chain as oracle.sparc.dense_operator so both realize
    the same A (host numpy RNG, then shipped to device).
    """
    n, ML = cfg.n, cfg.ML
    rng = np.random.default_rng(np.random.SeedSequence([0xDE45E, cfg.op_seed]))
    A = jnp.asarray(rng.standard_normal((n, ML)) / math.sqrt(n),
                    dtype=jnp.float32)

    def Ax(beta):
        return beta @ A.T

    def Ay(z):
        return z @ A

    return BatchedOperator(Ax=Ax, Ay=Ay, n=n, ML=ML, N=ML)


def hadamard_operator(cfg: SparcConfig, policy=None) -> BatchedOperator:
    """Matrix-free partial-Hadamard operator (App. A.3), matmul transform.

    Transpose-free scheme (see ops.fwht): the forward transform emits the
    Walsh spectrum in *reversed mode layout* and the adjoint consumes that
    layout, so the per-iteration transforms are pure batched matmuls with no
    transpose passes.  The mode reversal is absorbed into the row index set:
    both directions address rows at rev_indices(rows) — precomputed on host,
    part of neither the code definition nor the math (w_rev[rev(i)] == w[i]).
    """
    plan = hadamard_plan(cfg.n, cfg.ML, cfg.op_seed, cfg.col_signs)
    N, n, ML = plan.N, plan.n, plan.ML
    rows_rev = jnp.asarray(rev_indices(plan.rows, N), dtype=jnp.int32)
    signs = (jnp.asarray(plan.signs, dtype=jnp.float32)
             if plan.signs is not None else None)
    inv_sqrt_n = 1.0 / math.sqrt(n)
    prec = cfg.transform_precision

    # transform backend: plain local/GSPMD mode contractions, or the hand
    # hypercube-ppermute collective FWHT under a section-sharded policy
    # (cfg.fwht_dist == "collective"; parallel.dist_fwht docstring).
    if (policy is not None and getattr(policy, "section_axis", None)
            and cfg.fwht_dist == "collective"):
        from ..parallel.dist_fwht import dist_fwht

        def txf(u):
            return dist_fwht(u, policy.mesh, policy.data_axis,
                             policy.section_axis, precision=prec)
    else:
        def txf(u):
            return fwht_mxu(u, precision=prec)

    if cfg.fwht_scheme == "mxu":
        rows_nat = jnp.asarray(plan.rows, dtype=jnp.int32)
        mask_np = np.zeros(N, dtype=np.float32)
        mask_np[plan.rows] = 1.0
        mask = jnp.asarray(mask_np)

        def Ax(beta):
            if signs is not None:
                beta = beta * signs
            u = beta if ML == N else jnp.pad(beta, ((0, 0), (0, N - ML)))
            w = txf(u)
            return jnp.take(w, rows_nat, axis=-1) * inv_sqrt_n

        def Ay(z):
            u = jnp.zeros(z.shape[:-1] + (N,), dtype=z.dtype)
            u = u.at[..., rows_nat].set(z)
            w = txf(u)
            s = w[..., :ML] * inv_sqrt_n
            return s * signs if signs is not None else s

        # ---- N-space members (see BatchedOperator docstring) ----

        def embed_y(y):
            u = jnp.zeros(y.shape[:-1] + (N,), dtype=y.dtype)
            return u.at[..., rows_nat].set(y)

        def resid_n(yN, beta, zN, coef):
            if signs is not None:
                beta = beta * signs
            u = beta if ML == N else jnp.pad(beta, ((0, 0), (0, N - ML)))
            w = txf(u)
            return mask * (yN - w * inv_sqrt_n) + zN * coef

        def adj_n(zN):
            w = txf(zN)
            s = w[..., :ML] * inv_sqrt_n
            return s * signs if signs is not None else s

        return BatchedOperator(
            Ax=Ax, Ay=Ay, n=n, ML=ML, N=N,
            embed_y=embed_y, resid_n=resid_n, adj_n=adj_n)
    else:
        def Ax(beta):  # (B, ML) -> (B, n)
            if signs is not None:
                beta = beta * signs
            u = beta if ML == N else jnp.pad(beta, ((0, 0), (0, N - ML)))
            w_rev = fwht_to_rev(u, precision=prec)
            return jnp.take(w_rev, rows_rev, axis=-1) * inv_sqrt_n

        def Ay(z):  # (B, n) -> (B, ML)
            u = jnp.zeros(z.shape[:-1] + (N,), dtype=z.dtype)
            u = u.at[..., rows_rev].set(z)
            w = fwht_from_rev(u, precision=prec)
            s = w[..., :ML] * inv_sqrt_n
            return s * signs if signs is not None else s

    return BatchedOperator(Ax=Ax, Ay=Ay, n=n, ML=ML, N=N)


def dct_operator(cfg: SparcConfig) -> BatchedOperator:
    """Matrix-free subsampled orthonormal-DCT operator (App. A.3).

    DCT-II (norm='ortho') forward, DCT-III (= idct ortho) adjoint; XLA FFT
    path.  Column Rademacher signs ON per the plan (see design.codebook).
    """
    import jax.scipy.fft as jfft

    plan = dct_plan(cfg.n, cfg.ML, cfg.op_seed, col_signs=True)
    N, n, ML = plan.N, plan.n, plan.ML
    rows = jnp.asarray(plan.rows, dtype=jnp.int32)
    signs = jnp.asarray(plan.signs, dtype=jnp.float32)
    scale = math.sqrt(N / n)

    def Ax(beta):
        u = (beta * signs)
        if ML != N:
            u = jnp.pad(u, ((0, 0), (0, N - ML)))
        w = jfft.dct(u, norm="ortho", axis=-1)
        return jnp.take(w, rows, axis=-1) * scale

    def Ay(z):
        u = jnp.zeros(z.shape[:-1] + (N,), dtype=z.dtype)
        u = u.at[..., rows].set(z)
        w = jfft.idct(u, norm="ortho", axis=-1)
        return w[..., :ML] * scale * signs

    return BatchedOperator(Ax=Ax, Ay=Ay, n=n, ML=ML, N=N)


def make_operator(cfg: SparcConfig, policy=None) -> BatchedOperator:
    if cfg.op_kind == "dense":
        return dense_operator(cfg)
    if cfg.op_kind == "hadamard":
        return hadamard_operator(cfg, policy=policy)
    if cfg.op_kind == "dct":
        return dct_operator(cfg)
    raise ValueError(cfg.op_kind)
