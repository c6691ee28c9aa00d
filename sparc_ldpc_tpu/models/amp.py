"""AMP decode loop — THE hot loop (SURVEY.md §3.2, App. A.5).

Per iteration: two transform matvecs + one sectionwise softmax, with the
Onsager correction and online tau tracking:

    z_t   = y - A beta_t + (z_{t-1}/tau2_{t-1}) (P - ||beta_t||^2 / n)
    tau2_t = ||z_t||^2 / n                      (or an SE schedule)
    s_t   = beta_t + A^T z_t
    beta_{t+1} = eta(s_t; tau2_t)               (ops.denoiser)

Structure (plain jax.numpy/lax; XLA fuses the chains and hands the
transform contractions to the GEMM library):
  - `lax.scan` over a static iteration count T (XLA traces the body once);
  - per-codeword early stop is a *mask*, not control flow (SURVEY.md §7
    hard-part 4): once |tau2_t - tau2_{t-1}| < tol*tau2_t the state is
    frozen, so trajectories match the oracle's `break` semantics exactly;
  - the scan carry holds ONLY (beta, z, tau2, done, iters).  The final
    posteriors and hard decisions are recovered from beta after the loop
    (beta = sqrt(nP_l) * posterior, and argmax_j posterior == argmax_j s
    sectionwise), which removes two (B, L, M) tensors from the carry —
    at L=1024/M=512/B=128 that is ~0.5 GB of HBM traffic per iteration;
  - the reductions ||beta||^2 and ||z||^2 are plain sums — under a section-
    sharded NamedSharding, GSPMD turns them into the psum the design calls
    for (SURVEY.md §2 #14-15) with no hand-written collectives;
  - decision-feedback pinning (App. A.7 step 5) is a denoiser override mask,
    reused by the concatenated pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.denoiser import denoise
from ..ops.operators import BatchedOperator


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class AmpResult:
    """Final AMP state.  `posteriors`/`scores` are DERIVED lazily from
    beta: every shipped consumer reads beta directly (the
    concat chain folds it straight into LLRs —
    models/concat._protected_llrs_from_beta), so materializing two more
    (B, L, M) tensors eagerly would cost ~0.5 GB of HBM traffic per
    un-jitted decode() at the shipped shapes for nothing.  Inside jit
    the properties trace as ordinary ops and DCE applies as usual."""
    beta: jax.Array         # (B, L, M) final posterior-mean estimate
    tau2_trace: jax.Array   # (T, B)
    iters: jax.Array        # (B,) iterations actually used
    sq_npl: jax.Array       # (L,) sqrt(n P_l) (beta's per-section scale)

    @property
    def posteriors(self) -> jax.Array:
        """(B, L, M) final section posteriors (= beta / sqrt(n P_l))."""
        return self.beta / self.sq_npl[None, :, None]

    @property
    def scores(self) -> jax.Array:
        """(B, L, M) log-posteriors; the smallest-normal floor bounds the
        effective clip at ~87 nats >> the BP llr_clip, so it is inert."""
        p = self.posteriors
        return jnp.log(jnp.maximum(p, jnp.finfo(p.dtype).tiny))


def amp_decode(
    y: jax.Array,                 # (B, n)
    op: BatchedOperator,
    sq_npl: jax.Array,            # (L,) sqrt(n P_l)
    P: float,
    n: int,
    T: int,
    tol: float = 1e-6,
    tau2_schedule: Optional[jax.Array] = None,   # (T,) SE schedule
    pinned_onehot: Optional[jax.Array] = None,   # (B, L, M) one-hot targets
    pinned_mask: Optional[jax.Array] = None,     # (B, L) bool
    pinned_idx: Optional[jax.Array] = None,      # (B, L) int32 pin targets
                                                 # (alternative to onehot)
    policy=None,                                 # parallel.mesh.ShardingPolicy
    residual_space: str = "n",
) -> AmpResult:
    B = y.shape[0]
    L = sq_npl.shape[0]
    ML = op.ML
    M = ML // L

    c_bml = policy.constrain_bml if policy is not None else (lambda x: x)
    c_blm = policy.constrain_blm if policy is not None else (lambda x: x)
    c_bn = policy.constrain_bn if policy is not None else (lambda x: x)

    def apply_pin(beta3):
        if pinned_mask is None:
            return beta3
        oh = (pinned_onehot if pinned_onehot is not None
              else jax.nn.one_hot(pinned_idx, M, dtype=jnp.float32))
        m = pinned_mask[:, :, None]
        return jnp.where(m, sq_npl[None, :, None] * oh, beta3)

    # N-space residual path (BatchedOperator docstring): fast-transform
    # operators keep z in the length-N transform domain, which removes the
    # per-iteration row gather/scatter.  Mathematically identical (off-row
    # entries are exactly zero).
    n_space = op.embed_y is not None and residual_space == "N"
    yN = op.embed_y(y) if n_space else None

    def step(state, t):
        beta, z, tau2_prev, done, iters = state
        beta = c_bml(beta)
        # named scopes label the profiler's device events by stage
        # (scripts/stage_profile.py)
        with jax.named_scope("onsager_denoise"):
            bnorm2 = jnp.sum(beta * beta, axis=-1)  # psum over section shards
            coef = (P - bnorm2 / n) / tau2_prev         # 0 at t=0 (inf)
        with jax.named_scope("amp_transform"):
            if n_space:
                # zN is section-shardable like beta (same coefficient
                # layout), so section sharding needs no residual all-gather.
                z_new = c_bml(op.resid_n(yN, beta, z, coef[:, None]))
            else:
                z_new = c_bn(y - op.Ax(beta) + z * coef[:, None])
        with jax.named_scope("onsager_denoise"):
            if tau2_schedule is None:
                tau2 = jnp.sum(z_new * z_new, axis=-1) / n      # (B,)
            else:
                tau2 = jnp.full((B,), tau2_schedule[t], dtype=y.dtype)
        with jax.named_scope("amp_transform"):
            adj = op.adj_n(z_new) if n_space else op.Ay(z_new)
        with jax.named_scope("onsager_denoise"):
            s_new = c_blm((beta + adj).reshape(B, L, M))
            beta3, _ = denoise(s_new, tau2, sq_npl)
            beta3 = apply_pin(beta3)
        # schedule mode has no online tau to compare (a scheduled tau2
        # plateau would freeze every codeword at once), so it never stops
        # early.
        if tau2_schedule is None:
            conv = jnp.abs(tau2 - tau2_prev) < tol * tau2
        else:
            conv = jnp.zeros_like(done)
        # freeze codewords that were already done before this iteration
        keep = done
        k1 = keep[:, None]
        out = (
            jnp.where(k1, beta, beta3.reshape(B, ML)),
            jnp.where(k1, z, z_new),
            jnp.where(keep, tau2_prev, tau2),
            keep | conv,
            iters + jnp.where(keep, 0, 1).astype(iters.dtype),
        )
        return out, jnp.where(keep, tau2_prev, tau2)

    beta0 = jnp.zeros((B, ML), dtype=y.dtype)
    z0 = jnp.zeros((B, op.N) if n_space else y.shape, dtype=y.dtype)
    tau20 = jnp.full((B,), jnp.inf, dtype=y.dtype)
    done0 = jnp.zeros((B,), dtype=bool)
    it0 = jnp.zeros((B,), dtype=jnp.int32)

    (beta, z, tau2, done, iters), trace = jax.lax.scan(
        step, (beta0, z0, tau20, done0, it0), jnp.arange(T))

    beta3 = beta.reshape(B, L, M)
    return AmpResult(beta=beta3, tau2_trace=trace, iters=iters,
                     sq_npl=sq_npl)


def hard_indices(scores_or_beta: jax.Array) -> jax.Array:
    """argmax per section: (B, L, M) -> (B, L) (App. A.5 hard decision).

    Valid on beta, posteriors, or scores — all share the sectionwise argmax.
    """
    return jnp.argmax(scores_or_beta, axis=-1).astype(jnp.int32)
