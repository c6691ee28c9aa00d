"""SPARC codec pipeline: encode -> channel -> AMP decode -> errors.

SURVEY.md §3.1/§3.2 and the L4->L5 contract
(`run_trial(rng, params) -> {bit_errors, frame_error, iters}`).

`SparcModel` bundles a config with its device constants (operator index
sets, power allocation) so the whole trial is one jittable, vmap-free
*batched* function: every stage is written over a leading codeword batch
axis, which is the 'data' mesh axis at scale (SURVEY.md §2 parallelism
breakdown: DP is the primary axis).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SparcConfig
from ..design.power import power_allocation
from ..design.se import se_trajectory
from ..utils import rng as rngu
from ..utils.bits import bits_to_indices, indices_to_bits
from ..ops.operators import BatchedOperator, make_operator
from .amp import AmpResult, amp_decode, hard_indices


@dataclass(frozen=True)
class SparcModel:
    """A SPARC codebook instantiated on device for one operating point.

    The power allocation depends on sigma2 for the SE-derived kinds, so a
    model is built per (config, ebno) pair; building is host-side and cheap
    relative to campaigns.
    """
    cfg: SparcConfig
    ebno_db: float
    sigma2: float
    p_alloc: np.ndarray                 # host copy (design-time truth)
    sq_npl: jax.Array                   # (L,) sqrt(n P_l) device constant
    op: BatchedOperator
    tau2_schedule: Optional[jax.Array]  # (T,) when cfg.tau_mode == "se"
    policy: object = None               # parallel.mesh.ShardingPolicy | None

    @staticmethod
    def build(cfg: SparcConfig, ebno_db: float,
              policy=None) -> "SparcModel":
        sigma2 = cfg.sigma2(ebno_db)
        p = power_allocation(cfg.power_alloc, cfg.L, cfg.P, sigma2,
                             cfg.n, cfg.M, cfg.pa_a, cfg.pa_f)
        if cfg.amp_iters_auto:
            from dataclasses import replace
            from ..design.se import se_converged_iters
            t_se = se_converged_iters(p, cfg.n, cfg.M, sigma2,
                                      tol=cfg.amp_auto_tol,
                                      T_max=cfg.amp_iters,
                                      margin=cfg.amp_auto_margin)
            cfg = replace(cfg, amp_iters=t_se)
        sched = None
        if cfg.tau_mode == "se":
            tr = se_trajectory(p, cfg.n, cfg.M, sigma2, T=cfg.amp_iters)
            sched = jnp.asarray(
                np.pad(tr[1:], (0, max(0, cfg.amp_iters - len(tr) + 1)),
                       mode="edge")[: cfg.amp_iters], dtype=jnp.float32)
        return SparcModel(
            cfg=cfg, ebno_db=ebno_db, sigma2=sigma2, p_alloc=p,
            sq_npl=jnp.asarray(np.sqrt(cfg.n * p), dtype=jnp.float32),
            op=make_operator(cfg, policy=policy),
            tau2_schedule=sched, policy=policy)

    # ------------------------------------------------------------- encode

    def build_beta(self, indices: jax.Array,
                   sq_npl: Optional[jax.Array] = None) -> jax.Array:
        """(B, L) indices -> (B, ML) beta via one-hot scatter (App. A.1).

        sq_npl overrides the model constant so shared-compile sweeps can
        pass the per-point power allocation as a traced argument."""
        sq = self.sq_npl if sq_npl is None else sq_npl
        onehot = jax.nn.one_hot(indices, self.cfg.M, dtype=jnp.float32)
        beta = sq[None, :, None] * onehot
        return beta.reshape(indices.shape[0], self.cfg.ML)

    def encode(self, bits: jax.Array) -> jax.Array:
        """(B, k_bits) -> (B, n) codewords (SURVEY.md §3.1)."""
        idx = bits_to_indices(bits, self.cfg.logM)
        return self.op.Ax(self.build_beta(idx))

    def channel(self, x: jax.Array, key: jax.Array) -> jax.Array:
        noise = jax.random.normal(key, x.shape, dtype=x.dtype)
        return x + noise * math.sqrt(self.sigma2)

    # ------------------------------------------------------------- decode

    def decode(self, y: jax.Array, T: Optional[int] = None,
               sq_npl: Optional[jax.Array] = None,
               **amp_kw) -> AmpResult:
        return amp_decode(
            y, self.op, self.sq_npl if sq_npl is None else sq_npl,
            self.cfg.P, self.cfg.n,
            T=T or self.cfg.amp_iters, tol=self.cfg.amp_tol,
            tau2_schedule=self.tau2_schedule, policy=self.policy,
            residual_space=self.cfg.amp_residual_space, **amp_kw)

    def decode_bits(self, y: jax.Array) -> jax.Array:
        res = self.decode(y)
        return indices_to_bits(hard_indices(res.beta), self.cfg.logM)

    # -------------------------------------------------------------- trial

    def run_trials(self, key: jax.Array, batch: int) -> Dict[str, jax.Array]:
        """Full batched Monte-Carlo block: encode->channel->decode->count.

        Key discipline (App. A.8): per-trial keys are fold_in(block_key, i);
        message and noise keys are positional folds of the trial key, so
        results are independent of batch partitioning / sharding.
        """
        return self.run_block(rngu.trial_keys(key, batch))

    def run_block(self, tkeys: jax.Array) -> Dict[str, jax.Array]:
        """Same as run_trials but takes the (B,) per-trial key array —
        the campaign driver shards it over the 'data' mesh axis and jits
        this function (SURVEY.md §3.5)."""
        return self.run_block_params(tkeys, self.sq_npl,
                                     jnp.float32(math.sqrt(self.sigma2)))

    def run_block_params(self, tkeys: jax.Array, sq_npl: jax.Array,
                         sigma: jax.Array) -> Dict[str, jax.Array]:
        """run_block with the per-operating-point device parameters as
        ARGUMENTS instead of closure constants, so one jit compilation
        serves every Eb/N0 point of a sweep (see SparcSweep; only sq_npl
        and sigma vary across points for online-tau configs)."""
        bits, idx_true, res = self.decode_block(tkeys, sq_npl, sigma)
        idx_hat = hard_indices(res.beta)
        bits_hat = indices_to_bits(idx_hat, self.cfg.logM)
        bit_errors = jnp.sum(bits != bits_hat, axis=-1)         # (B,)
        section_errors = jnp.sum(idx_true != idx_hat, axis=-1)  # (B,)
        return dict(
            bit_errors=jnp.sum(bit_errors),
            # sum of squared per-frame bit errors: bit errors cluster within
            # frames, so honest BER confidence intervals need the
            # frame-level second moment, not a bit-level binomial
            # (scripts/ber_parity.py)
            bit_errors_sq=jnp.sum(bit_errors.astype(jnp.float32) ** 2),
            frame_errors=jnp.sum(bit_errors > 0),
            section_errors=jnp.sum(section_errors),
            trials=jnp.asarray(tkeys.shape[0], dtype=jnp.int32),
            iters_sum=jnp.sum(res.iters),
            tau2_final=jnp.mean(res.tau2_trace[-1]),
        )

    def decode_block(self, tkeys: jax.Array, sq_npl: jax.Array,
                     sigma: jax.Array):
        """(bits, true section indices, AmpResult) of the block that
        run_block_params counts: the same trials, decoded the same way."""
        with jax.named_scope("trial_gen"):
            mkeys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(tkeys)
            nkeys = jax.vmap(lambda k: jax.random.fold_in(k, 1))(tkeys)
            bits = jax.vmap(
                lambda k: jax.random.bernoulli(k, 0.5, (self.cfg.k_bits,))
            )(mkeys).astype(jnp.int32)
            idx_true = bits_to_indices(bits, self.cfg.logM)
            noise = jax.vmap(
                lambda k: jax.random.normal(k, (self.cfg.n,),
                                            dtype=jnp.float32))(nkeys)
            y = (self.op.Ax(self.build_beta(idx_true, sq_npl))
                 + noise * sigma)
        return bits, idx_true, self.decode(y, sq_npl=sq_npl)


class SparcSweep:
    """Shared-compile sweep helper: one jitted block function reused across
    every Eb/N0 point (the per-point sq_npl / sigma are arguments, not
    closure constants — compiles once instead of once per point).

    Only valid for online-tau configs (an SE tau schedule is itself
    point-dependent and static-shaped; those fall back to per-point jits).
    """

    def __init__(self, cfg: SparcConfig, policy=None):
        self.cfg = cfg
        self.policy = policy
        # jit cache keyed by the effective iteration count: amp_iters_auto
        # gives each point its own SE-derived T (a static shape), so points
        # share compilations per distinct T instead of one global jit.
        self._jitted = {}

    class _Point:
        def __init__(self, sweep, model):
            self._sweep = sweep
            self.model = model
            self.cfg = model.cfg

        def run_block(self, tkeys):
            (_, fn, args), = self.programs(tkeys)
            return fn(*args)
        run_block._prejitted = True  # campaign must not re-jit

        def programs(self, tkeys):
            """[(stage, jitted fn, args)] of one block (one stage here),
            for AOT compilation and profiling."""
            return [("block", self._sweep._jitted[self.cfg.amp_iters],
                     (tkeys, self.model.sq_npl,
                      jnp.float32(math.sqrt(self.model.sigma2))))]

    def model_for_point(self, ebno_db: float) -> "SparcSweep._Point":
        model = SparcModel.build(self.cfg, ebno_db, policy=self.policy)
        if self.cfg.tau_mode != "online":
            return model          # point-specific schedule: per-point jit
        t_eff = model.cfg.amp_iters
        if t_eff not in self._jitted:
            self._jitted[t_eff] = jax.jit(model.run_block_params)
        return SparcSweep._Point(self, model)
