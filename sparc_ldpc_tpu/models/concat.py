"""Concatenated SPARC + LDPC pipeline (SURVEY.md §3.3, App. A.7).

Section partition: the first Lu sections are unprotected; the last Lp carry
LDPC codeword bits (num_cw codewords back to back).  Lp is derived from the
requested protected fraction so that num_cw * ldpc.n is a whole number of
sections (num_cw * n ≡ 0 mod logM) — sections stay shard-aligned with the
LDPC partition (SURVEY.md §3.3 boundary note).

Decode chain:
  1. full AMP -> final beta (= sq_npl * section posteriors);
  2. bitwise LLRs over protected sections by pair-fold sums over beta
     (the per-section scale cancels, so no (B, L, M) log-scores tensor
     is ever built — _protected_llrs_from_beta);
  3. flooding BP (ops.bp);
  4. harden -> protected section indices;
  5. decision feedback: re-run AMP with protected sections *pinned* to
     their hardened one-hots in the denoiser (soft-output pass);
  6. final argmax for unprotected sections from the feedback pass.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import ConcatConfig
from ..utils import rng as rngu
from ..utils.bits import bits_to_indices, indices_to_bits
from .amp import hard_indices
from .ldpc import LdpcModel
from .sparc import SparcModel


def _derive_partition(L: int, logM: int, ldpc_n: int, f_prot: float
                      ) -> Tuple[int, int, int]:
    """(Lu, Lp, num_cw) with num_cw*ldpc_n == Lp*logM exactly."""
    target_bits = int(round(f_prot * L)) * logM
    num_cw = target_bits // ldpc_n
    while num_cw > 0 and (num_cw * ldpc_n) % logM != 0:
        num_cw -= 1
    if num_cw == 0:
        raise ValueError(
            f"cannot fit an LDPC codeword (n={ldpc_n}) into "
            f"{target_bits} protected bits with logM={logM}")
    Lp = (num_cw * ldpc_n) // logM
    return L - Lp, Lp, num_cw


@dataclass(frozen=True)
class ConcatModel:
    """SPARC inner code + LDPC outer code at one operating point."""
    cfg: ConcatConfig
    sparc: SparcModel
    ldpc: LdpcModel
    Lu: int                  # unprotected sections
    Lp: int                  # protected sections
    num_cw: int              # LDPC codewords per SPARC frame
    # lazy per-stage jit cache (mutable holder inside a frozen dataclass)
    _jits: dict = field(default_factory=dict)

    @staticmethod
    def build(cfg: ConcatConfig, ebno_db: float,
              policy=None) -> "ConcatModel":
        sparc = SparcModel.build(cfg.sparc, ebno_db, policy=policy)
        ldpc = LdpcModel.build(cfg.ldpc)
        Lu, Lp, num_cw = _derive_partition(
            cfg.sparc.L, cfg.sparc.logM, ldpc.n, cfg.f_prot)
        return ConcatModel(cfg=cfg, sparc=sparc, ldpc=ldpc, Lu=Lu, Lp=Lp,
                           num_cw=num_cw)

    @property
    def k_user(self) -> int:
        """User payload bits per frame (unprotected + LDPC messages)."""
        return self.Lu * self.cfg.sparc.logM + self.num_cw * self.ldpc.k

    @property
    def overall_rate(self) -> float:
        return self.k_user / self.sparc.cfg.n

    # ------------------------------------------------------------- encode

    def encode(self, user_bits: jax.Array,
               sq_npl: Optional[jax.Array] = None) -> jax.Array:
        """(B, k_user) -> (B, n) channel codewords.

        sq_npl overrides the power-allocation constant (shared-compile
        sweeps pass it as a traced argument — see ConcatSweep)."""
        idx = self._true_indices(user_bits)
        return self.sparc.op.Ax(self.sparc.build_beta(idx, sq_npl))

    def _true_indices(self, user_bits: jax.Array) -> jax.Array:
        """(B, k_user) -> (B, L) per-section true indices (unprot split ->
        LDPC encode -> concat -> bits_to_indices)."""
        B = user_bits.shape[0]
        logM = self.cfg.sparc.logM
        nu = self.Lu * logM
        unprot = user_bits[:, :nu]
        msgs = user_bits[:, nu:].reshape(B * self.num_cw, self.ldpc.k)
        cw = self.ldpc.encode(msgs).reshape(B, self.num_cw * self.ldpc.n)
        return bits_to_indices(jnp.concatenate([unprot, cw], axis=1), logM)

    # ------------------------------------------------------------- decode

    def _protected_llrs(self, scores: jax.Array) -> jax.Array:
        """Log-posterior scores -> bitwise LLRs for protected sections.

        a_{l,j} = log p_{l,j} (any per-section shift cancels in the lse
        difference); llr_b = lse_{j: bit_b(j)=0} a - lse_{j: bit_b(j)=1} a.
        Returns (B, Lp*logM).

        Exp-once form: the straightforward masked double logsumexp
        exponentiates two where-filled (B, Lp, logM, M) tensors — 2*logM*M
        transcendentals per section.  But every bit-set sum is a sum over
        e = exp(a - amax) computed ONCE: bit k (LSB) partitions the index
        axis into even/odd pairs, and folding pairs level by level yields
        all logM (s0, s1) masked-sum pairs in ~3M adds total — no masked
        fills, M exps instead of 2*logM*M.  Both sums are direct (never
        total - s1), so there is no cancellation; values differ from the
        lse form only by f32 reassociation (verified ~1e-6 abs against
        both the lse form and a float64 ground truth).  Bit b of the
        MSB-first convention (utils/bits.py) is LSB level logM-1-b.
        The shipped trial paths go one step further and fold the AMP
        beta directly (_protected_llrs_from_beta — the parity artifacts
        are anchored on that route); this scores form remains for the
        public decode-from-scores surface and comparison tooling.
        """
        a = scores[:, self.Lu:, :]                            # (B, Lp, M)
        amax = jnp.max(a, axis=-1, keepdims=True)
        return self._llr_fold(jnp.exp(a - amax))

    def _llr_fold(self, w: jax.Array) -> jax.Array:
        """(B, Lp, M) nonnegative section weights -> (B, Lp*logM) LLRs.

        llr_b = log sum_{bit_b(j)=0} w_j - log sum_{bit_b(j)=1} w_j —
        any per-section scale (softmax normalizer, the sq_npl amplitude
        in beta) cancels in the difference, so the fold accepts
        exp-shifted posteriors AND raw beta rows alike.  Sums are
        floored at f32 tiny before the log: inert for the exp form
        (every term >= exp(log tiny) is normal), and for the beta form
        it reproduces the score path's effective ~87-nat clip when a
        whole bit-set's mass underflows to zero — far beyond the BP
        llr_clip either way.
        """
        B = w.shape[0]
        logM = self.cfg.sparc.logM
        s0 = [None] * logM
        s1 = [None] * logM
        cur = w
        for k in range(logM):                                 # fold LSB up
            cur = cur.reshape(B, self.Lp, -1, 2)
            p0, p1 = cur[..., 0], cur[..., 1]
            s0[logM - 1 - k] = jnp.sum(p0, axis=-1)
            s1[logM - 1 - k] = jnp.sum(p1, axis=-1)
            cur = p0 + p1
        tiny = jnp.finfo(jnp.float32).tiny
        llr = (jnp.log(jnp.maximum(jnp.stack(s0, axis=-1), tiny))
               - jnp.log(jnp.maximum(jnp.stack(s1, axis=-1), tiny)))
        return llr.reshape(B, self.Lp * logM)

    @jax.named_scope("llr_bp")
    def _protected_llrs_from_beta(self, beta: jax.Array) -> jax.Array:
        """(B, L, M) final AMP beta -> (B, Lp*logM) LLRs, directly.

        beta_l = sq_npl[l] * posterior_l and the scale cancels in the
        fold, so the whole scores tensor (a (B, L, M) log over the
        posterior floor) never needs to exist: the shipped trial paths
        hand the AMP beta straight to the fold, which is pure streaming
        adds (no log/div, no exp).
        """
        return self._llr_fold(beta[:, self.Lu:, :])

    def _bp_from_scores(self, scores: jax.Array):
        """(2)-(4): scores -> hardened codeword bits + per-cw ok flags."""
        return self._bp_from_llr(self._protected_llrs(scores))

    def _bp_from_beta(self, beta: jax.Array):
        """(2)-(4) from the AMP beta directly (the shipped trial paths):
        skips the (B, L, M) scores tensor entirely — see
        _protected_llrs_from_beta."""
        return self._bp_from_llr(self._protected_llrs_from_beta(beta))

    @jax.named_scope("llr_bp")
    def _bp_from_llr(self, llr: jax.Array):
        B = llr.shape[0]
        llr = llr.reshape(B * self.num_cw, self.ldpc.n)
        bp = self.ldpc.decode(llr)
        # BP that fails the syndrome check can be *worse* than the channel
        # (min-sum diverges on garbage LLRs); fall back to the channel hard
        # decision per codeword in that case.
        chan_hard = (llr < 0).astype(jnp.uint8)
        cw_bits = jnp.where(bp.ok[:, None], bp.hard, chan_hard)
        cw_hat = cw_bits.reshape(B, self.num_cw * self.ldpc.n)
        return cw_hat, bp.ok.reshape(B, self.num_cw), bp.iters.reshape(B, -1)

    @jax.named_scope("feedback")
    def _feedback_user_bits(self, y: jax.Array, cw_hat: jax.Array,
                            ok: jax.Array,
                            sq_npl: Optional[jax.Array] = None
                            ) -> jax.Array:
        """(5)-(6): gated pinned re-AMP -> assembled user bits (B, k_user).

        Only sections whose bits all come from syndrome-verified codewords
        are pinned: pinning a wrongly-decoded codeword poisons the AMP
        re-pass (observed: 27% vs 8% unprotected BER), while gating on
        bp.ok makes failed frames fall back to plain-AMP quality and
        decoded frames typically become error-free.
        """
        B = cw_hat.shape[0]
        logM = self.cfg.sparc.logM
        prot_idx = bits_to_indices(cw_hat, logM)              # (B, Lp)
        bit_ok = jnp.repeat(ok, self.ldpc.n, axis=1)          # (B, Lp*logM)
        sec_ok = jnp.all(bit_ok.reshape(B, self.Lp, logM), axis=-1)
        pin_mask = jnp.concatenate(
            [jnp.zeros((B, self.Lu), bool), sec_ok], axis=1)
        full_idx = jnp.concatenate(
            [jnp.zeros((B, self.Lu), jnp.int32), prot_idx], axis=1)
        # pin targets travel as indices; amp_decode builds the one-hot
        # rows at apply_pin
        res2 = self.sparc.decode(
            y, T=self.cfg.feedback_iters, sq_npl=sq_npl,
            pinned_idx=full_idx, pinned_mask=pin_mask)
        unprot_idx = hard_indices(res2.beta)[:, : self.Lu]
        unprot_bits = indices_to_bits(unprot_idx, logM)
        msg_bits = self.ldpc.extract_message(
            cw_hat.reshape(B * self.num_cw, self.ldpc.n)
        ).reshape(B, self.num_cw * self.ldpc.k)
        return jnp.concatenate([unprot_bits, msg_bits], axis=1)

    def decode(self, y: jax.Array) -> Dict[str, jax.Array]:
        """Full concatenated decode; returns user bits + diagnostics."""
        res = self.sparc.decode(y)
        cw_hat, ok, bp_iters = self._bp_from_beta(res.beta)
        user_hat = self._feedback_user_bits(y, cw_hat, ok)
        return dict(user_bits=user_hat, bp_ok=ok,
                    amp_iters=res.iters, bp_iters=bp_iters,
                    tau2_final=res.tau2_trace[-1])

    # -------------------------------------------------------------- trial

    def run_trials(self, key: jax.Array, batch: int) -> Dict[str, jax.Array]:
        """Batched end-to-end Monte-Carlo block (SURVEY.md §3.5 inner body)."""
        return self.run_block(rngu.trial_keys(key, batch))

    # ---------------------------------------------------- staged execution
    #
    # The staged runner compiles three bounded programs (generate + inner
    # AMP, LLR + BP, feedback AMP + count) instead of one monolith of the
    # whole chain, and keeps all intermediates on device.  Counters are
    # identical to run_block (tests/test_parallel.py).

    def _stage_gen_amp(self, tkeys: jax.Array):
        return self._stage_gen_amp_params(
            tkeys, self.sparc.sq_npl,
            jnp.float32(math.sqrt(self.sparc.sigma2)))

    def _stage_gen_amp_params(self, tkeys: jax.Array, sq_npl: jax.Array,
                              sigma: jax.Array):
        """Stage 1 with the per-operating-point device parameters as
        ARGUMENTS (sq_npl, sigma) instead of closure constants, so one jit
        serves every Eb/N0 point of a sweep (ConcatSweep; mirrors
        SparcModel.run_block_params)."""
        bits, y = self._gen(tkeys, sq_npl, sigma)
        res = self.sparc.decode(y, sq_npl=sq_npl)
        return bits, y, res.beta, res.iters

    @jax.named_scope("trial_gen")
    def _gen(self, tkeys: jax.Array, sq_npl: jax.Array, sigma):
        """(B,) trial keys -> user bits (B, k_user) and channel output."""
        mkeys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(tkeys)
        nkeys = jax.vmap(lambda k: jax.random.fold_in(k, 1))(tkeys)
        bits = jax.vmap(
            lambda k: jax.random.bernoulli(k, 0.5, (self.k_user,))
        )(mkeys).astype(jnp.int32)
        noise = jax.vmap(
            lambda k: jax.random.normal(k, (self.sparc.cfg.n,),
                                        dtype=jnp.float32))(nkeys)
        return bits, self.encode(bits, sq_npl) + noise * sigma

    def _stage_finish(self, y, cw_hat, ok, bits, amp_iters):
        return self._stage_finish_params(y, cw_hat, ok, bits, amp_iters,
                                         self.sparc.sq_npl)

    def _stage_finish_params(self, y, cw_hat, ok, bits, amp_iters, sq_npl):
        user_hat = self._feedback_user_bits(y, cw_hat, ok, sq_npl)
        return self._count(bits, user_hat, ok, amp_iters)

    @staticmethod
    def _count(bits, user_hat, ok, amp_iters) -> Dict[str, jax.Array]:
        bit_errors = jnp.sum(bits != user_hat, axis=-1)
        return dict(
            bit_errors=jnp.sum(bit_errors),
            # frame-level second moment for cluster-robust BER CIs
            # (scripts/ber_parity.py; campaign journals carry it too)
            bit_errors_sq=jnp.sum(bit_errors.astype(jnp.float32) ** 2),
            frame_errors=jnp.sum(bit_errors > 0),
            trials=jnp.asarray(bits.shape[0], dtype=jnp.int32),
            bp_ok=jnp.sum(ok),
            iters_sum=jnp.sum(amp_iters),
        )

    def _jit(self, name, fn):
        if name not in self._jits:
            self._jits[name] = jax.jit(fn)
        return self._jits[name]

    def run_block_staged(self, tkeys: jax.Array) -> Dict[str, jax.Array]:
        """Three bounded jits instead of one monolith (see note above)."""
        bits, y, beta, iters = self._jit("s1", self._stage_gen_amp)(tkeys)
        cw_hat, ok, _ = self._jit("s2", self._bp_from_beta)(beta)
        return self._jit("s3", self._stage_finish)(y, cw_hat, ok, bits,
                                                   iters)
    run_block_staged._prejitted = True   # campaign must not wrap in jit

    def run_block(self, tkeys: jax.Array) -> Dict[str, jax.Array]:
        bits, y = self._gen(tkeys, self.sparc.sq_npl,
                            math.sqrt(self.sparc.sigma2))
        out = self.decode(y)
        return self._count(bits, out["user_bits"], out["bp_ok"],
                           out["amp_iters"])


class ConcatSweep:
    """Shared-compile sweep helper for the concat chain (mirrors
    SparcSweep for ConcatModel).

    ConcatModel.run_block_staged rebuilds its three staged jits per Eb/N0
    point, so a multi-point concat campaign would be compile-dominated.
    Here the per-point device parameters (sq_npl, sigma) are ARGUMENTS to the
    staged functions, so each stage compiles once per distinct effective
    iteration count instead of once per point:

      s1 (gen+encode+inner AMP)  keyed by T_eff (amp_iters_auto can give
                                 each point its own static T)
      s2 (LLR extract + BP)      point-independent, one compile total
      s3 (feedback AMP + count)  point-independent, one compile total

    Only valid for online-tau configs (an SE tau schedule is itself
    point-dependent and static-shaped); those fall back to per-point
    models, exactly like SparcSweep.
    """

    def __init__(self, cfg: ConcatConfig, policy=None):
        self.cfg = cfg
        self.policy = policy
        self._jits: dict = {}

    def _jit(self, key, fn):
        if key not in self._jits:
            self._jits[key] = jax.jit(fn)
        return self._jits[key]

    class _Point:
        def __init__(self, sweep: "ConcatSweep", model: ConcatModel):
            self._sweep = sweep
            self.model = model
            self.cfg = model.cfg

        @property
        def k_user(self) -> int:
            return self.model.k_user

        def _stages(self):
            # the cached jits are bound to the FIRST point's model; every
            # closure constant other than (sq_npl, sigma) — operator index
            # sets, LDPC arrays, partition, P, n — is point-independent by
            # construction (seeds derive from the config, not ebno)
            m, sw = self.model, self._sweep
            return (sw._jit(("s1", m.sparc.cfg.amp_iters),
                            m._stage_gen_amp_params),
                    sw._jit("s2", m._bp_from_beta),
                    sw._jit("s3", m._stage_finish_params),
                    m.sparc.sq_npl, jnp.float32(math.sqrt(m.sparc.sigma2)))

        def run_block_staged(self, tkeys):
            s1, s2, s3, sq, sigma = self._stages()
            bits, y, beta, iters = s1(tkeys, sq, sigma)
            cw_hat, ok, _ = s2(beta)
            return s3(y, cw_hat, ok, bits, iters, sq)
        run_block_staged._prejitted = True   # campaign must not re-jit

        def programs(self, tkeys):
            """[(stage, jitted fn, args)] of one block, for AOT compilation
            and profiling; later stages get abstract (ShapeDtypeStruct)
            arguments, which lowering accepts."""
            s1, s2, s3, sq, sigma = self._stages()
            bits, y, beta, iters = jax.eval_shape(s1, tkeys, sq, sigma)
            cw_hat, ok, _ = jax.eval_shape(s2, beta)
            return [("s1_gen_amp", s1, (tkeys, sq, sigma)),
                    ("s2_llr_bp", s2, (beta,)),
                    ("s3_feedback", s3, (y, cw_hat, ok, bits, iters, sq))]

    def model_for_point(self, ebno_db: float) -> object:
        model = ConcatModel.build(self.cfg, ebno_db, policy=self.policy)
        if model.sparc.cfg.tau_mode != "online":
            return model          # point-specific schedule: per-point jits
        return ConcatSweep._Point(self, model)
