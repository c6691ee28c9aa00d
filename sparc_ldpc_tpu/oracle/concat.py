"""NumPy oracle for the full concatenated chain (SURVEY.md App. A.7).

Independent of models/concat.py — used to parity-test the JAX pipeline
end-to-end (encode -> AWGN -> AMP -> LLR -> BP -> decision feedback).
Mirrors the same partition rule (num_cw * ldpc_n == Lp * logM) and the same
bp_ok gating / channel-fallback policies so the two implementations are
comparable decision-for-decision.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..config import ConcatConfig
from ..design.ldpc_codes import (LdpcCode, adjacency, build_code,
                                 qc_structure)
from ..design.power import power_allocation
from ..utils.bits import np_bits_to_indices, np_indices_to_bits
from . import sparc as osparc
from .ldpc import bp_decode, bp_decode_layered


def derive_partition(L: int, logM: int, ldpc_n: int, f_prot: float):
    target_bits = int(round(f_prot * L)) * logM
    num_cw = target_bits // ldpc_n
    while num_cw > 0 and (num_cw * ldpc_n) % logM != 0:
        num_cw -= 1
    if num_cw == 0:
        raise ValueError("cannot fit an LDPC codeword")
    Lp = (num_cw * ldpc_n) // logM
    return L - Lp, Lp, num_cw


@dataclass
class OracleConcat:
    cfg: ConcatConfig
    sigma2: float
    p_alloc: np.ndarray
    op: osparc.Operator
    code: LdpcCode
    Lu: int
    Lp: int
    num_cw: int

    @staticmethod
    def build(cfg: ConcatConfig, ebno_db: float) -> "OracleConcat":
        s = cfg.sparc
        sigma2 = s.sigma2(ebno_db)
        p = power_allocation(s.power_alloc, s.L, s.P, sigma2, s.n, s.M,
                             s.pa_a, s.pa_f)
        code = build_code(cfg.ldpc)
        Lu, Lp, num_cw = derive_partition(s.L, s.logM, code.n, cfg.f_prot)
        return OracleConcat(cfg=cfg, sigma2=sigma2, p_alloc=p,
                            op=osparc.make_operator(s), code=code,
                            Lu=Lu, Lp=Lp, num_cw=num_cw)

    @property
    def k_user(self) -> int:
        return self.Lu * self.cfg.sparc.logM + self.num_cw * self.code.k

    def encode(self, user_bits: np.ndarray) -> np.ndarray:
        s = self.cfg.sparc
        nu = self.Lu * s.logM
        msgs = user_bits[nu:].reshape(self.num_cw, self.code.k)
        cw = self.code.encode(msgs).reshape(-1)
        all_bits = np.concatenate([user_bits[:nu], cw])
        return osparc.encode(all_bits, s, self.p_alloc, self.op)

    def decode(self, y: np.ndarray) -> np.ndarray:
        s = self.cfg.sparc
        logM, M = s.logM, s.M
        res = osparc.amp_decode(y, s, self.p_alloc, self.op)
        tau2 = res.tau2_trace[-1]
        # bitwise LLRs from log-posteriors over protected sections
        logp = np.log(np.maximum(res.posteriors[self.Lu:], 1e-300))
        j = np.arange(M)
        llrs = np.empty((self.Lp, logM))
        for b in range(logM):
            bit1 = ((j >> (logM - 1 - b)) & 1).astype(bool)
            a0 = logp[:, ~bit1]
            a1 = logp[:, bit1]
            llrs[:, b] = (_lse(a0) - _lse(a1))
        llr_flat = llrs.reshape(-1).reshape(self.num_cw, self.code.n)
        lc = self.cfg.ldpc
        # mirror the shipped decode schedule: row-layered MPA when the
        # preset configures it (the float64 twin of ops/bp_qc.py
        # layered), flooding otherwise
        layered = lc.schedule == "layered"
        if layered:
            qc = qc_structure(lc)
            assert qc is not None, "layered schedule requires a QC code"
        else:
            adj = adjacency(self.code.H)
        prot_bits = np.empty((self.num_cw, self.code.n), dtype=np.uint8)
        ok = np.zeros(self.num_cw, dtype=bool)
        for c in range(self.num_cw):
            if layered:
                hard, _, _ = bp_decode_layered(
                    llr_flat[c], self.code, qc[0], qc[1],
                    iters=lc.bp_iters, method=lc.decoder, alpha=lc.alpha,
                    beta=lc.beta, clip=lc.llr_clip)
            else:
                hard, _, _ = bp_decode(llr_flat[c], self.code,
                                       iters=lc.bp_iters,
                                       method=lc.decoder, alpha=lc.alpha,
                                       clip=lc.llr_clip, adj=adj)
            ok[c] = not np.any(self.code.syndrome(hard))
            prot_bits[c] = hard if ok[c] else (llr_flat[c] < 0).astype(np.uint8)
        # decision feedback: pin sections whose bits all come from ok cws
        bit_ok = np.repeat(ok, self.code.n).reshape(self.Lp, logM)
        sec_ok = bit_ok.all(axis=1)
        prot_idx = np_bits_to_indices(prot_bits.reshape(-1), logM)
        pin_mask = np.concatenate([np.zeros(self.Lu, bool), sec_ok])
        pin_idx = np.concatenate(
            [np.zeros(self.Lu, np.int64), prot_idx]).astype(np.int64)
        res2 = osparc.amp_decode(y, s, self.p_alloc, self.op,
                                 T=self.cfg.feedback_iters,
                                 pinned_idx=pin_idx, pinned_mask=pin_mask)
        unprot_idx = osparc.hard_decision(res2.s, s.L, M)[: self.Lu]
        unprot_bits = np_indices_to_bits(unprot_idx, logM)
        msg_bits = np.concatenate(
            [prot_bits[c][self.code.message_positions]
             for c in range(self.num_cw)])
        return np.concatenate([unprot_bits, msg_bits])

    def run_trial(self, seed: int) -> Dict[str, int]:
        rng = np.random.default_rng(np.random.SeedSequence([0xC0CA7, seed]))
        bits = rng.integers(0, 2, self.k_user)
        x = self.encode(bits)
        y = osparc.awgn(x, self.sigma2, rng)
        hat = self.decode(y)
        be = int(np.sum(bits != hat))
        return dict(bit_errors=be, frame_error=int(be > 0))


def _lse(a: np.ndarray) -> np.ndarray:
    m = a.max(axis=1, keepdims=True)
    return (m + np.log(np.exp(a - m).sum(axis=1, keepdims=True))).squeeze(1)
