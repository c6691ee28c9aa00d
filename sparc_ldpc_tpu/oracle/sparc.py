"""NumPy float64 oracle: SPARC encode, measurement operators, AMP decode.

Implements SURVEY.md Appendix A.1/A.3/A.4/A.5 exactly, independently of the
JAX path (parity tests compare the two — SURVEY.md §4.1).  Single codeword
per call; vectorization is the JAX path's job.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
from scipy.fft import dct as _dct, idct as _idct

from ..config import SparcConfig
from ..design.codebook import hadamard_plan, dct_plan
from ..design.power import power_allocation
from ..utils.bits import np_bits_to_indices, np_indices_to_bits
from .fwht import fwht


@dataclass
class Operator:
    """Forward/adjoint matvec pair (SURVEY.md §1 L2->L3 contract)."""
    Ax: Callable[[np.ndarray], np.ndarray]   # (ML,) -> (n,)
    Ay: Callable[[np.ndarray], np.ndarray]   # (n,)  -> (ML,)
    n: int
    ML: int


def dense_operator(cfg: SparcConfig, rng: Optional[np.random.Generator] = None) -> Operator:
    """Explicit A with iid N(0, 1/n) entries (App. A.3; small configs only)."""
    n, ML = cfg.n, cfg.ML
    rng = rng or np.random.default_rng(np.random.SeedSequence([0xDE45E, cfg.op_seed]))
    A = rng.standard_normal((n, ML)) / math.sqrt(n)
    return Operator(Ax=lambda b: A @ b, Ay=lambda z: A.T @ z, n=n, ML=ML)


def hadamard_operator(cfg: SparcConfig) -> Operator:
    """Matrix-free partial-Hadamard operator (App. A.3) via oracle FWHT."""
    plan = hadamard_plan(cfg.n, cfg.ML, cfg.op_seed, cfg.col_signs)
    N, rows, signs = plan.N, plan.rows, plan.signs
    inv_sqrt_n = 1.0 / math.sqrt(cfg.n)

    def Ax(beta: np.ndarray) -> np.ndarray:
        u = np.zeros(N, dtype=np.float64)
        u[:cfg.ML] = beta * signs if signs is not None else beta
        return fwht(u)[rows] * inv_sqrt_n

    def Ay(z: np.ndarray) -> np.ndarray:
        u = np.zeros(N, dtype=np.float64)
        u[rows] = z
        s = fwht(u)[:cfg.ML] * inv_sqrt_n
        return s * signs if signs is not None else s

    return Operator(Ax=Ax, Ay=Ay, n=cfg.n, ML=cfg.ML)


def dct_operator(cfg: SparcConfig) -> Operator:
    """Matrix-free subsampled orthonormal-DCT operator (App. A.3).

    Uses DCT-II/DCT-III (norm='ortho'), which are mutual adjoints, scaled by
    sqrt(N/n) so columns have unit norm in expectation.
    """
    plan = dct_plan(cfg.n, cfg.ML, cfg.op_seed, col_signs=True)
    N, rows, signs = plan.N, plan.rows, plan.signs
    scale = math.sqrt(N / cfg.n)

    def Ax(beta: np.ndarray) -> np.ndarray:
        u = np.zeros(N, dtype=np.float64)
        u[:cfg.ML] = beta * signs
        return _dct(u, norm="ortho")[rows] * scale

    def Ay(z: np.ndarray) -> np.ndarray:
        u = np.zeros(N, dtype=np.float64)
        u[rows] = z
        s = _idct(u, norm="ortho")[:cfg.ML] * scale
        return s * signs

    return Operator(Ax=Ax, Ay=Ay, n=cfg.n, ML=cfg.ML)


def make_operator(cfg: SparcConfig) -> Operator:
    if cfg.op_kind == "dense":
        return dense_operator(cfg)
    if cfg.op_kind == "hadamard":
        return hadamard_operator(cfg)
    if cfg.op_kind == "dct":
        return dct_operator(cfg)
    raise ValueError(cfg.op_kind)


# ----------------------------------------------------------------- encoding

def build_beta(indices: np.ndarray, p_alloc: np.ndarray, n: int, M: int) -> np.ndarray:
    """beta in R^{LM}: beta[(l)M + c_l] = sqrt(n P_l) (App. A.1)."""
    L = indices.shape[0]
    beta = np.zeros(L * M, dtype=np.float64)
    beta[np.arange(L) * M + indices] = np.sqrt(n * p_alloc)
    return beta


def encode(bits: np.ndarray, cfg: SparcConfig, p_alloc: np.ndarray,
           op: Operator) -> np.ndarray:
    """bits (k,) -> codeword x (n,) (SURVEY.md §3.1)."""
    idx = np_bits_to_indices(bits, cfg.logM)
    beta = build_beta(idx, p_alloc, cfg.n, cfg.M)
    return op.Ax(beta)


def awgn(x: np.ndarray, sigma2: float, rng: np.random.Generator) -> np.ndarray:
    return x + rng.standard_normal(x.shape) * math.sqrt(sigma2)


# ---------------------------------------------------------------- AMP decode

def denoise(s: np.ndarray, tau2: float, p_alloc: np.ndarray, n: int,
            M: int) -> np.ndarray:
    """Sectionwise posterior-mean softmax eta(s) (App. A.5), stabilized."""
    L = p_alloc.shape[0]
    sq = np.sqrt(n * p_alloc)[:, None]                     # (L, 1)
    a = sq * s.reshape(L, M) / tau2
    a -= a.max(axis=1, keepdims=True)
    e = np.exp(a)
    post = e / e.sum(axis=1, keepdims=True)
    return (sq * post).reshape(L * M), post


@dataclass
class AmpResult:
    beta: np.ndarray
    s: np.ndarray                 # final test statistic (argmax input)
    posteriors: np.ndarray        # (L, M) final section posteriors
    tau2_trace: np.ndarray
    iters: int


def amp_decode(y: np.ndarray, cfg: SparcConfig, p_alloc: np.ndarray,
               op: Operator, T: Optional[int] = None,
               tau2_schedule: Optional[np.ndarray] = None,
               pinned_idx: Optional[np.ndarray] = None,
               pinned_mask: Optional[np.ndarray] = None) -> AmpResult:
    """AMP loop per SURVEY.md App. A.5 (and A.7's pinned re-pass).

    pinned_mask (L,) bool + pinned_idx (L,) int: sections where the denoiser
    output is clamped to the known one-hot (decision feedback, App. A.7 (5)).
    """
    n, M, P = cfg.n, cfg.M, float(np.sum(p_alloc))
    L = p_alloc.shape[0]
    T = T if T is not None else cfg.amp_iters
    beta = np.zeros(cfg.ML, dtype=np.float64)
    z = np.zeros(n, dtype=np.float64)
    tau2_prev = np.inf
    trace = []
    s = beta
    post = np.full((L, M), 1.0 / M)
    it = 0
    for t in range(T):
        onsager = (z / tau2_prev) * (P - float(beta @ beta) / n) if np.isfinite(tau2_prev) else 0.0
        z = y - op.Ax(beta) + onsager
        tau2 = float(z @ z) / n if tau2_schedule is None else float(tau2_schedule[min(t, len(tau2_schedule) - 1)])
        trace.append(tau2)
        s = beta + op.Ay(z)
        beta, post = denoise(s, tau2, p_alloc, n, M)
        if pinned_mask is not None:
            sq = np.sqrt(n * p_alloc)
            onehot = np.zeros((L, M))
            onehot[np.arange(L), pinned_idx] = 1.0
            b2 = beta.reshape(L, M).copy()
            b2[pinned_mask] = (sq[:, None] * onehot)[pinned_mask]
            beta = b2.reshape(L * M)
            post = np.where(pinned_mask[:, None], onehot, post)
        it = t + 1
        if np.isfinite(tau2_prev) and abs(tau2 - tau2_prev) < cfg.amp_tol * tau2:
            break
        tau2_prev = tau2
    return AmpResult(beta=beta, s=s, posteriors=post,
                     tau2_trace=np.asarray(trace), iters=it)


def hard_decision(s: np.ndarray, L: int, M: int) -> np.ndarray:
    """argmax per section -> indices (App. A.5)."""
    return np.argmax(s.reshape(L, M), axis=1)


def decode_bits(s: np.ndarray, cfg: SparcConfig) -> np.ndarray:
    return np_indices_to_bits(hard_decision(s, cfg.L, cfg.M), cfg.logM)


# ------------------------------------------------------------------- trials

def run_trial(seed: int, cfg: SparcConfig, ebno_db: float,
              op: Optional[Operator] = None,
              p_alloc: Optional[np.ndarray] = None) -> dict:
    """encode -> AWGN -> AMP -> count errors (SURVEY.md §1 L4->L5 contract)."""
    sigma2 = cfg.sigma2(ebno_db)
    if p_alloc is None:
        p_alloc = power_allocation(cfg.power_alloc, cfg.L, cfg.P, sigma2,
                                   cfg.n, cfg.M, cfg.pa_a, cfg.pa_f)
    if op is None:
        op = make_operator(cfg)
    rng = np.random.default_rng(np.random.SeedSequence([0x7124A1, seed]))
    bits = rng.integers(0, 2, size=cfg.k_bits)
    x = encode(bits, cfg, p_alloc, op)
    y = awgn(x, sigma2, rng)
    res = amp_decode(y, cfg, p_alloc, op)
    bhat = decode_bits(res.s, cfg)
    idx_true = np_bits_to_indices(bits, cfg.logM)
    idx_hat = hard_decision(res.s, cfg.L, cfg.M)
    bit_errors = int(np.sum(bits != bhat))
    return dict(bit_errors=bit_errors,
                frame_error=int(bit_errors > 0),
                section_errors=int(np.sum(idx_true != idx_hat)),
                iters=res.iters,
                tau2_trace=res.tau2_trace)
