"""NumPy oracle BP decoders: sum-product and normalized min-sum.

SURVEY.md App. A.6.  Flooding schedule, syndrome early stop, LLR clipping.
Convention: LLR lambda_v = log P(bit=0)/P(bit=1); a positive message votes
for bit 0.  Check node sign uses the tanh rule.  Independent of the JAX BP
in ops/bp.py (parity-tested).

`bp_decode_layered` is the float64 twin of the row-layered schedule the
shipped concat presets run on the QC engine (ops/bp_qc.py): block rows are swept sequentially within one iteration, with
variable totals refreshed after each layer.  Implemented over the circulant
(shifts, Z) structure with np.roll permutations — independent of the JAX
gather-tensor layout, message-parity-tested in tests/test_ldpc_qc.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..design.ldpc_codes import LdpcCode, Adjacency, adjacency


def bp_decode(llr: np.ndarray, code: LdpcCode, iters: int = 64,
              method: str = "minsum", alpha: float = 0.8125,
              beta: float = 0.15, clip: float = 20.0,
              adj: Optional[Adjacency] = None) -> Tuple[np.ndarray, np.ndarray, int]:
    """Flooding BP on one codeword.

    Returns (hard_bits, posterior_llr, iters_used).
    """
    adj = adj or adjacency(code.H)
    m, n = code.H.shape
    max_dc = adj.max_dc
    llr = np.clip(llr.astype(np.float64), -clip, clip)

    m_cv = np.zeros((m, max_dc))                     # check -> var messages
    tot = llr.copy()
    it_used = iters
    for it in range(iters):
        # variable -> check: tot[v] - m_cv for each edge
        v_of_edge = adj.check_nbr                     # (m, max_dc)
        m_vc = tot[v_of_edge] - m_cv                  # (m, max_dc)
        m_vc = np.clip(m_vc, -clip, clip)
        m_vc = np.where(adj.check_mask, m_vc, np.inf)  # pads neutral for min
        sign = np.where(adj.check_mask, np.sign(m_vc + (m_vc == 0)), 1.0)
        sign_prod = np.prod(sign, axis=1, keepdims=True)
        mag = np.abs(m_vc)
        if method in ("minsum", "oms"):
            # exclude-self min via (min1, min2)
            order = np.argsort(mag, axis=1)
            min1 = np.take_along_axis(mag, order[:, :1], axis=1)
            min2 = np.take_along_axis(mag, order[:, 1:2], axis=1)
            is_min1 = mag == min1
            exc_min = np.where(is_min1, min2, min1)
            if method == "oms":
                new_cv = (sign_prod * sign) * np.maximum(exc_min - beta, 0.0)
            else:
                new_cv = alpha * (sign_prod * sign) * exc_min
        elif method == "spa":
            phi = _phi(np.where(adj.check_mask, mag, np.inf))
            phi_sum = np.sum(np.where(adj.check_mask, phi, 0.0), axis=1,
                             keepdims=True)
            exc = _phi(np.maximum(phi_sum - phi, 1e-12))
            new_cv = (sign_prod * sign) * exc
        else:
            raise ValueError(method)
        m_cv = np.where(adj.check_mask, np.clip(new_cv, -clip, clip), 0.0)
        # total per variable: llr + sum of incoming check messages
        flat = m_cv.reshape(-1)
        incoming = np.where(adj.var_mask, flat[adj.var_edge], 0.0)
        tot = llr + incoming.sum(axis=1)
        hard = (tot < 0).astype(np.uint8)
        if not np.any(code.syndrome(hard)):
            it_used = it + 1
            break
    hard = (tot < 0).astype(np.uint8)
    return hard, tot, it_used


def _phi(x: np.ndarray) -> np.ndarray:
    """phi(x) = -log tanh(x/2), self-inverse, clipped for stability."""
    x = np.clip(x, 1e-12, 40.0)
    return -np.log(np.tanh(x / 2.0))


def bp_decode_layered(llr: np.ndarray, code: LdpcCode, shifts: np.ndarray,
                      Z: int, iters: int = 64, method: str = "minsum",
                      alpha: float = 0.8125, beta: float = 0.15,
                      clip: float = 20.0) -> Tuple[np.ndarray, np.ndarray, int]:
    """Row-layered BP on one codeword of a QC code (float64 oracle twin of
    ops.bp_qc's "layered" schedule).

    shifts: (J, K) circulant base matrix (-1 = zero block), Z: circulant
    size; variable order is k*Z + zv (the dense-H column order of
    design.ldpc_codes.qc_base_H).  Per block row j the current totals are
    read at the layer's check coordinates (roll by -shift), the extrinsic
    check update applied, and the refreshed totals written straight back
    (roll by +shift) — so later layers inside the same iteration see this
    layer's update, the defining property of layered MPA.  Clipping points
    mirror the JAX engine exactly: totals pass through clip(tot - m_cv)
    when re-assembled, including through zero blocks.

    Returns (hard_bits, posterior_llr, iters_used).
    """
    shifts = np.asarray(shifts, dtype=np.int64)
    J, K = shifts.shape
    llr = np.clip(llr.astype(np.float64), -clip, clip).reshape(K, Z)
    m_cv = np.zeros((J, K, Z))
    tot = llr.copy()
    it_used = iters
    for it in range(iters):
        for j in range(J):
            active = shifts[j] >= 0                       # (K,)
            sj = np.where(active, shifts[j], 0)
            # totals seen from check slot zc: tot[k, (zc + s) mod Z]
            tot_at = np.stack([np.roll(tot[k], -int(sj[k]))
                               for k in range(K)])
            m_vc = np.clip(tot_at - m_cv[j], -clip, clip)
            mag = np.where(active[:, None], np.abs(m_vc), np.inf)
            sign = np.where(active[:, None],
                            np.sign(m_vc + (m_vc == 0)), 1.0)
            sign_prod = np.prod(sign, axis=0, keepdims=True)
            if method in ("minsum", "oms"):
                order = np.argsort(mag, axis=0)
                min1 = np.take_along_axis(mag, order[:1], axis=0)
                min2 = np.take_along_axis(mag, order[1:2], axis=0)
                exc = np.where(mag == min1, min2, min1)
                if method == "oms":
                    new_cv = (sign_prod * sign) * np.maximum(exc - beta, 0.0)
                else:
                    new_cv = alpha * (sign_prod * sign) * exc
            elif method == "spa":
                ph = np.where(active[:, None], _phi(mag), 0.0)
                ph_sum = ph.sum(axis=0, keepdims=True)
                new_cv = (sign_prod * sign) * _phi(
                    np.maximum(ph_sum - ph, 1e-12))
            else:
                raise ValueError(method)
            new_cv = np.where(active[:, None],
                              np.clip(new_cv, -clip, clip), 0.0)
            tot_at_new = m_vc + new_cv
            tot = np.stack([np.roll(tot_at_new[k], int(sj[k]))
                            for k in range(K)])
            m_cv[j] = new_cv
        hard = (tot.reshape(-1) < 0).astype(np.uint8)
        if not np.any(code.syndrome(hard)):
            it_used = it + 1
            break
    tot_flat = tot.reshape(-1)
    return (tot_flat < 0).astype(np.uint8), tot_flat, it_used
