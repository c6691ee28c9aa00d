"""Margin-aware comparison of AMP decisions between two routes.

Two routes that round differently (bf16 vs f32 transforms, TF32 vs f32
matmuls, f32 vs float64, another summation order) carry independent
rounding noise, and T AMP iterations amplify it at near-tie sections.  A
flipped argmax is only meaningful where the section was decisive on both
routes.  Used by the tests and by chip_smoke.py's oracle comparisons.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def decision_flips(beta_a, beta_b, rel_margin: float = 2e-2
                   ) -> Dict[str, object]:
    """Compare sectionwise argmax decisions of two (..., M) arrays.

    Returns the number of sections, of flipped decisions, of flips where
    both routes' top-2 relative margin exceeds rel_margin ("decisive"),
    and the indices of the decisive flips.
    """
    a, b = np.asarray(beta_a), np.asarray(beta_b)
    mm = a.argmax(-1) != b.argmax(-1)
    sa = np.sort(a, -1)
    sb = np.sort(b, -1)
    ga = (sa[..., -1] - sa[..., -2]) / np.maximum(sa[..., -1], 1e-30)
    gb = (sb[..., -1] - sb[..., -2]) / np.maximum(sb[..., -1], 1e-30)
    decisive = mm & (ga > rel_margin) & (gb > rel_margin)
    return dict(sections=int(mm.size), flips=int(mm.sum()),
                decisive=int(decisive.sum()),
                decisive_at=np.argwhere(decisive).tolist())


def assert_decisions_match(beta_a, beta_b, rel_margin: float = 2e-2,
                           max_flips: float = 0.01) -> int:
    """No decisive flip, and sub-margin flips below max_flips of all
    sections.  Returns the number of (sub-margin) flips."""
    d = decision_flips(beta_a, beta_b, rel_margin)
    assert not d["decisive"], (
        f"{d['decisive']} decisive flips at {d['decisive_at'][:10]}")
    assert d["flips"] <= max_flips * d["sections"], d
    return d["flips"]
