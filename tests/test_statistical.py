"""Statistical integration tests (SURVEY.md §4.3): MC BER of the JAX path
within binomial confidence bands of the oracle at a fixed operating point."""

import numpy as np
import pytest

import jax

from sparc_ldpc_tpu.config import SparcConfig
from sparc_ldpc_tpu.models.sparc import SparcModel
from sparc_ldpc_tpu.oracle import sparc as osparc


def test_ber_within_binomial_ci_of_oracle():
    """Same operating point, independent randomness: section-error rates
    agree within 4-sigma binomial CI (catches any systematic decode bias)."""
    cfg = SparcConfig(L=64, M=64, R=1.0, op_kind="hadamard", amp_iters=16)
    ebno = 3.4   # partial-failure region: nonzero, measurable error rate

    # oracle: sequential trials
    op = osparc.make_operator(cfg)
    from sparc_ldpc_tpu.design.power import flat_alloc
    p = flat_alloc(cfg.L, cfg.P)
    n_trials_o = 160
    sec_o = sum(osparc.run_trial(seed=s, cfg=cfg, ebno_db=ebno, op=op,
                                 p_alloc=p)["section_errors"]
                for s in range(n_trials_o))
    rate_o = sec_o / (n_trials_o * cfg.L)

    # JAX path (CPU backend in CI): batched
    model = SparcModel.build(cfg, ebno_db=ebno)
    B = 256
    out = model.run_trials(jax.random.key(123), batch=B)
    rate_j = int(out["section_errors"]) / (B * cfg.L)

    # binomial std of the difference (independent samples)
    pbar = (sec_o + int(out["section_errors"])) / ((n_trials_o + B) * cfg.L)
    pbar = max(pbar, 1e-6)
    std = np.sqrt(pbar * (1 - pbar) * (1 / (n_trials_o * cfg.L)
                                       + 1 / (B * cfg.L)))
    assert rate_o > 0 or rate_j > 0, "operating point has no errors; move it"
    assert abs(rate_o - rate_j) < 4 * std + 1e-9, (
        f"oracle {rate_o:.4f} vs jax-path {rate_j:.4f} (std {std:.4f})")


def test_plot_command(tmp_path):
    """cli plot renders curves from jsonl (SURVEY.md §5 observability)."""
    from sparc_ldpc_tpu.cli import main
    from sparc_ldpc_tpu.utils.io import append_jsonl

    res = tmp_path / "r.jsonl"
    for e, ber in [(1.5, 2e-2), (2.0, 4e-3), (2.5, 3e-4)]:
        append_jsonl(str(res), dict(kind="point", ebno_db=e, ber=ber,
                                    fer=ber * 30))
    out = tmp_path / "curves.png"
    rc = main(["plot", str(res), "--out", str(out)])
    assert rc == 0
    assert out.exists() and out.stat().st_size > 10_000
