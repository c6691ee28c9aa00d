"""M3: SE-derived design features (SURVEY.md §7 M3, App. A.2/A.5)."""

import json
import subprocess
import sys

import numpy as np
import pytest

import jax

from sparc_ldpc_tpu.config import SparcConfig
from sparc_ldpc_tpu.design.power import (
    exp_alloc, iterative_alloc, modified_alloc, optimize_modified,
)
from sparc_ldpc_tpu.design.se import (
    se_section_error_rate, se_section_success, se_section_success_quad,
    se_trajectory, se_x,
)
from sparc_ldpc_tpu.models.sparc import SparcModel


def test_exp_alloc_shape():
    p = exp_alloc(64, 1.0, 0.25)
    assert p[0] > p[-1] > 0
    np.testing.assert_allclose(p.sum(), 1.0, rtol=1e-12)
    # successive ratio constant: 2^{-2C/L}
    ratios = p[1:] / p[:-1]
    np.testing.assert_allclose(ratios, ratios[0], rtol=1e-9)


def test_modified_alloc_flattens_tail():
    p = modified_alloc(64, 1.0, 0.25, a=0.8, f=0.5)
    np.testing.assert_allclose(p[32:], p[32], rtol=1e-12)
    assert p[0] > p[31] > p[32] > 0


def test_iterative_beats_flat_threshold():
    """SE: iterative PA decodes at a point where flat stalls (App. A.2)."""
    cfg = SparcConfig(L=256, M=512, R=1.0)
    sigma2 = cfg.sigma2(2.0)
    flat = np.full(cfg.L, cfg.P / cfg.L)
    tr_flat = se_trajectory(flat, cfg.n, cfg.M, sigma2, n_samples=1024)
    p_it = iterative_alloc(cfg.L, cfg.P, sigma2, cfg.n, cfg.M,
                           n_samples=1024)
    tr_it = se_trajectory(p_it, cfg.n, cfg.M, sigma2, n_samples=1024)
    assert tr_flat[-1] > 2.0 * sigma2        # flat stalls
    assert tr_it[-1] < 1.25 * sigma2         # iterative decodes


def test_optimize_modified_improves_on_exp():
    cfg = SparcConfig(L=64, M=32, R=1.0)
    sigma2 = cfg.sigma2(2.5)
    p_opt, a, f = optimize_modified(cfg.L, cfg.P, sigma2, cfg.n, cfg.M,
                                    n_samples=512, na=4, nf=4)
    tr_opt = se_trajectory(p_opt, cfg.n, cfg.M, sigma2, n_samples=512)
    p_exp = exp_alloc(cfg.L, cfg.P, sigma2)
    tr_exp = se_trajectory(p_exp, cfg.n, cfg.M, sigma2, n_samples=512)
    assert tr_opt[-1] <= tr_exp[-1] * 1.05
    assert 0.4 <= f <= 1.0 and 0.4 <= a <= 1.3


def test_se_tau_schedule_mode_decodes():
    """tau_mode='se' uses the precomputed schedule instead of online tau."""
    cfg = SparcConfig(L=64, M=64, R=1.0, op_kind="hadamard", amp_iters=12,
                      tau_mode="se")
    model = SparcModel.build(cfg, ebno_db=6.0)
    assert model.tau2_schedule is not None
    assert model.tau2_schedule.shape == (cfg.amp_iters,)
    out = model.run_trials(jax.random.key(0), batch=4)
    assert int(out["bit_errors"]) == 0


def test_se_quadrature_matches_mc():
    """Gauss-Hermite x(tau2) tracks the MC estimator across the nu range
    (weak/critical/strong signal) within the MC sampling error."""
    M = 512
    rng = np.random.default_rng(3)
    U = rng.standard_normal((8192, M))
    nu = np.array([0.5, 2.0, 3.0, 3.5, 4.0, 5.0, 7.0, 10.0])
    mc = se_section_success(nu, U)
    quad = se_section_success_quad(nu, M)
    np.testing.assert_allclose(quad, mc, atol=1.2e-2)
    # endpoints: uninformative -> 1/M mass; strong signal -> ~1
    assert abs(se_section_success_quad(np.array([0.0]), M)[0] - 1 / M) < 1e-9
    assert se_section_success_quad(np.array([20.0]), M)[0] > 0.999


def test_se_trajectory_quad_matches_mc():
    cfg = SparcConfig(L=256, M=512, R=1.0)
    sigma2 = cfg.sigma2(4.0)
    p = np.full(cfg.L, cfg.P / cfg.L)
    tr_mc = se_trajectory(p, cfg.n, cfg.M, sigma2, n_samples=8192)
    tr_q = se_trajectory(p, cfg.n, cfg.M, sigma2, method="quad")
    assert abs(tr_q[-1] - tr_mc[-1]) < 0.02 * tr_mc[-1]
    with pytest.raises(ValueError):
        se_x(1.0, p, cfg.n, cfg.M, method="nope")


def test_se_section_error_rate_predicts_mc_argmax(rng):
    """The deterministic hard-decision predictor matches a direct MC of
    P[argmax wrong] (SURVEY.md §4.3 anchor)."""
    M, n, tau2 = 64, 2304, 1.0
    p = np.array([4.0, 9.0, 16.0]) / n          # nu = 2, 3, 4
    pred = se_section_error_rate(p, n, tau2, M)
    S = 20000
    U = rng.standard_normal((S, M))
    for i, nu in enumerate(np.sqrt(n * p / tau2)):
        wins = (U[:, 0] + nu)[:, None] > U[:, 1:]
        p_mc = 1.0 - np.mean(np.all(wins, axis=1))
        se_mc = np.sqrt(p_mc * (1 - p_mc) / S)
        assert abs(pred[i] - p_mc) < 4 * se_mc + 1e-4, (nu, pred[i], p_mc)


def test_cli_se_smoke():
    r = subprocess.run(
        [sys.executable, "-m", "sparc_ldpc_tpu.cli", "se",
         "--preset", "plain_small", "--ebno", "6.0"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    rec = json.loads(r.stdout)
    assert rec["decodes"] is True


def test_se_converged_iters_and_auto_budget():
    """SE-derived per-point iteration budget.

    At the flagship operating point SE plateaus at t=19 (tol 1e-4), so the
    auto budget is 22 with margin 3 — the value bench.py runs with.
    """
    from sparc_ldpc_tpu.design.power import power_allocation
    from sparc_ldpc_tpu.design.se import se_converged_iters

    cfg = SparcConfig(L=1024, M=512, R=1.0, power_alloc="iterative",
                      op_kind="hadamard", amp_iters=32, amp_tol=0.0,
                      amp_iters_auto=True)
    sigma2 = cfg.sigma2(2.0)
    p = power_allocation(cfg.power_alloc, cfg.L, cfg.P, sigma2, cfg.n, cfg.M)
    t = se_converged_iters(p, cfg.n, cfg.M, sigma2, tol=1e-4, T_max=32)
    assert 20 <= t <= 26, t
    model = SparcModel.build(cfg, ebno_db=2.0)
    assert model.cfg.amp_iters == t
    # the cap binds: a small cap passes through unchanged
    cfg_cap = SparcConfig(L=1024, M=512, R=1.0, power_alloc="iterative",
                          op_kind="hadamard", amp_iters=8, amp_tol=0.0,
                          amp_iters_auto=True)
    model_cap = SparcModel.build(cfg_cap, ebno_db=2.0)
    assert model_cap.cfg.amp_iters == 8
    # easier operating point -> shorter budget
    t_hi = se_converged_iters(p, cfg.n, cfg.M, cfg.sigma2(4.0), tol=1e-4,
                              T_max=32)
    assert t_hi < t, (t_hi, t)
