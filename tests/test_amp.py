"""AMP pipeline parity vs oracle + end-to-end smoke (SURVEY.md §4.1, §4.6)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparc_ldpc_tpu.config import SparcConfig
from sparc_ldpc_tpu.design.power import flat_alloc
from sparc_ldpc_tpu.models.sparc import SparcModel
from sparc_ldpc_tpu.models.amp import hard_indices
from sparc_ldpc_tpu.oracle import sparc as osparc
from sparc_ldpc_tpu.utils.bits import np_bits_to_indices


CFG = SparcConfig(L=32, M=64, R=1.0, op_kind="hadamard", amp_iters=16,
                  amp_tol=0.0)  # tol=0: fixed iteration count for parity


@pytest.mark.parametrize("kind", ["dense", "hadamard"])
def test_amp_trajectory_parity_vs_oracle(kind, rng):
    """Full AMP trajectory (tau trace + final beta) matches oracle <=1e-4
    rel in f32 (SURVEY.md §4.1)."""
    cfg = CFG.replace(op_kind=kind)
    model = SparcModel.build(cfg, ebno_db=6.0)
    oop = osparc.make_operator(cfg)
    p = model.p_alloc

    bits = rng.integers(0, 2, cfg.k_bits)
    x = osparc.encode(bits.astype(np.int64), cfg, p, oop)
    yv = x + rng.standard_normal(cfg.n) * np.sqrt(model.sigma2)

    ores = osparc.amp_decode(yv, cfg, p, oop, T=cfg.amp_iters)
    jres = model.decode(jnp.asarray(yv[None, :], dtype=jnp.float32))

    tau_j = np.asarray(jres.tau2_trace[:, 0])
    tau_o = ores.tau2_trace
    T = min(len(tau_o), len(tau_j))
    np.testing.assert_allclose(tau_j[:T], tau_o[:T], rtol=2e-3)
    # posteriors match (the s statistic itself is not materialized on the
    # JAX path — posteriors/scores/beta are its sufficient equivalents)
    np.testing.assert_allclose(np.asarray(jres.posteriors[0]),
                               ores.posteriors, rtol=5e-3, atol=1e-5)
    # identical hard decisions
    np.testing.assert_array_equal(
        np.asarray(hard_indices(jres.beta)[0]),
        osparc.hard_decision(ores.s, cfg.L, cfg.M))


def test_encode_matches_oracle(rng):
    model = SparcModel.build(CFG, ebno_db=4.0)
    oop = osparc.make_operator(CFG)
    bits = rng.integers(0, 2, (2, CFG.k_bits))
    xj = np.asarray(model.encode(jnp.asarray(bits)))
    for b in range(2):
        xo = osparc.encode(bits[b], CFG, model.p_alloc, oop)
        np.testing.assert_allclose(xj[b], xo, rtol=1e-4, atol=1e-4)


def test_end_to_end_smoke_zero_errors():
    """Config decodes its own encode at high SNR with 0 errors
    (SURVEY.md §4.6), every commit."""
    cfg = SparcConfig(L=64, M=128, R=1.0, op_kind="hadamard", amp_iters=32)
    model = SparcModel.build(cfg, ebno_db=8.0)
    out = model.run_trials(jax.random.key(0), batch=4)
    assert int(out["bit_errors"]) == 0
    assert int(out["frame_errors"]) == 0


def test_early_stop_masking():
    """Early-stopped codewords freeze: tol>0 gives same answer as tol=0."""
    cfg = SparcConfig(L=32, M=64, R=1.0, op_kind="hadamard", amp_iters=24)
    m_tol = SparcModel.build(cfg.replace(amp_tol=1e-5), ebno_db=7.0)
    m_fix = SparcModel.build(cfg.replace(amp_tol=0.0), ebno_db=7.0)
    key = jax.random.key(3)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (3, cfg.n))
    bits = jax.random.bernoulli(jax.random.fold_in(key, 0), 0.5,
                                (3, cfg.k_bits)).astype(jnp.int32)
    y = m_tol.encode(bits) + noise * np.sqrt(m_tol.sigma2)
    r_tol = m_tol.decode(y)
    r_fix = m_fix.decode(y)
    np.testing.assert_array_equal(np.asarray(hard_indices(r_tol.beta)),
                                  np.asarray(hard_indices(r_fix.beta)))
    assert int(jnp.max(r_tol.iters)) <= cfg.amp_iters
    assert int(jnp.min(r_tol.iters)) < cfg.amp_iters  # actually stopped early


def test_run_trials_deterministic_in_key():
    cfg = SparcConfig(L=32, M=64, R=1.0, op_kind="hadamard", amp_iters=8)
    model = SparcModel.build(cfg, ebno_db=5.0)
    a = model.run_trials(jax.random.key(7), batch=8)
    b = model.run_trials(jax.random.key(7), batch=8)
    assert int(a["bit_errors"]) == int(b["bit_errors"])
    assert int(a["section_errors"]) == int(b["section_errors"])
