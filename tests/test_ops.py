"""L1/L2 op tests: FWHT variants, operators, denoiser (SURVEY.md §4.2, §4.5)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparc_ldpc_tpu.config import SparcConfig
from sparc_ldpc_tpu.ops.fwht import factorize_pow2, fwht_mxu, fwht_butterfly
from sparc_ldpc_tpu.ops.operators import make_operator
from sparc_ldpc_tpu.ops.denoiser import denoise
from sparc_ldpc_tpu.oracle.fwht import fwht, fwht_np
from sparc_ldpc_tpu.oracle import sparc as osparc
from sparc_ldpc_tpu.design.power import flat_alloc


def test_factorize():
    assert factorize_pow2(1 << 21) == (128, 128, 128)
    assert factorize_pow2(1 << 19) == (128, 64, 64)
    assert factorize_pow2(1 << 22) == (256, 128, 128)
    assert factorize_pow2(2) == (2,)
    for k in range(1, 23):
        fs = factorize_pow2(1 << k)
        assert int(np.prod(fs)) == 1 << k


@pytest.mark.parametrize("N", [8, 64, 512, 4096, 1 << 15])
def test_fwht_mxu_matches_oracle(N, rng):
    x = rng.standard_normal((3, N)).astype(np.float32)
    want = fwht_np(x.astype(np.float64))
    got = np.asarray(fwht_mxu(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-3 * np.sqrt(N))
    got_b = np.asarray(fwht_butterfly(jnp.asarray(x)))
    np.testing.assert_allclose(got_b, want, rtol=2e-5, atol=2e-3 * np.sqrt(N))


@pytest.mark.parametrize("kind", ["dense", "hadamard", "dct"])
def test_batched_operator_matches_oracle(kind, rng):
    cfg = SparcConfig(L=32, M=64, R=1.0, op_kind=kind)
    jop = make_operator(cfg)
    oop = osparc.make_operator(cfg)
    B = 3
    beta = rng.standard_normal((B, cfg.ML)).astype(np.float32)
    z = rng.standard_normal((B, cfg.n)).astype(np.float32)
    fwd_o = np.stack([oop.Ax(beta[b].astype(np.float64)) for b in range(B)])
    adj_o = np.stack([oop.Ay(z[b].astype(np.float64)) for b in range(B)])
    np.testing.assert_allclose(np.asarray(jop.Ax(jnp.asarray(beta))), fwd_o,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(jop.Ay(jnp.asarray(z))), adj_o,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", ["hadamard", "dct"])
def test_batched_adjointness(kind, rng):
    cfg = SparcConfig(L=64, M=128, R=1.2, op_kind=kind)
    op = make_operator(cfg)
    beta = jnp.asarray(rng.standard_normal((2, cfg.ML)), dtype=jnp.float32)
    z = jnp.asarray(rng.standard_normal((2, cfg.n)), dtype=jnp.float32)
    lhs = jnp.sum(op.Ax(beta) * z, axis=-1)
    rhs = jnp.sum(beta * op.Ay(z), axis=-1)
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs),
                               rtol=2e-3, atol=1e-2)


def test_denoiser_matches_oracle(rng):
    L, M, n = 16, 32, 256
    p = flat_alloc(L, 1.0)
    s = rng.standard_normal((2, L, M))
    tau2 = np.array([0.5, 0.1])
    sq = np.sqrt(n * p)
    beta_j, post_j = denoise(jnp.asarray(s, dtype=jnp.float32),
                             jnp.asarray(tau2, dtype=jnp.float32),
                             jnp.asarray(sq, dtype=jnp.float32))
    for b in range(2):
        beta_o, post_o = osparc.denoise(s[b].reshape(-1), tau2[b], p, n, M)
        np.testing.assert_allclose(np.asarray(beta_j[b]).reshape(-1), beta_o,
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(post_j[b]), post_o,
                                   rtol=1e-4, atol=1e-6)
    # softmax mass: sum_j beta = sqrt(n P_l) per section
    np.testing.assert_allclose(np.asarray(beta_j.sum(-1)),
                               np.tile(sq, (2, 1)), rtol=1e-5)


def test_denoiser_extreme_tau_no_overflow():
    """SURVEY.md §7 hard-part 2: huge softmax arguments must not overflow."""
    L, M = 8, 16
    s = jnp.asarray(np.full((1, L, M), 50.0), dtype=jnp.float32)
    s = s.at[0, :, 3].set(1e4)
    tau2 = jnp.asarray([1e-6], dtype=jnp.float32)
    sq = jnp.full((L,), 30.0, dtype=jnp.float32)
    beta, post = denoise(s, tau2, sq)
    assert np.all(np.isfinite(np.asarray(beta)))
    np.testing.assert_allclose(np.asarray(post[0, :, 3]), 1.0, atol=1e-6)


# Relative L2 error bounds of fwht_mxu against the float64 oracle on the
# CPU backend, per SparcConfig.transform_precision.  The CPU computes every
# f32 precision in full f32 (sum of log2(N) rounding steps, ~1e-7 each);
# "bf16" rounds the data operand to 8 mantissa bits before each of the
# k <= 3 mode contractions (~0.4% per rounding, independent across
# entries, so ~2e-3 rel for the whole transform).
FWHT_REL_BOUND = {"highest": 2e-6, "high": 2e-6, "default": 2e-6,
                  "bf16": 5e-3}


@pytest.mark.parametrize("precision", sorted(FWHT_REL_BOUND))
@pytest.mark.parametrize("N", [1 << 6, 1 << 9, 1 << 14, 1 << 17])
def test_fwht_mxu_precision_vs_oracle(precision, N, rng):
    x = rng.standard_normal((2, N)).astype(np.float32)
    want = fwht(x.astype(np.float64))
    got = np.asarray(fwht_mxu(jnp.asarray(x), precision=precision),
                     dtype=np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < FWHT_REL_BOUND[precision], (precision, N, rel)
