"""JAX-path LDPC tests: encoder/BP parity vs oracle, concat pipeline
(SURVEY.md §4.1, §4.2)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparc_ldpc_tpu.config import ConcatConfig, LdpcConfig, SparcConfig
from sparc_ldpc_tpu.models.concat import ConcatModel, _derive_partition
from sparc_ldpc_tpu.models.ldpc import LdpcModel
from sparc_ldpc_tpu.oracle.ldpc import bp_decode as oracle_bp


LCFG = LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12, bp_iters=48)


@pytest.fixture(scope="module")
def lmodel():
    return LdpcModel.build(LCFG)


def test_device_encoder_matches_host(lmodel, rng):
    u = rng.integers(0, 2, (4, lmodel.k))
    cw_host = lmodel.code.encode(u)
    cw_dev = np.asarray(lmodel.encode(jnp.asarray(u)))
    np.testing.assert_array_equal(cw_dev, cw_host)
    # syndrome zero on device H
    syn = (cw_dev @ lmodel.code.H.T) % 2
    assert not syn.any()


@pytest.mark.parametrize("method", ["minsum", "oms", "spa"])
def test_bp_parity_vs_oracle(method, rng):
    """Same LLRs -> same hard outputs as the oracle, for ALL variants."""
    lm = LdpcModel.build(LCFG.replace(decoder=method))
    B = 4
    sigma = 0.55
    u = rng.integers(0, 2, (B, lm.k)).astype(np.uint8)
    cw = lm.code.encode(u)
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal((B, lm.n))
    llr = 2.0 * y / sigma**2
    res = lm.decode(jnp.asarray(llr, dtype=jnp.float32))
    for b in range(B):
        hard_o, _, _ = oracle_bp(
            llr[b], lm.code, iters=LCFG.bp_iters, method=method,
            alpha=LCFG.alpha, beta=LCFG.beta, clip=LCFG.llr_clip)
        np.testing.assert_array_equal(np.asarray(res.hard[b]), hard_o)


@pytest.mark.parametrize("method", ["minsum", "oms", "spa"])
def test_bp_decodes_and_early_stops(method, rng):
    lm = LdpcModel.build(LCFG.replace(decoder=method))
    B = 6
    sigma = 0.5
    u = rng.integers(0, 2, (B, lm.k)).astype(np.uint8)
    cw = lm.code.encode(u)
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal((B, lm.n))
    llr = jnp.asarray(2.0 * y / sigma**2, dtype=jnp.float32)
    res = lm.decode(llr)
    assert np.all(np.asarray(res.ok))
    np.testing.assert_array_equal(np.asarray(res.hard), cw)
    assert int(jnp.max(res.iters)) < LCFG.bp_iters  # early stop engaged


# ----------------------------------------------------------------- concat

def test_derive_partition():
    # L=128, logM=9, ldpc n=156: num_cw*156 % 9 == 0 -> num_cw = 3 (468/9=52)
    Lu, Lp, num_cw = _derive_partition(128, 9, 156, 0.5)
    assert (Lu, Lp, num_cw) == (76, 52, 3)
    with pytest.raises(ValueError):
        _derive_partition(8, 9, 10000, 0.5)


@pytest.fixture(scope="module")
def cmodel():
    cfg = ConcatConfig(
        sparc=SparcConfig(L=128, M=512, R=1.2, op_kind="hadamard",
                          amp_iters=24),
        ldpc=LCFG, f_prot=0.5, feedback_iters=6)
    return ConcatModel.build(cfg, ebno_db=6.0)


def test_concat_roundtrip_noiseless(cmodel, rng):
    """Encode -> tiny noise -> decode recovers user bits exactly."""
    out = cmodel.run_trials(jax.random.key(0), batch=3)
    assert int(out["bit_errors"]) == 0
    assert int(out["frame_errors"]) == 0
    assert int(out["bp_ok"]) == 3 * cmodel.num_cw


def test_concat_beats_plain_sparc_in_residual_regime():
    """App. A.7 rationale: near the AMP threshold, converged frames keep a
    few scattered section errors; the outer code must remove the protected
    ones (via BP) so concat FER/BER strictly improves on plain SPARC.

    At L=256, R=1.0, 4.0 dB flat-PA, plain AMP leaves ~1-section errors in
    ~10% of frames (found by scanning; deterministic under the fixed key).
    """
    scfg = SparcConfig(L=256, M=512, R=1.0, op_kind="hadamard", amp_iters=32)
    cfg = ConcatConfig(sparc=scfg, ldpc=LCFG, f_prot=0.5, feedback_iters=8)
    ebno = 4.0
    cm = ConcatModel.build(cfg, ebno)
    from sparc_ldpc_tpu.models.sparc import SparcModel
    sm = SparcModel.build(scfg, ebno)
    key = jax.random.key(1)
    B = 64
    plain = sm.run_trials(key, B)
    conc = cm.run_trials(key, B)
    # every protected-section error is fixed (BP converges on all codewords)
    assert int(conc["bp_ok"]) == B * cm.num_cw
    assert int(conc["frame_errors"]) < int(plain["frame_errors"])
    assert int(conc["bit_errors"]) < int(plain["bit_errors"])


def test_concat_end_to_end_parity_vs_oracle(rng):
    """Full-chain independent parity (SURVEY.md §4.1): the oracle concat
    decoder and the JAX pipeline recover identical user bits from the SAME
    received vector."""
    import numpy as np
    from sparc_ldpc_tpu.oracle.concat import OracleConcat

    cfg = ConcatConfig(
        sparc=SparcConfig(L=128, M=512, R=1.0, op_kind="hadamard",
                          amp_iters=20, amp_tol=0.0),
        ldpc=LCFG, f_prot=0.5, feedback_iters=6)
    ebno = 4.5
    cm = ConcatModel.build(cfg, ebno)
    oc = OracleConcat.build(cfg, ebno)
    assert (oc.Lu, oc.Lp, oc.num_cw) == (cm.Lu, cm.Lp, cm.num_cw)
    assert oc.k_user == cm.k_user

    for seed in range(3):
        r = np.random.default_rng(seed)
        bits = r.integers(0, 2, cm.k_user)
        x = oc.encode(bits)
        y = x + r.standard_normal(cfg.sparc.n) * np.sqrt(oc.sigma2)
        hat_o = oc.decode(y)
        out_j = cm.decode(jnp.asarray(y[None], dtype=jnp.float32))
        hat_j = np.asarray(out_j["user_bits"][0])
        # decisions must agree (both run the same gated-pinning policy);
        # f32-vs-f64 can flip decisions only in near-tie events, so allow a
        # tiny discrepancy budget rather than exact equality
        diff = int(np.sum(hat_o != hat_j))
        assert diff <= max(2, oc.k_user // 1000), (
            f"seed {seed}: {diff} differing user bits")
