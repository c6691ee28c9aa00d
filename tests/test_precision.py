"""Transform-precision and route validation (SURVEY.md §7 hard-part 2).

The bf16 fast-transform path halves the bytes each transform moves; these
tests pin down that the induced quantization noise is far below channel
noise: identical hard decisions and tau trajectories within 1% on a
realistic decode.  (On CPU the precision argument is a no-op for f32, but
the bf16 path really does round through bfloat16, so this test is
meaningful in CI.)  The XLA AMP route's decision-feedback pinning, SE
schedule and early stop are anchored against the float64 oracle.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparc_ldpc_tpu.config import SparcConfig
from sparc_ldpc_tpu.models.amp import hard_indices
from sparc_ldpc_tpu.models.sparc import SparcModel
from sparc_ldpc_tpu.ops.fwht import fwht_mxu
from sparc_ldpc_tpu.utils.compare import assert_decisions_match
from sparc_ldpc_tpu.oracle.fwht import fwht_np



def test_bf16_fwht_error_small(rng):
    N = 1 << 14
    x = rng.standard_normal((2, N)).astype(np.float32)
    want = fwht_np(x.astype(np.float64))
    got = np.asarray(fwht_mxu(jnp.asarray(x), precision="bf16"))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 5e-3, rel


def test_bf16_decode_matches_f32_decisions():
    cfg32 = SparcConfig(L=64, M=128, R=1.0, op_kind="hadamard",
                        amp_iters=16, transform_precision="high")
    cfgbf = cfg32.replace(transform_precision="bf16")
    m32 = SparcModel.build(cfg32, ebno_db=5.0)
    mbf = SparcModel.build(cfgbf, ebno_db=5.0)
    key = jax.random.key(9)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (4, cfg32.n))
    bits = jax.random.bernoulli(jax.random.fold_in(key, 0), 0.5,
                                (4, cfg32.k_bits)).astype(jnp.int32)
    y = m32.encode(bits) + noise * np.sqrt(m32.sigma2)
    r32 = m32.decode(y)
    rbf = mbf.decode(y)
    np.testing.assert_array_equal(np.asarray(hard_indices(r32.beta)),
                                  np.asarray(hard_indices(rbf.beta)))
    tau32 = np.asarray(r32.tau2_trace)
    taubf = np.asarray(rbf.tau2_trace)
    np.testing.assert_allclose(taubf, tau32, rtol=2e-2)


def test_nspace_residual_matches_nspace():
    """amp_residual_space='N' must reproduce the classic path exactly (the
    off-row entries are zeros; only f32 association order differs)."""
    base = SparcConfig(L=64, M=128, R=1.0, op_kind="hadamard", amp_iters=16,
                      amp_tol=0.0)
    m_n = SparcModel.build(base, ebno_db=5.0)
    m_N = SparcModel.build(base.replace(amp_residual_space="N"), ebno_db=5.0)
    key = jax.random.key(4)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (3, base.n))
    bits = jax.random.bernoulli(jax.random.fold_in(key, 0), 0.5,
                                (3, base.k_bits)).astype(jnp.int32)
    y = m_n.encode(bits) + noise * np.sqrt(m_n.sigma2)
    r_n, r_N = m_n.decode(y), m_N.decode(y)
    np.testing.assert_array_equal(np.asarray(hard_indices(r_n.beta)),
                                  np.asarray(hard_indices(r_N.beta)))
    np.testing.assert_allclose(np.asarray(r_N.tau2_trace),
                               np.asarray(r_n.tau2_trace), rtol=1e-4)


def test_no_nans_under_debug_nans():
    """SURVEY.md §5 sanitizer analog: a full decode under jax.debug_nans
    (catches 0/0, inf propagation regressions in the hot loop)."""
    cfg = SparcConfig(L=32, M=64, R=1.0, op_kind="hadamard", amp_iters=8)
    m = SparcModel.build(cfg, ebno_db=5.0)
    with jax.debug_nans(True):
        out = m.run_trials(jax.random.key(0), batch=4)
        assert int(out["trials"]) == 4


def test_llr_beta_fold_matches_scores_path():
    """The shipped LLR extraction folds the AMP beta directly
    (models/concat._protected_llrs_from_beta); the scores-lse form and a
    float64 ground truth must agree with it to f32-reassociation level,
    and the BP decisions downstream must be identical on a realistic
    block."""
    from sparc_ldpc_tpu.config import PRESETS
    from sparc_ldpc_tpu.models.concat import ConcatModel
    from sparc_ldpc_tpu.utils import rng as rngu

    m = ConcatModel.build(PRESETS["concat"], ebno_db=3.0)
    tkeys = rngu.trial_keys(rngu.base_key(3), 4)
    _, _, beta, _ = m._stage_gen_amp(tkeys)
    post = beta / m.sparc.sq_npl[None, :, None]
    scores = jnp.log(jnp.maximum(post, jnp.finfo(jnp.float32).tiny))
    llr_b = np.asarray(m._protected_llrs_from_beta(beta))
    llr_s = np.asarray(m._protected_llrs(scores))
    # f32 reassociation level only (the sq_npl scale cancels in the fold)
    np.testing.assert_allclose(llr_b, llr_s, atol=2e-4, rtol=1e-3)
    # float64 ground truth per bit (MSB-first convention, utils/bits.py)
    a64 = np.asarray(beta[:, m.Lu:, :], np.float64)
    M, logM = m.cfg.sparc.M, m.cfg.sparc.logM
    bit = ((np.arange(M)[None, :] >> (logM - 1
            - np.arange(logM)[:, None])) & 1).astype(bool)   # (logM, M)
    s0 = np.einsum("blm,km->blk", a64, (~bit).astype(np.float64))
    s1 = np.einsum("blm,km->blk", a64, bit.astype(np.float64))
    gt = (np.log(s0) - np.log(s1)).reshape(llr_b.shape)
    np.testing.assert_allclose(llr_b, gt, atol=2e-4, rtol=1e-3)
    # decisions through BP: bitwise identical on this block
    cw_b, ok_b, _ = m._bp_from_llr(jnp.asarray(llr_b))
    cw_s, ok_s, _ = m._bp_from_llr(jnp.asarray(llr_s))
    np.testing.assert_array_equal(np.asarray(cw_b), np.asarray(cw_s))
    np.testing.assert_array_equal(np.asarray(ok_b), np.asarray(ok_s))


# --------------------------------------- XLA route vs the float64 oracle
#
# The XLA scan (models.amp.amp_decode) at transform_precision="highest"
# against oracle.sparc.amp_decode on the same y, codeword by codeword.
# Tolerances: both sides run the same recursion, the JAX side in f32, so
# the tau2 trajectories agree to f32 accumulation level — 1e-3 relative
# bounds T <= 16 iterations of ~1e-6 relative drift amplified by the
# Onsager feedback; decisions use the margin-aware rule above.

ORACLE_SHAPES = [(64, 64), (256, 64), (64, 256)]


def _oracle_case(L, M, ebno, B, seed, **cfg_kw):
    from sparc_ldpc_tpu.oracle import sparc as osparc

    cfg = SparcConfig(L=L, M=M, R=1.0, op_kind="hadamard",
                      transform_precision="highest", **cfg_kw)
    m = SparcModel.build(cfg, ebno_db=ebno)
    key = jax.random.key(seed)
    bits = jax.random.bernoulli(jax.random.fold_in(key, 0), 0.5,
                                (B, cfg.k_bits)).astype(jnp.int32)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (B, cfg.n))
    y = m.encode(bits) + noise * np.sqrt(m.sigma2)
    return cfg, m, bits, y, osparc.make_operator(cfg)


def _oracle_decode(cfg, m, y, op, **kw):
    from sparc_ldpc_tpu.oracle import sparc as osparc

    y64 = np.asarray(y, np.float64)
    return [osparc.amp_decode(y64[b], cfg, m.p_alloc, op,
                              **{k: (v[b] if k.startswith("pinned") else v)
                                 for k, v in kw.items()})
            for b in range(y64.shape[0])]


@pytest.mark.parametrize("L,M", ORACLE_SHAPES)
def test_xla_pinning_matches_oracle(L, M):
    """Decision-feedback pinning (App. A.7 step 5): 40% of sections pinned
    to their true indices; pinned rows are exactly the scaled one-hots and
    the free sections decide like the float64 oracle."""
    from sparc_ldpc_tpu.models.amp import amp_decode
    from sparc_ldpc_tpu.utils.bits import bits_to_indices

    cfg, m, bits, y, op = _oracle_case(L, M, 5.0, 3, 3, amp_iters=8,
                                       amp_tol=0.0)
    B = y.shape[0]
    pin_mask = np.random.default_rng(0).random((B, L)) < 0.4
    pin_idx = np.asarray(bits_to_indices(bits, cfg.logM))
    r = amp_decode(y, m.op, m.sq_npl, cfg.P, cfg.n, T=cfg.amp_iters,
                   tol=0.0, pinned_idx=jnp.asarray(pin_idx),
                   pinned_mask=jnp.asarray(pin_mask))
    orc = _oracle_decode(cfg, m, y, op, pinned_idx=pin_idx,
                         pinned_mask=pin_mask)
    beta_o = np.stack([o.beta.reshape(L, M) for o in orc])
    assert_decisions_match(r.beta, beta_o)
    np.testing.assert_allclose(np.asarray(r.tau2_trace),
                               np.stack([o.tau2_trace for o in orc], 1),
                               rtol=1e-3)
    want = np.asarray(m.sq_npl)[None, :, None] * np.eye(M)[pin_idx]
    np.testing.assert_allclose(np.asarray(r.beta)[pin_mask],
                               want[pin_mask], rtol=1e-6)


@pytest.mark.parametrize("L,M", ORACLE_SHAPES)
def test_xla_se_schedule_matches_oracle(L, M):
    """A fixed tau2 schedule replaces the online estimate identically on
    both sides (amp_tol=0: schedule mode never stops early)."""
    from sparc_ldpc_tpu.models.amp import amp_decode

    cfg, m, bits, y, op = _oracle_case(L, M, 5.0, 2, 5, amp_iters=8,
                                       amp_tol=0.0)
    sched = np.geomspace(1.0 + m.sigma2, m.sigma2,
                         cfg.amp_iters).astype(np.float32)
    r = amp_decode(y, m.op, m.sq_npl, cfg.P, cfg.n, T=cfg.amp_iters,
                   tol=0.0, tau2_schedule=jnp.asarray(sched))
    orc = _oracle_decode(cfg, m, y, op, tau2_schedule=sched)
    assert_decisions_match(r.beta,
                           np.stack([o.beta.reshape(L, M) for o in orc]))
    np.testing.assert_allclose(np.asarray(r.tau2_trace),
                               np.stack([o.tau2_trace for o in orc], 1),
                               rtol=1e-6)


@pytest.mark.parametrize("L,M", ORACLE_SHAPES)
def test_xla_early_stop_matches_oracle(L, M):
    """Per-codeword early stop (amp_tol > 0): the XLA scan's freeze mask
    stops each codeword at the oracle's `break` iteration, with the same
    decisions and the same trace up to the stop.  6 dB is decisively
    converged, so the threshold crossing is robust to f32 vs float64."""
    cfg, m, bits, y, op = _oracle_case(L, M, 6.0, 4, 3, amp_iters=16,
                                       amp_tol=1e-4)
    r = m.decode(y)
    orc = _oracle_decode(cfg, m, y, op)
    its = np.array([o.iters for o in orc])
    assert its.max() < cfg.amp_iters, "test point must actually stop early"
    np.testing.assert_array_equal(np.asarray(r.iters), its)
    assert_decisions_match(r.beta,
                           np.stack([o.beta.reshape(L, M) for o in orc]))
    tr = np.asarray(r.tau2_trace)
    for b, o in enumerate(orc):
        np.testing.assert_allclose(tr[: o.iters, b], o.tau2_trace,
                                   rtol=1e-3)
