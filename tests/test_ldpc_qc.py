"""QC-circulant BP engine tests (ops.bp_qc; SURVEY.md §7 hard-part 3).

The flooding schedule must be message-identical to the padded-dense edge
engine on the same graph (same update order, same rules); layered is a
different schedule, anchored message-exactly (x64) against the independent
float64 NumPy twin oracle.ldpc.bp_decode_layered, plus fixed-point +
decode-success tests and a convergence-speed comparison.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from sparc_ldpc_tpu.config import LdpcConfig
from sparc_ldpc_tpu.design.ldpc_codes import (
    build_code, qc_base_H, qc_structure)
from sparc_ldpc_tpu.models.ldpc import LdpcModel
from sparc_ldpc_tpu.ops.bp import BpTables, bp_decode
from sparc_ldpc_tpu.ops.bp_qc import QcBpTables, bp_decode_qc


LCFG = LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12, bp_iters=48)


def _noisy_llrs(cfg, rng, B, sigma):
    code = build_code(cfg)
    u = rng.integers(0, 2, (B, code.k)).astype(np.uint8)
    cw = code.encode(u)
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal((B, code.n))
    return code, cw, jnp.asarray(2.0 * y / sigma**2, dtype=jnp.float32)


def test_qc_structure_matches_dense_H():
    """The (shifts, Z) view and the dense array-code H are the same graph."""
    shifts, Z = qc_structure(LCFG)
    H = qc_base_H(shifts, Z)
    code = build_code(LCFG)
    np.testing.assert_array_equal(H, code.H)


@pytest.mark.parametrize("method", ["minsum", "oms", "spa"])
def test_qc_flooding_parity_vs_edge_engine(method, rng):
    """Flooding QC == padded-dense edge engine: same decisions, posteriors,
    early-stop iteration counts, ok flags (identical message schedule)."""
    code, _, llr = _noisy_llrs(LCFG, rng, B=6, sigma=0.6)
    edge = bp_decode(llr, BpTables.build(code), iters=LCFG.bp_iters,
                     method=method)
    qc = bp_decode_qc(llr, QcBpTables.build(*qc_structure(LCFG)),
                      iters=LCFG.bp_iters, method=method)
    np.testing.assert_array_equal(np.asarray(qc.hard), np.asarray(edge.hard))
    np.testing.assert_array_equal(np.asarray(qc.ok), np.asarray(edge.ok))
    np.testing.assert_array_equal(np.asarray(qc.iters),
                                  np.asarray(edge.iters))
    np.testing.assert_allclose(np.asarray(qc.posterior),
                               np.asarray(edge.posterior), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("method", ["minsum", "spa"])
def test_layered_decodes_and_is_faster(method, rng):
    """Layered BP decodes the same noisy batch and needs fewer iterations
    than flooding (the standard ~2x layered-convergence advantage)."""
    code, cw, llr = _noisy_llrs(LCFG, rng, B=8, sigma=0.5)
    t = QcBpTables.build(*qc_structure(LCFG))
    fl = bp_decode_qc(llr, t, iters=LCFG.bp_iters, method=method,
                      schedule="flooding")
    ly = bp_decode_qc(llr, t, iters=LCFG.bp_iters, method=method,
                      schedule="layered")
    assert np.all(np.asarray(ly.ok))
    np.testing.assert_array_equal(np.asarray(ly.hard), cw)
    assert int(np.sum(np.asarray(ly.iters))) < int(
        np.sum(np.asarray(fl.iters)))


@pytest.mark.parametrize("method", ["minsum", "oms", "spa"])
def test_layered_message_parity_vs_oracle_twin(method, rng):
    """Row-layered QC BP == the independent float64 NumPy twin
    (oracle.ldpc.bp_decode_layered): same decisions, ok flags, early-stop
    iteration counts, and message-exact posteriors — the message-level
    anchor for the schedule the shipped concat presets decode with.
    The twin routes messages with np.roll
    permutations, the JAX engine with static Z-gather tensors; layer
    ordering bugs (stale totals, wrong-direction shifts, missed zero-block
    clip-through) would break iteration counts or posteriors here."""
    import jax
    from sparc_ldpc_tpu.oracle.ldpc import bp_decode_layered

    # noisy-but-decodable + some undecodable frames: both early-stop and
    # budget-exhaustion paths are compared.  The engine runs in x64 so the
    # comparison is MESSAGE-exact (~1e-12): at f32, min-sum's discrete
    # min selections flip on ulp-level ties and the sequential layered
    # totals then diverge by (min2 - min1) while still reaching identical
    # decisions — decision-level f32 parity is covered by the statistical
    # concat artifact (scripts/ber_parity.py).
    code, cw, llr = _noisy_llrs(LCFG, rng, B=8, sigma=0.75)
    shifts, Z = qc_structure(LCFG)
    llr_np = np.asarray(llr, dtype=np.float64)
    with jax.enable_x64(True):
        res = bp_decode_qc(jnp.asarray(llr_np), QcBpTables.build(shifts, Z),
                           iters=LCFG.bp_iters, method=method,
                           schedule="layered")
        for b in range(llr.shape[0]):
            hard, tot, it = bp_decode_layered(llr_np[b], code, shifts, Z,
                                              iters=LCFG.bp_iters,
                                              method=method)
            np.testing.assert_array_equal(np.asarray(res.hard[b]), hard,
                                          err_msg=f"frame {b}")
            assert bool(res.ok[b]) == (not np.any(code.syndrome(hard)))
            assert int(res.iters[b]) == it, (b, int(res.iters[b]), it)
            np.testing.assert_allclose(np.asarray(res.posterior[b]), tot,
                                       rtol=1e-10, atol=1e-10)


def test_layered_oracle_twin_zero_blocks(rng):
    """The twin handles zero blocks (-1 shifts) identically to the engine:
    a zero block's identity round trip must still clip the totals
    through (the engine's documented clip-through semantics)."""
    from sparc_ldpc_tpu.oracle.ldpc import bp_decode_layered

    import jax

    shifts, Z = qc_structure(LCFG)
    shifts = shifts.copy()
    shifts[1, 4] = -1
    shifts[2, 9] = -1
    H = qc_base_H(shifts, Z)
    from sparc_ldpc_tpu.design.ldpc_codes import systematize
    code = systematize(H)
    u = rng.integers(0, 2, (4, code.k)).astype(np.uint8)
    cw = code.encode(u)
    y = (1.0 - 2.0 * cw) + 0.7 * rng.standard_normal((4, code.n))
    llr = 2.0 * y / 0.49
    with jax.enable_x64(True):
        res = bp_decode_qc(jnp.asarray(llr, dtype=jnp.float64),
                           QcBpTables.build(shifts, Z), iters=48,
                           schedule="layered")
        for b in range(4):
            hard, tot, it = bp_decode_layered(llr[b], code, shifts, Z,
                                              iters=48)
            np.testing.assert_array_equal(np.asarray(res.hard[b]), hard)
            assert int(res.iters[b]) == it
            np.testing.assert_allclose(np.asarray(res.posterior[b]), tot,
                                       rtol=1e-10, atol=1e-10)


def test_layered_noiseless_fixed_point(rng):
    """On very confident correct LLRs, layered BP stops immediately with the
    codeword (syndrome satisfied after the first sweep)."""
    code = build_code(LCFG)
    u = rng.integers(0, 2, (3, code.k)).astype(np.uint8)
    cw = code.encode(u)
    llr = jnp.asarray((1.0 - 2.0 * cw) * 15.0, dtype=jnp.float32)
    res = bp_decode_qc(llr, QcBpTables.build(*qc_structure(LCFG)),
                       iters=16, schedule="layered")
    np.testing.assert_array_equal(np.asarray(res.hard), cw)
    assert np.all(np.asarray(res.iters) == 1)


def test_model_dispatch_and_auto_engine(rng):
    """LdpcModel routes decode through the QC engine when configured; auto
    resolves to qc for QC codes; layered+edge is rejected at config time."""
    code, cw, llr = _noisy_llrs(LCFG, rng, B=4, sigma=0.5)
    for engine, schedule in [("qc", "flooding"), ("auto", "layered")]:
        lm = LdpcModel.build(LCFG.replace(engine=engine, schedule=schedule))
        assert lm.qc_tables is not None
        res = lm.decode(llr)
        assert np.all(np.asarray(res.ok))
        np.testing.assert_array_equal(np.asarray(res.hard), cw)
    with pytest.raises(ValueError):
        LCFG.replace(engine="edge", schedule="layered")
    with pytest.raises(ValueError):
        LdpcModel.build(LdpcConfig(kind="regular", n_bits=156, dv=3, dc=6,
                                   engine="qc"))


def test_qc_base_file_roundtrip(tmp_path, rng):
    """Generic QC base-matrix file: load -> valid code -> QC BP decodes."""
    shifts, Z = qc_structure(LCFG)
    shifts = shifts.copy()
    shifts[0, 0] = -1          # a zero block, exercising the block mask
    path = tmp_path / "base.qc"
    lines = [f"{Z}"] + [" ".join(str(int(s)) for s in row) for row in shifts]
    path.write_text("# test base matrix\n" + "\n".join(lines) + "\n")

    cfg = LdpcConfig(kind="qc", path=str(path), engine="auto",
                     schedule="layered", bp_iters=48)
    lm = LdpcModel.build(cfg)
    np.testing.assert_array_equal(lm.code.H, qc_base_H(shifts, Z))
    u = rng.integers(0, 2, (4, lm.k)).astype(np.uint8)
    cw = lm.code.encode(u)
    y = (1.0 - 2.0 * cw) + 0.5 * rng.standard_normal((4, lm.n))
    res = lm.decode(jnp.asarray(2.0 * y / 0.25, dtype=jnp.float32))
    assert np.all(np.asarray(res.ok))
    np.testing.assert_array_equal(np.asarray(res.hard), cw)


@pytest.mark.parametrize("path", ["wifi_n648_r12", "qc_n648_r56"])
def test_shipped_code_f32_engine_matches_oracle_twin(path, rng):
    """The shipped outer decode (LdpcModel.decode: layered min-sum on the
    QC engine, f32) against the float64 twin on the same LLRs, for the two
    standard-structure codes the concat presets ship.  Hard decisions and
    ok flags must be equal; posteriors agree to 1e-2 absolute: f32
    rounding (~1e-6 relative per update, values bounded by the +-20 clip)
    drifts through the layered recursion of a frame that runs all 32
    iterations — up to 3.4e-3 measured on these codes."""
    from sparc_ldpc_tpu.oracle.ldpc import bp_decode_layered

    cfg = LdpcConfig(kind="qc", path=path, engine="qc", schedule="layered",
                     bp_iters=32)
    lm = LdpcModel.build(cfg)
    code, cw, llr = _noisy_llrs(cfg, rng, B=6, sigma=0.6)
    res = lm.decode(llr)
    shifts, Z = qc_structure(cfg)
    for b in range(llr.shape[0]):
        hard, tot, _ = bp_decode_layered(
            np.asarray(llr[b], np.float64), code, shifts, Z,
            iters=cfg.bp_iters, method=cfg.decoder, alpha=cfg.alpha,
            beta=cfg.beta, clip=cfg.llr_clip)
        np.testing.assert_array_equal(np.asarray(res.hard[b]), hard)
        assert bool(res.ok[b]) == (not np.any(code.syndrome(hard)))
        np.testing.assert_allclose(np.asarray(res.posterior[b]), tot,
                                   atol=1e-2)
