"""Standard 802.11n QC-LDPC codes (SURVEY.md §2 #16): structural
verification of the checked-in base matrices and decode tests with both BP
engines.

Exact shift values cannot be re-fetched in this offline environment (the
data files document this), so the tests pin the *structural* invariants of
the 802.11n family — dual-diagonal encodable parity part, full rank (rate
exactly 1/2), 4-cycle-free expansion — plus working BP waterfall behavior.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sparc_ldpc_tpu.config import LdpcConfig
from sparc_ldpc_tpu.design.ldpc_codes import (
    STANDARD_CODES, load_qc_base, qc_base_H, systematize)
from sparc_ldpc_tpu.models.ldpc import LdpcModel


EXPECT = {"wifi_n648_r12": 27, "wifi_n1296_r12": 54, "wifi_n1944_r12": 81}


@pytest.mark.parametrize("name", STANDARD_CODES)
def test_base_matrix_structure(name):
    shifts, Z = load_qc_base(name)
    assert Z == EXPECT[name]
    J, K = shifts.shape
    assert (J, K) == (12, 24)
    # dual-diagonal parity part: anchor column 12 has exactly three
    # circulants (rows 0, mid, 11) with shifts (1, 0, 1); columns 13..23
    # carry the double diagonal of 0-shifts
    col12 = shifts[:, 12]
    nz = np.nonzero(col12 >= 0)[0]
    assert nz[0] == 0 and nz[-1] == 11 and len(nz) == 3
    assert col12[0] == 1 and col12[11] == 1 and col12[nz[1]] == 0
    for j in range(11):
        assert shifts[j, 13 + j] == 0 and shifts[j + 1, 13 + j] == 0
        assert np.count_nonzero(shifts[:, 13 + j] >= 0) == 2
    assert shifts[11, 23] == 0


@pytest.mark.parametrize("name", STANDARD_CODES)
def test_expanded_code_properties(name):
    shifts, Z = load_qc_base(name)
    H = qc_base_H(shifts, Z)
    m, n = H.shape
    assert (m, n) == (12 * Z, 24 * Z)
    code = systematize(H)          # asserts G H^T = 0 internally
    assert code.k == n - m, "H must be full rank (rate exactly 1/2)"
    # girth >= 6: no two rows share more than one column
    overlap = (H.astype(np.int32) @ H.T.astype(np.int32))
    np.fill_diagonal(overlap, 0)
    assert overlap.max() <= 1, "4-cycle in expanded H"


@pytest.mark.parametrize("engine,schedule", [("edge", "flooding"),
                                             ("qc", "flooding"),
                                             ("qc", "layered")])
def test_wifi648_decodes_both_engines(engine, schedule, rng):
    """A published-standard code decodes cleanly with both BP engines."""
    cfg = LdpcConfig(kind="qc", path="wifi_n648_r12", decoder="minsum",
                     engine=engine, schedule=schedule, bp_iters=48)
    lm = LdpcModel.build(cfg)
    assert (lm.n, lm.k) == (648, 324)
    B, sigma = 8, 0.78               # ~2.2 dB Eb/N0 at rate 1/2: waterfall
    u = rng.integers(0, 2, (B, lm.k)).astype(np.uint8)
    cw = lm.code.encode(u)
    y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal((B, lm.n))
    llr = jnp.asarray(2.0 * y / sigma**2, dtype=jnp.float32)
    res = lm.decode(llr)
    assert int(res.ok.sum()) == B
    np.testing.assert_array_equal(np.asarray(res.hard), cw)


def test_wifi648_waterfall(rng):
    """BER drops by >=10x across ~1 dB — BP actually works on the standard
    code rather than merely passing syndrome checks at high SNR."""
    cfg = LdpcConfig(kind="qc", path="wifi_n648_r12", decoder="minsum",
                     engine="qc", schedule="layered", bp_iters=48)
    lm = LdpcModel.build(cfg)
    B = 24
    u = rng.integers(0, 2, (B, lm.k)).astype(np.uint8)
    cw = lm.code.encode(u)
    errs = {}
    for sigma in (1.0, 0.79):        # ~0.0 dB vs ~2.05 dB at rate 1/2
        y = (1.0 - 2.0 * cw) + sigma * rng.standard_normal((B, lm.n))
        llr = jnp.asarray(2.0 * y / sigma**2, dtype=jnp.float32)
        res = lm.decode(llr)
        errs[sigma] = int((np.asarray(res.hard) != cw).sum())
    assert errs[1.0] > 10 * max(errs[0.79], 1) or errs[0.79] == 0, errs


# ---- constructed higher-rate codes (802.11n structure, generated shifts;
# scripts/gen_qc_codes.py) ----

from sparc_ldpc_tpu.design.ldpc_codes import CONSTRUCTED_CODES

RATE = {"qc_n648_r23": (8, 2 / 3), "qc_n648_r34": (6, 3 / 4),
        "qc_n648_r56": (4, 5 / 6)}


@pytest.mark.parametrize("name", CONSTRUCTED_CODES)
def test_constructed_code_properties(name):
    J, rate = RATE[name]
    shifts, Z = load_qc_base(name)
    assert shifts.shape == (J, 24) and Z == 27
    # dual-diagonal parity part with the (1, 0, 1) anchor column
    a = 24 - J
    col = shifts[:, a]
    nz = np.nonzero(col >= 0)[0]
    assert list(nz) == [0, J // 2, J - 1]
    assert col[0] == 1 and col[J - 1] == 1 and col[J // 2] == 0
    for j in range(J - 1):
        assert shifts[j, a + 1 + j] == 0 and shifts[j + 1, a + 1 + j] == 0
    H = qc_base_H(shifts, Z)
    code = systematize(H)
    assert code.k == 24 * Z - J * Z, "full rank (exact design rate)"
    assert abs(code.k / code.n - rate) < 1e-9
    ov = H.astype(np.int32) @ H.T.astype(np.int32)
    np.fill_diagonal(ov, 0)
    assert ov.max() <= 1, "4-cycle in expanded H"


@pytest.mark.parametrize("name,sigma",
                         [("qc_n648_r23", 0.55), ("qc_n648_r56", 0.42)])
def test_constructed_code_decodes(name, sigma, rng):
    """BP (QC layered engine) corrects AWGN noise at a moderate operating
    point and degrades at a harder one (waterfall sanity), per constructed
    higher-rate code."""
    J, rate = RATE[name]
    cfg = LdpcConfig(kind="qc", path=name, decoder="minsum",
                     engine="qc", schedule="layered", bp_iters=50)
    lm = LdpcModel.build(cfg)
    assert lm.n == 648 and lm.k == 648 - J * 27
    B = 24

    def run(sig):
        u = rng.integers(0, 2, (B, lm.k)).astype(np.uint8)
        cw = lm.code.encode(u)
        y = (1.0 - 2.0 * cw) + sig * rng.standard_normal((B, lm.n))
        llr = jnp.asarray(2.0 * y / sig**2, dtype=jnp.float32)
        res = lm.decode(llr)
        return int(res.ok.sum())

    ok_easy = run(sigma)
    assert ok_easy >= B - 1, ok_easy
    ok_hard = run(sigma + 0.22)
    assert ok_hard < ok_easy, (ok_easy, ok_hard)


def test_concat_r56_preset_geometry():
    """The high-rate concat preset (constructed rate-5/6 outer code) builds
    with consistent frame geometry: whole codewords, higher user rate than
    the rate-1/2 wifi preset."""
    import jax

    from sparc_ldpc_tpu.config import PRESETS
    from sparc_ldpc_tpu.models.concat import ConcatModel

    m = ConcatModel.build(PRESETS["concat_r56"], ebno_db=3.0)
    assert m.ldpc.n == 648 and m.ldpc.k == 540
    assert m.Lp * m.cfg.sparc.logM == m.num_cw * m.ldpc.n
    m_wifi = ConcatModel.build(PRESETS["concat_wifi"], ebno_db=3.0)
    assert m.k_user > m_wifi.k_user
