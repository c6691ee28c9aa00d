"""Deep BER-parity artifact check (SURVEY.md §4.3): oracle (NumPy
float64, native FWHT) vs GPU (the shipped XLA route on the card) BER
within joint 95% confidence at every persisted sweep point.

Reads the artifact produced by scripts/ber_parity.py from results/ —
it does NOT recompute anything (the oracle leg costs hours of CPU); runs
are skipped point-first when a leg is missing so a partially-built
artifact still checks whatever exists.
"""

import math
import os

import pytest

import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import ber_parity as bp  # noqa: E402


def _points():
    pts = []
    for preset in bp.GRIDS:
        recs = bp.load_records(preset)
        for ebno in bp.GRIDS[preset]:
            o = [r for r in recs if r["kind"] == "oracle"
                 and abs(r["ebno_db"] - ebno) < 1e-9]
            t = [r for r in recs if r["kind"] == "gpu"
                 and abs(r["ebno_db"] - ebno) < 1e-9]
            pts.append((preset, ebno, o[-1] if o else None,
                        t[-1] if t else None))
    return pts


@pytest.mark.parametrize("preset,ebno,oracle,gpu",
                         _points(),
                         ids=[f"{p}-{e}dB" for p, e, _, _ in _points()])
def test_ber_ci_overlap(preset, ebno, oracle, gpu):
    if oracle is None or gpu is None:
        pytest.skip("artifact leg not built yet (scripts/ber_parity.py)")
    assert gpu["trials"] >= 10_000
    # oracle-leg trials floor: a regenerated
    # artifact must not silently thin out below the per-preset floor the
    # sufficiency arithmetic was done for (ber_parity.ORACLE_TRIALS_FLOOR)
    assert oracle["trials"] >= bp.ORACLE_TRIALS_FLOOR[preset], (
        f"{preset}: oracle leg has {oracle['trials']} trials < floor "
        f"{bp.ORACLE_TRIALS_FLOOR[preset]}")
    gap = abs(oracle["ber"] - gpu["ber"])
    # joint 95% CI with a precision-sensitivity relative floor
    # (bp.REL_FLOOR: 1% default; 15% for the concat chains, whose
    # mid-waterfall BER moves ~12% relative between f32 and float64).
    # The tight same-platform check is test_control_vs_gpu below.
    bound = max(math.hypot(bp.ci_ber(oracle), bp.ci_ber(gpu)),
                bp.REL_FLOOR.get(preset, 0.01)
                * max(oracle["ber"], gpu["ber"]))
    assert gap <= bound, (
        f"{preset} @ {ebno} dB: oracle BER {oracle['ber']:.4e} vs GPU "
        f"{gpu['ber']:.4e}, |gap| {gap:.3e} > joint 95% {bound:.3e}")


def test_control_leg_required_for_rel_floor_presets():
    """REL_FLOOR presets lean on their f32-XLA control legs to justify
    the widened oracle bound — so wherever an oracle+gpu pair exists at
    a REL_FLOOR preset's grid point, the control leg MUST exist too
    (without it, a regenerated artifact that drops the control leg would
    silently leave concat anchored only at the 15% floor)."""
    checked = 0
    for preset in sorted(bp.REL_FLOOR):
        recs = bp.load_records(preset)
        for ebno in bp.GRIDS[preset]:
            o = [r for r in recs if r["kind"] == "oracle"
                 and abs(r["ebno_db"] - ebno) < 1e-9]
            t = [r for r in recs if r["kind"] == "gpu"
                 and abs(r["ebno_db"] - ebno) < 1e-9]
            if not (o and t):
                continue      # artifact still being built (point-first)
            c = [r for r in recs if r["kind"] == "control_f32xla"
                 and abs(r["ebno_db"] - ebno) < 1e-9]
            assert c, (
                f"{preset} @ {ebno}: control_f32xla leg missing — "
                f"scripts/ber_parity.py gpu --control --preset {preset}")
            checked += 1
    if not checked:
        pytest.skip("no completed REL_FLOOR points yet")


def test_control_vs_gpu_within_ci():
    """Same-platform implementation check: wherever an f32 control leg
    exists (scripts/ber_parity.py gpu --control: every transform at
    "highest", no bf16), the shipped route must sit on it within the
    joint 95% CI at a 2% relative floor.  Precision sensitivity mostly
    cancels between the two on-card routes, so this stays tight where the
    oracle comparison carries the f64-sensitivity floor."""
    checked = 0
    for preset in bp.GRIDS:
        recs = bp.load_records(preset)
        for ebno in bp.GRIDS[preset]:
            c = [r for r in recs if r["kind"] == "control_f32xla"
                 and abs(r["ebno_db"] - ebno) < 1e-9]
            t = [r for r in recs if r["kind"] == "gpu"
                 and abs(r["ebno_db"] - ebno) < 1e-9]
            if not (c and t):
                continue
            c, t = c[-1], t[-1]
            gap = abs(c["ber"] - t["ber"])
            bound = max(math.hypot(bp.ci_ber(c), bp.ci_ber(t)),
                        0.02 * max(c["ber"], t["ber"]))
            assert gap <= bound, (preset, ebno, c["ber"], t["ber"])
            checked += 1
    if not checked:
        pytest.skip("no control legs in the artifacts yet")


def test_se_tracks_gpu_ser():
    """tau2-based SE section-error prediction within 10% of the measured
    GPU SER wherever AMP converges to the SE fixed point (pa_l1024 grid;
    the flat-PA plain_small waterfall points are finite-L dominated and
    SE is knowingly optimistic there — not asserted)."""
    recs = bp.load_records("pa_l1024")
    for ebno in bp.GRIDS["pa_l1024"]:
        t = [r for r in recs if r["kind"] == "gpu"
             and abs(r["ebno_db"] - ebno) < 1e-9]
        s = [r for r in recs if r["kind"] == "se"
             and abs(r["ebno_db"] - ebno) < 1e-9]
        if not (t and s):
            pytest.skip("artifact leg not built yet")
        rel = abs(t[-1]["ser"] - s[-1]["ser"]) / max(s[-1]["ser"], 1e-12)
        assert rel < 0.10, (ebno, t[-1]["ser"], s[-1]["ser"], rel)
