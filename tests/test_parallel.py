"""Distributed-without-a-cluster tests (SURVEY.md §4.4): 8 fake CPU devices.

Identical-results discipline: the fold_in key tree makes counters a pure
function of (config, seed), so 1-device and 8-device meshes must agree.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from sparc_ldpc_tpu.config import CampaignConfig, SparcConfig
from sparc_ldpc_tpu.models.sparc import SparcModel
from sparc_ldpc_tpu.parallel.mesh import ShardingPolicy, make_mesh
from sparc_ldpc_tpu.parallel.campaign import run_campaign, run_point
from sparc_ldpc_tpu.utils import rng as rngu
from sparc_ldpc_tpu.utils.io import CampaignState


CFG = SparcConfig(L=64, M=64, R=1.0, op_kind="hadamard", amp_iters=12)


def test_fake_devices_present():
    assert jax.device_count() == 8, (
        "conftest must provide 8 virtual CPU devices")


def test_make_mesh_shapes():
    mesh = make_mesh(section_shards=2)
    assert mesh.shape == {"data": 4, "section": 2}
    mesh = make_mesh(section_shards=1)
    assert mesh.shape == {"data": 8, "section": 1}
    with pytest.raises(ValueError):
        make_mesh(section_shards=3)


def _counters(model, mesh=None, policy=None, batch=16, seed=3):
    tkeys = rngu.trial_keys(rngu.base_key(seed), batch)
    if policy is not None:
        tkeys = jax.device_put(tkeys, policy.batch1())
    out = jax.jit(model.run_block)(tkeys)
    return {k: int(v) for k, v in out.items()
            if k in ("bit_errors", "frame_errors", "section_errors", "trials")}


def test_dp_sharded_matches_single_device():
    """Pure DP over 8 devices == single device, bitwise (SURVEY.md §4.4)."""
    model = SparcModel.build(CFG, ebno_db=5.0)
    ref = _counters(model)
    mesh = make_mesh(section_shards=1)
    pol = ShardingPolicy(mesh, section_axis=None)
    model_sh = SparcModel.build(CFG, ebno_db=5.0, policy=pol)
    with jax.sharding.set_mesh(mesh):
        got = _counters(model_sh, policy=pol)
    assert got == ref


def test_section_sharded_matches_single_device():
    """data x section mesh == single device on integer counters."""
    model = SparcModel.build(CFG, ebno_db=5.0)
    ref = _counters(model)
    mesh = make_mesh(section_shards=2)
    pol = ShardingPolicy(mesh)
    model_sh = SparcModel.build(CFG, ebno_db=5.0, policy=pol)
    with jax.sharding.set_mesh(mesh):
        got = _counters(model_sh, policy=pol)
    assert got == ref


@pytest.mark.parametrize("route", ["dp", "s2", "s4", "collective"])
def test_amp_tol_parity_across_routes(route):
    """amp_tol > 0 has the SAME per-codeword freeze semantics on every
    mesh route: pure DP over 8 devices, section-sharded at S=2 and S=4
    (GSPMD mode contractions) and S=2 with the hand ppermute FWHT
    (fwht_dist="collective") all report the single-device decisions AND
    per-codeword iteration counts — and the counts show the stop actually
    engaged (iters_sum < cap * batch).

    6 dB: decisively converged, so the plateau-crossing iteration is
    robust to the routes' differing f32 association.  f32 transforms
    ("high"): the collective FWHT rounds to bf16 at other points than the
    GSPMD contractions, which can move a plateau crossing by an iteration
    while the decisions stay equal."""
    T, B = 16, 16
    base = SparcConfig(L=64, M=64, R=1.0, op_kind="hadamard", amp_iters=T,
                       amp_tol=1e-4, transform_precision="high")
    tkeys = rngu.trial_keys(rngu.base_key(5), B)
    keys = ("bit_errors", "frame_errors", "section_errors", "iters_sum")

    def run(cfg, policy=None):
        m = SparcModel.build(cfg, ebno_db=6.0, policy=policy)
        tk = (jax.device_put(tkeys, policy.batch1()) if policy is not None
              else tkeys)
        out = jax.jit(m.run_block)(tk)
        return {k: int(v) for k, v in out.items() if k in keys}

    ref = run(base)
    assert ref["iters_sum"] < T * B, "early stop never engaged — bad point"
    shards, cfg = {"dp": (1, base), "s2": (2, base), "s4": (4, base),
                   "collective": (2, base.replace(fwht_dist="collective"))
                   }[route]
    mesh = make_mesh(section_shards=shards)
    pol = ShardingPolicy(mesh,
                         section_axis="section" if shards > 1 else None)
    with jax.sharding.set_mesh(mesh):
        got = run(cfg, policy=pol)
    assert got == ref, (route, got, ref)


def test_campaign_runs_and_resumes(tmp_path):
    """Restart reproduces identical final counters from the journal
    (SURVEY.md §5 fault-injection design)."""
    ccfg = CampaignConfig(ebno_grid_db=(5.0,), batch=8, min_frame_errors=2,
                          max_trials=64, base_seed=11)
    model = SparcModel.build(CFG, ebno_db=5.0)
    journal = str(tmp_path / "journal.jsonl")

    res1 = run_campaign(lambda e: model, ccfg, lambda m: m.cfg.k_bits,
                        journal_path=journal, verbose=False)

    # simulate a crash: drop the last journaled block, then resume
    lines = open(journal).read().strip().split("\n")
    with open(journal, "w") as f:
        f.write("\n".join(lines[:-1]) + "\n")
    res2 = run_campaign(lambda e: model, ccfg, lambda m: m.cfg.k_bits,
                        journal_path=journal, verbose=False)

    for k in ("bit_errors", "frame_errors", "trials"):
        assert res1[0][k] == res2[0][k]


def test_campaign_truthful_iters_and_throughput(tmp_path):
    """mean_iters reflects the adaptive stop (not the cap), bits_per_s is
    None for 1-block and journal-replayed points (never compile-polluted
    or replay-inflated), and records carry bit_errors_sq + provenance
    meta."""
    cfg = SparcConfig(L=64, M=64, R=1.0, op_kind="hadamard", amp_iters=16,
                      amp_tol=1e-4, transform_precision="bf16")
    model = SparcModel.build(cfg, ebno_db=6.0)
    ccfg = CampaignConfig(ebno_grid_db=(6.0,), batch=8, min_frame_errors=1,
                          max_trials=16, base_seed=11)
    rec = run_campaign(lambda e: model, ccfg, lambda m: m.cfg.k_bits,
                       verbose=False, meta=dict(preset="unit"))[0]
    assert 0 < rec["mean_iters"] < cfg.amp_iters, rec["mean_iters"]
    assert rec["preset"] == "unit"
    assert rec["bit_errors_sq"] >= 0
    # pipelined dispatch: the budget check lags by the one
    # in-flight block, so the 16-trial cap is met after harvesting block
    # 1 while block 2 is already submitted -> 3 blocks, and the
    # compile-free steady measurement exists
    assert rec["blocks"] == 3 and rec["bits_per_s"] is not None

    # single-block point: the only timing datum includes compile -> None.
    # Only the synchronous (pipelined=False) mode can produce a 1-block
    # point; the pipelined driver always over-dispatches one block.
    ccfg1 = ccfg.replace(max_trials=8)
    rec1 = run_campaign(lambda e: model, ccfg1, lambda m: m.cfg.k_bits,
                        verbose=False, pipelined=False)[0]
    assert rec1["blocks"] == 1 and rec1["bits_per_s"] is None
    # the pipelined driver on the same point: one over-dispatched block,
    # journaled and counted
    rec1p = run_campaign(lambda e: model, ccfg1, lambda m: m.cfg.k_bits,
                         verbose=False)[0]
    assert rec1p["blocks"] == 2 and rec1p["trials"] == 16

    # fully journal-replayed point: counters reproduced, throughput None
    journal = str(tmp_path / "j.jsonl")
    run_campaign(lambda e: model, ccfg, lambda m: m.cfg.k_bits,
                 journal_path=journal, verbose=False)
    rec2 = run_campaign(lambda e: model, ccfg, lambda m: m.cfg.k_bits,
                        journal_path=journal, verbose=False)[0]
    assert rec2["exec_blocks"] == 0 and rec2["bits_per_s"] is None
    assert rec2["trials"] == rec["trials"]
    assert rec2["bit_errors"] == rec["bit_errors"]


def test_run_point_respects_budget():
    model = SparcModel.build(CFG, ebno_db=8.0)  # high SNR: no errors
    pkey = rngu.point_key(rngu.base_key(0), 0)
    # synchronous mode: the cap binds exactly
    tot = run_point(model.run_block, pkey, batch=8, min_frame_errors=1,
                    max_trials=16, pipelined=False)
    assert tot["trials"] == 16  # hit the cap, not the error budget
    # pipelined mode: the lagged budget check over-dispatches exactly the
    # one in-flight block past the cap — deterministic, journal-visible
    tot = run_point(model.run_block, pkey, batch=8, min_frame_errors=1,
                    max_trials=16)
    assert tot["trials"] == 24 and tot["blocks"] == 3


def test_sparc_sweep_shared_compile_matches_per_point():
    """SparcSweep (one jit for all Eb/N0 points) == per-point jits."""
    from sparc_ldpc_tpu.models.sparc import SparcSweep

    sweep = SparcSweep(CFG)
    for e in (4.0, 6.0):
        pt = sweep.model_for_point(e)
        assert getattr(pt.run_block, "_prejitted", False)
        got = {k: int(v) for k, v in
               pt.run_block(rngu.trial_keys(rngu.base_key(3), 8)).items()
               if k != "tau2_final"}
        ref_model = SparcModel.build(CFG, e)
        ref = {k: int(v) for k, v in
               jax.jit(ref_model.run_block)(
                   rngu.trial_keys(rngu.base_key(3), 8)).items()
               if k != "tau2_final"}
        assert got == ref


def test_concat_staged_matches_monolithic():
    """run_block_staged (bounded per-stage jits) == single-jit run_block."""
    from sparc_ldpc_tpu.config import ConcatConfig, LdpcConfig
    from sparc_ldpc_tpu.models.concat import ConcatModel

    cfg = ConcatConfig(
        sparc=SparcConfig(L=128, M=512, R=1.0, op_kind="hadamard",
                          amp_iters=12, amp_tol=0.0),
        ldpc=LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12,
                        bp_iters=24),
        f_prot=0.5, feedback_iters=4)
    m = ConcatModel.build(cfg, ebno_db=4.5)
    tk = rngu.trial_keys(rngu.base_key(7), 8)
    mono = {k: int(v) for k, v in jax.jit(m.run_block)(tk).items()}
    staged = {k: int(v) for k, v in m.run_block_staged(tk).items()}
    assert mono == staged


def test_concat_sweep_shared_compile_matches_per_point():
    """ConcatSweep (stage jits shared across Eb/N0 points) == per-point
    ConcatModel staged runs, and the jit cache really is shared (3 entries
    after two same-T points, not 6)."""
    from sparc_ldpc_tpu.config import ConcatConfig, LdpcConfig
    from sparc_ldpc_tpu.models.concat import ConcatModel, ConcatSweep

    cfg = ConcatConfig(
        sparc=SparcConfig(L=128, M=512, R=1.0, op_kind="hadamard",
                          amp_iters=12, amp_tol=0.0),
        ldpc=LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12,
                        bp_iters=24),
        f_prot=0.5, feedback_iters=4)
    sweep = ConcatSweep(cfg)
    tk = rngu.trial_keys(rngu.base_key(7), 8)
    for e in (4.0, 4.5):
        pt = sweep.model_for_point(e)
        assert getattr(pt.run_block_staged, "_prejitted", False)
        got = {k: int(v) for k, v in pt.run_block_staged(tk).items()}
        ref_m = ConcatModel.build(cfg, e)
        ref = {k: int(v) for k, v in ref_m.run_block_staged(tk).items()}
        assert got == ref, (e, got, ref)
    assert len(sweep._jits) == 3, sweep._jits.keys()


def test_dist_fwht_matches_local():
    """Hand hypercube-ppermute FWHT (parallel.dist_fwht) == local transform
    on every mesh shape, and self-inverse up to N."""
    from sparc_ldpc_tpu.ops.fwht import fwht_mxu
    from sparc_ldpc_tpu.parallel.dist_fwht import dist_fwht

    x = jnp.asarray(np.random.default_rng(3).standard_normal((8, 512)),
                    jnp.float32)
    ref = fwht_mxu(x, precision="highest")
    for shards in (8, 4, 2, 1):
        mesh = make_mesh(section_shards=shards)
        got = dist_fwht(x, mesh, precision="highest")
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-5, atol=1e-3)
        twice = dist_fwht(got, mesh, precision="highest")
        np.testing.assert_allclose(np.asarray(twice), np.asarray(x) * 512,
                                   rtol=1e-5, atol=1e-2)


def test_collective_fwht_model_matches_single_device():
    """fwht_dist="collective" under a section-sharded mesh reproduces the
    single-device decode counters exactly (same key tree)."""
    model = SparcModel.build(CFG, ebno_db=5.0)
    ref = _counters(model)
    cfg_c = SparcConfig(L=64, M=64, R=1.0, op_kind="hadamard", amp_iters=12,
                        fwht_dist="collective")
    mesh = make_mesh(section_shards=2)
    pol = ShardingPolicy(mesh)
    model_c = SparcModel.build(cfg_c, ebno_db=5.0, policy=pol)
    with jax.sharding.set_mesh(mesh):
        got = _counters(model_c, policy=pol)
    assert got == ref