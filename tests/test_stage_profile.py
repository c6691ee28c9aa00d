"""scripts/stage_profile.py's trace reduction: HLO instruction -> named
scope -> stage, checked on synthetic HLO and on a compiled CPU program."""

import os
import sys

import jax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import stage_profile as sp  # noqa: E402
from sparc_ldpc_tpu.config import SparcConfig  # noqa: E402
from sparc_ldpc_tpu.models.sparc import SparcModel  # noqa: E402
from sparc_ldpc_tpu.utils import rng as rngu  # noqa: E402

HLO = '''HloModule jit_run_block, entry_computation_layout={()->f32[]}

%body {
  %fusion.3 = f32[4]{0} fusion(%p), kind=kLoop, calls=%fc, metadata={op_name="jit(run_block)/while/body/onsager_denoise/exp"}
  ROOT %custom-call.1 = f32[4]{0} custom-call(%a), custom_call_target="__cublas$gemm", metadata={op_name="jit(run_block)/while/body/amp_transform/dot_general"}
}
'''


def test_hlo_op_names_parses_modules_and_roots():
    names = sp.hlo_op_names(HLO)
    assert set(names) == {"jit_run_block"}
    assert sp.stage_of(names["jit_run_block"]["fusion.3"]) == \
        "onsager_denoise"
    assert sp.stage_of(names["jit_run_block"]["custom-call.1"]) == \
        "amp_transform"


def test_stage_priority_and_whole_segments():
    # feedback wins over the AMP scopes nested inside it
    assert sp.stage_of("jit(s3)/feedback/while/body/amp_transform/dot") == \
        "feedback"
    assert sp.stage_of("jit(x)/llr_bp_extra/add") == "other"
    assert sp.stage_of("") == "other"


def test_compiled_block_carries_stage_scopes():
    m = SparcModel.build(SparcConfig(L=32, M=64, R=1.0, amp_iters=4),
                         ebno_db=5.0)
    text = jax.jit(m.run_block).lower(
        rngu.trial_keys(rngu.base_key(0), 2)).compile().as_text()
    stages = {sp.stage_of(v)
              for d in sp.hlo_op_names(text).values() for v in d.values()}
    assert {"trial_gen", "amp_transform", "onsager_denoise"} <= stages


def test_concat_point_programs_cover_every_stage():
    """ConcatSweep points expose their three staged programs (abstract
    arguments for the later stages) and together they carry every stage
    scope the profiler reduces to."""
    from sparc_ldpc_tpu.config import PRESETS
    from sparc_ldpc_tpu.models.concat import ConcatSweep

    cfg = PRESETS["concat_wifi"]
    pt = ConcatSweep(cfg.replace(sparc=cfg.sparc.replace(L=256))
                     ).model_for_point(3.0)
    progs = pt.programs(rngu.trial_keys(rngu.base_key(0), 2))
    assert [name for name, _, _ in progs] == [
        "s1_gen_amp", "s2_llr_bp", "s3_feedback"]
    stages = set()
    for _, fn, args in progs:
        names = sp.hlo_op_names(fn.lower(*args).compile().as_text())
        stages |= {sp.stage_of(v) for d in names.values() for v in d.values()}
    assert set(sp.STAGES) <= stages
