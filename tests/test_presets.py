"""Every shipped preset runs end to end on the XLA route.

On the CPU each preset is scaled down in L only (every other field, the
LDPC code and the partition rule are the shipped ones) and driven through
run_block; its lowered program must hold no custom kernel call (Pallas,
Mosaic, Triton).  On the card (marker ``gpu``) the same check runs on the
full-width lowering.
"""

import re

import numpy as np
import pytest

import jax

from sparc_ldpc_tpu.config import PRESETS, ConcatConfig
from sparc_ldpc_tpu.models.concat import ConcatModel
from sparc_ldpc_tpu.models.sparc import SparcModel
from sparc_ldpc_tpu.utils import rng as rngu

# preset -> (L on the CPU, Eb/N0): concat needs L >= 496 to hold whole
# 744-bit array-code codewords on whole 9-bit sections at f_prot=0.5
SCALED_L = {"plain_small": (32, 2.0), "pa_l1024": (64, 2.25),
            "fast_l4096": (128, 6.0), "concat": (512, 3.0),
            "concat_wifi": (256, 3.0), "concat_r56": (256, 3.5)}
KERNEL_CALL = re.compile(r"pallas|mosaic|triton|tpu_custom_call", re.I)


def custom_kernel_calls(hlo_text: str):
    """custom_call targets of a lowered module that name a kernel route."""
    targets = re.findall(r"custom_call\s*@([\w.$]+)", hlo_text)
    targets += re.findall(r'call_target_name\s*=\s*"([^"]+)"', hlo_text)
    return [t for t in targets if KERNEL_CALL.search(t)]


def _model(name, L=None, ebno=3.0):
    cfg = PRESETS[name]
    if isinstance(cfg, ConcatConfig):
        if L is not None:
            cfg = cfg.replace(sparc=cfg.sparc.replace(L=L))
        return ConcatModel.build(cfg, ebno_db=ebno)
    if L is not None:
        cfg = cfg.replace(L=L)
    return SparcModel.build(cfg, ebno_db=ebno)


def test_custom_kernel_call_detector():
    assert custom_kernel_calls(
        'stablehlo.custom_call @tpu_custom_call(%0)') == ["tpu_custom_call"]
    assert custom_kernel_calls(
        'call_target_name = "__gpu$xla.gpu.triton"') == [
            "__gpu$xla.gpu.triton"]
    assert custom_kernel_calls('stablehlo.custom_call @Sharding(%1)') == []


@pytest.mark.parametrize("name", sorted(SCALED_L))
def test_preset_scaled_in_L_runs_on_xla_route(name):
    L, ebno = SCALED_L[name]
    m = _model(name, L, ebno)
    tkeys = rngu.trial_keys(rngu.base_key(1), 2)
    fn = jax.jit(m.run_block)
    assert custom_kernel_calls(fn.lower(tkeys).as_text()) == []
    out = {k: float(v) for k, v in fn(tkeys).items()}
    assert out["trials"] == 2
    assert all(np.isfinite(v) for v in out.values()), out
    kb = m.k_user if isinstance(m, ConcatModel) else m.cfg.k_bits
    assert 0 <= out["bit_errors"] <= 2 * kb


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SCALED_L))
def test_preset_full_width_lowers_without_kernel_calls(name, gpu_device):
    m = _model(name)
    batch = 256 if name == "fast_l4096" else 512
    tkeys = rngu.trial_keys(rngu.base_key(1), batch)
    text = jax.jit(m.run_block).lower(tkeys).as_text()
    assert custom_kernel_calls(text) == []
