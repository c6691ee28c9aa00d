"""Card-only tests (marker ``gpu``; skip elsewhere).  Run on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparc_ldpc_tpu.config import PRESETS
from sparc_ldpc_tpu.models.sparc import SparcModel
from sparc_ldpc_tpu.ops.fwht import fwht_mxu
from sparc_ldpc_tpu.oracle.fwht import fwht
from sparc_ldpc_tpu.utils import rng as rngu

# relative L2 error of fwht_mxu against the float64 oracle on an H100, per
# SparcConfig.transform_precision: "highest" is an f32 cuBLAS GEMM
# (measured 3.6e-7), "high" a TF32 cuBLAS GEMM and "default" a TF32 Triton
# GEMM fusion (3.6e-4: 10 mantissa bits), "bf16" rounds the data operand
# to 8 bits (2.9e-3).  Bounds sit ~2-5x above the measurements at
# N = 2^19 and 2^21; a precision that silently changed algorithm fails.
GPU_FWHT_REL_BOUND = {"highest": 2e-6, "high": 1e-3, "default": 1e-3,
                      "bf16": 5e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("precision", sorted(GPU_FWHT_REL_BOUND))
@pytest.mark.parametrize("logN", [19, 21])
def test_fwht_precision_on_gpu(precision, logN, gpu_device):
    x = np.random.default_rng(0).standard_normal((4, 1 << logN))
    x = x.astype(np.float32)
    f = jax.jit(functools.partial(fwht_mxu, precision=precision))
    got = np.asarray(f(jnp.asarray(x)), np.float64)
    want = fwht(x.astype(np.float64))
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < GPU_FWHT_REL_BOUND[precision], (precision, logN, rel)


@pytest.mark.gpu
def test_block_is_deterministic_on_gpu(gpu_device):
    """Same keys -> identical counters (journal restarts replay blocks)."""
    m = SparcModel.build(PRESETS["pa_l1024"], ebno_db=2.25)
    run = jax.jit(m.run_block)
    tk = rngu.trial_keys(rngu.base_key(0), 64)
    a = {k: float(v) for k, v in jax.device_get(run(tk)).items()}
    b = {k: float(v) for k, v in jax.device_get(run(tk)).items()}
    assert a == b
