"""BASELINE config 3 smoke: matrix-free L=4096 (ML = 2^21) end-to-end.

The transform here is the 'long-context analog' (SURVEY.md §5): three
128-sized Kronecker factors, no dense matrix anywhere.  Kept small-batch /
few-iteration so the CPU CI stays fast; the full-scale path is exercised on
the GPU by chip_smoke.py, bench.py and scripts/.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sparc_ldpc_tpu.config import SparcConfig
from sparc_ldpc_tpu.models.sparc import SparcModel
from sparc_ldpc_tpu.ops.fwht import factorize_pow2


# R=1.5 exceeds the flat-allocation threshold (~0.72 bits/use at any SNR),
# so this config REQUIRES the SE-derived allocation; SE says it decodes in
# 14 iterations at 8 dB.
CFG = SparcConfig(L=4096, M=512, R=1.5, power_alloc="iterative",
                  op_kind="hadamard", amp_iters=18)


def test_l4096_factors():
    assert factorize_pow2(CFG.ML) == (128, 128, 128)
    assert CFG.n == 24576  # n = L*logM/R = 4096*9/1.5
    assert CFG.ML == 1 << 21


def test_l4096_decodes_high_snr():
    model = SparcModel.build(CFG, ebno_db=8.0)
    out = model.run_trials(jax.random.key(0), batch=2)
    assert int(out["section_errors"]) == 0
    assert int(out["bit_errors"]) == 0


def test_l4096_dct_adjointness(rng):
    """<Ax, z> == <x, A^T z> at ML = 2^21, normalized by ||Ax|| ||z||.

    The error must be normalized by the PRODUCT NORM, not by |<Ax, z>|:
    the two vectors are independent, so the inner product itself is a
    near-cancelling sum (E = 0) and dividing by it made the round-1 bound
    an effectively absolute 5e-2.  Measured normalized error of the
    DCT-II/III ortho pair at this size: ~2e-9 (f32 CPU backend) — the XLA
    FFT pair is structurally adjoint; 1e-7 leaves 30x headroom.
    """
    cfg = CFG.replace(op_kind="dct")
    from sparc_ldpc_tpu.ops.operators import make_operator
    op = make_operator(cfg)
    beta = jnp.asarray(rng.standard_normal((1, cfg.ML)), dtype=jnp.float32)
    z = jnp.asarray(rng.standard_normal((1, cfg.n)), dtype=jnp.float32)
    Ab, Az = op.Ax(beta), op.Ay(z)
    lhs = float(jnp.sum(Ab * z))
    rhs = float(jnp.sum(beta * Az))
    scale = float(jnp.linalg.norm(Ab) * jnp.linalg.norm(z))
    assert abs(lhs - rhs) < 1e-7 * scale, (lhs, rhs, scale)
