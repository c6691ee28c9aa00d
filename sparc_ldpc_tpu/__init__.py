"""SPARC/LDPC coded-modulation framework in JAX/XLA (GPU, CPU for tests).

Built from scratch against the behavioral contract in SURVEY.md (the
reference repo mount is empty — SURVEY.md §0); correctness is judged against
the NumPy oracle in sparc_ldpc_tpu.oracle plus state-evolution predictions.

Layers (SURVEY.md §1):
  config    — typed, jit-static configuration (L1..L6 shared)
  design    — host-side code design: power allocation, SE, operator plans,
              LDPC construction (inputs to both oracle and JAX paths)
  oracle    — NumPy float64 reference implementation + CPU baseline
  ops       — L1/L2 transforms, denoiser, BP & matrix-free operators (XLA)
  models    — L3/L4 algorithms: AMP, LDPC BP, concatenation pipelines
  parallel  — L0/L5 mesh, shardings, Monte-Carlo campaign driver
  utils     — bits, RNG key-tree, jsonl IO
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    SparcConfig, LdpcConfig, ConcatConfig, CampaignConfig, PRESETS,
)
