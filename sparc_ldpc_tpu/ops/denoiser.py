"""Sectionwise posterior-mean softmax denoiser (SURVEY.md §2 #13, App. A.5).

    beta_{l,j} = sqrt(n P_l) * softmax_j( sqrt(n P_l) * s_{l,.} / tau2 )

Numerics (SURVEY.md §7 hard-part 2): the softmax argument scales like
sqrt(n P_l)*s/tau2 which overflows f32 quickly as tau2 shrinks — always
max-subtract per section.  Plain jnp: XLA fuses the elementwise chain and
the two per-section reductions into a few kernels.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def denoise(s: jax.Array, tau2: jax.Array, sq_npl: jax.Array
            ) -> Tuple[jax.Array, jax.Array]:
    """Sectionwise softmax denoiser.

    Args:
      s: (B, L, M) effective observation beta + A^T z.
      tau2: (B,) per-codeword effective noise variance.
      sq_npl: (L,) sqrt(n * P_l).
    Returns:
      (beta, posteriors): (B, L, M) posterior-mean scaled estimate and the
      section posteriors (used by the LDPC LLR pass, SURVEY.md §1 L3->L4).
    """
    a = sq_npl[None, :, None] * s / tau2[:, None, None]
    a = a - jax.lax.stop_gradient(jnp.max(a, axis=-1, keepdims=True))
    e = jnp.exp(a)
    post = e / jnp.sum(e, axis=-1, keepdims=True)
    return sq_npl[None, :, None] * post, post
