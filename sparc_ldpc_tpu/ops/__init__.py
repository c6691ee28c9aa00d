"""L1/L2 ops and matrix-free operators (SURVEY.md §1), plain jnp/lax.

- fwht:      fast Walsh-Hadamard transform as Kronecker mode contractions
             (batched matmuls).
- dct:       orthonormal DCT-II/III pair (XLA FFT path).
- operators: batched forward/adjoint matvec pairs (dense / partial-Hadamard
             / subsampled-DCT), derived from design.codebook plans.
- denoiser:  sectionwise posterior-mean softmax.
- bp:        padded edge-array LDPC belief propagation.
"""

from .operators import make_operator, BatchedOperator  # noqa: F401
from .fwht import fwht_mxu, hadamard_factor  # noqa: F401
from .denoiser import denoise  # noqa: F401
