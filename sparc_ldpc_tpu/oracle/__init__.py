"""NumPy float64 oracle (SURVEY.md §4.1, §7 M0).

A from-scratch, independent implementation of the full behavioral contract
(SURVEY.md Appendix A): SPARC encode, measurement operators, AMP decode,
LDPC encode/BP, concatenation.  It plays two roles:

1. Parity oracle — the reference repo mount is empty (SURVEY.md §0), so BER
   and trajectory parity of the JAX path is judged against this code plus
   state-evolution predictions.
2. CPU throughput baseline — the >=10x-per-chip target (BASELINE.md) is
   measured against this implementation with the native C++ FWHT
   (native/fwht.cpp) enabled, mirroring the reference lineage's C extension.
"""

from . import fwht, sparc, ldpc  # noqa: F401
