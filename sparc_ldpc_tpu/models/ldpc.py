"""Device-side LDPC code bundle: encoder + BP tables (SURVEY.md §2 #16-19).

Construction and GF(2) systematization are host-side (design.ldpc_codes);
this module ships the results to the device: the generator as an int8 matrix
(encode = int matmul mod 2) and the padded BP adjacency
tables (ops.bp).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LdpcConfig
from ..design.ldpc_codes import LdpcCode, adjacency, build_code, qc_structure
from ..ops.bp import BpResult, BpTables, bp_decode
from ..ops.bp_qc import QcBpTables, bp_decode_qc


@dataclass(frozen=True)
class LdpcModel:
    cfg: LdpcConfig
    code: LdpcCode                  # host truth (numpy)
    G: jax.Array                    # (k, n) int8 device generator
    H: jax.Array                    # (m, n) int8 device parity-check
    tables: BpTables
    msg_pos: jax.Array              # (k,) message positions in codeword
    qc_tables: Optional[QcBpTables] = None

    @staticmethod
    def build(cfg: LdpcConfig) -> "LdpcModel":
        code = build_code(cfg)
        qc = qc_structure(cfg)
        if cfg.engine == "qc" and qc is None:
            raise ValueError(f"bp engine {cfg.engine!r} needs a QC code, "
                             f"got kind={cfg.kind!r}")
        return LdpcModel(
            cfg=cfg, code=code,
            G=jnp.asarray(code.G, dtype=jnp.int8),
            H=jnp.asarray(code.H, dtype=jnp.int8),
            tables=BpTables.build(code),
            msg_pos=jnp.asarray(code.message_positions, dtype=jnp.int32),
            qc_tables=QcBpTables.build(*qc) if qc is not None else None)

    @property
    def k(self) -> int:
        return self.code.k

    @property
    def n(self) -> int:
        return self.code.n

    def encode(self, bits: jax.Array) -> jax.Array:
        """(B, k) {0,1} -> (B, n) systematic codewords (int32 matmul mod 2)."""
        prod = jnp.dot(bits.astype(jnp.int32), self.G.astype(jnp.int32),
                       preferred_element_type=jnp.int32)
        return (prod & 1).astype(jnp.int32)

    def decode(self, llr: jax.Array, iters: Optional[int] = None) -> BpResult:
        use_qc = (self.cfg.engine == "qc"
                  or (self.cfg.engine == "auto" and self.qc_tables is not None))
        if use_qc:
            return bp_decode_qc(llr, self.qc_tables,
                                iters=iters or self.cfg.bp_iters,
                                method=self.cfg.decoder, alpha=self.cfg.alpha,
                                beta=self.cfg.beta, clip=self.cfg.llr_clip,
                                schedule=self.cfg.schedule)
        return bp_decode(llr, self.tables,
                         iters=iters or self.cfg.bp_iters,
                         method=self.cfg.decoder, alpha=self.cfg.alpha,
                         beta=self.cfg.beta, clip=self.cfg.llr_clip)

    def extract_message(self, codeword_bits: jax.Array) -> jax.Array:
        """(B, n) -> (B, k) message bits at the systematic positions."""
        return jnp.take(codeword_bits, self.msg_pos, axis=-1)
