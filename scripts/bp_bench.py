"""A/B the LDPC BP engines on the real chip (whole jitted blocks, distinct inputs per rep, forced scalar readback).

Usage: python scripts/bp_bench.py [--B 192] [--sigma 0.62] [--reps 5]
Code = the judged concat preset's array code (z=31, 4x24 -> n=744).
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from sparc_ldpc_tpu.config import LdpcConfig
from sparc_ldpc_tpu.models.ldpc import LdpcModel


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=192)
    ap.add_argument("--sigma", type=float, default=0.62)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=64)
    args = ap.parse_args()

    print("devices:", jax.devices())
    base = LdpcConfig(kind="array", z=31, rows_b=4, cols_b=24,
                      bp_iters=args.iters)
    variants = {
        "edge/flooding": base.replace(engine="edge"),
        "qc/flooding": base.replace(engine="qc"),
        "qc/layered": base.replace(engine="qc", schedule="layered"),
    }

    rng = np.random.default_rng(0)
    code = LdpcModel.build(base).code
    u = rng.integers(0, 2, (args.reps + 1, args.B, code.k)).astype(np.uint8)
    cw = code.encode(u.reshape(-1, code.k)).reshape(args.reps + 1, args.B,
                                                    code.n)
    y = (1.0 - 2.0 * cw) + args.sigma * rng.standard_normal(cw.shape)
    llrs = jnp.asarray(2.0 * y / args.sigma**2, dtype=jnp.float32)

    for name, cfg in variants.items():
        lm = LdpcModel.build(cfg)
        fn = jax.jit(lm.decode)
        t0 = time.perf_counter()
        r = fn(llrs[0])
        ok0 = int(jnp.sum(r.ok))
        compile_s = time.perf_counter() - t0
        times = []
        oks = its = errs = 0
        for i in range(1, args.reps + 1):
            t0 = time.perf_counter()
            r = fn(llrs[i])
            oks += int(jnp.sum(r.ok))          # forces readback
            times.append(time.perf_counter() - t0)
            its += int(jnp.sum(r.iters))
            errs += int(jnp.sum(r.hard != cw[i]))
        ms = 1e3 * float(np.median(times))
        print(f"{name:16s} {ms:8.2f} ms/block  ok={oks}/{args.reps*args.B}"
              f"  iters_sum={its}  bit_err={errs}  compile={compile_s:.1f}s"
              f"  (warm ok={ok0})")


if __name__ == "__main__":
    main()
