"""Headline benchmark: AMP-decoded bits/s/chip, rate 1.0, L=1024.

BASELINE.md: the primary metric is accelerator decode throughput on the
flagship config (power-allocated SPARC L=1024, M=512, R=1.0,
partial-Hadamard operator), with `vs_baseline` = GPU bits/s divided by the
CPU oracle's bits/s on the *same* decode (NumPy float64 + native C++ FWHT,
one thread, built from source on the host — the honest reference-lineage
CPU path).  Target: >=10x.

Prints ONE json line: {"metric", "value", "unit", "vs_baseline"}.
Diagnostics, including the device and its power limit, go to stderr.
Refuses to run without a GPU.
"""

from __future__ import annotations

import json
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def measure_cpu_oracle(cfg, ebno_db: float, T: int) -> float:
    """Oracle decode throughput (bits/s) on one codeword, native FWHT."""
    import numpy as np
    from sparc_ldpc_tpu.design.power import power_allocation
    from sparc_ldpc_tpu.oracle import sparc as osparc
    from sparc_ldpc_tpu.oracle.fwht import has_native

    sigma2 = cfg.sigma2(ebno_db)
    p = power_allocation(cfg.power_alloc, cfg.L, cfg.P, sigma2, cfg.n, cfg.M)
    op = osparc.make_operator(cfg)
    rng = np.random.default_rng(np.random.SeedSequence([0x7124A1, 0]))
    bits = rng.integers(0, 2, cfg.k_bits)
    x = osparc.encode(bits, cfg, p, op)
    y = osparc.awgn(x, sigma2, rng)
    # warmup + timed decode at fixed T (same iteration count as GPU path)
    osparc.amp_decode(y, cfg, p, op, T=2)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        osparc.amp_decode(y, cfg, p, op, T=T)
    dt = (time.perf_counter() - t0) / reps
    log(f"cpu oracle: {dt*1e3:.0f} ms/codeword (T={T}, "
        f"native_fwht={has_native()}, one thread) -> "
        f"{cfg.k_bits/dt:,.0f} bits/s")
    return cfg.k_bits / dt


def main():
    import jax
    from sparc_ldpc_tpu.config import SparcConfig
    from sparc_ldpc_tpu.models.sparc import SparcModel
    from sparc_ldpc_tpu.utils import rng as rngu
    from sparc_ldpc_tpu.utils.runtime import enable_compile_cache, \
        gpu_name_power

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX found "
                         f"{dev.platform!r} ({dev.device_kind})")
    enable_compile_cache()
    log(f"device: {dev.platform} {dev.device_kind} x{jax.device_count()} "
        f"[{gpu_name_power()}]")

    T = 32          # fixed AMP iteration budget (SE needs 28 iters @ 2 dB —
                    # R=1.0 is only 0.24 dB above the Shannon limit here)
    B = 2048        # codewords per block
    EBNO = 2.0
    # amp_iters_auto: SE-derived per-point iteration budget — SE plateaus
    # at t=19 (tol 1e-4) at this operating point, so T_eff = 22 with
    # margin 3; T=32 stays the cap.
    cfg = SparcConfig(L=1024, M=512, R=1.0, power_alloc="iterative",
                      op_kind="hadamard", amp_iters=T, amp_tol=0.0,
                      transform_precision="bf16", amp_iters_auto=True)

    model = SparcModel.build(cfg, ebno_db=EBNO)
    log(f"SE-derived iteration budget: T={model.cfg.amp_iters} (cap {T})")

    run = jax.jit(model.run_block)
    tkeys = rngu.trial_keys(rngu.base_key(0), B)

    t0 = time.perf_counter()
    out = {k: v.block_until_ready() for k, v in run(tkeys).items()}
    log(f"compile+first block: {time.perf_counter()-t0:.1f}s  "
        f"section_errors={int(out['section_errors'])}/{B*cfg.L} "
        f"tau2_final={float(out['tau2_final']):.4f} "
        f"(sigma2={model.sigma2:.4f})")

    # steady-state timing: fresh key block per rep and a scalar host
    # readback per rep.  Rep r+1 is submitted before rep r's counters are
    # read back — the dispatch pattern of the campaign driver
    # (parallel/campaign.py double-buffering).
    reps = 5
    times = []
    pend = None
    t0 = time.perf_counter()
    for r in range(1, reps + 1):
        keys = rngu.trial_keys(rngu.base_key(r), B)
        nxt = run(keys)
        if pend is not None:
            _ = int(pend["bit_errors"])
            now = time.perf_counter()
            times.append(now - t0)
            t0 = now
        pend = nxt
    _ = int(pend["bit_errors"])
    now = time.perf_counter()
    times.append(now - t0)
    times.sort()
    dt = times[len(times) // 2]
    gpu_bits_per_s = B * cfg.k_bits / dt
    log(f"gpu: {dt*1e3:.1f} ms/block of {B} -> {gpu_bits_per_s:,.0f} bits/s")

    # the oracle gets the same SE-derived budget — the speedup ratio must
    # compare equal work (model.cfg.amp_iters is the post-auto value).
    cpu_bits_per_s = measure_cpu_oracle(cfg, EBNO, model.cfg.amp_iters)
    ratio = gpu_bits_per_s / cpu_bits_per_s

    print(json.dumps({
        "metric": "amp_decoded_bits_per_s_per_chip_L1024_R1",
        "value": round(gpu_bits_per_s, 1),
        "unit": "bits/s",
        "vs_baseline": round(ratio, 2),
    }))


if __name__ == "__main__":
    main()
