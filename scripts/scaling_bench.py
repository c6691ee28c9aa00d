"""Scaling-efficiency harness (BASELINE.md: >=80% at 2 hosts).

Measures Monte-Carlo block throughput vs device count on whatever mesh is
available:
  - on a CPU: N virtual CPU devices (validates the harness + the sharded
    program; CPU timing is NOT a GPU number);
  - on a multi-GPU host: run unchanged (devices come from jax.devices();
    with jax.distributed it spans hosts) — records 1-card/1-host/N-host
    points per the BASELINE measurement plan.

Weak scaling: per-device batch is fixed, so ideal efficiency keeps
blocks/s/device constant.  Efficiency_N = throughput_N / (N * throughput_1).

Usage:
  python scripts/scaling_bench.py                # GPUs/whatever is present
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/scaling_bench.py            # virtual 8-device check
"""

import json
import sys
import time

import jax

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from sparc_ldpc_tpu.config import SparcConfig
from sparc_ldpc_tpu.models.sparc import SparcModel
from sparc_ldpc_tpu.parallel.mesh import ShardingPolicy, make_mesh
from sparc_ldpc_tpu.utils import rng as rngu


def measure(n_dev: int, per_dev_batch: int = 16, reps: int = 5) -> float:
    cfg = SparcConfig(L=256, M=512, R=1.0, op_kind="hadamard",
                      amp_iters=16, amp_tol=0.0)
    mesh = make_mesh(section_shards=1, devices=jax.devices()[:n_dev])
    policy = ShardingPolicy(mesh, section_axis=None)
    model = SparcModel.build(cfg, ebno_db=5.0, policy=policy)
    B = per_dev_batch * n_dev
    run = jax.jit(model.run_block)

    def keys(r):
        k = rngu.trial_keys(rngu.base_key(r), B)
        return jax.device_put(k, policy.batch1())

    with jax.sharding.set_mesh(mesh):
        _ = int(run(keys(99))["bit_errors"])
        ts = []
        for r in range(reps):
            t0 = time.perf_counter()
            out = run(keys(r))
            _ = int(out["bit_errors"])
            ts.append(time.perf_counter() - t0)
    ts.sort()
    med = ts[len(ts) // 2]
    return B * cfg.k_bits / med


def main():
    avail = jax.device_count()
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= avail]
    print(f"devices available: {avail} ({jax.devices()[0].platform} "
          f"{jax.devices()[0].device_kind})", file=sys.stderr)
    results = {}
    for n in counts:
        bps = measure(n)
        results[n] = bps
        eff = bps / (n * results[1])
        print(json.dumps(dict(devices=n, bits_per_s=round(bps, 1),
                              efficiency=round(eff, 3))))


if __name__ == "__main__":
    main()
