"""Smoke run of the SPARC/LDPC Monte-Carlo path on a GPU.

    python chip_smoke.py          # one card: every preset at full width
    python chip_smoke.py --four   # four cards: the multi-card legs only

The parent process stays off JAX and runs each phase as a child process,
one at a time, so only one process holds the card:

  smi       nvidia-smi name and power limit; build the oracle's native FWHT
  device    JAX must report a GPU (no CPU fallback)
  campaign  per preset: `python -m sparc_ldpc_tpu.cli campaign` for three
            blocks at the preset's full width -> BER/FER
  block     per preset: compile time, compiled.memory_analysis(), peak
            device memory, and one block run twice on the same keys with
            identical counters (journal restarts depend on it)
  amp       pa_l1024 and fast_l4096 AMP on 4 codewords against the float64
            oracle (oracle.sparc.amp_decode) on the same y
  bp        concat_wifi's QC layered BP on the card against the float64
            layered twin (oracle.ldpc) on the same LLRs
  pytest    the card-only tests: JAX_PLATFORMS=cuda pytest -m gpu tests/

--four runs only: a concat_wifi data-parallel campaign over 4 cards, and
pa_l1024 section-sharded at S=4 (fwht_dist "gspmd" and "collective"), each
against the same blocks on one card.

A failed phase makes the script print {"ok": false, ...} and exit 1.  On
success the last line is
{"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}.
Full child logs go to chiprun_out/smoke/.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from sparc_ldpc_tpu.utils.runtime import SMI_QUERY, parse_smi_csv, smi_text

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "smoke")
RESULT = "RESULT "          # prefix of a child's machine-readable line

# preset -> (campaign batch, Eb/N0 in dB): the shipped widths, each at a
# point of its parity grid (scripts/ber_parity.py GRIDS)
SMOKE_PRESETS = {
    "plain_small": (2048, 2.0),
    "pa_l1024": (2048, 2.25),
    "fast_l4096": (256, 6.0),
    "concat": (512, 3.0),
    "concat_wifi": (512, 3.0),
    "concat_r56": (512, 3.5),
}
AMP_ORACLE_PRESETS = ("pa_l1024", "fast_l4096")
# relative tolerance on the tau2 trajectory against the float64 oracle, by
# the preset's transform_precision: bf16 rounds the transform's data
# operand to 8 mantissa bits (~0.4% per entry) and T iterations carry it
# into tau2; the f32 precisions round far less
TAU2_RTOL = {"bf16": 2e-2, "default": 2e-2, "high": 2e-2, "highest": 1e-3}
# BP posterior tolerance (absolute LLR units) against the float64 twin:
# f32 rounding of message sums bounded by the +-20 clip drifts through the
# layered recursion of frames that run all 32 iterations
BP_POSTERIOR_ATOL = 1e-2


def result_line(platform: str, kind: str, count: int) -> str:
    """The exact last line of a successful run."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def phases(four: bool) -> list:
    """[(name, argv)] in run order; argv None means the parent runs it."""
    py = sys.executable
    me = os.path.abspath(__file__)
    out = [("smi", None), ("native", None),
           ("device", [py, me, "--phase", "device"])]
    if four:
        return out + [("four_concat_dp",
                       [py, me, "--phase", "four_concat_dp"]),
                      ("four_pa_s4", [py, me, "--phase", "four_pa_s4"])]
    for p, (b, e) in SMOKE_PRESETS.items():
        out.append((f"campaign:{p}", [
            py, "-m", "sparc_ldpc_tpu.cli", "campaign", "--preset", p,
            "--ebno", str(e), "--batch", str(b),
            # the pipelined driver over-dispatches one block past the
            # budget: 2 blocks of trials -> 3 blocks executed
            "--max-trials", str(2 * b), "--min-frame-errors", str(10**9),
            "--out", os.path.join(OUT, f"campaign_{p}.jsonl")]))
        out.append((f"block:{p}", [py, me, "--phase", "block",
                                   "--preset", p]))
    for p in AMP_ORACLE_PRESETS:
        out.append((f"amp:{p}", [py, me, "--phase", "amp", "--preset", p]))
    out.append(("bp:concat_wifi", [py, me, "--phase", "bp"]))
    out.append(("pytest", [py, "-m", "pytest", "-m", "gpu", "-q",
                           "-p", "no:cacheprovider", "tests/"]))
    return out


# ---------------------------------------------------------------- parent

def _run_child(name: str, argv: list, timeout: int = 900):
    env = dict(os.environ)
    if name == "pytest":
        env["JAX_PLATFORMS"] = "cuda"
    log = os.path.join(OUT, name.replace(":", "_") + ".log")
    t0 = time.perf_counter()
    try:
        p = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=timeout)
        rc, so, se = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, so, se = 124, e.stdout or "", (e.stderr or "") + "\nTIMEOUT"
        so = so.decode() if isinstance(so, bytes) else so
        se = se.decode() if isinstance(se, bytes) else se
    with open(log, "w") as f:
        f.write(so + "\n--- stderr ---\n" + se)
    res = [json.loads(line[len(RESULT):]) for line in so.splitlines()
           if line.startswith(RESULT)]
    shown = [line for line in so.splitlines()
             if not line.startswith(RESULT)][-12:]
    print(f"[{name}] rc={rc} {time.perf_counter() - t0:.1f}s")
    for line in shown:
        print(f"  {line}")
    if rc != 0:
        for line in se.strip().splitlines()[-15:]:
            print(f"  ! {line}")
    return rc, (res[-1] if res else None)


def _campaign_summary(name: str) -> None:
    path = os.path.join(OUT, f"campaign_{name.split(':')[1]}.jsonl")
    for line in open(path):
        r = json.loads(line)
        print(f"  -> BER {r['ber']:.4e} FER {r['fer']:.4e} "
              f"trials {r['trials']} blocks {r['blocks']} "
              f"first_block_s {r['first_block_s']:.2f} "
              f"bits/s {r['bits_per_s']} [{r.get('power_limit')}]")


def main_parent(four: bool) -> int:
    os.makedirs(OUT, exist_ok=True)
    failed = []
    device = None
    for name, argv in phases(four):
        if name == "smi":
            text = smi_text()
            if not text:
                print(f"[smi] {' '.join(SMI_QUERY)} failed: no GPU host")
                failed.append(name)
                break
            rows = parse_smi_csv(text)
            for line in text.strip().splitlines():
                print(line.strip())
            print(f"[smi] {len(rows)} card(s)")
            continue
        if name == "native":
            p = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                               capture_output=True, text=True)
            print(f"[native] make -C native rc={p.returncode}")
            if p.returncode != 0:
                print(p.stdout[-2000:] + p.stderr[-2000:])
                failed.append(name)
            continue
        if name.startswith("campaign:"):
            for f in (argv[-1], argv[-1] + ".journal"):
                if os.path.exists(f):
                    os.remove(f)
        rc, res = _run_child(name, argv)
        if rc == 0 and name.startswith("campaign:"):
            _campaign_summary(name)
        own_phase = "--phase" in argv       # reports ok in its RESULT line
        if rc != 0 or (own_phase and not (res or {}).get("ok")):
            failed.append(name)
        if name == "device":
            if rc != 0 or not res or res.get("platform") != "gpu":
                break                     # no card: nothing else can run
            device = res
    if failed or device is None:
        print(json.dumps({"ok": False, "failed": failed}))
        return 1
    print(result_line(device["platform"], device["kind"], device["count"]))
    return 0


# ---------------------------------------------------------------- phases

def _emit(**kw) -> None:
    print(RESULT + json.dumps(kw, default=str), flush=True)


def _setup():
    from sparc_ldpc_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()


def phase_device() -> None:
    import jax

    devs = jax.devices()
    d = devs[0]
    print(f"jax {jax.__version__}: {d.platform} {d.device_kind} "
          f"x{len(devs)}")
    _emit(ok=d.platform == "gpu", platform=d.platform,
          kind=d.device_kind, count=len(devs))


def _sweep_point(preset: str, ebno: float, policy=None):
    """(sweep point, staged?) exactly as the campaign CLI builds it."""
    from sparc_ldpc_tpu.config import PRESETS, ConcatConfig
    from sparc_ldpc_tpu.models.concat import ConcatSweep
    from sparc_ldpc_tpu.models.sparc import SparcSweep

    cfg = PRESETS[preset]
    if isinstance(cfg, ConcatConfig):
        return ConcatSweep(cfg, policy=policy).model_for_point(ebno), True
    return SparcSweep(cfg, policy=policy).model_for_point(ebno), False


def phase_block(preset: str) -> None:
    import jax

    from sparc_ldpc_tpu.utils import rng as rngu

    _setup()
    batch, ebno = SMOKE_PRESETS[preset]
    pt, staged = _sweep_point(preset, ebno)
    tkeys = rngu.trial_keys(rngu.base_key(7), batch)
    # the campaign phase compiled these programs into the persistent
    # cache, so the times below are cache loads; its first_block_s holds
    # the cold compile
    for name, fn, args in pt.programs(tkeys):
        t0 = time.perf_counter()
        ma = fn.lower(*args).compile().memory_analysis()
        print(f"{name}: compile {time.perf_counter() - t0:.2f}s; "
              f"memory_analysis: args {ma.argument_size_in_bytes} out "
              f"{ma.output_size_in_bytes} temp {ma.temp_size_in_bytes} "
              f"bytes")
    run = pt.run_block_staged if staged else pt.run_block
    outs = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = {k: float(v) for k, v in jax.device_get(run(tkeys)).items()}
        outs.append(out)
        print(f"block of {batch}: {time.perf_counter() - t0:.3f}s {out}")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    same = outs[0] == outs[1]
    print(f"peak_bytes_in_use {peak}; same keys twice -> identical "
          f"counters: {same}")
    _emit(ok=same, preset=preset, peak_bytes_in_use=peak, counters=outs[0])


def phase_amp(preset: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sparc_ldpc_tpu.config import PRESETS
    from sparc_ldpc_tpu.models.sparc import SparcModel
    from sparc_ldpc_tpu.oracle import sparc as osparc
    from sparc_ldpc_tpu.utils.compare import decision_flips

    _setup()
    _, ebno = SMOKE_PRESETS[preset]
    cfg = PRESETS[preset]
    m = SparcModel.build(cfg, ebno_db=ebno)
    B = 4
    key = jax.random.key(11)
    bits = jax.random.bernoulli(jax.random.fold_in(key, 0), 0.5,
                                (B, cfg.k_bits)).astype(jnp.int32)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (B, cfg.n))
    y = jax.jit(m.encode)(bits) + noise * np.sqrt(m.sigma2)
    r = jax.jit(m.decode)(y)
    beta = np.asarray(r.beta)
    trace = np.asarray(r.tau2_trace)
    its = np.asarray(r.iters)
    op = osparc.make_operator(cfg)
    y64 = np.asarray(y, np.float64)
    rtol = TAU2_RTOL[cfg.transform_precision]
    ok = True
    worst = 0.0
    beta_o = []
    t0 = time.perf_counter()
    for b in range(B):
        o = osparc.amp_decode(y64[b], cfg, m.p_alloc, op)
        beta_o.append(o.beta.reshape(cfg.L, cfg.M))
        t = min(o.iters, int(its[b]))
        rel = float(np.max(np.abs(trace[:t, b] - o.tau2_trace[:t])
                           / o.tau2_trace[:t]))
        worst = max(worst, rel)
        ok &= rel <= rtol
        print(f"codeword {b}: iters gpu {int(its[b])} oracle {o.iters}; "
              f"tau2 final gpu {trace[int(its[b]) - 1, b]:.6f} oracle "
              f"{o.tau2_trace[-1]:.6f}; max rel tau2 diff {rel:.2e}")
    d = decision_flips(beta, np.stack(beta_o))
    ok &= d["decisive"] == 0 and d["flips"] <= 0.01 * d["sections"]
    print(f"{preset} @ {ebno} dB, transform_precision="
          f"{cfg.transform_precision}: tau2 max rel diff {worst:.2e} "
          f"(tol {rtol:g}); decisions: {d['flips']} flips of "
          f"{d['sections']}, {d['decisive']} decisive (margin 2e-2); "
          f"oracle {time.perf_counter() - t0:.1f}s")
    _emit(ok=bool(ok), preset=preset, tau2_max_rel=worst, tol=rtol,
          flips=d["flips"], decisive=d["decisive"])


def phase_bp() -> None:
    import jax
    import numpy as np

    from sparc_ldpc_tpu.config import PRESETS
    from sparc_ldpc_tpu.design.ldpc_codes import qc_structure
    from sparc_ldpc_tpu.models.concat import ConcatModel
    from sparc_ldpc_tpu.oracle.ldpc import bp_decode_layered
    from sparc_ldpc_tpu.utils import rng as rngu

    _setup()
    _, ebno = SMOKE_PRESETS["concat_wifi"]
    cfg = PRESETS["concat_wifi"]
    m = ConcatModel.build(cfg, ebno_db=ebno)
    _, _, beta, _ = jax.jit(m._stage_gen_amp)(
        rngu.trial_keys(rngu.base_key(5), 8))
    llr = jax.jit(m._protected_llrs_from_beta)(beta)
    llr = llr.reshape(-1, m.ldpc.n)
    res = jax.device_get(jax.jit(m.ldpc.decode)(llr))
    llr64 = np.asarray(llr, np.float64)
    shifts, Z = qc_structure(cfg.ldpc)
    lc = cfg.ldpc
    n_diff = 0
    worst = 0.0
    for c in range(llr64.shape[0]):
        hard, tot, _ = bp_decode_layered(
            llr64[c], m.ldpc.code, shifts, Z, iters=lc.bp_iters,
            method=lc.decoder, alpha=lc.alpha, beta=lc.beta,
            clip=lc.llr_clip)
        n_diff += int(np.sum(np.asarray(res.hard[c]) != hard))
        worst = max(worst, float(np.max(np.abs(res.posterior[c] - tot))))
    ok = n_diff == 0 and worst <= BP_POSTERIOR_ATOL
    print(f"concat_wifi @ {ebno} dB: {llr64.shape[0]} codewords, "
          f"{int(np.sum(res.ok))} syndrome-ok; hard decisions differing "
          f"from the float64 twin: {n_diff}; max |posterior diff| "
          f"{worst:.2e} (tol {BP_POSTERIOR_ATOL:g}, f32 on the card)")
    _emit(ok=bool(ok), hard_diff=n_diff, posterior_max_abs=worst)


def _counters(out) -> dict:
    import jax

    return {k: float(v) for k, v in jax.device_get(out).items()}


def phase_four_concat_dp() -> None:
    """concat_wifi: a data-parallel campaign over 4 cards on a fixed key
    tree against the same blocks on one card."""
    import jax

    from sparc_ldpc_tpu.config import CampaignConfig
    from sparc_ldpc_tpu.parallel.campaign import run_campaign
    from sparc_ldpc_tpu.parallel.mesh import ShardingPolicy, make_mesh

    _setup()
    assert jax.device_count() >= 4, jax.devices()
    batch, ebno = SMOKE_PRESETS["concat_wifi"]
    ccfg = CampaignConfig(ebno_grid_db=(ebno,), batch=batch,
                          min_frame_errors=10**9, max_trials=2 * batch,
                          base_seed=31)
    mesh = make_mesh(section_shards=1, devices=jax.devices()[:4])
    pol = ShardingPolicy(mesh, section_axis=None)
    recs = {}
    for tag, policy in (("4 cards", pol), ("1 card", None)):
        pt, _ = _sweep_point("concat_wifi", ebno, policy=policy)
        t0 = time.perf_counter()
        if policy is not None:
            with jax.sharding.set_mesh(mesh):
                r = run_campaign(lambda e: pt, ccfg, lambda m: m.k_user,
                                 policy=policy, verbose=False)[0]
        else:
            with jax.default_device(jax.devices()[0]):
                r = run_campaign(lambda e: pt, ccfg, lambda m: m.k_user,
                                 verbose=False)[0]
        recs[tag] = {k: r[k] for k in ("bit_errors", "frame_errors",
                                       "trials", "blocks")}
        recs[tag]["mean_iters"] = r["mean_iters"]
        print(f"concat_wifi DP campaign, {tag}: {recs[tag]} "
              f"({time.perf_counter() - t0:.1f}s, bits/s "
              f"{r['bits_per_s']})")
    same = recs["4 cards"] == recs["1 card"]
    print(f"4-card counters == 1-card counters: {same}")
    _emit(ok=same, four=recs["4 cards"], one=recs["1 card"])


def s4_legs(cfg, ebno: float, batch: int, devices, seed: int = 17) -> dict:
    """cfg section-sharded at S=4 over `devices` ("gspmd" and "collective")
    against the same blocks on devices[0].

    The pass condition runs with the early stop off (amp_tol=0, all T
    iterations), so every codeword follows one trajectory on every route:
    the run_block counters must be equal, or else every decision that
    differs on those blocks must be a near-tie by the margin-aware rule.
    At the shipped amp_tol the spread of per-codeword stop iterations is
    reported beside it, not judged: a tolerance at the f32 noise floor of
    tau2 lets rounding move a stop by an iteration."""
    import jax
    import numpy as np

    from sparc_ldpc_tpu.models.sparc import SparcModel
    from sparc_ldpc_tpu.parallel.mesh import ShardingPolicy, make_mesh
    from sparc_ldpc_tpu.utils import rng as rngu
    from sparc_ldpc_tpu.utils.compare import decision_flips

    mesh = make_mesh(section_shards=4, devices=devices[:4])
    pol = ShardingPolicy(mesh)
    tkeys = rngu.trial_keys(rngu.base_key(seed), batch)
    errs = ("bit_errors", "frame_errors", "section_errors", "iters_sum")

    def run(c, policy, counters):
        m = SparcModel.build(c, ebno_db=ebno, policy=policy)
        sigma = np.float32(np.sqrt(m.sigma2))
        tk = tkeys if policy is None else jax.device_put(tkeys,
                                                         policy.batch1())
        _, _, r = jax.jit(m.decode_block)(tk, m.sq_npl, sigma)
        beta, iters = np.asarray(r.beta), np.asarray(r.iters)
        cnt = (_counters(jax.jit(m.run_block)(tk)) if counters else None)
        return beta.reshape(batch, cfg.L, cfg.M), iters, cnt

    fixed = cfg.replace(amp_tol=0.0)
    with jax.default_device(devices[0]):
        beta1, _, c1 = run(fixed, None, True)
        _, stop1, _ = run(cfg, None, False)
    print(f"S=4 legs, L={cfg.L} M={cfg.M} @ {ebno} dB, {batch} codewords, "
          f"T={cfg.amp_iters}, transform_precision="
          f"{cfg.transform_precision}; 1 device, amp_tol=0: "
          f"{ {k: c1[k] for k in errs} }")
    ok = True
    out = {}
    for dist in ("gspmd", "collective"):
        with jax.sharding.set_mesh(mesh):
            beta4, _, c4 = run(fixed.replace(fwht_dist=dist), pol, True)
            _, stop4, _ = run(cfg.replace(fwht_dist=dist), pol, False)
        eq = all(c4[k] == c1[k] for k in errs)
        d = decision_flips(beta1, beta4)
        leg_ok = eq or d["decisive"] == 0
        ok &= leg_ok
        moved = stop4 != stop1
        out[dist] = dict(counters_equal=eq, flips=d["flips"],
                         decisive=d["decisive"], ok=bool(leg_ok),
                         stop_moved=int(moved.sum()),
                         stop_max_shift=int(np.abs(stop4 - stop1).max()))
        print(f"S=4 {dist}, amp_tol=0: counters {c4}, equal: {eq}; "
              f"differing decisions {d['flips']} of {d['sections']}, "
              f"{d['decisive']} decisive (margin 2e-2) -> ok {leg_ok}")
        print(f"S=4 {dist}, shipped amp_tol={cfg.amp_tol:g} (reading, not "
              f"judged): {int(moved.sum())}/{batch} codewords stop on "
              f"another iteration than on 1 device, max shift "
              f"{out[dist]['stop_max_shift']}; iters_sum 1 device "
              f"{int(stop1.sum())}, S=4 {int(stop4.sum())}")
    return dict(ok=bool(ok), **out)


def phase_four_pa_s4() -> None:
    """pa_l1024 section-sharded at S=4 on four cards (s4_legs)."""
    import jax

    from sparc_ldpc_tpu.config import PRESETS

    _setup()
    assert jax.device_count() >= 4, jax.devices()
    _, ebno = SMOKE_PRESETS["pa_l1024"]
    _emit(**s4_legs(PRESETS["pa_l1024"], ebno, 64, jax.devices()))


PHASES = {"device": phase_device, "block": phase_block, "amp": phase_amp,
          "bp": phase_bp, "four_concat_dp": phase_four_concat_dp,
          "four_pa_s4": phase_four_pa_s4}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card legs")
    ap.add_argument("--phase", choices=sorted(PHASES), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--preset", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.phase is None:
        return main_parent(args.four)
    fn = PHASES[args.phase]
    fn(args.preset) if args.preset else fn()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
