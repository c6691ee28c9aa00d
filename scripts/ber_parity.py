"""Deep BER-parity artifact (SURVEY.md §4.3).

For judged configs 1 (plain_small), 2 (pa_l1024), 3 (fast_l4096), reduced
judged-4 chains (concat_small, concat_wifi_small, concat_r56_small) and the
shipped concat geometry (concat_full): oracle sweep (NumPy float64 +
native C++ FWHT), GPU sweep (the shipped XLA route), and the SE prediction
(plain SPARC only), persisted to one jsonl per preset and overlaid in one
plot.  tests/test_ber_parity.py asserts CI overlap from the persisted
artifact.

Trial targets: GPU >= 10^4/point everywhere.  Oracle floors per preset in
ORACLE_TRIALS_FLOOR (float64 trials cost 0.65-8 s each on a CPU core).

Subcommands:
  oracle  --preset pa_l1024 [--trials 10000] [--workers 2]
  gpu     --preset pa_l1024 [--trials 10240] [--batch 1024] [--control]
  se      --preset pa_l1024
  check   [--preset ...]          CI-overlap table from the jsonl
  plot    [--preset ...]          overlay figure -> results/ber_parity_X.png

The gpu subcommand runs in ONE process on one card; every record carries
utils/provenance.artifact_meta (preset, config hash, commit, platform,
device kind and count, the card's name and power limit).  Compile/warmup is
excluded from every throughput figure; records carry compile_s separately.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from sparc_ldpc_tpu.config import (ConcatConfig, LdpcConfig, PRESETS,
                                   SparcConfig)

# Reduced concatenated config for the oracle-vs-GPU concat CI leg: same
# chain as the judged `concat` preset — iterative PA inner SPARC,
# array-code outer LDPC, bp_ok-gated decision feedback — at L=256 so the
# float64 oracle can afford >=5x10^3 trials/point.  The oracle twin
# (oracle/concat.py) implements the identical partition and gating rules.
# The outer decode runs engine="qc", schedule="layered" — the decode path
# the shipped concat presets use; the float64 twin is
# oracle.ldpc.bp_decode_layered.
CONCAT_PRESETS = {
    "concat_small": ConcatConfig(
        sparc=SparcConfig(L=256, M=512, R=1.0, power_alloc="iterative",
                          op_kind="hadamard"),
        ldpc=LdpcConfig(kind="array", z=13, rows_b=3, cols_b=12,
                        bp_iters=24, engine="qc", schedule="layered"),
        f_prot=0.5, feedback_iters=8),
    # Standard-code chain (judged family 4b, `concat_wifi`): the SAME
    # reduced L=256 inner SPARC carrying ONE 802.11n n=648 rate-1/2
    # codeword (72 protected sections = f_prot 0.28), decoded layered on
    # the QC engine — the float64 anchor for the checked-in standard
    # base matrix + its dual-diagonal structure end-to-end.  User rate
    # 1980/2304 = 0.859.
    "concat_wifi_small": ConcatConfig(
        sparc=SparcConfig(L=256, M=512, R=1.0, power_alloc="iterative",
                          op_kind="hadamard"),
        ldpc=LdpcConfig(kind="qc", path="wifi_n648_r12", engine="qc",
                        schedule="layered", bp_iters=32),
        f_prot=0.28, feedback_iters=8),
    # High-rate outer code (judged family 4c, `concat_r56`): the same
    # reduced L=256 inner SPARC carrying ONE constructed rate-5/6 n=648
    # QC codeword (data/qc_n648_r56.qc, 802.11n dual-diagonal structure)
    # — dense check rows (high dc) are where normalized min-sum + LLR
    # clipping are most delicate (the wifi leg covers only the standard
    # r1/2 structure).
    # User rate 2196/2304 = 0.953.
    "concat_r56_small": ConcatConfig(
        sparc=SparcConfig(L=256, M=512, R=1.0, power_alloc="iterative",
                          op_kind="hadamard"),
        ldpc=LdpcConfig(kind="qc", path="qc_n648_r56", engine="qc",
                        schedule="layered", bp_iters=32),
        f_prot=0.28, feedback_iters=8),
    # The SHIPPED full-size concat geometry itself: L=1024, z=31 array
    # code, f_prot=0.5, num_cw=6 codewords/frame — the direct float64 leg,
    # so the anchor does not rest on the L=256 twin and the pa_l1024
    # plain-AMP parity composing.  One
    # pre-waterfall point (3.0 dB: FER=1.0, BER ~1.7e-3 — every frame
    # contributes countable, clustered bit errors, so ~10^3 trials give
    # a tight frame-variance CI at 0.89 s/trial on this 2-core host).
    "concat_full": PRESETS["concat"],
}

GRIDS = {
    "plain_small": [2.0, 3.0, 4.0],
    "pa_l1024": [1.5, 2.25, 3.0],
    # pre-waterfall / mid / post (probed: FER 11/12 -> 4/12 -> 2/12,
    # BER 8.7e-2 -> 2.0e-2 -> 5e-4 at 12 trials); user rate 0.904
    "concat_small": [2.5, 3.0, 3.5],
    # standard-code chain: pre-waterfall / knee / tail (probed at 8
    # trials: FER 7/8 -> 4/8 -> 3/8, BER 8e-2 -> 1.5e-3 -> 8e-4;
    # the unprotected sections dominate residual frame errors)
    "concat_wifi_small": [2.5, 3.0, 3.5],
    # high-rate chain: pre-waterfall / knee / tail (probed at 8 trials:
    # FER 8/8 -> 6/8 -> 3/8, BER 1.4e-1 -> 1.7e-3 -> 7.4e-4 — the
    # rate-5/6 waterfall sits ~0.5 dB above the r1/2 one, same grid)
    "concat_r56_small": [2.5, 3.0, 3.5],
    # shipped full-size geometry: single pre-waterfall anchor (FER=1.0,
    # BER 1.7e-3 probed at 3 trials)
    "concat_full": [3.0],
    # judged config 3 (L=4096, ML=2^21): direct float64 anchors at the
    # waterfall HEAD, where FER~1 makes a few hundred oracle trials a
    # tight BER measurement (~300k bit errors at 5.0 dB); 6.0 dB (~26
    # clustered bit errors/frame), 6.5 dB (~180 frame errors at 300
    # oracle trials, ~8 s/trial on a CPU core) and 7.0 dB (1000 trials ->
    # ~120 clustered frame errors) extend the anchor over the whole
    # fast_l4096 grid.
    "fast_l4096": [5.0, 5.5, 6.0, 6.5, 7.0],
}
# Oracle-leg trial floors enforced by tests/test_ber_parity.py (thin
# oracle legs must not silently slip into a regenerated artifact).  With
# frame-clustered CIs (ci_ber below), each floor is set so the joint 95%
# bound sits well under the decision threshold.
# fast_l4096's 300 trials ride FER=1.0 waterfall-head points where every
# frame contributes ~10^3 bit errors (~3x10^5 total — a tight direct
# anchor); the CI there is frame-variance dominated, not count-limited.
ORACLE_TRIALS_FLOOR = {
    "plain_small": 10_000,
    "pa_l1024": 4_000,
    "concat_small": 5_000,
    "concat_wifi_small": 5_000,
    "concat_r56_small": 5_000,
    # concat_full rides a FER=1.0 point where every frame contributes
    # clustered bit errors (probe mean ~15 bits/frame): at 10^3 trials
    # the frame-variance CI is ~3-4% relative, far under the 15%
    # concat precision floor — trials beyond that change no conclusion
    # (same arithmetic as fast_l4096's waterfall-head anchors).
    "concat_full": 1_000,
    "fast_l4096": 300,
}

# Relative floor on the oracle-vs-GPU bound (run_check / test_ber_parity).
# Default 1%: the allowance for f32-vs-float64 rounding at the plain
# presets' plateau points.  The concatenated chains: 15% — their
# mid-waterfall is a threshold phenomenon where f32 anywhere shifts BER by
# ~12% relative vs float64.  The tight implementation check is therefore
# control-vs-GPU (run_check below, 2% floor: the kind="control_f32xla" leg
# runs every transform at "highest"), and oracle-vs-GPU carries the
# measured precision-sensitivity floor.
REL_FLOOR = {"concat_small": 0.15, "concat_wifi_small": 0.15,
             "concat_r56_small": 0.15, "concat_full": 0.15}
OUT = os.path.join(os.path.dirname(__file__), "..", "results")


def get_cfg(preset):
    return CONCAT_PRESETS.get(preset) or PRESETS[preset]


def out_path(preset):
    return os.path.abspath(os.path.join(OUT, f"ber_parity_{preset}.jsonl"))


def load_records(preset):
    path = out_path(preset)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def append_record(preset, rec):
    rec = dict(rec, preset=preset, ts=time.time())
    with open(out_path(preset), "a") as f:
        f.write(json.dumps(rec, sort_keys=True) + "\n")
    print(json.dumps(rec, sort_keys=True), flush=True)


def have(preset, kind, ebno, min_trials=0):
    return any(r for r in load_records(preset)
               if r["kind"] == kind and abs(r["ebno_db"] - ebno) < 1e-9
               and r.get("trials", 0) >= min_trials)


# ------------------------------------------------------------------ oracle

_W = {}


def _worker_init(preset, ebno):
    from sparc_ldpc_tpu.design.power import power_allocation
    from sparc_ldpc_tpu.oracle import sparc as osparc

    if preset in CONCAT_PRESETS:
        from sparc_ldpc_tpu.oracle.concat import OracleConcat
        _W["concat"] = OracleConcat.build(CONCAT_PRESETS[preset], ebno)
        return
    cfg = PRESETS[preset]
    sigma2 = cfg.sigma2(ebno)
    _W["cfg"] = cfg
    _W["ebno"] = ebno
    _W["p"] = power_allocation(cfg.power_alloc, cfg.L, cfg.P, sigma2,
                               cfg.n, cfg.M, cfg.pa_a, cfg.pa_f)
    _W["op"] = osparc.make_operator(cfg)


def _worker_chunk(seeds):
    from sparc_ldpc_tpu.oracle import sparc as osparc

    be = fe = se_ = be2 = 0
    if "concat" in _W:
        for s in seeds:
            r = _W["concat"].run_trial(s)
            be += r["bit_errors"]
            be2 += r["bit_errors"] ** 2
            fe += r["frame_error"]
        return be, fe, 0, be2, len(seeds)
    for s in seeds:
        r = osparc.run_trial(s, _W["cfg"], _W["ebno"], op=_W["op"],
                             p_alloc=_W["p"])
        be += r["bit_errors"]
        be2 += r["bit_errors"] ** 2
        fe += r["frame_error"]
        se_ += r["section_errors"]
    return be, fe, se_, be2, len(seeds)


def run_oracle(preset, trials, workers):
    from concurrent.futures import ProcessPoolExecutor

    from sparc_ldpc_tpu.oracle.fwht import has_native

    cfg = get_cfg(preset)
    if preset in CONCAT_PRESETS:
        from sparc_ldpc_tpu.oracle.concat import OracleConcat
        kb, L = OracleConcat.build(cfg, GRIDS[preset][0]).k_user, cfg.sparc.L
    else:
        kb, L = cfg.k_bits, cfg.L
    for pi, ebno in enumerate(GRIDS[preset]):
        if have(preset, "oracle", ebno, min_trials=trials):
            print(f"oracle {preset} @ {ebno}: already done", flush=True)
            continue
        # distinct seed space per point (oracle folds seed into its own
        # SeedSequence; the GPU path uses an independent fold_in tree).
        # Chunks are journaled (kind="oracle_chunk") so a killed run
        # resumes where it stopped — campaign.py's restart discipline.
        done = {r["chunk"]: r for r in load_records(preset)
                if r["kind"] == "oracle_chunk"
                and abs(r["ebno_db"] - ebno) < 1e-9}
        chunk_sz = 200
        n_chunks = (trials + chunk_sz - 1) // chunk_sz
        todo = [c for c in range(n_chunks) if c not in done]
        t0 = time.time()
        with ProcessPoolExecutor(
                max_workers=workers, initializer=_worker_init,
                initargs=(preset, ebno)) as ex:
            seed_chunks = [
                [pi * 1_000_000 + c * chunk_sz + i
                 for i in range(min(chunk_sz, trials - c * chunk_sz))]
                for c in todo]
            for c, r in zip(todo, ex.map(_worker_chunk, seed_chunks)):
                append_record(preset, dict(
                    kind="oracle_chunk", ebno_db=ebno, chunk=c,
                    bit_errors=r[0], frame_errors=r[1],
                    section_errors=r[2], bit_errors_sq=r[3], trials=r[4]))
        done = {r["chunk"]: r for r in load_records(preset)
                if r["kind"] == "oracle_chunk"
                and abs(r["ebno_db"] - ebno) < 1e-9}
        be = sum(r["bit_errors"] for r in done.values())
        be2 = sum(r["bit_errors_sq"] for r in done.values())
        fe = sum(r["frame_errors"] for r in done.values())
        se_ = sum(r["section_errors"] for r in done.values())
        tr = sum(r["trials"] for r in done.values())
        append_record(preset, dict(
            kind="oracle", ebno_db=ebno, trials=tr, bit_errors=be,
            bit_errors_sq=be2, frame_errors=fe, section_errors=se_,
            k_bits=kb, L=L, ber=be / (tr * kb),
            fer=fe / tr, ser=se_ / (tr * L), wall_s=time.time() - t0,
            native_fwht=has_native(), dtype="float64"))


# -------------------------------------------------------------------- gpu

def _device_leg(preset, kind, cfg, trials, batch, force):
    """Append one kind=`kind` record per grid point: the JAX route on the
    device at hand, counters summed over whole blocks of the shared-compile
    sweep runners (SparcSweep / ConcatSweep — the path the campaign CLI
    drives), keys from an independent fold_in tree."""
    import jax

    from sparc_ldpc_tpu.models.concat import ConcatSweep
    from sparc_ldpc_tpu.models.sparc import SparcSweep
    from sparc_ldpc_tpu.utils import rng as rngu
    from sparc_ldpc_tpu.utils.provenance import artifact_meta

    concat = isinstance(cfg, ConcatConfig)
    sweep = ConcatSweep(cfg) if concat else SparcSweep(cfg)
    meta = artifact_meta(preset, cfg)
    n_blocks = (trials + batch - 1) // batch
    for pi, ebno in enumerate(GRIDS[preset]):
        if not force and have(preset, kind, ebno,
                              min_trials=n_blocks * batch):
            print(f"{kind} {preset} @ {ebno}: already done", flush=True)
            continue
        pt = sweep.model_for_point(ebno)
        if concat:
            run, kb = pt.run_block_staged, pt.k_user
        else:
            run, kb = pt.run_block, pt.cfg.k_bits
            if not getattr(run, "_prejitted", False):
                run = jax.jit(run)       # SE-schedule configs: per point
        t0 = time.time()
        # warmup compile on a throwaway key block — excluded from wall_s
        _ = int(run(rngu.trial_keys(rngu.base_key(10**6), batch))
                ["bit_errors"])
        compile_s = time.time() - t0
        tot = {}
        t0 = time.time()
        for b in range(n_blocks):
            keys = rngu.trial_keys(
                rngu.block_key(rngu.point_key(rngu.base_key(0), pi), b),
                batch)
            out = jax.device_get(run(keys))
            for k, v in out.items():
                tot[k] = tot.get(k, 0) + float(v)
        wall = time.time() - t0
        tr = int(tot["trials"])
        rec = dict(
            kind=kind, ebno_db=ebno, trials=tr,
            bit_errors=int(tot["bit_errors"]),
            bit_errors_sq=tot["bit_errors_sq"],
            frame_errors=int(tot["frame_errors"]), k_bits=kb,
            L=(cfg.sparc if concat else cfg).L,
            ber=tot["bit_errors"] / (tr * kb),
            fer=tot["frame_errors"] / tr, wall_s=wall, compile_s=compile_s,
            bits_per_s=tr * kb / wall, **meta)
        if concat:
            rec["bp_ok"] = int(tot["bp_ok"])
        else:
            rec["section_errors"] = int(tot["section_errors"])
            rec["ser"] = tot["section_errors"] / (tr * cfg.L)
            rec["amp_iters"] = pt.cfg.amp_iters
        append_record(preset, rec)


def run_gpu(preset, trials, batch, force=False, control=False):
    """GPU parity leg at the preset's own configuration (kind="gpu"), or
    with control=True the f32 control leg (kind="control_f32xla": every
    transform at transform_precision="highest", no bf16 anywhere)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"the gpu leg needs a GPU; JAX found "
                         f"{dev.platform!r}")
    cfg = get_cfg(preset)
    if preset == "fast_l4096":
        batch = min(batch, 256)          # (B, L*M) f32 state at ML=2^21
    if control:
        if isinstance(cfg, ConcatConfig):
            cfg = cfg.replace(sparc=cfg.sparc.replace(
                transform_precision="highest"))
        else:
            cfg = cfg.replace(transform_precision="highest")
    _device_leg(preset, "control_f32xla" if control else "gpu", cfg,
                trials, batch, force)


# --------------------------------------------------------------------- se

def run_se(preset):
    from sparc_ldpc_tpu.design.power import power_allocation
    from sparc_ldpc_tpu.design.se import (se_section_error_rate,
                                          se_trajectory)

    if preset in CONCAT_PRESETS:
        # SE describes the inner AMP only; post-BP/feedback BER has no SE
        # prediction, so the concat artifact is oracle-vs-GPU two-way.
        print(f"se {preset}: N/A for the concatenated chain", flush=True)
        return
    cfg = PRESETS[preset]
    for ebno in GRIDS[preset]:
        sigma2 = cfg.sigma2(ebno)
        p = power_allocation(cfg.power_alloc, cfg.L, cfg.P, sigma2,
                             cfg.n, cfg.M, cfg.pa_a, cfg.pa_f)
        tr = se_trajectory(p, cfg.n, cfg.M, sigma2)
        per_sec = se_section_error_rate(p, cfg.n, float(tr[-1]), cfg.M)
        ser = float(np.mean(per_sec))
        # a wrong index is uniform over the other M-1 -> expected wrong bits
        # per wrong section = logM * M / (2 (M-1))
        ber = ser * cfg.M / (2 * (cfg.M - 1))
        append_record(preset, dict(
            kind="se", ebno_db=ebno, ser=ser, ber=ber,
            tau2_final=float(tr[-1]), se_iters=len(tr) - 1))


# ------------------------------------------------------------ check/plot

def ci(k, n):
    """95% binomial CI half-width (normal approx, floored at the 0-count
    Clopper-Pearson upper bound 3/n)."""
    p = k / n
    return max(1.96 * math.sqrt(max(p * (1 - p), 0.0) / n), 3.0 / n)


def ci_ber(rec):
    """95% CI half-width on BER with FRAME-level clustering: bit errors
    within a frame are strongly correlated (whole sections flip, frames
    sit on one side of the waterfall), so the independent unit is the
    frame.  sigma^2(BER) = Var(per-frame BER) / trials, from the journaled
    per-frame second moment; falls back to the (anti-conservative)
    bit-binomial if the record predates bit_errors_sq."""
    tr, k = rec["trials"], rec["k_bits"]
    if "bit_errors_sq" not in rec:
        return ci(rec["bit_errors"], tr * k)
    mean_be = rec["bit_errors"] / tr
    var_be = max(rec["bit_errors_sq"] / tr - mean_be ** 2, 0.0)
    half = 1.96 * math.sqrt(var_be / tr) / k
    return max(half, 3.0 / (tr * k))


def run_check(presets, strict=True):
    ok = True
    for preset in presets:
        recs = load_records(preset)
        for ebno in GRIDS[preset]:
            o = [r for r in recs if r["kind"] == "oracle"
                 and abs(r["ebno_db"] - ebno) < 1e-9]
            t = [r for r in recs if r["kind"] == "gpu"
                 and abs(r["ebno_db"] - ebno) < 1e-9]
            s = [r for r in recs if r["kind"] == "se"
                 and abs(r["ebno_db"] - ebno) < 1e-9]
            c = [r for r in recs if r["kind"] == "control_f32xla"
                 and abs(r["ebno_db"] - ebno) < 1e-9]
            if not (o and t):
                print(f"{preset} @ {ebno}: MISSING "
                      f"(oracle={bool(o)}, gpu={bool(t)})")
                ok = False
                continue
            o, t = o[-1], t[-1]
            gap = abs(o["ber"] - t["ber"])
            # joint 95% CI, floored at the precision-sensitivity relative
            # bound (REL_FLOOR; default 1%)
            rel = REL_FLOOR.get(preset, 0.01)
            bound = max(math.hypot(ci_ber(o), ci_ber(t)),
                        rel * max(o["ber"], t["ber"]))
            line = (f"{preset} @ {ebno}: oracle {o['ber']:.3e} "
                    f"gpu {t['ber']:.3e} |gap| {gap:.2e} "
                    f"joint95 {bound:.2e} -> "
                    f"{'OK' if gap <= bound else 'APART'}")
            if s:
                line += f"  (SE ber {s[-1]['ber']:.3e})"
            print(line)
            ok &= gap <= bound
            if c:
                # tight same-platform implementation check: the shipped
                # route vs the all-f32 control, both on the card —
                # precision sensitivity mostly cancels, so this stays at a
                # 2% relative floor
                c = c[-1]
                gap_c = abs(c["ber"] - t["ber"])
                bound_c = max(math.hypot(ci_ber(c), ci_ber(t)),
                              0.02 * max(c["ber"], t["ber"]))
                print(f"{preset} @ {ebno}: control(f32 xla) "
                      f"{c['ber']:.3e} vs gpu |gap| {gap_c:.2e} "
                      f"joint95 {bound_c:.2e} -> "
                      f"{'OK' if gap_c <= bound_c else 'APART'}")
                ok &= gap_c <= bound_c
            elif preset in REL_FLOOR:
                # REL_FLOOR presets lean on the control leg to separate
                # precision sensitivity from implementation error — a
                # regenerated artifact must not silently drop it
                print(f"{preset} @ {ebno}: MISSING control_f32xla leg "
                      f"(required for REL_FLOOR presets)")
                ok = False
    return ok


def run_plot(presets):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for preset in presets:
        recs = load_records(preset)
        fig, ax = plt.subplots(figsize=(6, 4.2))
        for kind, fmt, label in (("oracle", "o-", "oracle (float64 CPU)"),
                                 ("gpu", "s--", "GPU (shipped route)"),
                                 ("control_f32xla", "^:",
                                  "GPU control (f32 transforms)")):
            pts = sorted(
                {r["ebno_db"]: r for r in recs if r["kind"] == kind}.items())
            if not pts:
                continue
            x = [p[0] for p in pts]
            y = [p[1]["ber"] for p in pts]
            err = [ci_ber(p[1]) for p in pts]
            ax.errorbar(x, y, yerr=err, fmt=fmt, capsize=3, label=label)
        pts = sorted(
            {r["ebno_db"]: r for r in recs if r["kind"] == "se"}.items())
        if pts:
            ax.plot([p[0] for p in pts], [p[1]["ber"] for p in pts],
                    "k:", label="state evolution")
        ax.set_yscale("log")
        ax.set_xlabel("Eb/N0 (dB)")
        ax.set_ylabel("BER")
        flo = ORACLE_TRIALS_FLOOR.get(preset)
        ax.set_title(f"BER parity — {preset} (>=10^4 GPU / "
                     f">={flo} oracle trials/point, 95% CIs)")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend()
        fig.tight_layout()
        png = out_path(preset).replace(".jsonl", ".png")
        fig.savefig(png, dpi=130)
        print(f"wrote {png}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", choices=["oracle", "gpu", "se", "check", "plot"])
    ap.add_argument("--preset", action="append",
                    choices=list(GRIDS), default=None)
    ap.add_argument("--trials", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--force", action="store_true",
                    help="re-run legs even when records already exist "
                         "(appends; tests read the LAST record per point, "
                         "so this re-anchors the artifact on current code)")
    ap.add_argument("--control", action="store_true",
                    help="gpu leg with every transform at 'highest' -> "
                         "kind='control_f32xla'")
    args = ap.parse_args()
    presets = args.preset or list(GRIDS)
    if args.cmd == "oracle":
        for p in presets:
            run_oracle(p, args.trials, args.workers)
    elif args.cmd == "gpu":
        from sparc_ldpc_tpu.utils.runtime import enable_compile_cache
        enable_compile_cache()
        for p in presets:
            run_gpu(p, max(args.trials, 10240), args.batch,
                    force=args.force, control=args.control)
    elif args.cmd == "se":
        for p in presets:
            run_se(p)
    elif args.cmd == "check":
        sys.exit(0 if run_check(presets) else 1)
    elif args.cmd == "plot":
        run_plot(presets)


if __name__ == "__main__":
    main()
