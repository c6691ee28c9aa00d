"""Campaign CLI (SURVEY.md §1 L6, §3.5).

Presets map to the five judged BASELINE configs (config.PRESETS).  Examples:

  # BER sweep on the flagship power-allocated config
  python -m sparc_ldpc_tpu.cli campaign --preset pa_l1024 \
      --ebno 1.5 2.0 2.5 3.0 --batch 64 --min-frame-errors 50 \
      --out results/pa_l1024.jsonl

  # concatenated SPARC+LDPC with the soft-output pass
  python -m sparc_ldpc_tpu.cli campaign --preset concat --ebno 2.0 \
      --batch 32 --out results/concat.jsonl

  # multi-host: same command on every host; jax.distributed.initialize()
  # reads the coordinator from the cluster environment it finds
  python -m sparc_ldpc_tpu.cli campaign --preset pa_l1024 --distributed

  # state-evolution design report (offline, SURVEY.md §3.4)
  python -m sparc_ldpc_tpu.cli se --preset pa_l1024 --ebno 2.0

Observability: results are structured jsonl (one record per sweep point,
plus per-block journal records for restart); --profile wraps the sweep in
jax.profiler.trace for TensorBoard/Perfetto (SURVEY.md §5).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sparc_ldpc_tpu",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("campaign", help="run a Monte-Carlo BER/FER campaign")
    c.add_argument("--preset", default="plain_small",
                   help="plain_small | pa_l1024 | fast_l4096 | concat | "
                        "concat_wifi | concat_r56")
    c.add_argument("--ebno", type=float, nargs="+", default=None,
                   help="Eb/N0 grid in dB (default: preset grid)")
    c.add_argument("--batch", type=int, default=64)
    c.add_argument("--min-frame-errors", type=int, default=100)
    c.add_argument("--max-trials", type=int, default=100_000)
    c.add_argument("--seed", type=int, default=1234)
    c.add_argument("--out", default=None, help="results jsonl path")
    c.add_argument("--journal", default=None,
                   help="block journal for restart (default: <out>.journal)")
    c.add_argument("--section-shards", type=int, default=1)
    c.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (debug)")
    c.add_argument("--amp-iters", type=int, default=None,
                   help="override the AMP iteration cap (e.g. 64 for "
                        "mid-waterfall points where SE needs >32 iters)")
    c.add_argument("--auto-iters", action="store_true",
                   help="SE-derived per-point AMP iteration budget "
                        "(amp_iters becomes the cap; design/se.py)")
    c.add_argument("--profile", default=None,
                   help="jax.profiler trace output dir")
    c.add_argument("--distributed", action="store_true",
                   help="call jax.distributed.initialize() (multi-host)")

    s = sub.add_parser("se", help="state-evolution design report")
    s.add_argument("--preset", default="pa_l1024")
    s.add_argument("--ebno", type=float, default=2.0)

    b = sub.add_parser("plot", help="render BER/FER curves from jsonl")
    b.add_argument("results", nargs="+")
    b.add_argument("--out", default="curves.png")
    return p


def _get_sparc_preset(name: str):
    from .config import PRESETS, SparcConfig, ConcatConfig
    cfg = PRESETS[name]
    return cfg


def cmd_campaign(args) -> int:
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax

    if args.distributed:
        jax.distributed.initialize()
    is_proc0 = jax.process_index() == 0

    from .config import CampaignConfig, ConcatConfig, SparcConfig
    from .models.concat import ConcatModel
    from .models.sparc import SparcModel
    from .parallel.campaign import run_campaign
    from .parallel.mesh import ShardingPolicy, make_mesh

    cfg = _get_sparc_preset(args.preset)
    if args.amp_iters is not None:
        if args.amp_iters <= 0:
            raise SystemExit(f"--amp-iters must be positive, "
                             f"got {args.amp_iters}")
        if isinstance(cfg, ConcatConfig):
            cfg = cfg.replace(sparc=cfg.sparc.replace(
                amp_iters=args.amp_iters))
        else:
            cfg = cfg.replace(amp_iters=args.amp_iters)
    if args.auto_iters:
        if isinstance(cfg, ConcatConfig):
            cfg = cfg.replace(sparc=cfg.sparc.replace(amp_iters_auto=True))
        else:
            cfg = cfg.replace(amp_iters_auto=True)
    grid = tuple(args.ebno) if args.ebno else (1.5, 2.0, 2.5, 3.0)
    ccfg = CampaignConfig(ebno_grid_db=grid, batch=args.batch,
                          min_frame_errors=args.min_frame_errors,
                          max_trials=args.max_trials, base_seed=args.seed,
                          section_shards=args.section_shards)

    policy = None
    ctx = None
    # the config field is the single truth for the mesh shape (args only
    # feed it above), so programmatic callers get the same behavior
    if ccfg.section_shards > 1 or jax.device_count() > 1:
        mesh = make_mesh(section_shards=ccfg.section_shards)
        policy = ShardingPolicy(
            mesh,
            section_axis="section" if ccfg.section_shards > 1 else None)
        ctx = jax.sharding.set_mesh(mesh)
        ctx.__enter__()

    if isinstance(cfg, ConcatConfig):
        from .models.concat import ConcatSweep
        csweep = ConcatSweep(cfg, policy=policy)
        def model_for_point(e):
            return csweep.model_for_point(e)
        def k_bits(m):
            return m.k_user
    else:
        from .models.sparc import SparcSweep
        sweep = SparcSweep(cfg, policy=policy)
        def model_for_point(e):
            return sweep.model_for_point(e)
        def k_bits(m):
            return m.cfg.k_bits

    out = args.out
    journal = args.journal or (out + ".journal" if out else None)
    if is_proc0:
        print(f"campaign: preset={args.preset} grid={grid} "
              f"batch={args.batch} devices={jax.device_count()} "
              f"section_shards={args.section_shards}")

    from .utils.provenance import artifact_meta

    def go():
        return run_campaign(model_for_point, ccfg, k_bits,
                            journal_path=journal, results_path=out,
                            policy=policy, is_proc0=is_proc0,
                            meta=artifact_meta(args.preset, cfg))

    if args.profile:
        import jax.profiler
        with jax.profiler.trace(args.profile):
            results = go()
        if is_proc0:
            print(f"profile trace written to {args.profile}")
    else:
        results = go()
    if ctx is not None:
        ctx.__exit__(None, None, None)
    return 0


def cmd_se(args) -> int:
    from .config import ConcatConfig
    from .design.power import power_allocation
    from .design.se import se_trajectory

    cfg = _get_sparc_preset(args.preset)
    if isinstance(cfg, ConcatConfig):
        cfg = cfg.sparc
    sigma2 = cfg.sigma2(args.ebno)
    p = power_allocation(cfg.power_alloc, cfg.L, cfg.P, sigma2, cfg.n, cfg.M,
                         cfg.pa_a, cfg.pa_f)
    tr = se_trajectory(p, cfg.n, cfg.M, sigma2)
    rec = dict(preset=args.preset, ebno_db=args.ebno, sigma2=sigma2,
               n=cfg.n, L=cfg.L, M=cfg.M,
               pa_kind=cfg.power_alloc,
               pa_min=float(p.min()), pa_max=float(p.max()),
               se_iters=len(tr) - 1, tau2_final=float(tr[-1]),
               decodes=bool(tr[-1] < 1.25 * sigma2),
               tau2_trace=[round(float(t), 6) for t in tr])
    print(json.dumps(rec, indent=2))
    return 0


def cmd_plot(args) -> int:
    from .utils.io import read_jsonl
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available", file=sys.stderr)
        return 1
    fig, ax = plt.subplots(1, 2, figsize=(11, 4))
    for path in args.results:
        recs = list(read_jsonl(path))
        pts = [r for r in recs if r.get("kind") == "point"]
        if not pts:
            continue
        eb = [r["ebno_db"] for r in pts]
        label = os.path.basename(path).replace(".jsonl", "")
        ax[0].semilogy(eb, [max(r["ber"], 1e-12) for r in pts],
                       "o-", label=label)
        ax[1].semilogy(eb, [max(r["fer"], 1e-12) for r in pts],
                       "s-", label=label)
        # overlay SE-prediction legs when the artifact carries them
        # (e.g. fast_l4096, where the float64 oracle is infeasible)
        se = sorted((r["ebno_db"], r["ber"]) for r in recs
                    if r.get("kind") == "se")
        if se:
            ax[0].semilogy([e for e, _ in se],
                           [max(b, 1e-12) for _, b in se],
                           "k--", alpha=0.7, label=f"{label} (SE)")
    for a, name in zip(ax, ("BER", "FER")):
        a.set_xlabel("Eb/N0 (dB)")
        a.set_ylabel(name)
        a.grid(True, which="both", alpha=0.3)
        a.legend()
    fig.tight_layout()
    fig.savefig(args.out, dpi=130)
    print(f"wrote {args.out}")
    return 0


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "campaign":
        from .utils.runtime import enable_compile_cache
        enable_compile_cache()
        return cmd_campaign(args)
    if args.cmd == "se":
        return cmd_se(args)
    if args.cmd == "plot":
        return cmd_plot(args)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
