"""Per-stage device time of one Monte-Carlo block per preset, from a
jax.profiler trace (GPU).

    python scripts/stage_profile.py [--preset P ...] [--out DIR]

For each preset: build the sweep point exactly as the campaign CLI does,
run one warm-up block (compile), then trace one block and reduce the
trace's device events by the named scopes the models put on each stage:

  trial_gen        message bits, noise, encode (SparcModel / ConcatModel)
  amp_transform    the A / A^T transforms inside the AMP scan
  onsager_denoise  Onsager coefficient, tau2 and the softmax denoiser
  llr_bp           LLR extraction + layered BP (concat presets)
  feedback         the pinned decision-feedback AMP pass (concat presets)

Each kernel in the trace names its HLO module and instruction (the script
turns XLA's CUDA-graph command buffers off so that every kernel, GEMMs
included, is launched and named on its own); the compiled HLO of the same
programs maps those to their op_name metadata, which carries the scope
path.  A kernel belongs to the first of feedback,
llr_bp, trial_gen, amp_transform, onsager_denoise on its path; the rest is
"other".  Prints each stage's device time and share, device busy and
idle share over the traced window, the AMP time per iteration (the scan
runs all T iterations; early stop is a freeze mask) and the BP decode time.
One process, one card.
"""

from __future__ import annotations

import argparse
import glob
import re
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import SMOKE_PRESETS  # noqa: E402  preset -> (batch, dB)

STAGES = ("feedback", "llr_bp", "trial_gen", "amp_transform",
          "onsager_denoise")


_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"')


def hlo_op_names(hlo_text: str) -> dict:
    """Compiled (optimized) HLO text -> {module: {instruction: op_name}}.
    The trace names each kernel by module and instruction; the op_name
    metadata carries the jax.named_scope path."""
    out = {}
    cur = None
    for line in hlo_text.splitlines():
        if line.startswith("HloModule "):
            cur = out.setdefault(line.split()[1].rstrip(","), {})
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur[m.group(1)] = m.group(2)
    return out


def stage_of(op_name: str) -> str:
    return next((s for s in STAGES if f"/{s}/" in f"/{op_name}/"), "other")


def reduce_trace(xplane_path: str, op_names: dict) -> dict:
    """Device time per stage (ns), device busy/idle over the window."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    per = {s: 0 for s in STAGES + ("other",)}
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                if "hlo_op" not in st:
                    continue          # memcpys of the host readback
                ops = op_names.get(st.get("hlo_module"), {})
                name = ops.get(st["hlo_op"], ops.get(ev.name, ""))
                per[stage_of(name)] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns
                                  + ev.duration_ns))
    intervals.sort()
    busy = 0
    cur_s = cur_e = None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = (intervals[-1][1] - intervals[0][0]) if intervals else 0
    return dict(stage_ns=per, busy_ns=busy, window_ns=window)


def profile(preset: str, out_dir: str) -> dict:
    import jax

    from sparc_ldpc_tpu.config import PRESETS, ConcatConfig
    from sparc_ldpc_tpu.models.concat import ConcatSweep
    from sparc_ldpc_tpu.models.sparc import SparcSweep
    from sparc_ldpc_tpu.utils import rng as rngu

    cfg = PRESETS[preset]
    concat = isinstance(cfg, ConcatConfig)
    sweep = ConcatSweep(cfg) if concat else SparcSweep(cfg)
    B, ebno = SMOKE_PRESETS[preset]
    pt = sweep.model_for_point(ebno)
    run = pt.run_block_staged if concat else pt.run_block
    jax.device_get(run(rngu.trial_keys(rngu.base_key(1), B)))   # compile
    t0 = time.perf_counter()
    jax.device_get(run(rngu.trial_keys(rngu.base_key(2), B)))
    wall = time.perf_counter() - t0
    d = os.path.join(out_dir, preset)
    with jax.profiler.trace(d):
        jax.device_get(run(rngu.trial_keys(rngu.base_key(3), B)))
    path = sorted(glob.glob(os.path.join(d, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    op_names = {}
    for _, fn, args in pt.programs(rngu.trial_keys(rngu.base_key(3), B)):
        op_names.update(hlo_op_names(fn.lower(*args).compile().as_text()))
    red = reduce_trace(path, op_names)
    sp = cfg.sparc if concat else cfg
    total = sum(red["stage_ns"].values()) or 1
    amp_ns = (red["stage_ns"]["amp_transform"]
              + red["stage_ns"]["onsager_denoise"])
    rec = dict(
        preset=preset, batch=B, ebno_db=ebno,
        transform_precision=sp.transform_precision, amp_iters=sp.amp_iters,
        block_wall_s_untraced=wall,
        device_busy_share=red["busy_ns"] / max(red["window_ns"], 1),
        window_ms=red["window_ns"] / 1e6,
        stage_ms={k: v / 1e6 for k, v in red["stage_ns"].items()},
        stage_share={k: v / total for k, v in red["stage_ns"].items()},
        # main AMP pass only: the feedback pass is its own stage
        amp_ms_per_iter=amp_ns / 1e6 / sp.amp_iters,
        bp_decode_ms=red["stage_ns"]["llr_bp"] / 1e6 if concat else None)
    return rec


def main():
    # one launch per HLO op, so every kernel (GEMMs included) carries its
    # instruction name; XLA's CUDA-graph command buffers would hide them.
    # Block times printed here are therefore without command buffers.
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", action="append", default=None,
                    choices=sorted(SMOKE_PRESETS))
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "traces"))
    args = ap.parse_args()

    import jax

    from sparc_ldpc_tpu.utils.runtime import (enable_compile_cache,
                                              gpu_name_power)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"stage_profile traces the GPU; JAX found "
                         f"{dev.platform!r}")
    enable_compile_cache()
    card = gpu_name_power()
    for p in args.preset or list(SMOKE_PRESETS):
        rec = profile(p, args.out)
        rec.update(device_kind=dev.device_kind, card=card)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
