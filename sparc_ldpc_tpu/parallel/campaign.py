"""Monte-Carlo BER/FER campaign driver (SURVEY.md §3.5, App. A.8).

Per Eb/N0 point: run jitted trial blocks (batch sharded over the 'data' mesh
axis) until the frame-error budget or trial cap is met.  All randomness
flows from the fold_in key tree (base, point, block, trial), so:

  - re-running with a different mesh/device count gives bitwise-identical
    counters (tests/test_parallel.py);
  - completed blocks are journaled (utils.io.CampaignState) and skipped on
    restart; a crash costs only the in-flight block (SURVEY.md §5
    failure-detection/elastic design).

Only process 0 writes results (single-writer rule).  Counters come back as
tiny scalars per block; the cross-device reduction happens inside jit (sum
over the sharded batch axis -> GSPMD psum over 'data').
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import jax

from ..config import CampaignConfig
from ..utils import io as iou
from ..utils import rng as rngu
from .mesh import ShardingPolicy


_COUNTER_KEYS = ("bit_errors", "frame_errors", "section_errors", "trials",
                 "iters_sum", "bp_ok", "bit_errors_sq")


def run_point(
    run_block: Callable,
    point_key: jax.Array,
    batch: int,
    min_frame_errors: int,
    max_trials: int,
    state: Optional[iou.CampaignState] = None,
    point_idx: int = 0,
    policy: Optional[ShardingPolicy] = None,
    is_proc0: bool = True,
    pipelined: bool = True,
) -> Dict[str, float]:
    """Run blocks until the error budget for one sweep point is met.

    Executed-vs-replayed accounting: journal-replayed
    blocks contribute their counters but near-zero wall time, so throughput
    must come from the blocks THIS process actually executed — tracked as
    exec_blocks / exec_trials / exec_wall_s alongside the combined totals.

    Double-buffered dispatch: block b+1 is SUBMITTED before block b's
    counters are read back, so the host round-trip of each `device_get`
    overlaps the next block's device execution instead of idling the
    device.  The budget check therefore sees counters lagged by the one
    in-flight block, which over-dispatches at most one block per point;
    that block is journaled like any other.  To keep restart EXACT,
    journal-replayed blocks flow through the same one-slot pending
    machinery, so the "process block b?" decision always uses totals
    through block b-2 — an interrupted point resumed from the journal
    reproduces the original block set and counters bit-for-bit
    (tests/test_parallel.py::test_campaign_runs_and_resumes).
    ``pipelined=False`` restores strictly synchronous dispatch (the
    round-4 behavior: no over-dispatch, check sees b-1) for A/B
    measurement — block SETS between the two modes differ by that one
    trailing block, so counters are mode-consistent, not cross-mode
    identical.
    """
    totals: Dict[str, float] = {}
    block = 0
    exec_blocks = 0
    exec_trials = 0
    exec_wall = 0.0
    t0 = time.perf_counter()
    t_last = t0
    compiled = None
    pending = None          # ("exec", block_idx, device_out) | ("replay", rec)

    def harvest():
        """Fold the pending block's counters into totals (+journal)."""
        nonlocal pending, exec_blocks, exec_trials, exec_wall, t_last
        if pending is None:
            return
        tag, blk, payload = pending
        pending = None
        if tag == "replay":
            for k in _COUNTER_KEYS:
                if k in payload:
                    totals[k] = totals.get(k, 0) + payload[k]
            t_last = time.perf_counter()
            return
        # one bulk transfer instead of one host round-trip per scalar;
        # blocks until the in-flight computation completes
        out = jax.device_get({k: v for k, v in payload.items()
                              if k in _COUNTER_KEYS})
        out = {k: int(v) for k, v in out.items()}
        now = time.perf_counter()
        blk_s = now - t_last
        t_last = now
        if "first_block_s" not in totals:
            # the first executed block carries jit compilation; record it
            # separately so throughput figures can exclude compile
            totals["first_block_s"] = blk_s
        exec_blocks += 1
        exec_trials += out.get("trials", 0)
        exec_wall += blk_s
        for k, v in out.items():
            totals[k] = totals.get(k, 0) + v
        if state is not None:
            state.record_block(point_idx, blk, out, is_proc0=is_proc0)

    while (totals.get("frame_errors", 0) < min_frame_errors
           and totals.get("trials", 0) < max_trials):
        if state is not None and state.is_done(point_idx, block):
            rec = state.block_record(point_idx, block)
            harvest()
            pending = ("replay", block, rec)
            if not pipelined:
                harvest()
            block += 1
            continue
        tkeys = rngu.trial_keys(rngu.block_key(point_key, block), batch)
        if policy is not None:
            tkeys = jax.device_put(tkeys, policy.batch1())
        if compiled is None:
            # SparcSweep points arrive pre-jitted (shared compilation across
            # sweep points); everything else is jitted here per point.
            compiled = (run_block if getattr(run_block, "_prejitted", False)
                        else jax.jit(run_block))
        out_dev = compiled(tkeys)      # async dispatch: returns immediately
        harvest()                      # now read back the PREVIOUS block
        pending = ("exec", block, out_dev)
        if not pipelined:
            harvest()
        block += 1
    harvest()
    totals["wall_s"] = time.perf_counter() - t0
    totals["blocks"] = block
    totals["exec_blocks"] = exec_blocks
    totals["exec_trials"] = exec_trials
    totals["exec_wall_s"] = exec_wall
    return totals


def steady_bits_per_s(tot: Dict[str, float], batch: int,
                      kb: int) -> Optional[float]:
    """Steady-state throughput: blocks actually executed by this process,
    with the compile-bearing first block excluded.

    Returns None when fewer than two executed blocks exist — a 1-block
    point's only timing datum includes compile, and a journal-replayed
    point did no work here; publishing a number for either would be
    garbage or inflated by replayed trials over near-zero wall.
    first_block_s is always recorded so
    thin points stay diagnosable.
    """
    eb = tot.get("exec_blocks", 0)
    fb = tot.get("first_block_s")
    if fb is None or eb < 2:
        return None
    et = tot.get("exec_trials", 0)
    return ((et - batch) * kb
            / max(tot.get("exec_wall_s", 0.0) - fb, 1e-9))


def run_campaign(
    model_for_point: Callable[[float], object],
    cfg: CampaignConfig,
    k_bits_fn: Callable[[object], int],
    journal_path: Optional[str] = None,
    results_path: Optional[str] = None,
    policy: Optional[ShardingPolicy] = None,
    is_proc0: bool = True,
    verbose: bool = True,
    meta: Optional[Dict[str, object]] = None,
    pipelined: bool = True,
) -> List[Dict[str, float]]:
    """Full Eb/N0 sweep -> list of result records (also jsonl-persisted).

    Args:
      model_for_point: ebno_db -> model exposing .run_block(tkeys).
      k_bits_fn: model -> payload bits per trial (denominator for BER).
      meta: provenance fields merged into every record (preset name,
        config hash, commit — artifacts must be self-identifying so stale sweeps can't masquerade as current).
    """
    state = iou.CampaignState(journal_path) if journal_path else None
    base = rngu.base_key(cfg.base_seed)
    results = []
    for pi, ebno in enumerate(cfg.ebno_grid_db):
        model = model_for_point(ebno)
        pkey = rngu.point_key(base, pi)
        # prefer a staged runner when the model provides one (ConcatModel:
        # three bounded jits); counters are identical (test_parallel).
        run_block = getattr(model, "run_block_staged", None)
        if run_block is None:
            run_block = model.run_block
        tot = run_point(run_block, pkey, cfg.batch,
                        cfg.min_frame_errors, cfg.max_trials,
                        state=state, point_idx=pi, policy=policy,
                        is_proc0=is_proc0, pipelined=pipelined)
        kb = k_bits_fn(model)
        trials = max(1, int(tot.get("trials", 0)))
        rec = dict(
            kind="point", ebno_db=float(ebno),
            ber=tot.get("bit_errors", 0) / (trials * kb),
            fer=tot.get("frame_errors", 0) / trials,
            trials=trials,
            bit_errors=int(tot.get("bit_errors", 0)),
            bit_errors_sq=int(tot.get("bit_errors_sq", 0)),
            frame_errors=int(tot.get("frame_errors", 0)),
            mean_iters=tot.get("iters_sum", 0) / trials,
            wall_s=tot["wall_s"],
            first_block_s=tot.get("first_block_s"),
            bits_per_s=steady_bits_per_s(tot, cfg.batch, kb),
            blocks=int(tot["blocks"]),
            exec_blocks=int(tot.get("exec_blocks", 0)),
            **(meta or {}),
        )
        results.append(rec)
        if results_path and is_proc0:
            iou.append_jsonl(results_path, rec)
        if verbose and is_proc0:
            bps = rec["bits_per_s"]
            bps_s = f"{bps:,.0f} bits/s" if bps else "bits/s: n/a (<2 blocks)"
            print(f"  ebno={ebno:5.2f} dB  ber={rec['ber']:.3e}  "
                  f"fer={rec['fer']:.3e}  trials={trials}  ({bps_s})")
    return results
