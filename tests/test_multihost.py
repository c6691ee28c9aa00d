"""Multi-host smoke: 2 local processes + jax.distributed on localhost
(SURVEY.md §4.4 'Multi-host logic tested with multiple local processes').

Asserts the 2-process global-mesh counters equal a single-process run with
the same key tree (the multi-host determinism contract).
"""

import json
import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_counters_match_single():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "scripts", "multihost_worker.py")
    port = _free_port()

    def env_for(pid, nproc):
        env = dict(os.environ)
        env.update(SPARC_COORD=f"localhost:{port}", SPARC_NPROC=str(nproc),
                   SPARC_PROC_ID=str(pid))
        # one CPU device per process
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
        return env

    procs = [subprocess.Popen([sys.executable, worker],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env_for(pid, 2))
             for pid in range(2)]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{se[-2000:]}"
    two_proc = json.loads(outs[0][0].strip().splitlines()[-1])

    # single process, same key tree
    port2 = _free_port()
    env = env_for(0, 1)
    env["SPARC_COORD"] = f"localhost:{port2}"
    r = subprocess.run([sys.executable, worker], capture_output=True,
                       text=True, env=env, timeout=420)
    assert r.returncode == 0, r.stderr[-2000:]
    one_proc = json.loads(r.stdout.strip().splitlines()[-1])

    assert two_proc == one_proc


@pytest.mark.slow
def test_two_process_section_sharded_collective_matches_single():
    """2 processes x section sharding with the hand ppermute FWHT
    (fwht_dist="collective") == single-process unsharded counters: the
    cross-PROCESS collective path of parallel.dist_fwht."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "scripts", "multihost_worker.py")
    port = _free_port()

    def env_for(pid, nproc, extra=None):
        env = dict(os.environ)
        env.update(SPARC_COORD=f"localhost:{port}", SPARC_NPROC=str(nproc),
                   SPARC_PROC_ID=str(pid))
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("XLA_FLAGS", None)
        env.update(extra or {})
        return env

    extra = {"SPARC_SECTION_SHARDS": "2", "SPARC_FWHT_DIST": "collective"}
    procs = [subprocess.Popen([sys.executable, worker],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env_for(pid, 2, extra))
             for pid in range(2)]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{se[-2000:]}"
    sharded = json.loads(outs[0][0].strip().splitlines()[-1])

    port2 = _free_port()
    env = env_for(0, 1)
    env["SPARC_COORD"] = f"localhost:{port2}"
    r = subprocess.run([sys.executable, worker], capture_output=True,
                       text=True, env=env, timeout=420)
    assert r.returncode == 0, r.stderr[-2000:]
    single = json.loads(r.stdout.strip().splitlines()[-1])

    assert sharded == single


@pytest.mark.slow
def test_four_process_two_device_counters_match_single():
    """4 processes x 2 local devices each (8-device global mesh), with the
    section-sharded collective FWHT — process-count generality beyond the
    2-process smoke: proc0-only writes, key-tree
    folding, and the cross-process ppermute butterflies must all hold when
    the process grid is neither 1 nor 2 and each process carries multiple
    devices.  Counters must equal a single-process single-device run of
    the same key tree."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "scripts", "multihost_worker.py")
    port = _free_port()

    def env_for(pid, nproc, devices, extra=None):
        env = dict(os.environ)
        env.update(SPARC_COORD=f"localhost:{port}", SPARC_NPROC=str(nproc),
                   SPARC_PROC_ID=str(pid))
        env["JAX_PLATFORMS"] = "cpu"
        if devices > 1:
            env["XLA_FLAGS"] = (
                f"--xla_force_host_platform_device_count={devices}")
        else:
            env.pop("XLA_FLAGS", None)
        env.update(extra or {})
        return env

    extra = {"SPARC_SECTION_SHARDS": "2", "SPARC_FWHT_DIST": "collective"}
    procs = [subprocess.Popen([sys.executable, worker],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env_for(pid, 4, 2, extra))
             for pid in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{se[-2000:]}"
    sharded = json.loads(outs[0][0].strip().splitlines()[-1])

    port2 = _free_port()
    env = env_for(0, 1, 1)
    env["SPARC_COORD"] = f"localhost:{port2}"
    r = subprocess.run([sys.executable, worker], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    single = json.loads(r.stdout.strip().splitlines()[-1])

    assert sharded == single
