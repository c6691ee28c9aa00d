"""Compile-cache placement (utils/runtime.enable_compile_cache), checked in
fresh interpreters so the suite's own JAX config stays untouched."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import jax; from sparc_ldpc_tpu.utils.runtime import "
         "enable_compile_cache; d = enable_compile_cache(); "
         "print(d); print(jax.config.jax_compilation_cache_dir)")


def _probe(env):
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.strip().splitlines()[-2:]


def test_cache_defaults_to_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    ret, cfg = _probe(env)
    want = os.path.join(ROOT, ".jax_cache")
    assert ret == want and cfg == want


def test_cache_env_var_is_honoured(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c"))
    ret, cfg = _probe(env)
    assert ret == str(tmp_path / "c") and cfg == str(tmp_path / "c")
