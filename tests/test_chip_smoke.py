"""chip_smoke.py helpers: phase selection, the exact last line, nvidia-smi
CSV parsing, and refusal without a GPU (the script itself runs on the card;
these tests check what surrounds it)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from sparc_ldpc_tpu.utils.runtime import parse_smi_csv  # noqa: E402


def test_result_line_is_exact():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_one_card_phases_cover_every_preset():
    names = [n for n, _ in chip_smoke.phases(four=False)]
    assert names[:3] == ["smi", "native", "device"]
    for p in chip_smoke.SMOKE_PRESETS:
        assert f"campaign:{p}" in names and f"block:{p}" in names
    assert {"amp:pa_l1024", "amp:fast_l4096", "bp:concat_wifi",
            "pytest"} <= set(names)
    assert not [n for n in names if n.startswith("four_")]
    camp = dict(chip_smoke.phases(four=False))["campaign:pa_l1024"]
    assert camp[1:4] == ["-m", "sparc_ldpc_tpu.cli", "campaign"]


def test_four_selects_only_the_multi_card_legs():
    names = [n for n, _ in chip_smoke.phases(four=True)]
    assert names == ["smi", "native", "device", "four_concat_dp",
                     "four_pa_s4"]


def test_s4_legs_on_virtual_devices():
    """The --four S=4 comparison at a small L on 4 virtual CPU devices:
    with the stop off both sharded routes hold the one-device counters,
    and the shipped-tolerance stop spread is reported."""
    import jax

    from sparc_ldpc_tpu.config import SparcConfig

    cfg = SparcConfig(L=64, M=64, R=1.0, op_kind="hadamard", amp_iters=12,
                      amp_tol=1e-4)
    res = chip_smoke.s4_legs(cfg, 6.0, 8, jax.devices()[:4])
    assert res["ok"], res
    for dist in ("gspmd", "collective"):
        assert res[dist]["counters_equal"] and not res[dist]["decisive"]
        assert res[dist]["stop_max_shift"] >= 0


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W\n",
     [("NVIDIA H100 80GB HBM3", "700.00 W")]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\n" * 4 + "\n",
     [("NVIDIA H100 80GB HBM3", "500.00 W")] * 4),
    ("Some, Card, Name, 350.00 W", [("Some, Card, Name", "350.00 W")]),
])
def test_parse_smi_csv(text, want):
    assert parse_smi_csv(text) == want


@pytest.mark.parametrize("bad", ["no comma here", ", 700.00 W", "H100,"])
def test_parse_smi_csv_rejects_malformed(bad):
    with pytest.raises(ValueError):
        parse_smi_csv(bad)


def test_device_phase_refuses_cpu():
    """The device phase reports ok=false on a CPU backend, and the parent
    then stops with a non-zero exit and an ok=false last line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py", "--phase",
                        "device"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1][len("RESULT "):])
    assert res["ok"] is False and res["platform"] == "cpu"


def test_script_without_gpu_host_fails_without_a_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PATH=os.path.dirname(sys.executable))   # no nvidia-smi
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and "device" not in last


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
