"""Process set-up shared by the entry points: the persistent compile cache
and the facts about the card that every measurement is reported beside.

Used by the campaign CLI, bench.py, chip_smoke.py's phase children and
scripts/ber_parity.py.  Nothing here runs at import time.
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Optional, Tuple

# root of the source checkout (the directory holding the package)
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here.  Otherwise the cache lives at <checkout>/.jax_cache (a
    fixed path, so later processes of the same checkout hit it).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def parse_smi_csv(text: str) -> List[Tuple[str, str]]:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    output -> [(name, power_limit), ...], one tuple per card."""
    rows = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        name, sep, power = line.rpartition(",")
        if not sep or not name.strip() or not power.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        rows.append((name.strip(), power.strip()))
    return rows


def smi_text() -> Optional[str]:
    """Raw nvidia-smi name/power-limit CSV, or None where there is none."""
    try:
        out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout if out.returncode == 0 else None


def gpu_name_power() -> Optional[str]:
    """"<name>, <power limit>" of the first card, or None off a GPU host."""
    text = smi_text()
    rows = parse_smi_csv(text) if text else []
    return ", ".join(rows[0]) if rows else None
