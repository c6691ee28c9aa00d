"""Artifact provenance.

Every persisted results record should carry the preset name, a hash of the
exact config that produced it, the source commit and the device it ran on,
so a reader can tell whether an artifact still describes the shipped
preset and where its numbers come from.  Frozen dataclass
configs have a deterministic repr, so sha1(repr) is a stable fingerprint
across processes (unlike Python's salted hash()).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import Optional


def config_hash(cfg: object) -> str:
    """12-hex fingerprint of a (frozen, repr-stable) config object."""
    return hashlib.sha1(repr(cfg).encode()).hexdigest()[:12]


def git_commit() -> Optional[str]:
    """Short HEAD commit of the source tree, or None outside a checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        return out.stdout.strip() or None
    except Exception:
        return None


def artifact_meta(preset: str, cfg: object) -> dict:
    """Provenance fields to merge into every results record: preset,
    config hash, commit, and the device the numbers came from (platform,
    device_kind, device count, and the card's name and power limit as
    nvidia-smi reports them — None off a GPU machine)."""
    import jax

    from .runtime import gpu_name_power

    dev = jax.devices()[0]
    meta = dict(preset=preset, config_hash=config_hash(cfg),
                platform=dev.platform, device_kind=dev.device_kind,
                device_count=jax.device_count(),
                power_limit=gpu_name_power())
    commit = git_commit()
    if commit:
        meta["commit"] = commit
    return meta
