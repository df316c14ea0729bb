"""The run manifest, the first record of every metrics file: the port of
``config_hash``, ``git_sha`` and ``run_manifest`` of
``gtopkssgd_tpu/obs/manifest.py``.

``config_hash`` is the same sorted-key sha256 of the full config (its
first 16 hex digits), and the manifest carries the same headline keys.
The JAX backend fields become the port's: ``torch_version``,
``cuda_version``, the card's name and power limit as ``nvidia-smi``
reports them (None off the card), the process group's ``backend`` (nccl
| gloo, None for one process) and ``world_size``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import subprocess
from typing import Any, Dict, Optional

import torch

_HEADLINE_KEYS = ("dnn", "dataset", "compression", "density", "wire_codec",
                  "nworkers", "batch_size", "seed")


def _config_dict(config: Any) -> Dict[str, Any]:
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        return dataclasses.asdict(config)
    return dict(config)


def config_hash(config: Any) -> str:
    """Short hash of the FULL config (sorted-key JSON, other leaves as
    strings): two runs are comparable iff their hashes match."""
    blob = json.dumps(_config_dict(config), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


@functools.lru_cache(maxsize=4)
def git_sha(repo_dir: Optional[str] = None) -> Optional[str]:
    """Short sha of the checkout this package was imported from, with
    '-dirty' when tracked files have changes; None outside a checkout."""
    repo_dir = repo_dir or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=repo_dir, capture_output=True, text=True, timeout=5)
        if out.returncode != 0 or not out.stdout.strip():
            return None
        sha = out.stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain", "--untracked-files=no"],
            cwd=repo_dir, capture_output=True, text=True, timeout=5)
        if dirty.returncode == 0 and dirty.stdout.strip():
            sha += "-dirty"
        return sha
    except (OSError, subprocess.SubprocessError):
        return None


@functools.lru_cache(maxsize=1)
def card_identity() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_fields(device: torch.device) -> Dict[str, Optional[str]]:
    """The card's name and power limit (``nvidia-smi``'s), None each off
    the card."""
    if torch.device(device).type != "cuda":
        return {"device_name": None, "power_limit": None}
    name, _, limit = card_identity().partition(",")
    return {"device_name": name.strip(), "power_limit": limit.strip()}


def run_manifest(config: Any = None, *, device="cpu",
                 backend: Optional[str] = None, world_size: int = 1,
                 **extra) -> Dict[str, Any]:
    """The manifest record's body (the logger adds kind, time and rank);
    ``extra`` lands verbatim (num_params, steps_per_epoch, ...)."""
    man: Dict[str, Any] = {}
    if config is not None:
        cfg = _config_dict(config)
        man["config_hash"] = config_hash(cfg)
        for key in _HEADLINE_KEYS:
            if key in cfg:
                man[key] = cfg[key]
    man["torch_version"] = torch.__version__
    man["cuda_version"] = torch.version.cuda
    man.update(card_fields(device))
    man["backend"] = backend
    man["world_size"] = int(world_size)
    man["git_sha"] = git_sha()
    man.update(extra)
    return man
