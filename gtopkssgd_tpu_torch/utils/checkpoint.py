"""Checkpoints that keep the error-feedback residual, the port of
``gtopkssgd_tpu/utils/checkpoint.py`` on ``torch.save`` / ``torch.load``.

A save holds the whole training state of one rank as a flat mapping of
named tensors (the trainer's ``checkpoint_state``: the step, the weights
and BatchNorm statistics, the SGD momentum buffers, the residual and the
count, and what else the run needs to go on bitwise). Each rank writes
its own file, ``<dir>/<step>/rank<r>.pt``: each rank has its own
residual, as the JAX package's ``P('dp')`` shards are each their own.
A file is written to a temporary name and renamed, so a file that exists
is whole unless the disk tore it.

Integrity, after the JAX design: once every rank has written its file,
rank 0 writes the sidecar ``integrity-<step>.json`` with the run's
config hash, a digest of the state's names, shapes and dtypes
(``state_digest``) and ``meta`` (the world size). ``restore`` checks the
sidecar BEFORE it reads a tensor:

  config hash mismatch -> CheckpointMismatch (resuming under other flags
                          changes the experiment; ``allow_mismatch`` is
                          the explicit escape hatch)
  digest mismatch      -> CheckpointMismatch (the state's structure
                          changed); ``allow_mismatch`` lets it through
                          too, as in the JAX package
  other world size     -> ValueError: a resume at another P needs the
                          residual re-partitioned, which is the elastic
                          resume of ROADMAP.md section 1, item 7
  unreadable file      -> the previous step, with a warning (a machine
                          killed mid-save leaves a torn latest step); at
                          P > 1 the ranks agree on the newest step every
                          one of them can read

A step without a sidecar is not complete and is never restored. The last
``max_to_keep`` steps are kept.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

ROADMAP_ELASTIC = "ROADMAP.md section 1, item 7 (elastic resume)"


class CheckpointMismatch(RuntimeError):
    """Refusal to restore a checkpoint whose recorded config hash or state
    digest disagrees with the restoring run's."""


def state_digest(state: Mapping[str, torch.Tensor]) -> str:
    """Short digest of a state's STRUCTURE: its names with each tensor's
    shape and dtype. Equal digests are restore-compatible."""
    blob = json.dumps([[name, list(t.shape), str(t.dtype)]
                       for name, t in sorted(state.items())])
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


class CheckpointManager:
    """Per-rank ``torch.save`` checkpoints in `directory`, with the
    integrity sidecars of the module docstring. `group` is the process
    group of a P-rank run (None for one process): ``save`` and
    ``restore`` are then collective."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 config_hash: Optional[str] = None, rank: int = 0,
                 group=None, logger: Optional[logging.Logger] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.config_hash = config_hash
        self.rank = rank
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.logger = logger or logging.getLogger(__name__)
        self.last_restored_step: Optional[int] = None
        os.makedirs(self.directory, exist_ok=True)

    def _rank_path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), f"rank{self.rank}.pt")

    def _integrity_path(self, step: int) -> str:
        return os.path.join(self.directory, f"integrity-{step}.json")

    def _barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def _read_integrity(self, step: int) -> Optional[dict]:
        try:
            with open(self._integrity_path(step)) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def all_steps(self) -> List[int]:
        """The complete steps (those with a sidecar), ascending."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        steps = []
        for name in names:
            stem = name[len("integrity-"):-len(".json")]
            if (name.startswith("integrity-") and name.endswith(".json")
                    and stem.isdigit()):
                steps.append(int(stem))
        return sorted(steps)

    def save(self, step: int, state: Mapping[str, torch.Tensor]) -> None:
        """Write this rank's `state` for `step`; collective at P > 1."""
        path = self._rank_path(step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        torch.save({name: t.detach().cpu() for name, t in state.items()},
                   tmp)
        os.replace(tmp, path)
        self._barrier()  # every rank's file is in place
        if self.rank == 0:
            rec = {"step": int(step), "config_hash": self.config_hash,
                   "state_digest": state_digest(state),
                   "meta": {"world_size": self.world}}
            side = self._integrity_path(step)
            with open(side + ".tmp", "w") as fh:
                json.dump(rec, fh, sort_keys=True)
                fh.write("\n")
            os.replace(side + ".tmp", side)
            self._prune()
        self._barrier()

    def _prune(self) -> None:
        """Keep the newest ``max_to_keep`` steps (files and sidecars)."""
        for step in self.all_steps()[:-self.max_to_keep]:
            try:
                os.remove(self._integrity_path(step))
            except OSError:
                pass
            shutil.rmtree(os.path.join(self.directory, str(step)),
                          ignore_errors=True)

    def _verify(self, step: int, digest: str, allow_mismatch: bool) -> None:
        rec = self._read_integrity(step) or {}
        saved_world = int(rec.get("meta", {}).get("world_size", 1))
        if saved_world != self.world:
            raise ValueError(
                f"checkpoint step {step} in {self.directory} was saved by "
                f"{saved_world} rank(s), this run has {self.world}: a "
                f"resume at another P re-partitions the residual, which "
                f"is {ROADMAP_ELASTIC}, not ported")
        problems = []
        want = rec.get("config_hash")
        if (want is not None and self.config_hash is not None
                and want != self.config_hash):
            problems.append(f"config_hash {want} != this run's "
                            f"{self.config_hash} (different flags)")
        if rec.get("state_digest") != digest:
            problems.append(f"state digest {rec.get('state_digest')} != "
                            f"this run's {digest} (state structure change)")
        if not problems:
            return
        msg = (f"checkpoint step {step} in {self.directory} does not match "
               "this run: " + "; ".join(problems))
        if allow_mismatch:
            self.logger.warning("%s; restoring anyway (allow_ckpt_mismatch)",
                                msg)
            return
        raise CheckpointMismatch(msg + " (pass --allow-ckpt-mismatch to "
                                       "override)")

    def _all_ok(self, ok: bool) -> bool:
        if self.group is None:
            return ok
        flag = torch.tensor([int(ok)], dtype=torch.int32)
        if dist.get_backend(self.group) == "nccl":
            flag = flag.cuda()
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
        return bool(flag.item())

    def restore(self, digest: str, *, allow_mismatch: bool = False,
                device="cpu") -> Optional[Dict[str, torch.Tensor]]:
        """This rank's state of the newest complete step that every rank
        can read (None when there is no step), on `device`. `digest` is
        ``state_digest`` of the state this run would save."""
        candidates = sorted(self.all_steps(), reverse=True)
        for s in candidates:
            self._verify(s, digest, allow_mismatch)
            state, err = None, None
            try:
                state = torch.load(self._rank_path(s), map_location=device,
                                   weights_only=True)
            except Exception as e:  # torn or unreadable: the step before
                err = e
            if not self._all_ok(state is not None):
                self.logger.warning(
                    "checkpoint step %d unreadable (%s); falling back to "
                    "the previous step", s,
                    "another rank's file" if err is None
                    else f"{type(err).__name__}: {str(err)[:200]}")
                continue
            if s != candidates[0]:
                self.logger.warning("restored FALLBACK step %d (latest "
                                    "step %d was unreadable)", s,
                                    candidates[0])
            self.last_restored_step = s
            return state
        if candidates:
            raise RuntimeError(f"no restorable checkpoint in "
                               f"{self.directory} (tried {candidates})")
        return None
