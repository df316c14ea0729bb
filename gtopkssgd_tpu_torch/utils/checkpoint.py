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
  other world size     -> ValueError, unless ``elastic``: then the
                          residual is re-partitioned onto this run's P
                          (``resilience.elastic``): rank r adds up the
                          old rows ``source_rows`` names (its own, then
                          r + P * j on a shrink; none, zeros, for a rank
                          a grow added), its rank-local entries come
                          from its old rank's file (a new rank keeps its
                          own), the replicated ones from any file
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
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from gtopkssgd_tpu_torch.resilience.elastic import source_rows

#: Entries whose name starts so are the rank's row of a per-rank buffer,
#: re-partitioned by an elastic restore (the residual's layouts).
FOLD_PREFIX = "residual"


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
        self.last_restored_world: Optional[int] = None
        os.makedirs(self.directory, exist_ok=True)

    def _rank_path(self, step: int, rank: Optional[int] = None) -> str:
        return os.path.join(self.directory, str(step),
                            f"rank{self.rank if rank is None else rank}.pt")

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

    def saved_world(self, step: int) -> int:
        """The world size `step` was saved at (1 without a record)."""
        rec = self._read_integrity(step) or {}
        return int(rec.get("meta", {}).get("world_size", 1))

    def _verify(self, step: int, digest: str, allow_mismatch: bool,
                elastic: bool) -> None:
        rec = self._read_integrity(step) or {}
        saved_world = self.saved_world(step)
        if saved_world != self.world and not elastic:
            raise ValueError(
                f"checkpoint step {step} in {self.directory} was saved by "
                f"{saved_world} rank(s), this run has {self.world}: a "
                f"resume at another P re-partitions the residual, which "
                f"takes --elastic on both sides of the resize")
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

    def _load(self, step: int, rank: int, device) -> Dict[str, torch.Tensor]:
        return torch.load(self._rank_path(step, rank), map_location=device,
                          weights_only=True)

    def _load_resized(self, step: int, old_p: int, device,
                      rank_local: Sequence[str]
                      ) -> Dict[str, torch.Tensor]:
        """This rank's state of a step saved at `old_p` ranks (module
        docstring); entries named by a prefix in `rank_local` are left
        out for a rank the resize added."""
        rows = source_rows(self.rank, old_p, self.world)
        files = [self._load(step, r, "cpu") for r in rows] or [
            self._load(step, 0, "cpu")]
        state = {}
        for name, t in files[0].items():
            if name.startswith(FOLD_PREFIX):
                if not rows:
                    t = torch.zeros_like(t)
                else:
                    t = t.clone()
                    for other in files[1:]:
                        t += other[name]
            elif not rows and name.startswith(tuple(rank_local)):
                continue
            state[name] = t.to(device)
        return state

    def restore(self, digest: str, *, allow_mismatch: bool = False,
                device="cpu", elastic: bool = False,
                rank_local: Sequence[str] = ()
                ) -> Optional[Dict[str, torch.Tensor]]:
        """This rank's state of the newest complete step that every rank
        can read (None when there is no step), on `device`. `digest` is
        ``state_digest`` of the state this run would save. ``elastic``
        restores a step saved at another world size (module docstring);
        ``last_restored_world`` then says which."""
        candidates = sorted(self.all_steps(), reverse=True)
        for s in candidates:
            self._verify(s, digest, allow_mismatch, elastic)
            old_p = self.saved_world(s)
            state, err = None, None
            try:
                state = (self._load(s, self.rank, device)
                         if old_p == self.world else
                         self._load_resized(s, old_p, device, rank_local))
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
            self.last_restored_world = old_p
            return state
        if candidates:
            raise RuntimeError(f"no restorable checkpoint in "
                               f"{self.directory} (tried {candidates})")
        return None
