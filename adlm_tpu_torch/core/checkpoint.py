"""Stage-keyed checkpoint store (counterpart of
``adlm_tpu.core.checkpoint``).

The reference pickles whole modules per validation epoch under
stage-keyed names ``{warmup,nopush,push}_{last,best}.pth`` (reference
segmentation/module.py:285-297) and a pruned model under
``pruned/pruned.pth``.  The port keeps the JAX package's layout:
``<run_dir>/checkpoints/<stage>_<kind>/`` directories beside the
experiment's ``config.json``.  A checkpoint directory holds one file,
``state.pt``: a payload of tensors, numbers and strings in nested dicts,
written with ``torch.save`` and read with ``torch.load(weights_only=True,
map_location=...)``, so that reading one runs no pickled code.

Writes are crash-atomic.  ``save`` stages the new generation at
``<path>.next`` through a temporary name, fsyncs it, renames it into
place, demotes the old generation to ``<path>.old``, rotates the new one
in and removes the old one.  At every instant one finalized generation
exists: ``<path>.next`` (newest: its rotation had not begun or was cut
between the two renames), ``<path>`` or ``<path>.old``.  Readers
(``exists``, ``restore``) only work out which to read and rename
nothing, so a reader beside a live writer cannot break its rotation;
only ``save`` completes an interrupted rotation and removes the staging
leftovers of an interrupted write.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import uuid
from typing import Any, Optional

import torch

# ProtoSeg's training stages, then U-Noise's two models
STAGES = ("warmup", "nopush", "push", "pruned", "utility", "noise")
KINDS = ("last", "best")
PAYLOAD = "state.pt"
_STAGING = ".tmp-"  # <path>.next.tmp-<id>: a write not yet finalized


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointStore:
    def __init__(self, run_dir: str):
        self.run_dir = os.path.abspath(run_dir)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _path(self, stage: str, kind: str) -> str:
        if stage not in STAGES or kind not in KINDS:
            raise ValueError(f"unknown checkpoint {stage}_{kind}")
        return os.path.join(self.ckpt_dir, f"{stage}_{kind}")

    @staticmethod
    def _finalized(path: str) -> Optional[str]:
        """The newest finalized generation of ``path`` (its directory),
        or None."""
        for cand in (path + ".next", path, path + ".old"):
            if os.path.isfile(os.path.join(cand, PAYLOAD)):
                return cand
        return None

    def _heal(self, path: str) -> None:
        """Complete a rotation a crash interrupted and remove what an
        interrupted write left; called by ``save`` only."""
        for leftover in glob.glob(glob.escape(path + ".next") + _STAGING + "*"):
            shutil.rmtree(leftover, ignore_errors=True)
        nxt, old = path + ".next", path + ".old"
        if os.path.isdir(nxt):
            # a finalized .next is a completed newer save whose rotation
            # was interrupted: it wins over path
            if os.path.isdir(old):
                shutil.rmtree(old)
            if os.path.isdir(path):
                os.rename(path, old)
            os.rename(nxt, path)
        elif not os.path.isdir(path) and os.path.isdir(old):
            os.rename(old, path)
        if os.path.isdir(path) and os.path.isdir(old):
            shutil.rmtree(old)
        _fsync_dir(self.ckpt_dir)

    def save(self, stage: str, kind: str, payload: Any) -> str:
        """Write ``payload`` as the new ``<stage>_<kind>`` generation;
        the previous one is removed only after the new one is finalized.
        Returns the checkpoint's directory."""
        path = self._path(stage, kind)
        self._heal(path)
        nxt, old = path + ".next", path + ".old"
        staging = nxt + _STAGING + uuid.uuid4().hex[:8]
        os.makedirs(staging)
        with open(os.path.join(staging, PAYLOAD), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(staging)
        os.rename(staging, nxt)
        _fsync_dir(self.ckpt_dir)
        if os.path.isdir(path):
            os.rename(path, old)
        os.rename(nxt, path)
        _fsync_dir(self.ckpt_dir)
        if os.path.isdir(old):
            shutil.rmtree(old)
        return path

    def restore(self, stage: str, kind: str,
                map_location: Any = "cpu") -> Any:
        """The newest finalized payload of ``<stage>_<kind>``, its
        tensors on ``map_location``.  Raises ``FileNotFoundError`` when
        there is none."""
        path = self._path(stage, kind)
        for attempt in range(2):
            src = self._finalized(path)
            if src is None:
                break
            try:
                return torch.load(os.path.join(src, PAYLOAD),
                                  map_location=map_location, weights_only=True)
            except FileNotFoundError:
                # a writer rotated the generation away mid-read: work
                # out the newest one once more
                if attempt:
                    raise
        raise FileNotFoundError(f"no checkpoint {stage}_{kind} under {self.ckpt_dir}")

    def exists(self, stage: str, kind: str) -> bool:
        return self._finalized(self._path(stage, kind)) is not None

    def save_config(self, config_json: str) -> None:
        with open(os.path.join(self.run_dir, "config.json"), "w") as f:
            f.write(config_json)

    def load_config_json(self) -> str:
        with open(os.path.join(self.run_dir, "config.json")) as f:
            return f.read()

    def save_metadata(self, name: str, obj: Any) -> None:
        with open(os.path.join(self.run_dir, f"{name}.json"), "w") as f:
            json.dump(obj, f, indent=2)
