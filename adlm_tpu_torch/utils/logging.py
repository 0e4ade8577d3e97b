"""Run logging: append-mode file log + CSV metric history + TensorBoard
(counterpart of ``adlm_tpu.utils.logging``).

Mirrors the reference's TensorBoard/CSV logger pair (reference
train.py:97-131) with a dependency-free CSV metrics file, an fsynced
text log (reference log.py:2-15) and hand-encoded TensorBoard event
files (``utils/tensorboard.py``).  Neptune is opt-in, as in the
reference: ``USE_NEPTUNE=1`` plus ``NEPTUNE_PROJECT``.
"""

from __future__ import annotations

import csv
import datetime
import json
import os
from typing import Dict, Optional


class RunLogger:
    def __init__(self, run_dir: str, name: str = "train",
                 tensorboard: bool = True):
        self.run_dir = run_dir
        os.makedirs(os.path.join(run_dir, "logs"), exist_ok=True)
        self._log_path = os.path.join(run_dir, "logs", f"{name}.log")
        self._csv_path = os.path.join(run_dir, "logs", f"{name}_metrics.csv")
        self._csv_fields: Optional[list] = None
        self._tb = None
        if tensorboard:
            from adlm_tpu_torch.utils.tensorboard import TBEventWriter
            self._tb = TBEventWriter(os.path.join(run_dir, "logs", "tb"))
        self._neptune = None
        if os.environ.get("USE_NEPTUNE", "").lower() in ("1", "true"):
            try:
                import neptune
                self._neptune = neptune.init_run(
                    project=os.environ.get("NEPTUNE_PROJECT"),
                    name=os.path.basename(os.path.normpath(run_dir)))
            except Exception as e:  # pragma: no cover
                print(f"[logging] USE_NEPTUNE set but neptune "
                      f"unavailable ({e}); continuing with CSV/TB only",
                      flush=True)

    def log_hyperparams(self, params: Dict) -> None:
        """Attach run hyperparameters (the reference logs the gin
        operative config as logger hyperparams, train.py:105-108)."""
        with open(os.path.join(self.run_dir, "logs",
                               "hyperparams.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)
        if self._neptune is not None:
            self._neptune["parameters"] = params

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._neptune is not None:
            self._neptune.stop()

    def log(self, msg: str) -> None:
        stamp = datetime.datetime.now().isoformat(timespec="seconds")
        line = f"[{stamp}] {msg}"
        print(line, flush=True)
        with open(self._log_path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())

    def metrics(self, step: int, phase: str, split: str,
                values: Dict[str, float]) -> None:
        row = {"step": step, "phase": phase, "split": split,
               **{k: float(v) for k, v in values.items()}}
        if self._tb is not None:
            # <split>/<phase>/<key>: the phase tells apart the step
            # counters every training stage restarts
            self._tb.add_scalars(step, {
                f"{split}/{phase}/{k}": float(v)
                for k, v in values.items()})
            self._tb.flush()
        if self._neptune is not None:
            for k, v in values.items():
                self._neptune[f"{split}/{phase}/{k}"].append(
                    float(v), step=step)
        if self._csv_fields is None:
            if os.path.exists(self._csv_path):
                # resume: the columns are the on-disk header's, not
                # those of this process's first row
                with open(self._csv_path, newline="") as f:
                    self._csv_fields = next(csv.reader(f), None)
            if not self._csv_fields:
                self._csv_fields = list(row.keys())
        missing = [k for k in row if k not in self._csv_fields]
        if missing:
            self._rewrite_with_fields(self._csv_fields + missing)
        with open(self._csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_fields,
                               extrasaction="ignore")
            if f.tell() == 0:
                w.writeheader()
            w.writerow(row)

    def _rewrite_with_fields(self, fields) -> None:
        """Extend the CSV's columns in place when a new metric key
        appears (val rows carry keys that train rows do not)."""
        rows = []
        if os.path.exists(self._csv_path):
            with open(self._csv_path, newline="") as f:
                rows = list(csv.DictReader(f))
        with open(self._csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            w.writeheader()
            for r in rows:
                w.writerow(r)
        self._csv_fields = fields
