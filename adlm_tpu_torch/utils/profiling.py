"""Profiling and step-rate hooks (counterpart of
``adlm_tpu.utils.profiling``).

``trace`` wraps a region in ``torch.profiler.profile`` (CPU activity,
and CUDA where the card is in use) with a ``record_function`` label,
and writes a Chrome trace under ``trace_dir``; ``StepMeter`` reports
steps/s and images/s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch


@contextlib.contextmanager
def trace(label: str, trace_dir: str) -> Iterator[None]:
    """A ``torch.profiler`` trace of the region, labelled ``label`` and
    saved as ``<trace_dir>/<label>.pt.trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(label):
            yield
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(trace_dir, f"{label}.pt.trace.json"))


class StepMeter:
    """Running steps/sec + images/sec."""

    def __init__(self, images_per_step: int):
        self.images_per_step = images_per_step
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1) -> None:
        self._steps += n

    def rates(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        sps = self._steps / dt
        return {"steps_per_sec": sps,
                "images_per_sec": sps * self.images_per_step}
