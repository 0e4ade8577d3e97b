"""In-run failure detection and restart for long trainings (counterpart
of ``adlm_tpu.utils.watchdog``).

A hung or killed training run is wall-clock lost unless something (a)
notices, (b) waits for the device to answer again, and (c) continues
from the exact window.  This module supplies (a) and (b); the
bit-identical mid-phase resume of ``train/pipeline.py`` (``train
--resume``) supplies (c):

* **Heartbeat**: the training child's fsynced run log and metrics CSV
  (``utils/logging.py``) advance every logged window, validation and
  push line; their newest mtime is the liveness signal.
* **Stall detection**: no heartbeat for ``timeout_s`` ⇒ the child is
  presumed hung and is killed by its exact pid.
* **Device probe**: before a relaunch, a small CUDA round trip runs in a
  subprocess with a time limit, so a hung device hangs the probe's
  process, not the supervisor.
* **Restart**: the child is relaunched with ``--resume``.  A child that
  exits with ``DIVERGED_EXIT`` (86, a non-finite loss) is not restarted:
  a resume with the same arguments replays the same window.

Driven by ``train --auto-restart N`` (``cli.py``).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

# cli.DIVERGED_EXIT: the run stopped on a non-finite loss
DIVERGED_EXIT = 86


def newest_mtime(paths: Sequence[str]) -> Optional[float]:
    """Newest mtime among ``paths`` that exist (None if none do)."""
    best = None
    for p in paths:
        try:
            m = os.stat(p).st_mtime
        except OSError:
            continue
        best = m if best is None else max(best, m)
    return best


def default_device_probe(probe_timeout_s: float = 60.0) -> bool:
    """True iff a small CUDA round trip completes within the timeout, in
    a subprocess (a hung device hangs the child, not the caller)."""
    code = ("import torch; "
            "assert torch.ones(4, device='cuda').sum().item() == 4.0")
    try:
        r = subprocess.run([sys.executable, "-c", code],
                           timeout=probe_timeout_s,
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
        return r.returncode == 0
    except subprocess.TimeoutExpired:
        return False


def wait_for_device(probe: Callable[[], bool], poll_s: float = 60.0,
                    max_wait_s: float = 3600.0, log=print) -> bool:
    """Poll ``probe`` until it reports live (True) or ``max_wait_s``
    elapses (False)."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < max_wait_s:
        if probe():
            return True
        log(f"watchdog: device still unresponsive "
            f"({time.monotonic() - t0:.0f}s); retrying")
        time.sleep(poll_s)
    return probe()


def run_with_watchdog(make_cmd: Callable[[int], List[str]],
                      heartbeat_paths: Sequence[str],
                      timeout_s: float = 900.0,
                      max_restarts: int = 3,
                      poll_s: float = 10.0,
                      probe: Optional[Callable[[], bool]] = None,
                      device_poll_s: float = 60.0,
                      device_max_wait_s: float = 3600.0,
                      grace_s: float = 10.0,
                      log=print) -> int:
    """Supervise a resumable child command; restart it on stall or crash.

    Args:
      make_cmd: attempt index → argv.  Attempt 0 is the initial run;
        attempts ≥ 1 should resume.
      heartbeat_paths: files whose mtime advancing means the child is
        alive (the run's log and metrics CSV).
      timeout_s: no-heartbeat window after which the child is presumed
        hung; it must exceed the longest legitimate silent stretch.
      max_restarts: restart budget (stalls and crashes both use it).
      poll_s: heartbeat check interval.
      probe: liveness check before each relaunch
        (default: :func:`default_device_probe`).
      grace_s: SIGTERM → SIGKILL escalation window.

    Returns the child's final exit code (0 = the run completed).
    """
    probe = probe or default_device_probe
    attempt = 0
    restarts_left = max_restarts
    while True:
        cmd = make_cmd(attempt)
        log(f"watchdog: starting attempt {attempt}: {' '.join(cmd)}")
        child = subprocess.Popen(cmd)
        start = time.monotonic()
        stalled = False
        while True:
            try:
                rc = child.wait(timeout=poll_s)
                break
            except subprocess.TimeoutExpired:
                pass
            hb = newest_mtime(heartbeat_paths)
            # mtimes are wall-clock: shift them onto the monotonic axis;
            # a heartbeat older than this attempt's start does not count
            hb_mono = (hb - _mono_offset()) if hb is not None else start
            silent = time.monotonic() - max(hb_mono, start)
            if silent > timeout_s:
                log(f"watchdog: no heartbeat for {silent:.0f}s "
                    f"(> {timeout_s:.0f}s) — killing pid {child.pid}")
                child.terminate()
                try:
                    child.wait(timeout=grace_s)
                except subprocess.TimeoutExpired:
                    child.kill()
                    child.wait()
                rc = None
                stalled = True
                break
        if rc == 0:
            log("watchdog: run completed")
            return 0
        if rc == DIVERGED_EXIT:
            log(f"watchdog: child reported divergence (exit {DIVERGED_EXIT}) — "
                "deterministic failure, not restarting; relaunch "
                "manually with a stability knob (e.g. --grad-clip)")
            return rc
        reason = "stall" if stalled else f"exit {rc}"
        if restarts_left <= 0:
            log(f"watchdog: {reason}, restart budget exhausted")
            return rc if rc is not None else 1
        restarts_left -= 1
        log(f"watchdog: {reason} — probing device before resume "
            f"({restarts_left} restarts left)")
        if not wait_for_device(probe, poll_s=device_poll_s,
                               max_wait_s=device_max_wait_s, log=log):
            log("watchdog: device never recovered — giving up")
            return rc if rc is not None else 1
        attempt += 1


def _mono_offset() -> float:
    """time.time() − time.monotonic(): converts file mtimes (wall clock)
    onto the monotonic axis of the stall arithmetic."""
    return time.time() - time.monotonic()
