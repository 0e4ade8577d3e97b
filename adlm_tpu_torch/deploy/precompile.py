"""Ahead-of-run builds of the kernel libraries (counterpart of
``adlm_tpu.deploy.precompile``).

The JAX package warms XLA's persistent compile cache, because each of
its jitted programs compiles for minutes at first use.  The port's
programs run eagerly; their only ahead-of-time compile is ``nvcc`` of
the hand-written kernels, ``adlm_tpu_torch/csrc/<name>.cu`` →
``adlm_tpu_torch/_build/lib<name>-<hash>.so`` (``ops/_build.py``), which
otherwise happens at a kernel's first launch.  ``precompile`` builds
every library not yet built (``_build.build_all``: one ``nvcc`` per
source, all at once) and reports the seconds it took.  A library
already built from the same source and flags is found by the hash in
its name and reused: a second call builds nothing.

Every program launches the prototype head, and one library serves every
shape and dtype, so the JAX flags that select programs or key XLA's
cache (``--phases``, ``--stats``, ``--steps-scale``, ``--bf16``,
``--fused``, ``--s2b``, ``--wire-uint8``, the batch sizes and
resolutions) have nothing to select here.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Tuple

from adlm_tpu_torch.core.device import resolve_device
from adlm_tpu_torch.ops import _build


def precompile_kernels(log=print) -> Tuple[Dict[str, bool], float]:
    """Build the kernel libraries not yet built, in parallel.  Returns
    ({name: built}, seconds): ``built`` is False for a library that was
    already there.  The libraries are for the card, so this raises on a
    host without one."""
    resolve_device(None)
    t0 = time.perf_counter()
    built = _build.build_all()
    sec = time.perf_counter() - t0
    out = {n: n in built for n in _build.KERNELS}
    for n, b in out.items():
        log(f"precompile {n}: {'built' if b else 'reused'} "
            f"{os.path.basename(_build._target(n))}")
    return out, sec
