"""Build and load the port's hand-written CUDA kernels.

Each ``adlm_tpu_torch/csrc/<name>.cu`` exposes plain ``extern "C"``
launchers and compiles on its own with ``nvcc`` for ``sm_90a`` into
``adlm_tpu_torch/_build/lib<name>-<hash>.so``, loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds, and no
``ninja`` is needed.  The file name carries a hash of the source and
flags: an edited source rebuilds, an unchanged one loads the earlier
build.

Builds run at first use (``load(name)``); ``build_all()`` starts one
``nvcc`` per source at once and waits for all of them.  A failed build
raises — nothing falls back to the plain PyTorch version.

The launch counts live here too: each kernel wrapper adds one to its
entry of ``LAUNCHES`` where it launches, so a caller can show that a
run went through the kernels (``reset_launches`` sets them to 0).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
KERNELS = ("prototype_head", "upsample_argmin")

LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from adlm_tpu_torch/csrc at first use")


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        h = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str, extra: List[str]) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = _target(name) + f".{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    tmp = proc.args[proc.args.index("-o") + 1]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, _target(name))
    return out


def build_all(names=KERNELS, verbose_ptxas: bool = False) -> Dict[str, str]:
    """Build every kernel not yet built, one ``nvcc`` each, in parallel.
    Returns the compiler output per built kernel."""
    extra = ["-Xptxas", "-v"] if verbose_ptxas else []
    todo = [n for n in names if not os.path.exists(_target(n))]
    procs = {n: _start(n, extra) for n in todo}
    try:
        return {n: _finish(n, p) for n, p in procs.items()}
    finally:
        for p in procs.values():  # a raise above leaves none running
            if p.poll() is None:
                p.kill()
                p.wait()


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not torch.cuda.is_available():
                raise RuntimeError(f"kernel {name!r} needs a CUDA device")
            build_all((name,))
            lib = ctypes.CDLL(_target(name))
            _libs[name] = lib
        return lib


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (a refused launch
    never runs, and a later synchronize would not report it)."""
    if status != 0:
        lib.adlm_error_string.restype = ctypes.c_char_p
        msg = lib.adlm_error_string(ctypes.c_int(status)).decode()
        raise RuntimeError(f"{what}: CUDA error {status} at launch: {msg}")
