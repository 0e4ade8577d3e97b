#!/usr/bin/env python3
"""Count the SASS instructions of CUDA's IEEE f32 division and ``logf``.

    python3 tools/epilogue_sass.py

Compiles four one-line probe kernels for ``sm_90a`` with the flags the
port's kernels use (``-O3``, IEEE division, no fast math), disassembles
them with ``cuobjdump -sass`` and counts the instructions each kernel
issues on its fast path, from its entry to its ``EXIT`` past the
division's out-of-line slow path, without the probe's own frame (the
thread index, parameter loads, address arithmetic, the load and the
store; ``FRAME``).  The frame check: ``a + b`` counts 1, a copy 0.

``chip_smoke.py`` adds these to the three instructions of the d
update and the two adds of the log activation to bound the prototype
head (``HEAD_EPILOGUE_OPS``).  Needs ``nvcc`` and ``cuobjdump`` (the
CUDA toolkit), no card.  The probe builds in ``adlm_tpu_torch/_build``.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "adlm_tpu_torch", "_build", "epilogue_probe")

PROBES = r"""
#include <math.h>
extern "C" __global__ void copy1(const float* a, float* o) {
  const int i = threadIdx.x; o[i] = a[i];
}
extern "C" __global__ void add2(const float* a, const float* b, float* o) {
  const int i = threadIdx.x; o[i] = a[i] + b[i];
}
extern "C" __global__ void div2(const float* a, const float* b, float* o) {
  const int i = threadIdx.x; o[i] = a[i] / b[i];
}
extern "C" __global__ void log1(const float* a, float* o) {
  const int i = threadIdx.x; o[i] = logf(a[i]);
}
"""


# the probes' own instructions: thread index, parameters, addresses,
# the global load and store
FRAME = {"S2R", "LDC", "LDC.64", "ULDC.64", "IMAD.WIDE", "LEA", "LEA.HI.X",
         "SHF.R.S32.HI", "LDG.E", "STG.E"}


def cuda_bin(tool: str) -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", tool)
    if not os.path.exists(path):
        raise SystemExit(f"{tool} not found under {home}/bin (set CUDA_HOME)")
    return path


def fast_path_counts(sass: str) -> dict:
    """{kernel: instructions outside FRAME issued from its entry to its
    first EXIT}.
    The walk takes every forward branch: in these probes the only
    branch skips the division's call to its slow path (FCHK clear)."""
    kernels, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\w+)", line)
        if m:
            name = m.group(1)
            kernels[name] = {}
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", line)
        if m and name is not None:
            kernels[name][int(m.group(1), 16)] = m.group(2).split()
    counts = {}
    for name, code in kernels.items():
        addrs, n, i = sorted(code), 0, 0
        while True:
            ins = code[addrs[i]]
            op = ins[1] if ins[0].startswith("@") else ins[0]
            if op == "EXIT":
                break
            n += op not in FRAME and op != "NOP"
            if op == "BRA" and int(ins[-1], 16) > addrs[i]:
                i = addrs.index(int(ins[-1], 16))
            else:
                i += 1
        counts[name] = n
    return counts


def main() -> int:
    os.makedirs(BUILD, exist_ok=True)
    src = os.path.join(BUILD, "probe.cu")
    cubin = os.path.join(BUILD, "probe.cubin")
    with open(src, "w") as f:
        f.write(PROBES)
    subprocess.run([cuda_bin("nvcc"), "-O3", "-std=c++17", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-cubin", "-o", cubin, src],
                   check=True)
    sass = subprocess.run([cuda_bin("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    with open(os.path.join(BUILD, "probe.sass"), "w") as f:
        f.write(sass)
    n = fast_path_counts(sass)
    print(f"fast-path instructions per kernel, frame excluded: {n}")
    if n["add2"] != 1 or n["copy1"] != 0:
        print("the frame check failed: FRAME does not match this compiler's "
              "probe code", file=sys.stderr)
        return 1
    print(f"IEEE f32 division: {n['div2']}  logf: {n['log1']}  head epilogue "
          f"(3 d update + 2 adds + division + logf): {5 + n['div2'] + n['log1']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
