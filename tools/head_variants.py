#!/usr/bin/env python3
"""Time variants of the prototype-head kernel against the kept one.

    python3 tools/head_variants.py [--iters 50]

Each variant is a copy of ``adlm_tpu_torch/csrc/prototype_head.cu``
with a few lines replaced (``VARIANTS``), built like the kept kernel
(one ``nvcc`` per copy, all at once, ``-Xptxas -v``) into
``adlm_tpu_torch/_build/variants`` and loaded with ``ctypes``.  All run
in one process on one card, in turns (each variant, then the list
again in reverse), at the flagship head shape at batch 2 (N =
2·129·257 rows, C = 64, P = 190, K = 19), log activation.

* Variants that keep the function (``exact``) are held against the
  plain version at the tolerances of ``chip_smoke.py`` phase 2, and
  checked for bit-equality with the kept kernel.
* The others take one piece out and compute something else: their
  times only say what that piece costs.

Prints, per variant: the mean CUDA-event time of f32 x with and without
``d`` and of bf16 x with ``d``, registers of the f32 P = 190 instance,
shared memory per CTA and CTAs per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), beside the card's
name and power limit.  ``--baseline NAME=FILE`` adds another version of
the kernel (for example the parent commit's) to the same turns.  Needs
the card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the instance the flagship runs (T = float, kRP = 12, log activation)
FLAGSHIP = "head_kernel<float, 12, false>"

# a CTAs-per-SM probe appended to every copy
OCCUPANCY = """
extern "C" int adlm_head_ctas_per_sm(int c, int p, int k) {
  Plan pl;
  if (!make_plan(c, p, k, 4, &pl)) return -1;
  auto kernel = %s;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, pl.smem);
  return n;
}
""" % FLAGSHIP

# 32-row tiles, two CTAs per SM: registers capped at 128, at most 3
# splits of the logits product, and one x buffer, loaded once the
# tile's last reader is done with it (106,368 B per CTA)
_TWO_CTAS = [
    ("constexpr int kRM = 4;", "constexpr int kRM = 2;"),
    ("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)"),
    ("  if (s > pp / 4) s = pp / 4;\n", "  if (s > pp / 4) s = pp / 4;\n  if (s > 3) s = 3;\n"),
    ("             2 * static_cast<size_t>(kTR) * c * elem;",
     "             static_cast<size_t>(kTR) * c * elem;"),
    ("    if (next < ntiles) stage_rows(x, xs + (buf ^ 1) * tile_elems, next * kTR, n, c, tid);\n"
     "    cp_async_commit();\n    cp_async_wait_prev();\n",
     "    asm volatile(\"cp.async.wait_group 0;\\n\" ::);\n"),
    ("    const T* xb = xs + buf * tile_elems;", "    const T* xb = xs;"),
    ("    __syncthreads();  // act complete\n",
     "    __syncthreads();  // act complete\n"
     "    if (next < ntiles) stage_rows(x, xs, next * kTR, n, c, tid);\n"
     "    cp_async_commit();\n"),
]

# name -> (replacements, exact)
VARIANTS = {
    "kept": ([], True),
    "32-row tiles": ([("constexpr int kRM = 4;", "constexpr int kRM = 2;")], True),
    "32-row tiles, 2 CTAs/SM, 1 x buffer": (_TWO_CTAS, True),
    "128-thread CTAs (32-row tiles)": (
        [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")], True),
    "barrier after the product (f32)": ([
        ("    __syncthreads();  // |x|^2 and the widened rows visible\n",
         "    if (kBF16) __syncthreads();\n"),
        ("    {  // epilogue: d, act\n",
         "    if (!kBF16) __syncthreads();\n    {  // epilogue\n")], True),
    "logits loop unroll 1": (
        [("#pragma unroll 2\n      for (int pi = lp0;", "#pragma unroll 1\n      for (int pi = lp0;")],
        True),
    "logits loop unroll 4": (
        [("#pragma unroll 2\n      for (int pi = lp0;", "#pragma unroll 4\n      for (int pi = lp0;")],
        True),
    "product loop unroll 2": (
        [("#pragma unroll 1\n    for (int ci = 0;", "#pragma unroll 2\n    for (int ci = 0;")], True),
    "product loop unroll 4": (
        [("#pragma unroll 1\n    for (int ci = 0;", "#pragma unroll 4\n    for (int ci = 0;")], True),
    "CUDA's \"/\" for the division": (
        [("logf(div_fast(d + 1.f, d + eps))", "logf((d + 1.f) / (d + eps))")], True),
    "prologue only": (
        [("  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {",
          "  for (int buf = 0; tile < 0; tile += gridDim.x, buf ^= 1) {")], False),
    "no division or logf (act = d)": (
        [("logf(div_fast(d + 1.f, d + eps))", "d")], False),
    "no logits product": (
        [("    if (ls < splits) {  // logits product", "    if (false) {  // logits product")],
        False),
    "no distance product": (
        [("    for (int ci = 0; ci < c; ci += 4) {\n      float xv[kRM][4];",
          "    for (int ci = 0; ci < 0; ci += 4) {\n      float xv[kRM][4];")], False),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown card"


def write_sources(out_dir: str, src: str) -> dict:
    """One source per variant: the kept source with its replacements, or
    a baseline's own file.  Sources with the kept launcher get the CTAs
    per SM probe."""
    paths = {}
    for i, (name, (subs, _)) in enumerate(VARIANTS.items()):
        if isinstance(subs, str):  # a baseline file
            with open(subs) as f:
                text = f.read()
        else:
            text = src
            for old, new in subs:
                if text.count(old) != 1:
                    raise SystemExit(f"variant {name!r}: {old!r} not found once in the source")
                text = text.replace(old, new)
        path = os.path.join(out_dir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(text + (OCCUPANCY if "make_plan" in text else ""))
        paths[name] = path
    return paths


def build(paths: dict) -> dict:
    from adlm_tpu_torch.ops import _build

    procs = {}
    for name, path in paths.items():
        lib = path[:-3] + ".so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, path]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name!r}:\n{out}")
        # ptxas prints each entry's properties after "Compiling entry function"
        regs = "?"
        for block in out.split("Compiling entry function")[1:]:
            if "head_kernelIfLi12ELb0E" in block.split("\n")[0]:
                m = re.search(r"Used (\d+) registers", block)
                spill = re.search(r"(\d+) bytes spill stores", block)
                regs = f"{m.group(1)} registers, {spill.group(1)} B spill stores"
        libs[name] = (ctypes.CDLL(lib), regs)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--baseline", action="append", default=[], metavar="NAME=FILE",
                    help="also time FILE, another version of the kernel with the "
                    "same adlm_prototype_head signature (held to the same tolerances)")
    args = ap.parse_args()
    for b in args.baseline:
        name, path = b.split("=", 1)
        VARIANTS[name] = (path, True)

    import torch
    if not torch.cuda.is_available():
        print("head_variants: no CUDA device", file=sys.stderr)
        return 2
    from adlm_tpu_torch.core.device import ieee_f32
    from adlm_tpu_torch.ops import _build
    from adlm_tpu_torch.ops.prototype import prototype_head_reference

    card = card_line()
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.CSRC, "prototype_head.cu")) as f:
        libs = build(write_sources(out_dir, f.read()))

    N, C, P, K = 2 * 129 * 257, 64, 190, 19
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand(N, C, device="cuda", generator=g)
    xs = {"f32": x, "bf16": x.to(torch.bfloat16)}
    protos = torch.rand(P, C, device="cuda", generator=g)
    w = torch.randn(P, K, device="cuda", generator=g)
    logits = torch.empty(N, K, device="cuda")
    dist = torch.empty(N, P, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib, dt: str, emit: bool) -> None:
        f = lib.adlm_prototype_head
        # sources since the general path take a scratch pointer after dist
        # (null here: the flagship shape takes the persistent kernel)
        scratch = [None] if hasattr(lib, "adlm_prototype_head_scratch") else []
        f.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * (4 + len(scratch)) + [
            ctypes.c_int64] + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        status = f(xs[dt].data_ptr(), int(dt == "bf16"), protos.data_ptr(), w.data_ptr(),
                   logits.data_ptr(), dist.data_ptr() if emit else None, *scratch,
                   N, C, P, K, 0, 1e-4, stream)
        if status:
            raise RuntimeError(f"launch failed: CUDA error {status}")

    def ms(lib, dt: str, emit: bool) -> float:
        for _ in range(2):
            run(lib, dt, emit)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.iters):
            run(lib, dt, emit)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / args.iters

    cells = [("f32", True), ("f32", False), ("bf16", True)]
    # the SM clock while the turns run, sampled every 100 ms
    clocks = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                               "--format=csv,noheader,nounits", "-lms", "100"],
                              stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    same = {name: True for name in libs}  # bit-equal to the kept kernel
    with torch.inference_mode(), ieee_f32():
        for dt in xs:
            want_l, want_d = prototype_head_reference(xs[dt], protos, w, "log")
            kept = None
            for name, (lib, _) in libs.items():
                if VARIANTS[name][1]:
                    run(lib, dt, True)
                    torch.cuda.synchronize()
                    if not (torch.allclose(logits, want_l, rtol=1e-4, atol=1e-3)
                            and torch.allclose(dist, want_d, rtol=1e-5, atol=1e-4)):
                        raise SystemExit(f"variant {name!r} disagrees with the plain "
                                         f"version ({dt})")
                    if kept is None:
                        kept = (logits.clone(), dist.clone())
                    same[name] &= torch.equal(logits, kept[0]) and torch.equal(dist, kept[1])
        times = {name: {cell: [] for cell in cells} for name in libs}
        order = list(libs)
        for rnd in (order, order[::-1]):  # in turns: a, b, ..., ..., b, a
            for name in rnd:
                for cell in cells:
                    times[name][cell].append(ms(libs[name][0], *cell))
    clocks.terminate()
    mhz = sorted(int(v) for v in clocks.communicate()[0].split() if v.isdigit())
    print(f"head variants, log, N={N} C={C} P={P} K={K}, {args.iters} launches "
          f"per time, two rounds  [{card}]")
    if mhz:
        print(f"  SM clock during the turns: min {mhz[0]}, median {mhz[len(mhz) // 2]}, "
              f"max {mhz[-1]} MHz ({len(mhz)} samples)")
    for name, (lib, regs) in libs.items():
        lib.adlm_prototype_head_smem.argtypes = [ctypes.c_int] * 4
        lib.adlm_prototype_head_smem.restype = ctypes.c_size_t
        smem = lib.adlm_prototype_head_smem(C, P, K, 0)
        ctas = lib.adlm_head_ctas_per_sm(C, P, K) if hasattr(lib, "adlm_head_ctas_per_sm") else "?"
        t = {cell: " ".join(f"{v:.4f}" for v in ts) for cell, ts in times[name].items()}
        tag = ((", bit-equal to kept" if same[name] else ", not bit-equal to kept")
               if VARIANTS[name][1] else "  (timing only)")
        print(f"  {name:36s} f32 with d {t['f32', True]} ms, without d "
              f"{t['f32', False]} ms, bf16 with d {t['bf16', True]} ms; {regs}, "
              f"{smem} B shared (f32), {ctas} CTA/SM{tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
