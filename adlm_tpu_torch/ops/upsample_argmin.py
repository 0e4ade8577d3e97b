"""Fused bilinear upsample + argmin over prototypes.

Counterpart of ``adlm_tpu.ops.upsample_argmin`` (the TPU kernel) and of
``upsampled_nearest`` with its plain paths in
``adlm_tpu.interpret.evaluate`` (:40-225).  The statistic is the
reference's nearest prototype per label pixel: bilinearly upsample the
(B, h, w, P) distance maps to label size and take the argmin over P
(reference segmentation/eval_valid.py:172-174).

* ``upsampled_argmin_cuda``: the hand-written kernel
  (``csrc/upsample_argmin.cu``).  It blends in exact f32 for f32 and
  bf16 maps alike: the card has no reason for a single-pass bf16 blend,
  so a bf16 map gives what its f32 cast would give (the JAX package's
  ``exact=True``).
* ``upsampled_argmin_reference``: the plain version, a port of the JAX
  chunked scan with both of its branches (exact f32 4-tap blend; bf16
  ``resize_bilinear`` when the map is bf16 and ``exact`` is off).  On
  the card it is the kernel's oracle, called with ``exact=True``.
* ``upsampled_nearest_integer``: the phase-decomposed plain path for
  integer upsampling factors of a CPU map.
* ``upsampled_nearest``: the dispatch — every CUDA map goes to the
  kernel; a CPU map takes the integer path where it applies, else the
  scan.

Each of them returns, when asked (``with_value=True``), the winning
value beside the index: ``min_p`` of the upsampled distances, f32, the
running best that the argmin keeps.  A tensor-parallel head's rank
(``parallel/sharding.py``) calls them on its slice of the prototypes
and combines the (value, index) pairs across ranks; a prototype's value
does not depend on the other prototypes of the call, so the combined
index is the whole bank's.

The kernel and the plain version also take an output-row window
(``out_rows=(o0, n)``: output rows [o0, o0 + n) of the whole (H, W)
result) and a slab of the map (``map_rows=(first, h)``: ``dist`` holds
rows [first, first + dist.shape[1]) of a map of ``h`` rows), as spatial
eval runs them on a rank's rows (``parallel/spatial.py``).  The
coordinates stay the whole map's, so a window's rows equal the same
rows of the whole-frame call bit for bit; ``tap_rows`` names the map
rows a window reads.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from adlm_tpu_torch.ops import _build
from adlm_tpu_torch.ops.resize import resize_bilinear

_F32 = torch.float32
# a prototype-chunk pad value that never wins the argmin; finite, so the
# zero-weight taps of the blend stay 0 instead of NaN
_PAD = 1e30


def upsampled_nearest_integer(dist: torch.Tensor, sy: int, sx: int,
                              with_value: bool = False):
    """argmin of the bilinear upsample by integer factors (sy, sx) (with
    ``with_value``, and its min: (index, value)).

    Each output pixel's 4 taps and weights depend only on its phase
    (o mod s), so each phase is one 4-tap blend + argmin on grid-sized
    maps, and the sy·sx phase results interleave into the output.  Edge
    clamping: out-of-range neighbours replicate the edge row/column.
    Blends in f32 even for bf16 maps.
    """
    B, h, w, P = dist.shape
    dist = dist.to(_F32)

    def shifted(ddy: int, ddx: int) -> torch.Tensor:
        t = dist
        if ddy == -1:
            t = torch.cat([t[:, :1], t[:, :-1]], dim=1)
        elif ddy == 1:
            t = torch.cat([t[:, 1:], t[:, -1:]], dim=1)
        if ddx == -1:
            t = torch.cat([t[:, :, :1], t[:, :, :-1]], dim=2)
        elif ddx == 1:
            t = torch.cat([t[:, :, 1:], t[:, :, -1:]], dim=2)
        return t

    phases = []
    for dy in range(sy):
        fy = (dy + 0.5) / sy - 0.5
        ylo = math.floor(fy)
        wy = fy - ylo
        for dx in range(sx):
            fx = (dx + 0.5) / sx - 0.5
            xlo = math.floor(fx)
            wx = fx - xlo
            blend = (shifted(ylo, xlo) * ((1 - wy) * (1 - wx))
                     + shifted(ylo, xlo + 1) * ((1 - wy) * wx)
                     + shifted(ylo + 1, xlo) * (wy * (1 - wx))
                     + shifted(ylo + 1, xlo + 1) * (wy * wx))
            phases.append((torch.argmin(blend, dim=-1).to(torch.int32),
                           blend.amin(dim=-1) if with_value else None))

    def interleave(maps):
        # out[b, sy·i+dy, sx·j+dx] = maps[dy, dx, b, i, j]
        out = torch.stack(maps).reshape(sy, sx, B, h, w)
        return out.permute(2, 3, 0, 4, 1).reshape(B, h * sy, w * sx)

    idx = interleave([i for i, _ in phases])
    return (idx, interleave([v for _, v in phases])) if with_value else idx


def _src_coords(n_out: int, n_in: int, device) -> Tuple[torch.Tensor, ...]:
    """Half-pixel source taps of each output index, in f32 as the kernel
    computes them: (lo, hi, weight of hi)."""
    scale = torch.tensor(n_in / n_out, dtype=_F32, device=device)
    s = torch.clamp((torch.arange(n_out, dtype=_F32, device=device) + 0.5)
                    * scale - 0.5, 0.0, n_in - 1.0)
    lo = torch.floor(s).to(torch.int64)
    hi = torch.clamp(lo + 1, max=n_in - 1)
    return lo, hi, s - lo.to(_F32)


def tap_rows(n_out: int, n_in: int, lo: int, hi: int) -> Tuple[int, int]:
    """Map rows [first, last + 1) that output rows [lo, hi) blend, by
    ``_src_coords``'s f32 arithmetic (on the host)."""
    f32 = np.float32
    scale = f32(n_in / n_out)

    def src(o: int) -> int:
        s = (f32(o) + f32(0.5)) * scale - f32(0.5)
        return int(np.floor(min(max(s, f32(0.0)), f32(n_in - 1))))

    return src(lo), min(src(hi - 1) + 1, n_in - 1) + 1


def _window(dist: torch.Tensor, size: Tuple[int, int], out_rows, map_rows
            ) -> Tuple[int, int, int, int]:
    """(o0, n, first, h) of a call, checked: the slab holds the map rows
    the window reads."""
    H = int(size[0])
    o0, n = (0, H) if out_rows is None else (int(out_rows[0]), int(out_rows[1]))
    first, h = (0, dist.shape[1]) if map_rows is None else (int(map_rows[0]), int(map_rows[1]))
    if not (0 <= o0 and n > 0 and o0 + n <= H):
        raise ValueError(f"output rows [{o0}, {o0 + n}) outside [0, {H})")
    lo, hi = tap_rows(H, h, o0, o0 + n)
    if lo < first or hi > first + dist.shape[1]:
        raise ValueError(f"output rows [{o0}, {o0 + n}) read map rows [{lo}, {hi}); "
                         f"dist holds [{first}, {first + dist.shape[1]})")
    return o0, n, first, h


def upsampled_argmin_reference(dist: torch.Tensor, size: Tuple[int, int],
                               chunk: int = 16, exact: bool = False,
                               out_rows: Optional[Tuple[int, int]] = None,
                               map_rows: Optional[Tuple[int, int]] = None,
                               with_value: bool = False):
    """Plain version: a scan over prototype chunks with a running
    (min, argmin), first-occurrence ties (strict ``<``).

    f32 maps, or any map with ``exact=True``: exact f32 4-tap blend,
    x pass then y pass.  bf16 maps without ``exact``: the chunk goes
    through ``resize_bilinear`` in bf16 (the JAX package's fast path;
    whole frames only).

    Args:
      dist: (B, h, w, P) distances, or rows [first, first + h') of them
        with ``map_rows=(first, h)``.  size: (H, W).
      out_rows: (o0, n): output rows [o0, o0 + n) alone.
      with_value: also return the running min, f32.
    Returns:
      (B, H, W) int32, or (B, n, W) for a window; with ``with_value``
      (index, value).
    """
    B, _, w, P = dist.shape
    H, W = size
    o0, n, first, h = _window(dist, size, out_rows, map_rows)
    n_chunks = -(-P // chunk)
    pad = n_chunks * chunk - P
    if pad:
        dist = torch.nn.functional.pad(dist, (0, pad), value=_PAD)
    fast_bf16 = dist.dtype == torch.bfloat16 and not exact
    if fast_bf16 and (n != H or dist.shape[1] != h):
        raise ValueError("the bf16 resize path takes whole frames only; pass exact=True")

    if fast_bf16:
        def chunk_up(sl):
            return resize_bilinear(sl, size)
    else:
        y0, y1, wy = _src_coords(H, h, dist.device)
        y0, y1, wy = y0[o0:o0 + n] - first, y1[o0:o0 + n] - first, wy[o0:o0 + n]
        x0, x1, wx = _src_coords(W, w, dist.device)
        wy = wy[:, None, None]
        wx = wx[:, None]

        def chunk_up(sl):
            sl = sl.to(_F32)
            fx = sl[:, :, x0, :] * (1.0 - wx) + sl[:, :, x1, :] * wx
            return fx[:, y0] * (1.0 - wy) + fx[:, y1] * wy

    cdt = torch.bfloat16 if fast_bf16 else _F32
    best = torch.full((B, n, W), 2e30, dtype=cdt, device=dist.device)
    best_i = torch.zeros((B, n, W), dtype=torch.int32, device=dist.device)
    for i in range(n_chunks):
        up = chunk_up(dist[..., i * chunk:(i + 1) * chunk])
        cmin, cidx = up.min(dim=-1)
        take = cmin < best
        best = torch.where(take, cmin, best)
        best_i = torch.where(take, cidx.to(torch.int32) + i * chunk, best_i)
    return (best_i, best.to(_F32)) if with_value else best_i


def _lib() -> ctypes.CDLL:
    lib = _build.load("upsample_argmin")
    f = lib.adlm_upsample_argmin
    if f.argtypes is None:  # first use: declare the C signature
        vp, ci = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [vp, ci, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        f.restype = ci
    return lib


def upsampled_argmin_cuda(dist: torch.Tensor, size: Tuple[int, int],
                          out_rows: Optional[Tuple[int, int]] = None,
                          map_rows: Optional[Tuple[int, int]] = None,
                          with_value: bool = False):
    """Launch the fused kernel: (B, h, w, P) f32/bf16 CUDA → (B, H, W)
    int32, exact f32 blend for both dtypes; with ``out_rows=(o0, n)`` the
    (B, n, W) rows [o0, o0 + n) alone, from the slab of the map that
    ``map_rows=(first, h)`` places (the plain version's arguments).
    ``with_value``: (index, the winning value f32), one launch."""
    if not dist.is_cuda:
        raise ValueError("upsampled_argmin_cuda takes a CUDA tensor")
    if dist.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dist must be float32 or bfloat16, got {dist.dtype}")
    if dist.dim() != 4:
        raise ValueError(f"dist must be (B, h, w, P), got {tuple(dist.shape)}")
    B, hs, w, P = dist.shape
    H, W = (int(s) for s in size)
    o0, n, first, h = _window(dist, size, out_rows, map_rows)
    lib = _lib()
    dist = dist.contiguous()
    out = torch.empty((B, n, W), dtype=torch.int32, device=dist.device)
    val = torch.empty((B, n, W), dtype=_F32, device=dist.device) if with_value else None
    with torch.cuda.device(dist.device):
        status = lib.adlm_upsample_argmin(
            dist.data_ptr(), int(dist.dtype == torch.bfloat16), out.data_ptr(),
            val.data_ptr() if with_value else None,
            B, h, w, P, H, W, o0, n, first, hs, _build.stream_ptr(dist))
    _build.check(lib, status, "upsample_argmin")
    _build.LAUNCHES["upsample_argmin"] += 1
    return (out, val) if with_value else out


def upsampled_nearest(dist: torch.Tensor, size: Tuple[int, int],
                      chunk: int = 16, exact: bool = False,
                      out_rows: Optional[Tuple[int, int]] = None,
                      map_rows: Optional[Tuple[int, int]] = None,
                      with_value: bool = False):
    """argmin over prototypes of the bilinearly upsampled distance maps,
    ``argmin(resize_bilinear(dist, size), -1)`` (reference
    eval_valid.py:172-174), as (B, H, W) int32 (an output-row window:
    ``upsampled_argmin_reference``'s ``out_rows`` and ``map_rows``;
    ``with_value``: (index, the winning value f32), by the same path).

    A CUDA map goes to the kernel (exact f32 blend whatever ``exact``
    says).  A whole CPU frame with integer factors whose f32 maps fit
    64Mi elements takes the phase path, any other CPU call the chunked
    scan (a window in its exact f32 blend).
    """
    window = {} if out_rows is None and map_rows is None else dict(out_rows=out_rows,
                                                                   map_rows=map_rows)
    if with_value:
        window["with_value"] = True
    if dist.is_cuda:
        return upsampled_argmin_cuda(dist, size, **window)
    if "out_rows" in window:
        return upsampled_argmin_reference(dist, size, chunk, True, **window)
    B, h, w, P = dist.shape
    H, W = size
    if (H % h == 0 and W % w == 0 and (H // h) * (W // w) <= 256
            and B * h * w * P <= 64 * 1024 * 1024):
        return upsampled_nearest_integer(dist, H // h, W // w, with_value)
    return upsampled_argmin_reference(dist, size, chunk, exact, with_value=with_value)
