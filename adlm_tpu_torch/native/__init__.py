"""ctypes bindings for the port's host C++ data library (counterpart of
``adlm_tpu.native``).

``augment.cc`` is the port's own copy of the JAX package's source.  It
is built with ``g++`` at first use into ``adlm_tpu_torch/_build/``,
under a name that carries a hash of the source and the flags, as
``ops/_build.py`` does for the CUDA kernels: an edited source rebuilds,
an unchanged one loads the earlier build.  It runs on the host CPU, so
building it needs no card.  A failed build raises: there is no PIL or
pure-Python path behind it.

``augment_sample_plain`` is a numpy version of the fused chain, for the
tests and ``chip_smoke.py`` only.  U-Noise's ``remap_*`` and
``gaussian_blur_f32`` are compiled but not bound yet.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "augment.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# portable -O3 (no -march=native: a build copied to another host must
# not fault on a missing instruction); no FMA contraction, so that every
# multiply and add rounds as augment_sample_plain's numpy does
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-ffp-contract=off"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> str:
    """Where the build of the current source and flags lives."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libadlm_data-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Build the library unless this source is built already; return its
    path.  Concurrent builds (threads, spawned loader workers) each
    write a file of their own and rename it into place."""
    target = library_path()
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        out = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the host data library is built "
                           "from adlm_tpu_torch/native/augment.cc") from e
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed for native/augment.cc (exit "
                           f"{out.returncode}):\n{out.stderr}")
    os.replace(tmp, target)
    return target


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _bind(lib)
            _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i = ctypes.c_int
    lib.resize_bilinear_u8.argtypes = [u8p, i, i, i, f32p, i, i]
    lib.resize_nearest_i32.argtypes = [i32p, i, i, i32p, i, i]
    lib.augment_sample.argtypes = [
        u8p, i32p, i, i, i, i, i, i, i, i, i, i, i, i,
        f32p, f32p, f32p, i32p, f32p, i32p]
    lib.augment_sample_fused.argtypes = [
        u8p, ctypes.c_void_p, i, i, i, i, i, i, i, i, i, i, i, i, i,
        f32p, f32p, i32p, i, f32p, i32p]
    for fn in (lib.resize_bilinear_u8, lib.resize_nearest_i32,
               lib.augment_sample, lib.augment_sample_fused):
        fn.restype = None


def resize_bilinear_u8(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Half-pixel bilinear resize of an (H, W, C) uint8 image to float32
    (cv2.INTER_LINEAR semantics)."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((dh, dw, c), np.float32)
    lib.resize_bilinear_u8(img, h, w, c, out, dh, dw)
    return out


def resize_nearest_i32(label: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Nearest label resize, source index floor((i + 0.5)·in/out)."""
    lib = _load()
    label = np.ascontiguousarray(label, np.int32)
    h, w = label.shape
    out = np.empty((dh, dw), np.int32)
    lib.resize_nearest_i32(label, h, w, out, dh, dw)
    return out


def _geometry(img: np.ndarray, label: np.ndarray, scale: float,
              window: Tuple[int, int], mean, std) -> Tuple[int, int, int, int, int]:
    """Validate what the C code indexes; (h, w, c, scaled h, scaled w)."""
    if img.ndim != 3 or label.shape != img.shape[:2]:
        raise ValueError(f"image (H, W, C) and label (H, W) expected, got "
                         f"{img.shape} and {label.shape}")
    h, w, c = img.shape
    if len(mean) != c or len(std) != c:
        raise ValueError(f"{c} channels need {c} means and stds, got "
                         f"{len(mean)} and {len(std)}")
    sh2, sw2 = int(h * scale), int(w * scale)
    if sh2 < 1 or sw2 < 1 or min(window) < 1:
        raise ValueError(f"scale {scale} of {h}x{w} or window {window} is empty")
    return h, w, c, sh2, sw2


_EMPTY_LUT = np.zeros(1, np.int32)


def augment_sample(img: np.ndarray, label: np.ndarray,
                   scale: float, window: Tuple[int, int],
                   start: Tuple[int, int], flip: bool,
                   mean: Tuple[float, ...], std: Tuple[float, ...],
                   cells: bool = False, normalize: bool = True,
                   label_lut: Optional[np.ndarray] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's training transform in one C call (the fused
    kernel): bilinear sampling of the uint8 source at the scaled crop
    coordinates, rounded to uint8 steps, /255 (unless ``cells``),
    floor-nearest labels, padding with the mean (label 0) where the
    scaled image is smaller than the window, horizontal flip, then
    ``(x − mean)/std`` unless ``normalize`` is False.

    img: (H, W, 3) uint8 (a read-only ``np.memmap`` works: only the
    sampled rows are read); label: (H, W) int32 or uint8 raw ids,
    remapped by ``label_lut`` on the cropped pixels.  Returns
    (window_h, window_w, 3) float32 and (window_h, window_w) int32."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    if label.dtype == np.uint8:
        label = np.ascontiguousarray(label)
        label_u8 = 1
    else:
        label = np.ascontiguousarray(label, np.int32)
        label_u8 = 0
    h, w, c, sh2, sw2 = _geometry(img, label, scale, window, mean, std)
    wh, ww = window
    out_img = np.empty((wh, ww, c), np.float32)
    out_label = np.empty((wh, ww), np.int32)
    if label_lut is None:
        lut, lut_size = _EMPTY_LUT, 0
    else:
        lut = np.ascontiguousarray(label_lut, np.int32)
        lut_size = lut.shape[0]
    lib.augment_sample_fused(
        img, label.ctypes.data_as(ctypes.c_void_p), label_u8,
        h, w, c, sh2, sw2, wh, ww, start[0], start[1], int(flip),
        int(cells), int(normalize), np.asarray(mean, np.float32),
        np.asarray(std, np.float32), lut, lut_size,
        out_img.reshape(-1), out_label.reshape(-1))
    return out_img, out_label


def augment_sample_unfused(img: np.ndarray, label: np.ndarray,
                           scale: float, window: Tuple[int, int],
                           start: Tuple[int, int], flip: bool,
                           mean: Tuple[float, ...], std: Tuple[float, ...],
                           cells: bool = False, normalize: bool = True
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """The resize-then-crop kernel, which ``augment_sample`` must equal
    bit for bit (kept for that test; no LUT)."""
    lib = _load()
    img = np.ascontiguousarray(img, np.uint8)
    label = np.ascontiguousarray(label, np.int32)
    h, w, c, sh2, sw2 = _geometry(img, label, scale, window, mean, std)
    wh, ww = window
    scratch_img = np.empty((sh2, sw2, c), np.float32)
    scratch_label = np.empty((sh2, sw2), np.int32)
    out_img = np.empty((wh, ww, c), np.float32)
    out_label = np.empty((wh, ww), np.int32)
    lib.augment_sample(img, label, h, w, c, sh2, sw2, wh, ww,
                       start[0], start[1], int(flip), int(cells),
                       int(normalize), np.asarray(mean, np.float32),
                       np.asarray(std, np.float32),
                       scratch_img.reshape(-1), scratch_label.reshape(-1),
                       out_img.reshape(-1), out_label.reshape(-1))
    return out_img, out_label


def _taps(s: np.ndarray, n: int, n2: int):
    """The fused kernel's per-row (or per-column) sampling state for
    scaled coordinates ``s`` of a source extent ``n`` scaled to ``n2``:
    the two clamped bilinear taps and the weight of the second in f32,
    as C computes them, and the floor-nearest label index in f64."""
    f32 = np.float32
    scale = f32(n) / f32(n2)
    f = (s.astype(f32) + f32(0.5)) * scale - f32(0.5)
    i0 = np.floor(f).astype(np.int64)
    wgt = f - i0.astype(f32)
    nearest = np.minimum(((s + 0.5) * (n / n2)).astype(np.int64), n - 1)
    return (np.clip(i0, 0, n - 1), np.clip(i0 + 1, 0, n - 1), wgt, nearest)


def augment_sample_plain(img: np.ndarray, label: np.ndarray,
                         scale: float, window: Tuple[int, int],
                         start: Tuple[int, int], flip: bool,
                         mean: Tuple[float, ...], std: Tuple[float, ...],
                         cells: bool = False, normalize: bool = True,
                         label_lut: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """``augment_sample`` in numpy: the same f32 operations in the same
    order, vectorized over the window (for the tests and
    ``chip_smoke.py``, which hold the C++ against it)."""
    f32 = np.float32
    img, label = np.asarray(img), np.asarray(label)
    h, w, c, sh2, sw2 = _geometry(img, label, scale, window, mean, std)
    wh, ww = window
    mean_a, std_a = np.asarray(mean, f32), np.asarray(std, f32)
    out_img = np.empty((wh, ww, c), f32)
    out_img[...] = (mean_a - mean_a) / std_a if normalize else mean_a
    out_label = np.zeros((wh, ww), np.int32)
    sy = start[0] + np.arange(wh)
    sx = start[1] + np.arange(ww)
    sy, sx = sy[sy < sh2], sx[sx < sw2]   # in-bounds prefixes; the rest pads
    if sy.size and sx.size:
        y0, y1, wy, ly = _taps(sy, h, sh2)
        x0, x1, wx, lx = _taps(sx, w, sw2)
        px = lambda ys, xs: img[ys[:, None], xs[None, :]].astype(f32)
        wx3, wy3 = wx[None, :, None], wy[:, None, None]
        top = px(y0, x0) * (f32(1) - wx3) + px(y0, x1) * wx3
        bot = px(y1, x0) * (f32(1) - wx3) + px(y1, x1) * wx3
        v = np.clip(np.rint(top * (f32(1) - wy3) + bot * wy3), f32(0), f32(255))
        v = v * (f32(1) if cells else f32(1) / f32(255))
        out_img[:sy.size, :sx.size] = (v - mean_a) / std_a if normalize else v
        raw = label[ly[:, None], lx[None, :]].astype(np.int32)
        if label_lut is not None:
            lut = np.asarray(label_lut, np.int32)
            raw = lut[np.clip(raw, 0, lut.shape[0] - 1)]
        out_label[:sy.size, :sx.size] = raw
    if flip:
        out_img, out_label = out_img[:, ::-1].copy(), out_label[:, ::-1].copy()
    return out_img, out_label
