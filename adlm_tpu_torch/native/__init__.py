"""ctypes bindings for the port's host C++ data library (counterpart of
``adlm_tpu.native``).

``augment.cc`` is the port's own copy of the JAX package's source;
``jpeg.cc`` is the port's JPEG decoder, bit-equal to PIL's pixels
(``decode_jpeg``); ``img_aug.cc`` holds PIL's bilinear affine warp
(``affine_bilinear_u8``) and a JPEG encoder byte-equal to PIL's default
``save`` (``encode_jpeg``).  All three are built with ``g++`` at first
use into one library in ``adlm_tpu_torch/_build/``, under a name that
carries a hash of the sources and the flags, as ``ops/_build.py`` does
for the CUDA kernels: an edit to any source rebuilds, unchanged ones
load the earlier build.  It runs on the host CPU, so building it needs no card.
A failed build raises: there is no PIL or pure-Python path behind it.

``augment_sample_plain`` is a numpy version of the fused chain, and
``remap_bilinear_plain``, ``remap_nearest_plain`` and
``gaussian_blur_plain`` are those of U-Noise's warps (``remap_*``,
``gaussian_blur``): for the tests and ``chip_smoke.py`` only.
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
JPEG_SOURCE = os.path.join(_DIR, "jpeg.cc")
IMG_AUG_SOURCE = os.path.join(_DIR, "img_aug.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# portable -O3 (no -march=native: a build copied to another host must
# not fault on a missing instruction); no FMA contraction, so that every
# multiply and add rounds as augment_sample_plain's numpy and PIL's warp do
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-ffp-contract=off"]

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _sources() -> Tuple[str, ...]:
    return SOURCE, JPEG_SOURCE, IMG_AUG_SOURCE


def library_path() -> str:
    """Where the build of the current sources and flags lives."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(f.read())
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
        out = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, *_sources()],
                             capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the host data library is built from "
                           "adlm_tpu_torch/native/augment.cc, jpeg.cc and img_aug.cc") from e
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed for native/augment.cc, jpeg.cc and img_aug.cc "
                           f"(exit {out.returncode}):\n{out.stderr}")
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
    lib.remap_bilinear_f32.argtypes = [f32p, i, i, i, f32p, f32p, i, i, f32p]
    lib.remap_nearest_f32.argtypes = [f32p, i, i, f32p, f32p, i, i, f32p]
    lib.gaussian_blur_f32.argtypes = [f32p, i, i, ctypes.c_float, f32p, f32p]
    lib.jpeg_header.argtypes = [u8p, ctypes.c_size_t, i32p, ctypes.c_char_p, i]
    lib.jpeg_decode.argtypes = [u8p, ctypes.c_size_t, u8p, i, i, i, ctypes.c_char_p, i]
    lib.jpeg_header.restype = lib.jpeg_decode.restype = ctypes.c_int
    lib.affine_bilinear_u8.argtypes = [
        u8p, i, i, np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"), u8p]
    lib.jpeg_encode.argtypes = [u8p, i, i, u8p, i, u8p, ctypes.c_size_t]
    lib.jpeg_encode.restype = ctypes.c_size_t
    for fn in (lib.resize_bilinear_u8, lib.resize_nearest_i32,
               lib.augment_sample, lib.augment_sample_fused,
               lib.remap_bilinear_f32, lib.remap_nearest_f32,
               lib.gaussian_blur_f32, lib.affine_bilinear_u8):
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


# ---------------------------------------------------------------------------
# U-Noise's warps (data/warps.py): cv2.remap with BORDER_REFLECT_101, and
# scipy's gaussian_filter(mode="constant", truncate=4)
# ---------------------------------------------------------------------------

def _maps(map_y: np.ndarray, map_x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    if map_y.shape != map_x.shape or map_y.ndim != 2:
        raise ValueError(f"maps must be two (H, W) arrays, got {map_y.shape} "
                         f"and {map_x.shape}")
    return (np.ascontiguousarray(map_y, np.float32),
            np.ascontiguousarray(map_x, np.float32))


def remap_bilinear(img: np.ndarray, map_y: np.ndarray,
                   map_x: np.ndarray) -> np.ndarray:
    """cv2.remap(INTER_LINEAR, BORDER_REFLECT_101) of a float32
    (H, W[, C]) image at the float coordinates of the (OH, OW) maps."""
    lib = _load()
    map_y, map_x = _maps(map_y, map_x)
    squeeze = img.ndim == 2
    img3 = np.ascontiguousarray(img[..., None] if squeeze else img, np.float32)
    h, w, c = img3.shape
    oh, ow = map_y.shape
    out = np.empty((oh, ow, c), np.float32)
    lib.remap_bilinear_f32(img3.reshape(-1), h, w, c, map_y.reshape(-1),
                           map_x.reshape(-1), oh, ow, out.reshape(-1))
    return out[..., 0] if squeeze else out


def remap_nearest(mask: np.ndarray, map_y: np.ndarray,
                  map_x: np.ndarray) -> np.ndarray:
    """cv2.remap(INTER_NEAREST, BORDER_REFLECT_101) of a float32 (H, W)
    mask; coordinates round half to even, as ``np.round``."""
    lib = _load()
    map_y, map_x = _maps(map_y, map_x)
    mask = np.ascontiguousarray(mask, np.float32)
    if mask.ndim != 2:
        raise ValueError(f"mask must be (H, W), got {mask.shape}")
    h, w = mask.shape
    oh, ow = map_y.shape
    out = np.empty((oh, ow), np.float32)
    lib.remap_nearest_f32(mask.reshape(-1), h, w, map_y.reshape(-1),
                          map_x.reshape(-1), oh, ow, out.reshape(-1))
    return out


def gaussian_blur(src: np.ndarray, sigma: float) -> np.ndarray:
    """Separable gaussian blur of a float32 (H, W) field with zero
    borders, truncated at 4 sigma (scipy's ``gaussian_filter(mode=
    "constant")``; the C code accumulates in f64)."""
    lib = _load()
    src = np.ascontiguousarray(src, np.float32)
    if src.ndim != 2:
        raise ValueError(f"field must be (H, W), got {src.shape}")
    h, w = src.shape
    tmp = np.empty((h, w), np.float32)
    out = np.empty((h, w), np.float32)
    lib.gaussian_blur_f32(src.reshape(-1), h, w, ctypes.c_float(sigma),
                          tmp.reshape(-1), out.reshape(-1))
    return out


def decode_jpeg(data: bytes, name: str) -> np.ndarray:
    """(H, W, 1) grey or (H, W, 3) RGB uint8 pixels of a JPEG file's
    bytes, bit-equal to what PIL decodes (``jpeg.cc``).  Raises
    ``ValueError`` naming ``name`` for corrupt or truncated data, and for
    the variants the decoder does not read (arithmetic coding, lossless
    and hierarchical frames, 12-bit samples, 2 or 4 components, other
    sampling factors), naming ROADMAP.md Queue 1 item 11 for those."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    hwc = np.zeros(3, np.int32)
    code = lib.jpeg_header(buf, buf.size, hwc, err, len(err))
    if code == 0:
        out = np.empty(tuple(int(v) for v in hwc), np.uint8)
        code = lib.jpeg_decode(buf, buf.size, out, *out.shape, err, len(err))
        if code == 0:
            return out
    msg = err.value.decode(errors="replace")
    if code == 2:
        raise ValueError(f"{name}: JPEG with {msg}, which the port does not read "
                         "(ROADMAP.md Queue 1 item 11); convert it to an (H, W, 3) uint8 .npy")
    raise ValueError(f"{name}: corrupt or truncated JPEG: {msg}")


def _rgb_u8(img: np.ndarray, what: str) -> np.ndarray:
    if not (isinstance(img, np.ndarray) and img.dtype == np.uint8 and img.ndim == 3
            and img.shape[2] == 3 and img.shape[0] >= 1 and img.shape[1] >= 1):
        desc = (f"{img.dtype} array of shape {img.shape}" if isinstance(img, np.ndarray)
                else type(img).__name__)
        raise ValueError(f"{what} takes an (H, W, 3) uint8 array with H, W >= 1, got {desc}")
    return np.ascontiguousarray(img)


def affine_bilinear_u8(img: np.ndarray, coeffs) -> np.ndarray:
    """PIL's ``Image.transform(size, Image.AFFINE, coeffs, Image.BILINEAR)``
    of an (H, W, 3) uint8 image, bit for bit: ``coeffs`` (a, b, c, d, e, f)
    map the output pixel centre (x, y) to the source point (a·x + b·y + c,
    d·x + e·y + f); points outside the image give 0 (``img_aug.cc``)."""
    lib = _load()
    img = _rgb_u8(img, "affine_bilinear_u8")
    a = np.asarray(coeffs, np.float64)
    if a.shape != (6,):
        raise ValueError(f"an affine transform has 6 coefficients, got {a.shape}")
    out = np.empty_like(img)
    lib.affine_bilinear_u8(img, img.shape[0], img.shape[1], a, out)
    return out


JPEG_MAX_DIMENSION = 65500    # libjpeg's limit, which PIL's save hits first
_COM_MAX = 65533              # a marker segment's payload


def encode_jpeg(rgb: np.ndarray, comment: Optional[bytes] = None) -> bytes:
    """The bytes of PIL's ``Image.fromarray(rgb).save(f, "JPEG")``
    (baseline, quality 75, 4:2:0, the standard Huffman tables, JFIF 1.01)
    with ``comment`` in a COM marker if it is not empty, as PIL writes
    ``im.info["comment"]`` (``img_aug.cc``).  Raises ``ValueError`` for
    anything but an (H, W, 3) uint8 array with 1 <= H, W <= 65500, or a
    comment longer than a marker holds."""
    lib = _load()
    rgb = _rgb_u8(rgb, "encode_jpeg")
    h, w = rgb.shape[:2]
    if max(h, w) > JPEG_MAX_DIMENSION:
        raise ValueError(f"encode_jpeg: {h}x{w} exceeds JPEG's {JPEG_MAX_DIMENSION} pixels a side")
    com = np.frombuffer(bytes(comment or b""), np.uint8)
    if com.size > _COM_MAX:
        raise ValueError(f"encode_jpeg: a comment of {com.size} bytes exceeds {_COM_MAX}")
    # a block codes in at most 1,700 bits, doubled by 0xFF stuffing
    mcus = -(-h // 16) * -(-w // 16)
    cap = mcus * 6 * 2 * 213 + com.size + 1024
    out = np.empty(cap, np.uint8)
    n = lib.jpeg_encode(rgb, h, w, com, com.size, out, cap)
    if n == 0:
        raise RuntimeError(f"jpeg_encode: {h}x{w} overran its {cap}-byte buffer")
    return out[:n].tobytes()


def _reflect101(coords: np.ndarray, n: int) -> np.ndarray:
    """Mirror out-of-range integer coordinates without repeating the edge
    (cv2.BORDER_REFLECT_101): -1 -> 1, n -> n-2."""
    if n == 1:
        return np.zeros_like(coords)
    period = 2 * (n - 1)
    c = np.abs(coords) % period
    return np.where(c >= n, period - c, c)


def remap_bilinear_plain(img: np.ndarray, map_y: np.ndarray,
                         map_x: np.ndarray) -> np.ndarray:
    """``remap_bilinear`` in numpy, the same f32 operations (the JAX
    package's ``_sample_bilinear``)."""
    h, w = img.shape[:2]
    y0 = np.floor(map_y).astype(np.int64)
    x0 = np.floor(map_x).astype(np.int64)
    fy = (map_y - y0).astype(np.float32)
    fx = (map_x - x0).astype(np.float32)
    ys = [_reflect101(y0, h), _reflect101(y0 + 1, h)]
    xs = [_reflect101(x0, w), _reflect101(x0 + 1, w)]
    if img.ndim == 3:
        fy, fx = fy[..., None], fx[..., None]
    top = img[ys[0], xs[0]] * (1 - fx) + img[ys[0], xs[1]] * fx
    bot = img[ys[1], xs[0]] * (1 - fx) + img[ys[1], xs[1]] * fx
    return (top * (1 - fy) + bot * fy).astype(img.dtype)


def remap_nearest_plain(mask: np.ndarray, map_y: np.ndarray,
                        map_x: np.ndarray) -> np.ndarray:
    """``remap_nearest`` in numpy (the JAX package's ``_sample_nearest``)."""
    h, w = mask.shape[:2]
    y = _reflect101(np.round(map_y).astype(np.int64), h)
    x = _reflect101(np.round(map_x).astype(np.int64), w)
    return mask[y, x]


def gaussian_blur_plain(src: np.ndarray, sigma: float) -> np.ndarray:
    """``gaussian_blur`` by scipy (f64 inside, a float32 result)."""
    from scipy.ndimage import gaussian_filter

    return gaussian_filter(src, sigma, mode="constant", cval=0)
