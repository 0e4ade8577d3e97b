"""Image-folder dataset of the ProtoPNet classifier (counterpart of
``adlm_tpu.data.image_folder``; reference main.py:50-105: resize to
``img_size``, /255, normalize).  Layout::

    root/<class_name>/*.png|*.npy

Classes are the sorted subdirectory names (torchvision's convention).

The port reads images without PIL, whose pixels the JAX package's come
from, and gives the same ones bit for bit:

* ``.npy`` arrays (H, W) or (H, W, 3|4) are taken as uint8;
* PNG files (8-bit grey, grey + alpha, RGB or RGBA, not interlaced,
  any of the five scanline filters) are inflated with ``zlib`` and
  unfiltered with numpy;
* grey becomes RGB by replication and alpha is dropped, as PIL's
  ``convert("RGB")`` does;
* the resize is PIL's 8-bit ``Image.BILINEAR`` (``resize_bilinear_u8``):
  the horizontal pass, then the vertical pass on its rounded uint8
  result, each in PIL's 22-bit fixed point.

Any other file type listed (JPEG, BMP, WebP) raises ``ValueError``,
naming the conversion to ``.npy``.  This module imports no torch.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np

from adlm_tpu_torch.data.dataset import _pil_bilinear_coeffs

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".npy")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type → samples per pixel
_PRECISION_BITS = 32 - 8 - 2               # PIL's Resample.c


def _unfilter_wavefront(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo PNG scanline filters (H, W, bpp) of any types, one
    anti-diagonal of pixels at a time: a pixel's predictor reads its
    left, upper and upper-left neighbours, all on earlier diagonals."""
    H, W, bpp = filt.shape
    out = np.zeros((H + 1, W + 1, bpp), np.int32)  # row 0 and column 0: zeros
    f = filt.astype(np.int32)
    for diag in range(H + W - 1):
        r = np.arange(max(0, diag - W + 1), min(H, diag + 1))
        x = diag - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        t = ftype[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (f[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """(H, W, channels) uint8 pixels of an 8-bit, non-interlaced PNG of
    colour type grey, grey + alpha, RGB or RGBA."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: PNG with bit depth {depth}, colour type {color}, interlace "
            f"{interlace}; the port reads 8-bit grey, grey+alpha, RGB or RGBA "
            "without interlace: convert the image to an (H, W, 3) uint8 .npy")
    bpp = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{h * (w * bpp + 1)}")
    raw = raw.reshape(h, w * bpp + 1)
    ftype, filt = raw[:, 0], raw[:, 1:].reshape(h, w, bpp)
    if ftype.max() > 4:
        raise ValueError(f"{path}: unknown scanline filter {int(ftype.max())}")
    if not ftype.any():
        return filt.copy()
    return _unfilter_wavefront(filt, ftype)


def _resize_axis_u8(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit bilinear resample along ``axis`` (0 or 1)
    of an (H, W, C) image: the double coefficients rounded to 22-bit
    integers, an integer sum from half a unit, shifted back and clipped
    to uint8.  The sums fit int32 (PIL's own type)."""
    n = x.shape[axis]
    xmin, k = _pil_bilinear_coeffs(n, out_size)
    kk = np.where(k < 0, np.trunc(k * (1 << _PRECISION_BITS) - 0.5),
                  np.trunc(k * (1 << _PRECISION_BITS) + 0.5)).astype(np.int32)
    shape = [1, 1, 1]
    shape[axis] = out_size
    src = x.astype(np.int32)
    acc = np.full(x.shape[:axis] + (out_size,) + x.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    for j in range(kk.shape[1]):
        acc += np.take(src, np.minimum(xmin + j, n - 1), axis=axis) * kk[:, j].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize((w, h), Image.BILINEAR)`` of an
    (H, W, C) uint8 image, in numpy: horizontal pass first, each pass
    skipped where its extent is unchanged."""
    h, w = size
    out = np.asarray(img, np.uint8)
    if out.shape[1] != w:
        out = _resize_axis_u8(out, w, 1)
    if out.shape[0] != h:
        out = _resize_axis_u8(out, h, 0)
    return out


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 pixels of a ``.npy`` or PNG image file."""
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        arr = arr.astype(np.uint8)
    elif path.lower().endswith(".png"):
        arr = read_png(path)
    else:
        raise ValueError(f"{path}: the port reads .npy and PNG images only (no "
                         "JPEG/BMP/WebP decoder without PIL); convert it to an "
                         "(H, W, 3) uint8 .npy, e.g. np.save(out, "
                         "np.asarray(Image.open(path).convert('RGB')))")
    if arr.ndim != 3 or arr.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"{path}: image of shape {arr.shape}")
    if arr.shape[2] <= 2:      # grey (+ alpha)
        return np.repeat(arr[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(arr[:, :, :3])


class ImageFolderDataset:
    def __init__(self, root: str, img_size: int, normalize: bool = True,
                 mean: Tuple[float, ...] = IMAGENET_MEAN,
                 std: Tuple[float, ...] = IMAGENET_STD):
        self.root = root
        self.img_size = img_size
        self.normalize = normalize
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.classes: List[str] = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if not self.classes:
            raise ValueError(f"no class subdirectories under {root!r}")
        self.samples: List[Tuple[str, int]] = []
        for ci, cname in enumerate(self.classes):
            cdir = os.path.join(root, cname)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(_EXTS):
                    self.samples.append((os.path.join(cdir, fname), ci))
        if not self.samples:
            raise ValueError(f"no images under {root!r}")

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int) -> Tuple[np.ndarray, int]:
        """(img_size, img_size, 3) float32 image, /255 and normalized,
        and its class index."""
        path, label = self.samples[index]
        img = resize_bilinear_u8(load_rgb(path), (self.img_size, self.img_size))
        x = np.asarray(img, np.float32) / 255.0
        if self.normalize:
            x = (x - self.mean) / self.std
        return x, label

    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0, with_count: bool = False) -> Iterator:
        """(B, S, S, 3) float32 / (B,) int32 batches.  The final partial
        batch wraps around to the start, so every batch has one shape.

        ``with_count=True`` yields ``(images, labels, n_valid)`` triples,
        ``n_valid < batch_size`` marking the wrapped tail batch: eval,
        k-nearest and push use it so that no wrapped image counts
        twice."""
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        n_batches = -(-len(self) // batch_size)
        # the images of a batch decode and resize on threads (numpy
        # releases the GIL in its array loops)
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            for b in range(n_batches):
                idxs = [int(order[(b * batch_size + j) % len(self)])
                        for j in range(batch_size)]
                items = list(pool.map(self.load, idxs))
                out = (np.stack([im for im, _ in items]),
                       np.asarray([lb for _, lb in items], np.int32))
                if with_count:
                    out = (*out, min(len(self) - b * batch_size, batch_size))
                yield out
