"""Image-folder dataset of the ProtoPNet classifier (counterpart of
``adlm_tpu.data.image_folder``; reference main.py:50-105: resize to
``img_size``, /255, normalize), and the port's image codecs.  Layout::

    root/<class_name>/*.jpg|*.jpeg|*.png|*.npy

Classes are the sorted subdirectory names (torchvision's convention).

The port reads images without PIL, whose pixels the JAX package's come
from, and gives the same ones bit for bit:

* ``.npy`` arrays (H, W) or (H, W, 3|4) are taken as uint8;
* JPEG files (``read_jpeg``) go through the host library's decoder
  (``native/jpeg.cc``), bit-equal to PIL's libjpeg-turbo: baseline,
  extended and progressive Huffman, 8-bit, grey or 3 components (YCbCr,
  or RGB where libjpeg-turbo takes it so), 4:4:4, 4:2:2 and 4:2:0,
  restart markers; arithmetic coding, lossless, 12-bit, CMYK/YCCK and
  other sampling factors raise, naming ROADMAP.md Queue 1 item 11;
* PNG files (``read_png``: 8-bit grey, grey + alpha, RGB, RGBA or
  palette, and 16-bit grey; not interlaced; any of the five scanline
  filters) are inflated with ``zlib`` and unfiltered with numpy;
* ``to_rgb`` is PIL's ``convert("RGB")`` of each of those: grey is
  replicated, alpha dropped, 16-bit grey clipped to 255 and palette
  indices looked up in the PLTE table (black past its end);
* the resize is PIL's 8-bit ``Image.BILINEAR`` (``resize_bilinear_u8``):
  the horizontal pass, then the vertical pass on its rounded uint8
  result, each in PIL's 22-bit fixed point.

``load_rgb`` picks the decoder from a file's leading bytes, as
``PIL.Image.open`` does (a PNG named ``.jpg`` reads as a PNG), and
``.npy`` by its suffix.  ``write_png`` writes 8-bit grey or RGB with
filter 0 and zlib level 6: PIL's encoder picks other filters, so the
bytes differ from PIL's and the pixels do not.  ``write_jpeg`` writes
PIL's default JPEG byte for byte (``native.encode_jpeg``), and
``image_comment`` reads the comment that PIL keeps in ``im.info`` and
writes back into a JPEG (``data/img_aug.py``).  Any other file type
listed (BMP, WebP) raises ``ValueError``, naming the conversion to
``.npy`` and ROADMAP.md Queue 1 item 11.  This module imports no torch.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np

from adlm_tpu_torch import native
from adlm_tpu_torch.data.dataset import _pil_bilinear_coeffs

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".npy")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"          # PIL's JpegImagePlugin._accept
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type → samples per pixel
_PNG_TYPES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha", 6: "RGBA"}
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


def read_png(path: str, palette: bool = False):
    """(H, W, channels) pixels of a non-interlaced PNG: uint8 for 8-bit
    grey, grey + alpha, RGB, RGBA and palette (the indices, as
    ``np.asarray(Image.open(path))``), uint16 for 16-bit grey.  With
    ``palette=True``, ``(pixels, table)``: the PLTE entries as (n, 3)
    uint8 for a palette image, else None."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat, table = 8, None, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if length % 3 or length > 3 * 256:
                raise ValueError(f"{path}: PLTE chunk of {length} bytes")
            table = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if not (depth == 8 and color in _PNG_CHANNELS or depth == 16 and color == 0) or interlace:
        kind = _PNG_TYPES.get(color, "unknown")
        raise ValueError(
            f"{path}: PNG with bit depth {depth}, colour type {color} ({kind}), interlace "
            f"{interlace}; the port reads 8-bit grey, grey+alpha, RGB, RGBA and palette "
            "and 16-bit grey without interlace (other PNG types: ROADMAP.md Queue 1 item "
            "11): convert the image to an (H, W, 3) uint8 .npy")
    if color == 3 and table is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    channels = _PNG_CHANNELS[color]
    bpp = channels * depth // 8        # bytes per pixel, the filters' stride
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{h * (w * bpp + 1)}")
    raw = raw.reshape(h, w * bpp + 1)
    ftype, filt = raw[:, 0], raw[:, 1:].reshape(h, w, bpp)
    if ftype.max() > 4:
        raise ValueError(f"{path}: unknown scanline filter {int(ftype.max())}")
    px = _unfilter_wavefront(filt, ftype) if ftype.any() else filt.copy()
    if depth == 16:                    # big-endian samples
        px = (px[:, :, 0::2].astype(np.uint16) << 8) | px[:, :, 1::2]
    return (px, table if color == 3 else None) if palette else px


def read_jpeg(path: str) -> np.ndarray:
    """(H, W, 1) grey or (H, W, 3) RGB uint8 pixels of a JPEG file,
    ``np.asarray(Image.open(path))`` bit for bit (``native.decode_jpeg``)."""
    with open(path, "rb") as fh:
        return native.decode_jpeg(fh.read(), path)


def to_rgb(pixels: np.ndarray, palette=None) -> np.ndarray:
    """PIL's ``convert("RGB")`` of ``read_png``'s (H, W, channels) pixels:
    (H, W, 3) uint8.  ``palette`` (n, 3), where given, maps the indices
    (those past its end to black); uint16 grey is clipped to 255; grey is
    replicated and alpha dropped."""
    if palette is not None:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette
        return lut[pixels[:, :, 0]]
    if pixels.dtype == np.uint16:
        pixels = np.minimum(pixels, 255).astype(np.uint8)
    if pixels.shape[2] <= 2:      # grey (+ alpha)
        return np.repeat(pixels[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, pixels: np.ndarray) -> None:
    """Write (H, W, 3) RGB or (H, W) grey uint8 pixels as an 8-bit PNG."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    if pixels.ndim == 2:
        color = 0
    elif pixels.ndim == 3 and pixels.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"PNG pixels must be (H, W) or (H, W, 3), got {pixels.shape}")
    h, w = pixels.shape[:2]
    rows = pixels.reshape(h, -1)
    # filter type 0 (none) before every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


def write_jpeg(path: str, rgb: np.ndarray, comment: Optional[bytes] = None) -> None:
    """Write (H, W, 3) uint8 pixels as ``Image.fromarray(rgb).save(path)``
    does for a .jpg, with ``comment`` in a COM marker if it is not empty."""
    data = native.encode_jpeg(rgb, comment)
    with open(path, "wb") as f:
        f.write(data)


# JPEG markers without a length (PIL's JpegImagePlugin.MARKER entries
# without a handler): JPG, RSTn, SOI, EOI, JPGn
_JPEG_BARE = {0xC8, *range(0xD0, 0xDA), *range(0xF0, 0xFE)}


def _jpeg_comment(data: bytes) -> Optional[bytes]:
    """The last COM marker's bytes before the first scan, walking the
    markers as ``JpegImageFile._open`` does (fill bytes and junk
    between segments skipped)."""
    pos, comment = 2, None
    while pos + 1 < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xFF or m == 0x00:
            pos += 1
            continue
        if m == 0xDA:
            break
        if m in _JPEG_BARE:
            pos += 2
            continue
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if m == 0xFE:
            comment = data[pos + 4:pos + 2 + length]
        pos += 2 + length
    return comment


def _png_comment(data: bytes) -> Optional[bytes]:
    """The text of the last tEXt, zTXt or iTXt chunk whose key is
    exactly ``comment``, as PIL decodes it into ``im.info`` (latin-1 for
    tEXt and zTXt, UTF-8 for iTXt), encoded as PIL's JPEG encoder takes
    a str: in UTF-8."""
    pos, comment = 8, None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            break
        if kind not in (b"tEXt", b"zTXt", b"iTXt"):
            continue
        key, _, value = body.partition(b"\0")
        if kind == b"zTXt" and value[:1] not in (b"", b"\0"):   # PIL refuses the file
            raise ValueError(f"unknown compression method {value[0]} in a zTXt chunk")
        if key != b"comment":
            continue
        if kind == b"tEXt":
            comment = value.decode("latin-1").encode()
        elif kind == b"zTXt":
            try:
                text = zlib.decompress(value[1:])
            except zlib.error:
                text = b""
            comment = text.decode("latin-1").encode()
        else:
            if len(value) < 2:
                continue
            flag, method, rest = value[0], value[1], value[2:]
            parts = rest.split(b"\0", 2)
            if len(parts) < 3:
                continue
            text = parts[2]
            if flag:
                if method:
                    continue
                try:
                    text = zlib.decompress(text)
                except zlib.error:
                    continue
            try:
                parts[0].decode("utf-8"), parts[1].decode("utf-8")
                comment = text.decode("utf-8").encode()
            except UnicodeError:
                continue
    return comment


def image_comment(path: str) -> Optional[bytes]:
    """The comment PIL's ``Image.open(path)`` keeps in ``info["comment"]``,
    as the bytes its JPEG encoder then writes into a COM marker: a
    JPEG's last COM marker, or a PNG's text chunk keyed ``comment``.
    None where there is none."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(_JPEG_SIGNATURE):
        return _jpeg_comment(data)
    if data.startswith(_PNG_SIGNATURE):
        return _png_comment(data)
    return None


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
    """(H, W, 3) uint8 pixels of a ``.npy``, JPEG or PNG image file, the
    last two told apart by their leading bytes."""
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        arr = arr.astype(np.uint8)
        if arr.ndim != 3 or arr.shape[2] not in (1, 2, 3, 4):
            raise ValueError(f"{path}: image of shape {arr.shape}")
        return to_rgb(arr)
    with open(path, "rb") as fh:
        head = fh.read(len(_PNG_SIGNATURE))
    if head.startswith(_JPEG_SIGNATURE):
        return to_rgb(read_jpeg(path))
    if head == _PNG_SIGNATURE:
        return to_rgb(*read_png(path, palette=True))
    raise ValueError(f"{path}: the port reads .npy, JPEG and PNG images only (BMP, "
                     "WebP: ROADMAP.md Queue 1 item 11); convert it to an (H, W, 3) "
                     "uint8 .npy, e.g. np.save(out, np.asarray(Image.open(path)"
                     ".convert('RGB')))")


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
                seed: int = 0, with_count: bool = False,
                shard: Optional[Tuple[int, int]] = None) -> Iterator:
        """(B, S, S, 3) float32 / (B,) int32 batches.  The final partial
        batch wraps around to the start, so every batch has one shape.

        ``with_count=True`` yields ``(images, labels, n_valid)`` triples,
        ``n_valid < batch_size`` marking the wrapped tail batch: eval,
        k-nearest and push use it so that no wrapped image counts
        twice.

        ``shard=(k, n)``: data rank k of n loads only its ``batch_size/n``
        rows of each batch (the wrapped tail included), with the global
        batch's ``n_valid``."""
        if shard is not None and batch_size % shard[1]:
            raise ValueError(f"batch {batch_size} does not divide over {shard[1]} data ranks")
        rows = (range(batch_size) if shard is None else
                range(shard[0] * (batch_size // shard[1]),
                      (shard[0] + 1) * (batch_size // shard[1])))
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        n_batches = -(-len(self) // batch_size)
        # the images of a batch decode and resize on threads (numpy
        # releases the GIL in its array loops)
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            for b in range(n_batches):
                idxs = [int(order[(b * batch_size + j) % len(self)])
                        for j in rows]
                items = list(pool.map(self.load, idxs))
                out = (np.stack([im for im, _ in items]),
                       np.asarray([lb for _, lb in items], np.int32))
                if with_count:
                    out = (*out, min(len(self) - b * batch_size, batch_size))
                yield out
