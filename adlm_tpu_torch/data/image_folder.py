"""Image-folder dataset of the ProtoPNet classifier (counterpart of
``adlm_tpu.data.image_folder``; reference main.py:50-105: resize to
``img_size``, /255, normalize), and the port's image codecs.  Layout::

    root/<class_name>/*.jpg|*.jpeg|*.png|*.bmp|*.webp|*.npy

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
* PNG files (``read_png``: every bit depth and colour type PNG allows,
  plain or Adam7-interlaced, any of the five scanline filters) are
  inflated with ``zlib``, unfiltered with numpy and given PIL's mode:
  1-bit grey as bool, 2- and 4-bit grey scaled to 0..255, 16-bit grey
  as uint16, the high byte of other 16-bit samples, 16-bit grey + alpha
  as RGBA;
* BMP files (``read_bmp``: the header sizes, depths, bitfields layouts,
  RLE8 and RLE4 that PIL's ``BmpImagePlugin`` reads, either row order)
  are unpacked with numpy as PIL unpacks them, save five kinds of file
  that PIL misreads, which the port reads by the format
  (``read_bmp``, ``_bmp_rle``);
* ``to_rgb`` is PIL's ``convert("RGB")`` of each of those: grey is
  replicated, alpha dropped, bool made 0 or 255, 16-bit grey clipped to
  255 and palette indices looked up in the table (black past its end);
* the resize is PIL's 8-bit ``Image.BILINEAR`` (``resize_bilinear_u8``):
  the horizontal pass, then the vertical pass on its rounded uint8
  result, each in PIL's 22-bit fixed point.

``load_rgb`` picks the decoder from a file's leading bytes, as
``PIL.Image.open`` does (a PNG or BMP named ``.jpg`` reads as what it
is), and ``.npy`` by its suffix.  ``write_png`` writes 8-bit grey or RGB
with filter 0 and zlib level 6: PIL's encoder picks other filters, so
the bytes differ from PIL's and the pixels do not.  ``write_jpeg``
writes PIL's default JPEG byte for byte (``native.encode_jpeg``), and
``image_comment`` reads the comment that PIL keeps in ``im.info`` and
writes back into a JPEG (``data/img_aug.py``).  A WebP file, and any
other type, raises ``ValueError``, naming the conversion to ``.npy``
and ROADMAP.md Queue 1 item 11; a PNG or BMP that PIL refuses raises
``ValueError`` naming the file.  This module imports no torch.
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
_BMP_SIGNATURE = b"BM"                     # PIL's BmpImagePlugin._accept
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type → samples per pixel
_PNG_TYPES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha", 6: "RGBA"}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
          (0, 1, 2, 2), (1, 0, 2, 1))
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


def _unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(h, width) samples of ``depth`` < 8 bits packed most significant
    bits first in the (h, bytes) ``rows``; each row's padding bits
    dropped."""
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :width]


def _png_pass(raw: np.ndarray, h: int, w: int, depth: int, channels: int,
              path: str) -> np.ndarray:
    """(h, w, channels) samples, uint8 (uint16 at 16 bits), of one
    image or Adam7 pass: ``raw`` holds its h scanlines, each its filter
    type and then its bytes.  The filters work on bytes, their stride
    one pixel's bytes (one byte below 8 bits)."""
    stride = max(1, channels * depth // 8)
    row_bytes = -(-w * channels * depth // 8)
    raw = raw.reshape(h, row_bytes + 1)
    ftype, filt = raw[:, 0], raw[:, 1:].reshape(h, row_bytes // stride, stride)
    if ftype.max() > 4:
        raise ValueError(f"{path}: unknown scanline filter {int(ftype.max())}")
    rows = (_unfilter_wavefront(filt, ftype) if ftype.any() else filt).reshape(h, row_bytes)
    if depth < 8:
        return _unpack_bits(rows, w, depth)[:, :, None]
    if depth == 16:                    # big-endian samples
        rows = (rows[:, 0::2].astype(np.uint16) << 8) | rows[:, 1::2]
    return rows.reshape(h, w, channels)


def read_png(path: str, palette: bool = False):
    """(H, W, channels) pixels of a PNG file of any bit depth and colour
    type, interlaced (Adam7) or not: ``np.asarray(Image.open(path))``
    with a channel axis.  That is bool for 1-bit grey (PIL's mode
    ``"1"``); uint8 samples scaled to 0..255 for 2- and 4-bit grey
    (``"L"``), uint16 for 16-bit grey (``"I;16"``); the indices of a
    palette image (``"P"``); uint8 for 8-bit grey + alpha, RGB and RGBA,
    and the high byte of each 16-bit sample, 16-bit grey + alpha being
    widened to RGBA (grey replicated) as PIL opens it.  A ``tRNS`` chunk
    is ignored, as ``np.asarray`` ignores it.  With ``palette=True``,
    ``(pixels, table)``: the PLTE entries as (n, 3) uint8 for a palette
    image, else None.  A file that PIL refuses (a bit depth its colour
    type forbids, a filter method other than 0) raises ``ValueError``
    naming it."""
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
    w, h, depth, color, _, filter_method, interlace = header
    if depth not in _PNG_DEPTHS.get(color, ()):
        raise ValueError(f"{path}: PNG with bit depth {depth} and colour type {color} "
                         f"({_PNG_TYPES.get(color, 'unknown')}), a combination PNG forbids")
    if filter_method:
        raise ValueError(f"{path}: unknown PNG filter method {filter_method}")
    if color == 3 and table is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    channels = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = np.zeros((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    used = 0
    for r0, c0, dr, dc in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        ph, pw = max(0, -(-(h - r0) // dr)), max(0, -(-(w - c0) // dc))
        if not ph or not pw:           # an empty pass has no scanlines
            continue
        n = ph * (-(-pw * channels * depth // 8) + 1)
        if used + n <= raw.size:
            px[r0::dr, c0::dc] = _png_pass(raw[used:used + n], ph, pw, depth, channels, path)
        used += n
    if raw.size != used:
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {used}")
    if color == 0 and depth < 8:       # PIL's modes "1" and "L" (L;2, L;4 scaled)
        px = px.astype(bool) if depth == 1 else px * np.uint8(255 // ((1 << depth) - 1))
    elif depth == 16 and color:        # RGB;16B, RGBA;16B, LA;16B → RGBA
        px = (px >> 8).astype(np.uint8)
        if color == 4:
            px = px[:, :, [0, 0, 0, 1]]
    return (px, table if color == 3 else None) if palette else px


def _bmp_rle(data: bytes, pos: int, w: int, h: int, rle4: bool, path: str) -> np.ndarray:
    """(h, w) palette indices, the file's first row first, of an RLE8 or
    RLE4 stream at ``pos``.  As Pillow's ``BmpRleDecoder``, the indices
    run on through the rows: an encoded run is cut at the row's end, end
    of line fills the row with index 0 and a delta fills what it skips.
    Unlike it, a delta's offsets are the two bytes after its escape, an
    absolute run of n 4-bit pixels reads its ceil(n / 2) bytes, and an
    end of bitmap before the last row fills the rest with index 0 (the
    BMP format's meaning: Pillow reads four bytes for a delta, n // 2
    for the run, and refuses the early end)."""
    n, out, x = w * h, bytearray(), 0
    ended = False
    while len(out) < n and pos + 2 <= len(data):
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:                      # encoded run
            count = min(count, max(0, w - x))
            pair = bytes((byte >> 4, byte & 15)) if rle4 else bytes((byte, byte))
            out += (pair * (count // 2 + 1))[:count]
            x += count
        elif byte == 0:                # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:                # end of bitmap
            ended = True
            break
        elif byte == 2:                # delta: right, then rows on
            if pos + 2 > len(data):
                break
            out += bytes(data[pos] + data[pos + 1] * w)
            pos += 2
            x = len(out) % w
        else:                          # absolute run of `byte` pixels, 16-bit aligned
            size = (byte + 1) // 2 if rle4 else byte
            run = data[pos:pos + size]
            if len(run) < size:
                break
            if rle4:
                run = _unpack_bits(np.frombuffer(run, np.uint8)[None], byte, 4)[0].tobytes()
            out += run
            pos += size + size % 2
            x += byte
    if len(out) < n and not ended:
        raise ValueError(f"{path}: the RLE stream ends after {len(out)} of {n} pixels")
    out += bytes(max(0, n - len(out)))
    return np.frombuffer(bytes(out[:n]), np.uint8).reshape(h, w)


# BI_BITFIELDS masks that PIL reads (BmpImagePlugin's SUPPORTED): 16-bit
# (red, green, blue) → PIL's raw mode; 32-bit (red, green, blue, alpha)
# → the byte of each channel in a little-endian pixel (alpha present:
# PIL's mode RGBA)
_BMP_MASKS16 = {(0xF800, 0x7E0, 0x1F): "BGR;16", (0x7C00, 0x3E0, 0x1F): "BGR;15"}
_BMP_MASKS32 = {(0xFF0000, 0xFF00, 0xFF, 0): (2, 1, 0),
                (0xFF000000, 0xFF0000, 0xFF00, 0): (3, 2, 1),
                (0xFF000000, 0xFF00, 0xFF, 0): (3, 1, 0),
                (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1, 0),
                (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2, 3),
                (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0, 3),
                (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0, 2),
                (0, 0, 0, 0): (2, 1, 0, 3)}


def _bgr16(v: np.ndarray, layout: str) -> np.ndarray:
    """(h, w, 3) uint8 of 16-bit BMP pixels, PIL's ``BGR;15`` (5-5-5,
    the top bit ignored) or ``BGR;16`` (5-6-5): each field v of n bits
    scaled as v·255 // (2^n − 1)."""
    if layout == "BGR;15":
        fields = ((v >> 10) & 31, 31), ((v >> 5) & 31, 31), (v & 31, 31)
    else:
        fields = ((v >> 11) & 31, 31), ((v >> 5) & 63, 63), (v & 31, 31)
    return np.stack([(f.astype(np.uint32) * 255 // m).astype(np.uint8) for f, m in fields], -1)


def read_bmp(path: str, palette: bool = False):
    """(H, W, channels) pixels of a BMP file, ``np.asarray(Image.open(path))``
    with a channel axis, as Pillow's ``BmpImagePlugin`` reads it: the
    header sizes 12 (3-byte palette entries), 40, 52, 56, 64, 108 and
    124; 1-, 4- and 8-bit palettes (the indices, PIL's mode ``"P"``),
    uncompressed or RLE8/RLE4 (see ``_bmp_rle``); 16-bit 5-5-5 and
    24-bit, and 32-bit with its fourth byte ignored (uint8 RGB); the
    ``BI_BITFIELDS`` masks PIL takes (``_BMP_MASKS16``, 24-bit BGR,
    ``_BMP_MASKS32``: RGBA where they name an alpha); bottom-up rows, or
    top-down for a negative height.

    A palette whose entries are all grey (i, i, i) at index i gives the
    indices as grey levels (uint8, PIL's mode ``"L"``), and a two-entry
    black and white palette gives bool (``"1"``), as PIL reads them.
    Unlike PIL, a 4-bit file of a grey palette and a 4-bit, 8-bit or
    RLE-coded file of a two-entry one are unpacked by their bit depth:
    PIL reads their bytes as 8-bit grey levels or as bits, or refuses
    them under RLE.

    With ``palette=True``, ``(pixels, table)``: the (n, 3) uint8 RGB
    entries of a ``"P"`` image, else None.  What PIL refuses (another
    header size, bit depth, compression or bitfields layout; a palette
    of more than 65,536 entries) and a truncated file raise
    ``ValueError`` naming the file."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] != _BMP_SIGNATURE or len(data) < 18:
        raise ValueError(f"{path}: not a BMP file")
    offset, size = struct.unpack_from("<II", data, 10)
    info = data[18:14 + size]
    if len(info) != size - 4:
        raise ValueError(f"{path}: BMP header of {size} bytes, the file is truncated")
    direction, masks, start = -1, None, 14 + size     # start: where PIL stops reading
    if size == 12:
        w, h, _, bits = struct.unpack_from("<HHHH", info)
        compression, colors, entry = 0, 0, 3
    elif size in (40, 52, 56, 64, 108, 124):
        w, h, _, bits, compression, _, _, _, colors = struct.unpack_from("<IIHHIIIII", info)
        if info[7] == 0xFF:            # a negative height: rows top-down
            h, direction = 2 ** 32 - h, 1
        entry = 4
        if compression == 3:           # 40-byte headers: the masks follow the header
            words = info[36:52] if len(info) >= 48 else data[14 + size:26 + size]
            masks = struct.unpack(f"<{len(words) // 4}I", words[:len(words) // 4 * 4])
            masks = (masks + (0,))[:4] if len(info) < 52 else masks
            start += 0 if len(info) >= 48 else 12
    else:
        raise ValueError(f"{path}: unsupported BMP header size {size}")
    colors = colors or 1 << bits
    if offset == 14 + size and bits <= 8:   # PIL: an offset at the palette skips it
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{path}: unsupported BMP bit depth {bits}")
    layout = {16: "BGR;15", 32: (2, 1, 0)}.get(bits)
    if compression == 3:
        if bits == 32 and masks in _BMP_MASKS32:
            layout = _BMP_MASKS32[masks]
        elif bits == 16 and masks[:3] in _BMP_MASKS16:
            layout = _BMP_MASKS16[masks[:3]]
        elif not (bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF)):
            raise ValueError(f"{path}: unsupported BMP bitfields layout {bits} bits, masks "
                             + ", ".join(f"{m:#x}" for m in masks))
    elif compression in (1, 2) and bits > 8 or compression not in (0, 1, 2, 3):
        raise ValueError(f"{path}: unsupported BMP compression {compression} at {bits} bits")
    grey, table = False, None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"{path}: unsupported BMP palette size {colors}")
        raw_pal = data[start:start + entry * colors]
        start += entry * colors
        grey = all(raw_pal[i * entry:i * entry + 3] == bytes((v & 255,)) * 3
                   for i, v in enumerate((0, 255) if colors == 2 else range(colors)))
        if not grey:
            n = len(raw_pal) // entry
            table = np.frombuffer(raw_pal[:n * entry], np.uint8).reshape(n, entry)[:, 2::-1]
    offset = offset or start
    if compression in (1, 2):
        px = _bmp_rle(data, offset, w, h, compression == 2, path)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if offset + h * stride > len(data):
            raise ValueError(f"{path}: truncated BMP: {len(data) - offset} bytes of pixel "
                             f"data, expected {h * stride}")
        rows = np.frombuffer(data, np.uint8, h * stride, offset).reshape(h, stride)
        if bits < 8:
            px = _unpack_bits(rows, w, bits)
        elif bits == 8:
            px = rows[:, :w]
        elif bits == 16:
            px = _bgr16(rows[:, :2 * w].view("<u2"), layout)
        elif bits == 24:
            px = rows[:, :3 * w].reshape(h, w, 3)[:, :, ::-1]
        else:
            px = rows[:, :4 * w].reshape(h, w, 4)[:, :, list(layout)]
    if direction == -1:
        px = px[::-1]
    px = np.ascontiguousarray(px.reshape(h, w, -1))
    if grey and colors == 2:           # PIL's mode "1"
        px = px == 1
    return (px, table) if palette else px


def read_jpeg(path: str) -> np.ndarray:
    """(H, W, 1) grey or (H, W, 3) RGB uint8 pixels of a JPEG file,
    ``np.asarray(Image.open(path))`` bit for bit (``native.decode_jpeg``)."""
    with open(path, "rb") as fh:
        return native.decode_jpeg(fh.read(), path)


def to_rgb(pixels: np.ndarray, palette=None) -> np.ndarray:
    """PIL's ``convert("RGB")`` of ``read_png``'s, ``read_bmp``'s or
    ``read_jpeg``'s (H, W, channels) pixels: (H, W, 3) uint8.
    ``palette`` (n, 3), where given, maps the indices (those past its
    end, or past 256 entries, to black); bool is 0 or 255, uint16 grey
    clipped to 255; grey is replicated and alpha dropped."""
    if palette is not None:
        lut = np.zeros((256, 3), np.uint8)
        lut[:min(len(palette), 256)] = palette[:256]
        return lut[pixels[:, :, 0]]
    if pixels.dtype == bool:
        pixels = pixels.astype(np.uint8) * np.uint8(255)
    elif pixels.dtype == np.uint16:
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
    """(H, W, 3) uint8 pixels of a ``.npy``, JPEG, PNG or BMP image file,
    the last three told apart by their leading bytes as
    ``PIL.Image.open`` tells them."""
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
    if head.startswith(_BMP_SIGNATURE):
        return to_rgb(*read_bmp(path, palette=True))
    raise ValueError(f"{path}: the port reads .npy, JPEG, PNG and BMP images only (WebP: "
                     "ROADMAP.md Queue 1 item 11); convert it to an (H, W, 3) uint8 .npy, "
                     "e.g. np.save(out, np.asarray(Image.open(path).convert('RGB')))")


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
