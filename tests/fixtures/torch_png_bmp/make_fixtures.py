"""PNG and BMP encoders of the tests (numpy and zlib only), and the
fixtures of ``tests/test_torch_png_bmp.py`` and ``chip_smoke.py``
(phase 20) that they write, with their ``manifest.json``:

    python tests/fixtures/torch_png_bmp/make_fixtures.py

``encode_png`` writes every bit depth and colour type that PNG allows,
interlaced (Adam7) or not, with scanline filter (row + pass) % 5 on
each row of a pass, so that every filter type meets every pass; the
padding bits of a sub-byte row are set to one.  ``encode_bmp`` writes
every BMP header size PIL reads (12 to 124 bytes), 1- to 32-bit
pixels, uncompressed, ``BI_BITFIELDS``, RLE8 and RLE4, bottom-up or
top-down, with junk in the row padding.

The manifest maps each fixture to PIL's reading of it: its ``mode``,
and the ``dtype``, ``shape`` and ``digest`` of ``np.asarray(Image.open(f))``
(``raw``) and of its ``convert("RGB")`` (``rgb``), the oracle of a host
without PIL.  The files are committed; run this again only to change
the set (the tests hold the manifest to PIL's reading of the committed
files, not to a fresh run).  Only ``main`` imports PIL.
"""

import hashlib
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}   # channels → PNG colour type
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7: (first row, first column, row step, column step) of each pass
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
         (0, 1, 2, 2), (1, 0, 2, 1))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def pack_bits(values: np.ndarray, depth: int, fill: int = 1) -> np.ndarray:
    """(h, ceil(w·depth / 8)) bytes of (h, w) samples of ``depth`` < 8
    bits, most significant bits first; the padding samples are
    ``fill`` (all ones by default)."""
    h, w = values.shape
    per = 8 // depth
    pad = np.full((h, -w % per), fill * ((1 << depth) - 1), np.uint8)
    v = np.concatenate([values.astype(np.uint8), pad], 1).reshape(h, -1, per)
    return (v << np.arange(8 - depth, -1, -depth, dtype=np.uint8)).sum(-1, dtype=np.uint8)


def be16(values: np.ndarray) -> np.ndarray:
    """(h, w, 2c) big-endian bytes of (h, w, c) 16-bit samples."""
    v = values.astype(np.uint16)
    return np.stack([v >> 8, v & 255], -1).reshape(*v.shape[:2], -1).astype(np.uint8)


def _scanlines(px: np.ndarray, depth: int, first: int) -> bytes:
    """Filtered scanlines of one image or pass: (h, w, bytes per pixel)
    data, or (h, w, 1) samples below 8 bits; row r gets filter type
    (first + r) % 5."""
    if depth < 8:
        px = pack_bits(px[:, :, 0], depth)[:, :, None]
    h, w, ch = px.shape
    px = px.astype(np.int32)
    rows = []
    for r in range(h):
        cur = px[r]
        up = px[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros((1, ch), np.int32), cur[:-1]])
        upleft = np.concatenate([np.zeros((1, ch), np.int32), up[:-1]])
        ftype = (first + r) % 5
        pred = [0, left, up, (left + up) >> 1, _paeth(left, up, upleft)][ftype]
        rows.append(bytes([ftype]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
    return b"".join(rows)


def png_bytes(pixels: np.ndarray, interlace: int = 0, depth: int = 8,
              color=None, plte=None, trns=None) -> bytes:
    """A PNG of (H, W, C) 8-bit pixels; with ``color`` given, of (H, W,
    bytes per pixel) data at 8 or 16 bits (16-bit samples big-endian,
    see ``be16``) or of (H, W, 1) samples below 8 bits.  ``interlace=1``
    writes the seven Adam7 passes; row r of pass k carries scanline
    filter (r + k) % 5.  ``plte`` (n, 3) is written as the PLTE chunk,
    ``trns`` (bytes) as the tRNS chunk."""
    h, w, ch = pixels.shape
    color = COLOR_TYPE[ch] if color is None else color
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        body += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    data = b"".join(_scanlines(pixels[r0::dr, c0::dc], depth, k)
                    for k, (r0, c0, dr, dc) in enumerate(ADAM7 if interlace else ((0, 0, 1, 1),))
                    if pixels[r0::dr, c0::dc].size)
    return (b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IDAT", zlib.compress(data, 6))
            + _chunk(b"IEND", b""))


def encode_png(path, pixels: np.ndarray, **kw) -> None:
    """Write ``png_bytes(pixels, **kw)`` to ``path``."""
    with open(path, "wb") as f:
        f.write(png_bytes(pixels, **kw))


def png_samples(rng, h: int, w: int, depth: int, color: int):
    """(pixels for ``encode_png``, plte): random samples over the whole
    range of ``depth`` (palette indices past the end of a table one entry
    short of 2^depth, or of 200 entries at 8 bits, included)."""
    ch = CHANNELS[color]
    top = (1 << depth) - 1
    vals = rng.randint(0, top + 1, (h, w, ch)).astype(np.uint16 if depth == 16 else np.uint8)
    plte = None
    if color == 3:
        plte = rng.randint(0, 256, (min(top, 200), 3)).astype(np.uint8)
    return (be16(vals) if depth == 16 else vals), plte


# -- BMP ----------------------------------------------------------------------

def rle_rows(idx: np.ndarray, rle4: bool, odd_runs: bool = False) -> bytes:
    """An RLE8 or RLE4 stream of (h, w) indices in file order: encoded
    runs for repeats of three or more (of a pair of indices, alternating,
    for RLE4), absolute runs (at least 3 pixels; of an even count for
    RLE4 unless ``odd_runs``) for the rest, end of line after each row
    but the last, end of bitmap after it."""
    out = bytearray()
    for r, row in enumerate(idx.tolist()):
        i, lit, w = 0, [], len(row)

        def flush(lit):
            while lit:
                n = min(len(lit), 254)
                if rle4 and not odd_runs and n % 2:
                    n -= 1
                if n >= 3:
                    part, lit[:] = lit[:n], lit[n:]
                    data = (bytes(((part + [0])[j] << 4 | (part + [0])[j + 1]
                                   for j in range(0, len(part), 2))) if rle4 else bytes(part))
                    out.extend([0, n])
                    out.extend(data + b"\0" * (len(data) % 2))
                else:
                    out.extend([1, lit.pop(0) << 4 if rle4 else lit.pop(0)])

        while i < w:
            n = 1
            while (i + n < w and n < 255
                   and row[i + n] == (row[i + (n % 2)] if rle4 else row[i])):
                n += 1
            if n >= 3:
                flush(lit)
                out.extend([n, (row[i] << 4 | (row[i + 1] if n > 1 else 0)) if rle4 else row[i]])
                i += n
            else:
                lit.append(row[i])
                i += 1
        flush(lit)
        out.extend([0, 1] if r == len(idx) - 1 else [0, 0])
    return bytes(out)


def encode_bmp(pixels: np.ndarray, bits: int, header: int = 40, compression: int = 0,
               masks=None, palette=None, colors=None, top_down: bool = False,
               rle_stream: bytes = None) -> bytes:
    """The bytes of a BMP file.  ``pixels``: (h, w) palette indices at 1,
    4 and 8 bits; (h, w) 16- or 32-bit words; (h, w, 3) RGB at 24 bits.
    ``palette`` (n, 3) RGB (3-byte entries under a 12-byte header, else
    4); ``colors`` the header's count (default n; 0 means 2^bits).
    ``compression`` 0 (rows padded to 4 bytes with junk), 1 or 2 (RLE8,
    RLE4: ``rle_rows`` of the pixels, or ``rle_stream``) or 3
    (``masks``: r, g, b and, from the 56-byte header on, a; after a
    40-byte header, r, g, b follow it)."""
    h, w = pixels.shape[:2]
    rows = pixels if top_down else pixels[::-1]
    if compression in (1, 2):
        data = rle_stream if rle_stream is not None else rle_rows(rows, compression == 2)
    else:
        if bits < 8:
            body = pack_bits(rows, bits)
        elif bits == 8:
            body = rows.astype(np.uint8)
        elif bits == 16:
            body = rows.astype("<u2").view(np.uint8).reshape(h, -1)
        elif bits == 24:
            body = rows[:, :, ::-1].astype(np.uint8).reshape(h, -1)
        else:
            body = rows.astype("<u4").view(np.uint8).reshape(h, -1)
        stride = ((w * bits + 31) >> 3) & ~3
        pad = np.full((h, stride - body.shape[1]), 0xAB, np.uint8)
        data = np.concatenate([body, pad], 1).tobytes()
    entry = 3 if header == 12 else 4
    pal = b""
    if palette is not None:
        pal = b"".join(bytes((b, g, r)) + b"\0" * (entry - 3)
                       for r, g, b in np.asarray(palette).tolist())
    n_colors = len(pal) // entry if colors is None else colors
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(data), 2835, 2835, n_colors, 0)
        extra = bytearray(header - 40)
        if compression == 3:
            words = struct.pack("<4I", *(tuple(masks) + (0,) * (4 - len(masks))))
            if header == 40:
                info += words[:12]
            else:
                extra[:min(header - 40, 16)] = words[:min(header - 40, 16)]
        info += bytes(extra)
    offset = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
            + info + pal + data)


# -- the fixtures -------------------------------------------------------------

def content(h: int, w: int, seed: int) -> np.ndarray:
    """(h, w, 3) uint8: gradients, filled blocks of random colours and
    mild noise (PASCAL-like frames that compress)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([rng.uniform(40, 200) + rng.uniform(-60, 60) * x / max(w - 1, 1)
                    + rng.uniform(-60, 60) * y / max(h - 1, 1) for _ in range(3)], -1)
    for _ in range(6):
        cy, cx = rng.uniform(0, 1, 2) * [h, w]
        ry, rx = rng.uniform(0.05, 0.3, 2) * [h, w]
        img[(np.abs(y - cy) < ry) & (np.abs(x - cx) < rx)] = rng.uniform(0, 255, 3)
    return np.clip(np.rint(img + rng.normal(0, 3, img.shape)), 0, 255).astype(np.uint8)


def labels(h: int, w: int, seed: int, n: int = 21) -> np.ndarray:
    """(h, w) uint8 label-like indices: rectangles of classes 1..n-1 on
    0, with a 255 (void) outline, as PASCAL's SegmentationClass."""
    rng = np.random.RandomState(seed)
    out = np.zeros((h, w), np.uint8)
    for _ in range(5):
        y0, x0 = rng.randint(0, h), rng.randint(0, w)
        y1, x1 = y0 + rng.randint(h // 8 + 1, h // 2 + 2), x0 + rng.randint(w // 8 + 1, w // 2 + 2)
        out[y0:y1, x0:x1] = 255
        out[y0 + 2:y1 - 2, x0 + 2:x1 - 2] = rng.randint(1, n)
    return out


def _png(**kw):
    """A fixture maker: ``png_bytes`` of 8-bit RGB content, of random
    samples (grey below 16 bits, palette), or of content scaled to the
    depth with random alpha."""
    def make(seed, kw=kw):
        kw = dict(kw)
        h, w = kw.pop("hw", (13, 19))
        depth, color = kw.get("depth", 8), kw.get("color")
        rng = np.random.RandomState(seed)
        if color is None:
            px = content(h, w, seed)
        elif color == 3 or (color == 0 and depth < 16):
            px, plte = png_samples(rng, h, w, depth, color)
            if color == 3:
                kw["plte"] = plte
        else:
            top = (1 << depth) - 1
            base = content(h, w, seed).astype(np.uint32) * top // 255
            if color in (0, 4):
                base = base[:, :, :1]
            if color in (4, 6):
                base = np.concatenate([base, rng.randint(0, top + 1, (h, w, 1))], -1)
            px = be16(base) if depth == 16 else base.astype(np.uint8)
        return png_bytes(px, **kw)
    return make


def _bmp(bits, **kw):
    """A fixture maker: ``encode_bmp`` of random indices (label-like at 8
    bits and under RLE) with a random palette, of random 16- and 32-bit
    words, or of 24-bit content."""
    def make(seed, kw=kw):
        kw = dict(kw)
        h, w = kw.pop("hw", (13, 19))
        rng = np.random.RandomState(seed)
        if bits <= 8:
            if bits == 8 or kw.get("compression") in (1, 2):
                lab = labels(h, w, seed, min(1 << bits, 21)) & ((1 << bits) - 1)
            else:
                lab = rng.randint(0, 1 << bits, (h, w))
            pal = kw.pop("palette", None)
            if pal is None:
                pal = rng.randint(0, 256, ((1 << bits) if bits < 8 else 256, 3))
            return encode_bmp(lab, bits, palette=pal, **kw)
        rgb = content(h, w, seed)
        if bits == 24:
            return encode_bmp(rgb, 24, **kw)
        if bits == 16:
            words = rng.randint(0, 1 << 16, (h, w))
            return encode_bmp(words, 16, **kw)
        words = rng.randint(0, 1 << 32, (h, w), dtype=np.uint64)
        return encode_bmp(words, 32, **kw)
    return make


FIXTURES = {
    "grey1.png": _png(depth=1, color=0),
    "grey2_adam7.png": _png(depth=2, color=0, interlace=1),
    "grey4.png": _png(depth=4, color=0, hw=(19, 13)),
    "grey16_adam7.png": _png(depth=16, color=0, interlace=1),
    "palette1_adam7.png": _png(depth=1, color=3, interlace=1),
    "palette2.png": _png(depth=2, color=3),
    "palette4_adam7.png": _png(depth=4, color=3, interlace=1, hw=(19, 13)),
    "rgb8_adam7.png": _png(interlace=1),
    "rgb16_adam7.png": _png(depth=16, color=2, interlace=1),
    "grey_alpha16.png": _png(depth=16, color=4),
    "rgba16_adam7.png": _png(depth=16, color=6, interlace=1),
    "core24.bmp": _bmp(24, header=12),
    "core8.bmp": _bmp(8, header=12),
    "p1.bmp": _bmp(1),
    "p4_top_down.bmp": _bmp(4, top_down=True, header=108),
    "p8_colors0.bmp": _bmp(8, colors=0, header=124),
    "rle8.bmp": _bmp(8, compression=1),
    "rle4.bmp": _bmp(4, compression=2, hw=(19, 13)),
    "bgr555.bmp": _bmp(16),
    "bgr565_bitfields.bmp": _bmp(16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
    "bgrx32_os2.bmp": _bmp(32, header=64),
    "bgra32_v5_bitfields.bmp": _bmp(32, header=124, compression=3,
                                    masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "grey8_bmp.bmp": _bmp(8, palette=[(i, i, i) for i in range(256)], header=56),
    "bw1_bmp.bmp": _bmp(1, palette=[(0, 0, 0), (255, 255, 255)], top_down=True),
}

# PASCAL-sized files, written at run time (phase 20 times their reads)
PASCAL_HW = (375, 500)


def pascal_files(root: str):
    """An interlaced 8-bit RGB PNG, an RLE8 BMP of PASCAL-like labels and
    a 24-bit BMP, each 500x375, under ``root``: [(path, the (h, w, c)
    pixels ``read_png``/``read_bmp`` must give)]."""
    rgb, idx = content(*PASCAL_HW, 7), labels(*PASCAL_HW, 7)
    out = [(os.path.join(root, "pascal_adam7.png"), rgb),
           (os.path.join(root, "pascal_rle8.bmp"), idx[:, :, None]),
           (os.path.join(root, "pascal_24.bmp"), rgb)]
    encode_png(out[0][0], rgb, interlace=1)
    palette = np.random.RandomState(7).randint(0, 256, (256, 3))
    with open(out[1][0], "wb") as f:
        f.write(encode_bmp(idx, 8, compression=1, palette=palette))
    with open(out[2][0], "wb") as f:
        f.write(encode_bmp(rgb, 24))
    return out


def digest(a: np.ndarray) -> str:
    """SHA-256 of an array's bytes, a bool array's as uint8 0 and 1 (PIL's
    mode "1" arrays hold 255 for True)."""
    return hashlib.sha256((a.astype(np.uint8) if a.dtype == bool else a).tobytes()).hexdigest()


def entry(path) -> dict:
    """PIL's reading of ``path``: mode, and dtype, shape and ``digest`` of
    ``np.asarray`` of the image and of its ``convert("RGB")``."""
    from PIL import Image

    with Image.open(path) as im:
        mode, raw, rgb = im.mode, np.asarray(im), np.asarray(im.convert("RGB"))
    return {"mode": mode,
            **{k: {"dtype": str(a.dtype), "shape": list(a.shape), "sha256": digest(a)}
               for k, a in (("raw", raw), ("rgb", rgb))}}


def main() -> None:
    manifest = {}
    for seed, name in enumerate(sorted(FIXTURES)):
        data = FIXTURES[name](seed)
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        manifest[name] = entry(path)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
