"""PyTorch port, the PNG and BMP readers of ``data/image_folder.py``
(``read_png``, ``read_bmp``, ``to_rgb``, ``load_rgb``) against PIL, whose
pixels the JAX package's datasets and preparation commands come from,
and the port's callers of them against the JAX package's functions.

Every comparison is exact: ``np.asarray(Image.open(p))`` in dtype,
shape and values, and ``convert("RGB")``.  The files are written by the
encoders of ``tests/fixtures/torch_png_bmp/make_fixtures.py``: every PNG
bit depth and colour type, plain and Adam7-interlaced, at sizes that
leave passes empty and rows with padding bits, with filters 0-4 on the
rows of each pass; every BMP header size, bit depth, compression
(uncompressed, ``BI_BITFIELDS`` with each layout PIL takes, RLE8, RLE4)
and row order.  Where PIL misreads a file (a 4-bit grey palette, a
two-entry black and white palette at 4 or 8 bits or under RLE, an RLE
delta, an odd RLE4 absolute run, an early end of bitmap) the port gives
the file's meaning and a test pins PIL's differing reading.  The
committed fixtures' manifest, the oracle of a host without PIL, equals
PIL's reading of them.
"""

import importlib.util
import json
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from adlm_tpu.data import img_aug as jax_img_aug
from adlm_tpu.data import preprocess as jpre
from adlm_tpu.data.image_folder import ImageFolderDataset as JaxImageFolder

from adlm_tpu_torch.data import img_aug
from adlm_tpu_torch.data import preprocess as tpre
from adlm_tpu_torch.data.image_folder import (
    ImageFolderDataset,
    load_rgb,
    read_bmp,
    read_png,
    to_rgb,
)

from test_torch_preprocess import assert_same_tree

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_png_bmp")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
_spec = importlib.util.spec_from_file_location("png_bmp_fixtures",
                                               os.path.join(FIXTURES, "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)   # the encoders, digest
_spec.loader.exec_module(mf)

SIZES = ((1, 1), (3, 5), (9, 17))
PNG_COMBOS = ((0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (3, 1), (3, 2), (3, 4), (3, 8),
              (2, 8), (2, 16), (4, 8), (4, 16), (6, 8), (6, 16))   # (colour type, depth)


def _pil(path):
    """PIL's mode, ``np.asarray`` and ``convert("RGB")`` of ``path``."""
    with Image.open(path) as im:
        return im.mode, np.asarray(im), np.asarray(im.convert("RGB"))


def assert_as_pil(path, reader) -> str:
    """``reader``'s pixels (with a channel axis), ``to_rgb`` of them and
    ``load_rgb`` equal PIL's; returns PIL's mode."""
    mode, raw, rgb = _pil(path)
    got, table = reader(str(path), palette=True)
    assert got.dtype == raw.dtype, (got.dtype, raw.dtype)
    assert got.shape == (raw.shape + (1,) if raw.ndim == 2 else raw.shape)
    np.testing.assert_array_equal(got.reshape(raw.shape), raw)
    assert (table is not None) == (mode == "P")
    for out in (to_rgb(got, table), load_rgb(str(path))):
        assert out.dtype == np.uint8 and out.shape == rgb.shape
        np.testing.assert_array_equal(out, rgb)
    return mode


def _write(path, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


# -- PNG ----------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("color,depth", PNG_COMBOS)
def test_png_equals_pil(tmp_path, color, depth, interlace, size):
    rng = np.random.RandomState(color * 100 + depth + 7 * interlace + size[1])
    px, plte = mf.png_samples(rng, *size, depth, color)
    path = tmp_path / "x.png"
    mf.encode_png(path, px, interlace=interlace, depth=depth, color=color, plte=plte)
    mode = assert_as_pil(path, read_png)
    want = {(0, 1): "1", (0, 16): "I;16", (4, 16): "RGBA"}.get(
        (color, depth), {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}[color])
    assert mode == want


def test_png_sub_byte_samples_are_scaled_as_pil_scales_them(tmp_path):
    """2-bit grey 0..3 reads 0, 85, 170, 255; 4-bit 0..15 reads 17 i;
    1-bit is bool."""
    for depth, scale in ((2, 85), (4, 17)):
        v = np.arange(1 << depth, dtype=np.uint8).reshape(1, -1, 1)
        mf.encode_png(tmp_path / "g.png", v, depth=depth, color=0, interlace=1)
        assert read_png(str(tmp_path / "g.png"))[0, :, 0].tolist() == (v[0, :, 0] * scale).tolist()
    mf.encode_png(tmp_path / "b.png", np.array([[[1], [0], [1]]], np.uint8), depth=1, color=0)
    assert read_png(str(tmp_path / "b.png"))[0, :, 0].tolist() == [True, False, True]


def test_adam7_passes_carry_every_filter_and_skip_empty_ones(tmp_path):
    """A 9x17 image has all seven passes, whose rows carry all five
    filter types.  A 1x1 image has pass 1 alone, a 3x5 one all but pass
    3 (which starts at row 4)."""
    def pass_sizes(h, w):
        return [(max(0, -(-(h - r0) // dr)), max(0, -(-(w - c0) // dc)))
                for r0, c0, dr, dc in mf.ADAM7]

    assert [p for p in pass_sizes(1, 1) if 0 not in p] == [(1, 1)]
    assert [i + 1 for i, p in enumerate(pass_sizes(3, 5)) if 0 not in p] == [1, 2, 4, 5, 6, 7]
    px = np.random.RandomState(0).randint(0, 256, (9, 17, 3)).astype(np.uint8)
    mf.encode_png(tmp_path / "x.png", px, interlace=1)
    data = (tmp_path / "x.png").read_bytes()
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8])
    pos, seen = 0, set()
    for ph, pw in pass_sizes(9, 17):
        for _ in range(ph):
            seen.add(raw[pos])
            pos += 1 + 3 * pw
    assert pos == len(raw) and seen == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(read_png(str(tmp_path / "x.png")), px)


@pytest.mark.parametrize("color,depth,trns", [
    (0, 1, b"\0\1"), (0, 8, b"\0\7"), (0, 16, b"\1\2"), (2, 8, b"\0\1\0\2\0\3"),
    (3, 4, b"\0\x80\xff"), (3, 8, b"\xff\0")])
def test_png_trns_is_ignored_as_pil_ignores_it(tmp_path, color, depth, trns):
    px, plte = mf.png_samples(np.random.RandomState(depth), 5, 7, depth, color)
    mf.encode_png(tmp_path / "t.png", px, depth=depth, color=color, plte=plte, trns=trns)
    assert_as_pil(tmp_path / "t.png", read_png)


@pytest.mark.parametrize("color,depth,filter_method", [
    (3, 16, 0), (2, 4, 0), (4, 2, 0), (6, 1, 0), (0, 3, 0), (5, 8, 0), (2, 8, 1)])
def test_png_that_pil_refuses_raises_naming_the_file(tmp_path, color, depth, filter_method):
    body = struct.pack(">IIBBBBB", 3, 2, depth, color, 0, filter_method, 0)
    path = _write(tmp_path / "bad.png", b"\x89PNG\r\n\x1a\n" + mf._chunk(b"IHDR", body)
                  + mf._chunk(b"IDAT", zlib.compress(bytes(64))) + mf._chunk(b"IEND", b""))
    with pytest.raises(Exception):
        with Image.open(path) as im:
            im.load()
    with pytest.raises(ValueError, match="bad.png"):
        read_png(path)
    with pytest.raises(ValueError, match="bad.png"):
        load_rgb(path)


# -- BMP ----------------------------------------------------------------------

def _bmp_pixels(rng, h, w, bits):
    if bits <= 8:
        return rng.randint(0, 1 << bits, (h, w))
    if bits == 24:
        return rng.randint(0, 256, (h, w, 3))
    return rng.randint(0, 1 << bits, (h, w), dtype=np.uint64)


def _raw_cases():
    out = []
    for header in (12, 40, 52, 56, 64, 108, 124):
        for bits in (1, 4, 8, 16, 24, 32):
            for top_down in ((False,) if header == 12 else (False, True)):
                out.append((header, bits, top_down, SIZES[len(out) % 3], len(out) % 3))
    return out


@pytest.mark.parametrize("header,bits,top_down,size,palette_kind", _raw_cases())
def test_bmp_equals_pil(tmp_path, header, bits, top_down, size, palette_kind):
    """Every header size, bit depth and row order; palettes full (with
    their count, or a count of 0 meaning 2^bits) or short (indices past
    the end are black, and PIL's table runs into the pixel data)."""
    rng = np.random.RandomState(header + bits + size[0])
    kw = {}
    if bits <= 8:
        n = 1 << bits
        if palette_kind == 2:
            n = max(1, n * 3 // 4)
        kw = dict(palette=rng.randint(0, 256, (n, 3)), colors=0 if palette_kind == 1 else None)
    data = mf.encode_bmp(_bmp_pixels(rng, *size, bits), bits, header=header, top_down=top_down,
                         **kw)
    mode = assert_as_pil(_write(tmp_path / "x.bmp", data), read_bmp)
    assert mode == ("P" if bits <= 8 else "RGB")


BITFIELDS = [(16, (0xF800, 0x7E0, 0x1F)), (16, (0x7C00, 0x3E0, 0x1F)),
             (24, (0xFF0000, 0xFF00, 0xFF)),
             (32, (0xFF0000, 0xFF00, 0xFF, 0)), (32, (0xFF000000, 0xFF0000, 0xFF00, 0)),
             (32, (0xFF000000, 0xFF00, 0xFF, 0)), (32, (0, 0, 0, 0)),
             (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)), (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
             (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)), (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000))]


def _bitfield_cases():
    out = []
    for bits, masks in BITFIELDS:
        for header in (40, 52, 56, 108, 124):
            if len(masks) == 4 and masks[3] and header < 56:   # no alpha mask there
                continue
            out.append((bits, masks, header, len(out) % 2 == 1))
    return out


@pytest.mark.parametrize("bits,masks,header,top_down", _bitfield_cases(),
                         ids=lambda v: f"{v:#x}" if isinstance(v, int) and v > 64 else None)
def test_bmp_bitfields_equal_pil(tmp_path, bits, masks, header, top_down):
    rng = np.random.RandomState(bits + header)
    data = mf.encode_bmp(_bmp_pixels(rng, 7, 9, bits), bits, header=header, compression=3,
                         masks=masks, top_down=top_down)
    mode = assert_as_pil(_write(tmp_path / "x.bmp", data), read_bmp)
    alpha = bits == 32 and (masks[3] or not any(masks))
    assert mode == ("RGBA" if alpha else "RGB")


@pytest.mark.parametrize("size", [(1, 1), (3, 5), (9, 17), (13, 40)], ids=str)
@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
@pytest.mark.parametrize("compression,bits", [(1, 8), (2, 4)], ids=["rle8", "rle4"])
def test_bmp_rle_equals_pil(tmp_path, compression, bits, top_down, size):
    """Encoded runs (of pairs under RLE4), absolute runs (odd ones padded
    under RLE8), end of line and end of bitmap."""
    rng = np.random.RandomState(size[1] + bits)
    px = mf.labels(*size, size[0], 1 << bits) & ((1 << bits) - 1)
    px[::3] = rng.randint(0, 1 << bits, px[::3].shape)
    data = mf.encode_bmp(px, bits, compression=compression, top_down=top_down,
                         palette=rng.randint(0, 256, (1 << bits, 3)))
    assert_as_pil(_write(tmp_path / "x.bmp", data), read_bmp)
    np.testing.assert_array_equal(read_bmp(str(tmp_path / "x.bmp"))[:, :, 0], px)


@pytest.mark.parametrize("compression,bits,header", [(0, 8, 40), (1, 8, 40), (2, 4, 124),
                                                     (0, 8, 12)])
def test_bmp_grey_palettes_read_as_grey_levels(tmp_path, compression, bits, header):
    """A palette of (i, i, i) at index i: PIL's mode L, the index as its
    grey level; a 1-bit black and white palette: mode 1."""
    px = np.random.RandomState(bits).randint(0, 1 << bits, (5, 6))
    data = mf.encode_bmp(px, bits, compression=compression, header=header,
                         palette=[(i, i, i) for i in range(1 << bits)])
    assert assert_as_pil(_write(tmp_path / "g.bmp", data), read_bmp) == "L"
    data = mf.encode_bmp(px & 1, 1, palette=[(0, 0, 0), (255, 255, 255)], header=header)
    assert assert_as_pil(_write(tmp_path / "b.bmp", data), read_bmp) == "1"


# -- PIL's misreadings, pinned ------------------------------------------------

PAL4 = [(10, 20, 30), (40, 50, 60), (70, 80, 90), (1, 2, 3)]


def _pil_reading(path):
    """(mode, np.asarray) of PIL, or the exception it raises."""
    try:
        with Image.open(path) as im:
            return im.mode, np.asarray(im)
    except Exception as e:    # noqa: BLE001 - the pinned refusal
        return type(e).__name__, str(e)


def test_4_bit_grey_palette_decodes_by_its_bit_depth(tmp_path):
    """PIL drops the all-grey palette and reads the packed 4-bit bytes as
    8-bit grey levels."""
    row = np.array([[0, 1, 2, 15]])
    path = _write(tmp_path / "g4.bmp", mf.encode_bmp(row, 4, palette=[(i, i, i) for i in range(16)]))
    got = read_bmp(path)
    assert got.dtype == np.uint8 and got[:, :, 0].tolist() == [[0, 1, 2, 15]]
    np.testing.assert_array_equal(load_rgb(path), np.repeat(got, 3, 2))
    mode, pil = _pil_reading(path)
    assert mode == "L" and pil.tolist() == [[0x01, 0x2F, 0xAB, 0xAB]]   # the bytes, padding too


@pytest.mark.parametrize("bits,compression", [(4, 0), (8, 0), (8, 1), (4, 2)])
def test_two_entry_black_and_white_palette_decodes_by_the_palette(tmp_path, bits, compression):
    """PIL takes a black and white palette of two entries for mode 1 and
    reads the first bits of 4- and 8-bit rows as pixels (0x01 0x10 and
    0x11 0x00 at 4 bits, 0 1 1 0 and 1 1 0 0 at 8), or refuses the
    RLE-coded file."""
    px = np.array([[0, 1, 1, 0], [1, 1, 0, 0]])
    path = _write(tmp_path / "bw.bmp", mf.encode_bmp(px, bits, compression=compression,
                                                     palette=[(0, 0, 0), (255, 255, 255)]))
    got = read_bmp(path)
    assert got.dtype == bool and got[:, :, 0].tolist() == px.astype(bool).tolist()
    np.testing.assert_array_equal(load_rgb(path)[:, :, 0], px * 255)
    pil = _pil_reading(path)
    if compression:
        assert pil == ("ValueError", "unknown raw mode for given image mode")
    else:
        assert pil[0] == "1" and pil[1].tolist() == [[False] * 4, [False] * 3 + [bits == 4]]


def test_rle_delta_reads_its_two_offset_bytes(tmp_path):
    """Row 0: two 1s, a delta of one pixel right, a 2; row 1: four 3s.
    PIL reads four bytes for the delta and loses the rest."""
    stream = bytes([2, 1, 0, 2, 1, 0, 1, 2, 0, 0, 4, 3, 0, 1])
    path = _write(tmp_path / "d.bmp", mf.encode_bmp(np.zeros((2, 4)), 8, compression=1,
                                                    palette=PAL4, rle_stream=stream))
    assert read_bmp(path)[::-1, :, 0].tolist() == [[1, 1, 0, 2], [3, 3, 3, 3]]
    mode, pil = _pil_reading(path)
    assert mode == "P" and pil[::-1].tolist() == [[1, 1, 0, 0], [0, 0, 0, 0]]


def test_rle4_odd_absolute_run_reads_its_last_pixel(tmp_path):
    """An absolute run of five 4-bit pixels takes three bytes and a pad
    byte; PIL reads two bytes, then misses the run's end, and refuses."""
    stream = bytes([0, 5, 0x12, 0x31, 0x20, 0, 1, 0x30, 0, 1])
    path = _write(tmp_path / "o.bmp", mf.encode_bmp(np.zeros((1, 6)), 4, compression=2,
                                                    palette=PAL4, rle_stream=stream))
    assert read_bmp(path)[0, :, 0].tolist() == [1, 2, 3, 1, 2, 3]
    assert _pil_reading(path) == ("ValueError", "not enough image data")


def test_rle_early_end_of_bitmap_leaves_index_0(tmp_path):
    """End of bitmap in the first row: the rest is index 0; PIL refuses."""
    path = _write(tmp_path / "e.bmp", mf.encode_bmp(np.zeros((2, 4)), 8, compression=1,
                                                    palette=PAL4,
                                                    rle_stream=bytes([2, 1, 0, 1])))
    assert read_bmp(path)[::-1, :, 0].tolist() == [[1, 1, 0, 0], [0, 0, 0, 0]]
    assert _pil_reading(path) == ("ValueError", "not enough image data")


# -- BMP refusals -------------------------------------------------------------

def _patched(data: bytes, at: int, fmt: str, value) -> bytes:
    return data[:at] + struct.pack(fmt, value) + data[at + struct.calcsize(fmt):]


def _refused():
    rng = np.random.RandomState(0)
    rgb = mf.encode_bmp(rng.randint(0, 256, (4, 5, 3)), 24)
    pal8 = mf.encode_bmp(rng.randint(0, 256, (4, 5)), 8, palette=rng.randint(0, 256, (256, 3)))
    rle = mf.encode_bmp(rng.randint(0, 4, (4, 5)), 8, compression=1, palette=PAL4)
    return {
        "jpeg": _patched(rgb, 30, "<I", 4),
        "png": _patched(rgb, 30, "<I", 5),
        "rle8_24_bit": _patched(rgb, 30, "<I", 1),
        "bitfields_8_bit": _patched(pal8, 30, "<I", 3),
        "masks_444": mf.encode_bmp(rng.randint(0, 1 << 16, (3, 3), dtype=np.uint64), 16,
                                   compression=3, masks=(0xF00, 0xF0, 0xF)),
        "masks_32": mf.encode_bmp(rng.randint(0, 1 << 32, (3, 3), dtype=np.uint64), 32,
                                  header=124, compression=3,
                                  masks=(0xFF00, 0xFF0000, 0xFF000000, 0xFF)),
        "depth_2": mf.encode_bmp(rng.randint(0, 4, (3, 3)), 2, palette=PAL4),
        "depth_64": _patched(rgb, 28, "<H", 64),
        "header_20": _patched(rgb, 14, "<I", 20),
        "palette_70000": _patched(pal8, 46, "<I", 70000),
        "truncated": rgb[:-7],
        "rle_without_end": rle[:-6],
    }


@pytest.mark.parametrize("name", sorted(_refused()))
def test_bmp_that_pil_refuses_raises_naming_the_file(tmp_path, name):
    path = _write(tmp_path / f"{name}.bmp", _refused()[name])
    assert not isinstance(_pil_reading(path)[1], np.ndarray)
    with pytest.raises(ValueError, match=f"{name}.bmp"):
        read_bmp(path)
    with pytest.raises(ValueError, match=f"{name}.bmp"):
        load_rgb(path)


def test_webp_is_refused_naming_item_11(tmp_path):
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "x.webp")
    shutil.copy(tmp_path / "x.webp", tmp_path / "x.png")      # the leading bytes decide
    for name in ("x.webp", "x.png"):
        with pytest.raises(ValueError, match=r"WebP: ROADMAP\.md Queue 1 item 11.*\.npy"):
            load_rgb(str(tmp_path / name))


# -- the committed fixtures ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_reads_as_pil_and_as_its_manifest(name):
    """PIL's reading of the committed file is the manifest's, and so is
    the port's (the check phase 20 makes on the card's host)."""
    path = os.path.join(FIXTURES, name)
    assert mf.entry(path) == MANIFEST[name]
    reader = read_png if name.endswith(".png") else read_bmp
    assert_as_pil(path, reader)
    want = MANIFEST[name]
    raw = reader(path).reshape(want["raw"]["shape"])
    assert str(raw.dtype) == want["raw"]["dtype"] and mf.digest(raw) == want["raw"]["sha256"]
    rgb = load_rgb(path)
    assert list(rgb.shape) == want["rgb"]["shape"] and mf.digest(rgb) == want["rgb"]["sha256"]


def test_pascal_sized_files_read_as_pil(tmp_path):
    """The three files phase 20 times, and their pixels the encoder's
    input."""
    for path, want in mf.pascal_files(str(tmp_path)):
        reader = read_png if path.endswith(".png") else read_bmp
        assert_as_pil(path, reader)
        np.testing.assert_array_equal(reader(path), want)


# -- the callers, against the JAX package -------------------------------------

def _folder(root):
    """Two classes of the new files, sizes around 32: BMPs (24-bit,
    RLE8, 4-bit top-down, 5-6-5, RGBA bitfields, 1-bit black and white)
    and PNGs (interlaced 16-bit RGB, 1-bit grey, interlaced 2-bit
    palette, 16-bit grey + alpha, 4-bit grey, a BMP named .png)."""
    rng = np.random.RandomState(5)
    a, b = root / "bmp_class", root / "png_class"
    a.mkdir(parents=True)
    b.mkdir()
    _write(a / "c24.bmp", mf.encode_bmp(mf.content(30, 41, 1), 24))
    _write(a / "rle8.bmp", mf.encode_bmp(mf.labels(40, 29, 2), 8, compression=1,
                                         palette=rng.randint(0, 256, (256, 3))))
    _write(a / "p4.bmp", mf.encode_bmp(rng.randint(0, 16, (17, 50)), 4, top_down=True,
                                       header=108, palette=rng.randint(0, 256, (16, 3))))
    _write(a / "w565.bmp", mf.encode_bmp(rng.randint(0, 1 << 16, (33, 33), dtype=np.uint64), 16,
                                         compression=3, masks=(0xF800, 0x7E0, 0x1F)))
    _write(a / "rgba.BMP", mf.encode_bmp(rng.randint(0, 1 << 32, (25, 31), dtype=np.uint64), 32,
                                         header=124, compression=3,
                                         masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)))
    _write(a / "bw.bmp", mf.encode_bmp(rng.randint(0, 2, (32, 32)), 1,
                                       palette=[(0, 0, 0), (255, 255, 255)]))
    mf.encode_png(b / "rgb16.png", mf.be16(mf.content(36, 28, 3).astype(np.uint16) * 257),
                  interlace=1, depth=16, color=2)
    mf.encode_png(b / "grey1.png", rng.randint(0, 2, (31, 45, 1)), depth=1, color=0)
    mf.encode_png(b / "pal2.png", rng.randint(0, 4, (29, 23, 1)), depth=2, color=3,
                  interlace=1, plte=rng.randint(0, 256, (3, 3)))
    mf.encode_png(b / "la16.png", mf.be16(rng.randint(0, 1 << 16, (20, 40, 2))), depth=16,
                  color=4)
    mf.encode_png(b / "grey4.png", rng.randint(0, 16, (35, 35, 1)), depth=4, color=0,
                  interlace=1)
    _write(b / "bmp_named.png", mf.encode_bmp(mf.content(21, 34, 4), 24, header=12))
    return root


def test_image_folder_equals_the_jax_dataset_bit_for_bit(tmp_path):
    root = _folder(tmp_path / "folder")
    port, ref = ImageFolderDataset(str(root), 32), JaxImageFolder(str(root), 32)
    assert port.samples == ref.samples and len(port) == 12
    for i in range(len(ref)):
        np.testing.assert_array_equal(port.load(i)[0], ref.load(i)[0], err_msg=port.samples[i][0])
    for kw in (dict(shuffle=True, seed=1), dict(with_count=True)):
        got, want = list(port.batches(5, **kw)), list(ref.batches(5, **kw))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x, y)


def test_preprocess_pascal_with_the_new_labels_equals_the_jax_function(tmp_path):
    """Labels as a 1-bit grey PNG (bool → 0/1), a 4-bit palette PNG and
    interlaced 8-bit palette and grey PNGs."""
    voc, rng = tmp_path / "voc", np.random.RandomState(8)
    for sub in ("JPEGImages", "SegmentationClassAug", os.path.join("ImageSets", "SegmentationAug")):
        os.makedirs(voc / sub)
    ids = ["2007_000032", "2007_000039", "2008_000123", "2009_000001"]
    for i, img_id in enumerate(ids):
        h, w = 14 + i, 19 - i
        Image.fromarray(mf.content(h, w, i)).save(voc / "JPEGImages" / f"{img_id}.jpg")
        lab = voc / "SegmentationClassAug" / f"{img_id}.png"
        if i == 0:
            mf.encode_png(lab, rng.randint(0, 2, (h, w, 1)), depth=1, color=0)
        elif i == 1:
            mf.encode_png(lab, rng.randint(0, 16, (h, w, 1)), depth=4, color=3,
                          plte=rng.randint(0, 256, (16, 3)))
        elif i == 2:
            mf.encode_png(lab, mf.labels(h, w, i)[:, :, None], color=3, interlace=1,
                          plte=rng.randint(0, 256, (256, 3)))
        else:
            mf.encode_png(lab, mf.labels(h, w, i)[:, :, None], color=0, interlace=1)
    with open(voc / "ImageSets" / "SegmentationAug" / "train_aug.txt", "w") as f:
        f.write("\n".join(f"/JPEGImages/{i}.jpg /SegmentationClassAug/{i}.png" for i in ids[:2]))
    with open(voc / "ImageSets" / "SegmentationAug" / "val.txt", "w") as f:
        f.write("\n".join(ids[1:]) + "\n")
    jpre.preprocess_pascal(str(voc), str(tmp_path / "jax"), margin=2)
    tpre.preprocess_pascal(str(voc), str(tmp_path / "port"), margin=2)
    assert assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax")) == 1 + 3 * 5
    label = np.load(tmp_path / "port" / "annotations" / "train" / "2007_000032.npy")
    assert label.dtype == np.uint8 and set(np.unique(label)) == {0, 1}


def test_preprocess_cityscapes_with_the_new_files_equals_the_jax_function(tmp_path):
    """Frame 0: an interlaced 16-bit RGB image, interlaced labelIds and
    16-bit instanceIds; frame 1: a BMP named .png, 4-bit grey labelIds
    and 1-bit instanceIds; object masks too."""
    src, rng = tmp_path / "cs", np.random.RandomState(9)
    lab_dir = src / "gtFine_trainvaltest" / "gtFine" / "train" / "ulm"
    img_dir = src / "leftImg8bit_trainvaltest" / "leftImg8bit" / "train" / "ulm"
    os.makedirs(lab_dir)
    os.makedirs(img_dir)
    h, w = 12, 21
    f0, f1 = "ulm_000000_000019", "ulm_000001_000019"
    mf.encode_png(img_dir / f"{f0}_leftImg8bit.png",
                  mf.be16(rng.randint(0, 1 << 16, (h, w, 3))), depth=16, color=2, interlace=1)
    mf.encode_png(lab_dir / f"{f0}_gtFine_labelIds.png", rng.randint(0, 34, (h, w, 1)),
                  interlace=1)
    inst = rng.choice([7, 999, 1000, 24001, 26000], (h, w)).astype(np.uint16)
    mf.encode_png(lab_dir / f"{f0}_gtFine_instanceIds.png", mf.be16(inst[:, :, None]), depth=16,
                  color=0, interlace=1)
    _write(img_dir / f"{f1}_leftImg8bit.png", mf.encode_bmp(mf.content(h, w, 1), 24))
    mf.encode_png(lab_dir / f"{f1}_gtFine_labelIds.png", rng.randint(0, 3, (h, w, 1)),
                  depth=4, color=0)
    mf.encode_png(lab_dir / f"{f1}_gtFine_instanceIds.png", rng.randint(0, 2, (h, w, 1)),
                  depth=1, color=0)
    for name, mod in (("jax", jpre), ("port", tpre)):
        mod.preprocess_cityscapes(str(src), str(tmp_path / name), margin=1, n_jobs=1)
        mod.preprocess_cityscapes_obj_masks(str(src), str(tmp_path / name))
    assert assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax")) == 1 + 2 + 2 * 2 + 2
    with np.load(tmp_path / "port" / "obj_masks" / "train" / f"{f0}.npz") as z:
        assert z["instance_ids"].tolist() == [1000, 24001, 26000]


def test_img_to_numpy_with_the_new_files_equals_the_jax_function(tmp_path):
    rng = np.random.RandomState(10)
    d = tmp_path / "port" / "img_with_margin_0" / "train"
    d.mkdir(parents=True)
    mf.encode_png(d / "rgb16.png", mf.be16(rng.randint(0, 1 << 16, (9, 11, 3))), depth=16,
                  color=2, interlace=1)
    mf.encode_png(d / "grey1.png", rng.randint(0, 2, (10, 7, 1)), depth=1, color=0,
                  interlace=1)
    mf.encode_png(d / "pal4.png", rng.randint(0, 16, (6, 13, 1)), depth=4, color=3,
                  plte=rng.randint(0, 256, (9, 3)))
    mf.encode_png(d / "rgba16.png", mf.be16(rng.randint(0, 1 << 16, (8, 8, 4))), depth=16,
                  color=6)
    _write(d / "bmp.png", mf.encode_bmp(rng.randint(0, 16, (7, 9)), 4, compression=2,
                                        palette=rng.randint(0, 256, (16, 3))))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    assert tpre.convert_images_to_numpy(str(tmp_path / "port")) == \
        jpre.convert_images_to_numpy(str(tmp_path / "jax")) == 5
    for sub in ("port", "jax"):     # the tree check reads every .png as a PNG
        os.remove(tmp_path / sub / "img_with_margin_0" / "train" / "bmp.png")
    assert assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax")) == 9


def test_augment_directory_on_a_bmp_named_jpg_equals_the_jax_function(tmp_path):
    """``augment_directory`` takes .jpg/.jpeg/.png names whatever the
    file: BMPs named .jpg and an interlaced PNG are augmented as the JAX
    package augments them, file for file."""
    src, rng = tmp_path / "src" / "c", np.random.RandomState(11)
    src.mkdir(parents=True)
    _write(src / "a.jpg", mf.encode_bmp(mf.content(19, 23, 5), 24))
    _write(src / "b.jpeg", mf.encode_bmp(mf.labels(17, 15, 6), 8, compression=1,
                                         palette=rng.randint(0, 256, (256, 3))))
    mf.encode_png(src / "c.png", mf.content(13, 21, 7), interlace=1)
    n_jax = jax_img_aug.augment_directory(str(tmp_path / "src"), str(tmp_path / "jax"),
                                          copies_per_op=1, seed=3)
    n = img_aug.augment_directory(str(tmp_path / "src"), str(tmp_path / "port"),
                                  copies_per_op=1, seed=3)
    assert n == n_jax == 9
    assert assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax")) == 9
