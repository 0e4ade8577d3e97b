"""PyTorch port, the classifier's image folders:
``adlm_tpu_torch.data.image_folder`` against ``adlm_tpu.data.image_folder``
(which decodes and resizes with PIL).

Every comparison is exact: the port's PNG decoder, its copy of PIL's
8-bit bilinear resize and the normalized float32 images equal the JAX
dataset's bit for bit.  The PNG files are written by PIL (which chooses
its scanline filters per row) and by the test's own encoder, which puts
each of the five filter types on some rows of every colour type.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from adlm_tpu.data.image_folder import ImageFolderDataset as JaxImageFolder

from adlm_tpu_torch.data.image_folder import (
    ImageFolderDataset,
    read_png,
    resize_bilinear_u8,
)

COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}   # channels → PNG colour type


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(path, pixels: np.ndarray, interlace: int = 0, depth: int = 8) -> None:
    """An 8-bit PNG of (H, W, C) pixels whose row ``r`` carries scanline
    filter ``r % 5``."""
    h, w, ch = pixels.shape
    px = pixels.astype(np.int32)
    rows = []
    for r in range(h):
        cur = px[r]
        up = px[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros((1, ch), np.int32), cur[:-1]])
        upleft = np.concatenate([np.zeros((1, ch), np.int32), up[:-1]])
        ftype = r % 5
        pred = [0, left, up, (left + up) >> 1, _paeth(left, up, upleft)][ftype]
        rows.append(bytes([ftype]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, COLOR_TYPE[ch],
                                              0, 0, interlace))
                + _chunk(b"IDAT", zlib.compress(b"".join(rows), 6))
                + _chunk(b"IEND", b""))


def _smooth(rng, h, w, ch):
    """Gradients with noise: PIL's adaptive filter picks Sub, Up, Avg
    and Paeth rows on them."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * (3 + c) + yy * (2 + c)) % 256 for c in range(ch)], -1)
    return np.clip(base + rng.randint(0, 4, base.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A three-class folder: .npy arrays (grey, RGB, RGBA), PIL-written
    PNGs (L, LA, RGB, RGBA) and the test encoder's PNGs (every filter,
    every colour type), at sizes above, below and equal to 32."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.RandomState(0)
    for c in ("apple", "banana", "cherry"):
        (root / c).mkdir()
    np.save(root / "apple" / "g.npy", rng.randint(0, 256, (45, 37)).astype(np.uint8))
    np.save(root / "apple" / "rgb.npy", rng.randint(0, 256, (20, 50, 3)).astype(np.uint8))
    np.save(root / "apple" / "rgba.npy", rng.randint(0, 256, (32, 32, 4)).astype(np.uint8))
    for mode, ch, hw in (("L", 1, (64, 48)), ("LA", 2, (31, 33)),
                         ("RGB", 3, (40, 50)), ("RGBA", 4, (17, 90))):
        px = _smooth(rng, *hw, ch)
        Image.fromarray(px[:, :, 0] if ch == 1 else px, mode).save(root / "banana" / f"{mode}.png")
    for ch, hw in ((1, (33, 41)), (2, (50, 30)), (3, (64, 64)), (4, (29, 45))):
        encode_png(root / "cherry" / f"c{ch}.png", _smooth(rng, *hw, ch))
        encode_png(root / "cherry" / f"n{ch}.png", rng.randint(0, 256, hw + (ch,)).astype(np.uint8))
    return root


def test_read_png_decodes_every_filter_and_colour_type(folder):
    seen = set()
    for path in sorted((folder / "banana").glob("*.png")) + sorted((folder / "cherry").glob("*.png")):
        want = np.asarray(Image.open(path))
        got = read_png(str(path))
        np.testing.assert_array_equal(got.reshape(want.shape), want, err_msg=str(path))
        data = path.read_bytes()
        raw = zlib.decompress(data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8])
        stride = got.shape[1] * got.shape[2] + 1
        seen |= set(raw[::stride])
    assert seen == {0, 1, 2, 3, 4}


def test_dataset_equals_the_jax_dataset_bit_for_bit(folder):
    port, ref = ImageFolderDataset(str(folder), 32), JaxImageFolder(str(folder), 32)
    assert port.classes == ref.classes
    assert port.samples == ref.samples and len(port) == len(ref) == 15
    for i in range(len(ref)):
        (x, y), (xr, yr) = port.load(i), ref.load(i)
        assert x.dtype == xr.dtype == np.float32 and y == yr
        np.testing.assert_array_equal(x, xr, err_msg=port.samples[i][0])
    for kw in (dict(shuffle=True, seed=3), dict(with_count=True)):
        got, want = list(port.batches(4, **kw)), list(ref.batches(4, **kw))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    assert [b[2] for b in port.batches(4, with_count=True)] == [4, 4, 4, 3]
    unnorm = ImageFolderDataset(str(folder), 24, normalize=False)
    np.testing.assert_array_equal(unnorm.load(4)[0],
                                  JaxImageFolder(str(folder), 24, normalize=False).load(4)[0])


@pytest.mark.parametrize("size", [(32, 32), (7, 90), (64, 20), (45, 37), (100, 100)])
def test_resize_bilinear_u8_is_pils(size):
    rng = np.random.RandomState(size[0])
    img = rng.randint(0, 256, (45, 37, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(size[::-1], resample=Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear_u8(img, size), want)


def test_other_formats_raise(tmp_path):
    (tmp_path / "a").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "a" / "x.jpg")
    ds = ImageFolderDataset(str(tmp_path), 8)
    with pytest.raises(ValueError, match=r"\.npy"):
        ds.load(0)
    px = np.zeros((8, 8, 3), np.uint8)
    for name, kw in (("interlaced.png", dict(interlace=1)), ("deep.png", dict(depth=16))):
        encode_png(tmp_path / name, px, **kw)
        with pytest.raises(ValueError, match="8-bit"):
            read_png(str(tmp_path / name))
    Image.fromarray(np.zeros((8, 8), np.uint8), "P").save(tmp_path / "palette.png")
    with pytest.raises(ValueError, match="colour type 3"):
        read_png(str(tmp_path / "palette.png"))
    with pytest.raises(ValueError, match="no class"):
        ImageFolderDataset(str(tmp_path / "a"), 8)
