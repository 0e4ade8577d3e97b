"""PyTorch port, the classifier's image folders:
``adlm_tpu_torch.data.image_folder`` against ``adlm_tpu.data.image_folder``
(which decodes and resizes with PIL).

Every comparison is exact: the port's PNG and JPEG decoders, its copy
of PIL's 8-bit bilinear resize and the normalized float32 images equal
the JAX dataset's bit for bit.  The PNG files are written by PIL (which
chooses its scanline filters per row) and by the test's own encoder,
which puts each of the five filter types on some rows of every colour
type; the JPEG files by PIL (colour at 4:2:0 and 4:4:4, grey,
progressive).
"""

import importlib.util
import os
import zlib

import numpy as np
import pytest
from PIL import Image

from adlm_tpu.data.image_folder import ImageFolderDataset as JaxImageFolder

from adlm_tpu_torch.data.image_folder import (
    ImageFolderDataset,
    load_rgb,
    read_bmp,
    read_png,
    resize_bilinear_u8,
)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_png_bmp")
_spec = importlib.util.spec_from_file_location("png_bmp_fixtures",
                                               os.path.join(FIXTURES, "make_fixtures.py"))
_mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_mf)
# every filter type on the rows, Adam7 and every bit depth on request
encode_png = _mf.encode_png


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


def test_jpeg_folder_equals_the_jax_dataset_bit_for_bit(tmp_path):
    """A class folder of JPEGs as CUB-200 and Stanford Cars ship: colour
    (PIL's defaults, 4:4:4 at quality 95), grey, progressive, and one
    ``.jpeg``; decode, ``convert("RGB")``, 8-bit resize, /255,
    normalize equal to the JAX dataset's."""
    rng = np.random.RandomState(1)
    for c in ("bird", "car"):
        (tmp_path / c).mkdir()
    files = (("bird", "a.jpg", (61, 47), "RGB", {}),
             ("bird", "b.jpeg", (30, 90), "RGB", dict(quality=95, subsampling=0)),
             ("bird", "c.jpg", (50, 50), "L", {}),
             ("car", "d.jpg", (73, 41), "RGB", dict(progressive=True)),
             ("car", "e.jpg", (24, 24), "L", dict(progressive=True, quality=90)))
    for cls, name, hw, mode, kw in files:
        px = _smooth(rng, *hw, 3)
        Image.fromarray(px[:, :, 0] if mode == "L" else px, mode).save(tmp_path / cls / name,
                                                                       **kw)
    port, ref = ImageFolderDataset(str(tmp_path), 32), JaxImageFolder(str(tmp_path), 32)
    assert port.samples == ref.samples and len(port) == 5
    for kw in (dict(), dict(with_count=True)):
        got, want = list(port.batches(2, **kw)), list(ref.batches(2, **kw))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["x.bmp", "interlaced.png", "deep.png", "palette.png"])
def test_formats_once_refused_equal_pil(tmp_path, name):
    """A PIL-written BMP, an interlaced PNG, a 16-bit RGB PNG and PIL's
    1-bit palette PNG read as PIL reads them, in a class folder too."""
    (tmp_path / "a").mkdir()
    px = np.random.RandomState(4).randint(0, 256, (8, 8, 3)).astype(np.uint8)
    path = tmp_path / "a" / name
    if name == "x.bmp":
        Image.fromarray(px).save(path)
    elif name == "interlaced.png":
        encode_png(path, px, interlace=1)
    elif name == "deep.png":
        encode_png(path, _mf.be16(px.astype(np.uint16) * 257 + 3), depth=16, color=2)
    else:
        Image.fromarray((px[:, :, 0] > 127).astype(np.uint8), "P").save(path)  # 1-bit
    with Image.open(path) as im:
        want, rgb = np.asarray(im), np.asarray(im.convert("RGB"))
    got = read_png(str(path)) if name.endswith(".png") else read_bmp(str(path))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    np.testing.assert_array_equal(load_rgb(str(path)), rgb)
    port, ref = ImageFolderDataset(str(tmp_path), 8), JaxImageFolder(str(tmp_path), 8)
    np.testing.assert_array_equal(port.load(0)[0], ref.load(0)[0])


def test_other_formats_raise(tmp_path):
    (tmp_path / "a").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "a" / "y.webp")
    ds = ImageFolderDataset(str(tmp_path), 8)
    with pytest.raises(ValueError, match=r"WebP: ROADMAP\.md Queue 1 item 11.*\.npy"):
        ds.load(0)
    with pytest.raises(ValueError, match="no class"):
        ImageFolderDataset(str(tmp_path / "a"), 8)
