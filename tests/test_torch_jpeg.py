"""PyTorch port, the JPEG decoder of the host data library
(``adlm_tpu_torch/native/jpeg.cc``, ``data/image_folder.py::read_jpeg``)
against PIL, whose pixels the JAX package's JPEG datasets come from.

Every comparison is exact.  The committed fixtures
(``tests/fixtures/torch_jpeg``, written by its ``make_fixtures.py``)
decode to PIL's pixels, and their manifest, the oracle of a host
without PIL, equals PIL's decode.  Generated files cover sizes that are
not multiples of the MCU, 4:4:4, 4:2:2 and 4:2:0, baseline and
progressive, qualities 10, 75 and 100, grey, colour and Adobe RGB, with
and without restart markers; files whose quantization tables the test
scales up show where PIL's libjpeg-turbo (its SIMD IDCT) saturates.
Formats the port does not read raise ``ValueError`` naming the file.
"""

import hashlib
import io
import json
import os
import re
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image, ImageFile, features

from adlm_tpu_torch import native
from adlm_tpu_torch.data.image_folder import load_rgb, read_jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)

SIZES = [(1, 1), (7, 9), (16, 16), (17, 33), (3, 200), (64, 48)]
QUALITIES = (10, 75, 100)


def _content(h, w, seed, grey=False):
    """Smooth gradients, sharp-edged blocks and noise, uint8."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(x / (4 + 3 * k) + y / (6 + 2 * k) + k)
                    for k in range(3)], -1)
    img[(x // 5 + y // 7) % 3 == 0] += rng.uniform(-80, 80, 3)
    img = np.clip(img + rng.normal(0, 8, img.shape), 0, 255).astype(np.uint8)
    return img.mean(-1).astype(np.uint8) if grey else img


def _encode(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pil(path):
    """(np.asarray(Image.open(path)), its convert("RGB"))."""
    with Image.open(path) as im:
        return np.asarray(im), np.asarray(im.convert("RGB"))


def _assert_as_pil(path):
    raw, rgb = _pil(path)
    got = read_jpeg(str(path))
    assert got.dtype == np.uint8 and got.ndim == 3
    np.testing.assert_array_equal(got[:, :, 0] if raw.ndim == 2 else got, raw)
    np.testing.assert_array_equal(load_rgb(str(path)), rgb)


@pytest.fixture(autouse=True)
def whole_files(monkeypatch):
    """PIL writes progressive and optimized files in one block: its
    default is too small for some of their scans."""
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 22)


def test_pil_decodes_through_libjpeg_turbo():
    """The oracle is libjpeg-turbo's default decode (3.1.3 here)."""
    assert features.check_feature("libjpeg_turbo")
    assert features.version("libjpeg_turbo") is not None


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_decodes_as_pil_and_as_its_manifest(name):
    path = os.path.join(FIXTURES, name)
    _assert_as_pil(path)
    raw, rgb = _pil(path)
    with Image.open(path) as im:
        mode = im.mode
    assert MANIFEST[name] == {"shape": list(rgb.shape), "mode": mode,
                              "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    got = load_rgb(path)
    assert hashlib.sha256(got.tobytes()).hexdigest() == MANIFEST[name]["sha256"]


def _cases():
    """Colour (YCbCr): every size x sampling x progressive, the quality
    and restart markers cycled so that each meets every other factor;
    grey: every size, baseline and progressive; Adobe RGB (4:4:4 only:
    PIL refuses subsampled RGB): every size."""
    out = []
    for si, size in enumerate(SIZES):
        for ss in (0, 1, 2):
            for prog in (False, True):
                out.append(("colour", size, ss, prog, QUALITIES[(si + ss + prog) % 3],
                            (si + ss) % 2))
        for prog in (False, True):
            out.append(("grey", size, None, prog, QUALITIES[(si + prog) % 3], (si + prog) % 2))
        out.append(("rgb", size, None, si % 2 == 1, QUALITIES[si % 3], si // 3))
    return out


@pytest.mark.parametrize(
    "kind,size,ss,prog,quality,restart", _cases(),
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_generated_case_is_bit_equal_to_pil(tmp_path, kind, size, ss, prog, quality, restart):
    kw = dict(quality=quality, progressive=prog)
    if ss is not None:
        kw["subsampling"] = ss
    if kind == "rgb":
        kw["keep_rgb"] = True
    if restart:
        kw["restart_marker_blocks"] = 2
    path = tmp_path / "x.jpg"
    path.write_bytes(_encode(_content(*size, seed=size[0] * 7 + size[1], grey=kind == "grey"),
                             **kw))
    _assert_as_pil(path)


def _segments(data: bytes):
    """(marker, offset of its FF, segment length) of the markers before
    the first scan."""
    pos, out = 2, []
    while data[pos + 1] != 0xDA:
        marker = data[pos + 1]
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((marker, pos, length))
        pos += 2 + length
    return out


def _scale_quant_tables(data: bytes, fn) -> bytes:
    out = bytearray(data)
    for marker, pos, length in _segments(data):
        if marker != 0xDB:
            continue
        j = pos + 4
        while j < pos + 2 + length:
            assert out[j] >> 4 == 0     # 8-bit tables
            for k in range(64):
                out[j + 1 + k] = fn(k, out[j + 1 + k])
            j += 65
    return bytes(out)


@pytest.mark.parametrize("quality,scale", [
    (100, lambda k, v: 6 if k == 0 else v),      # DC samples past +-512
    (95, lambda k, v: min(255, v * 5)),          # overshoot everywhere
    (50, lambda k, v: 255),                      # 16-bit dequantized values wrap
])
def test_scaled_quant_tables_saturate_as_pil(tmp_path, quality, scale):
    """Quantization tables scaled after the encoder used them push the
    IDCT's outputs and intermediates outside what any encoder writes:
    PIL's libjpeg-turbo saturates the samples (its SIMD IDCT), where the
    C version's range-limit table would wrap them."""
    for i, arr in enumerate((_content(37, 53, 5), np.full((16, 16, 3), 255, np.uint8),
                             np.zeros((16, 16, 3), np.uint8), _content(40, 40, 3, grey=True))):
        path = tmp_path / f"{i}.jpg"
        path.write_bytes(_scale_quant_tables(_encode(arr, quality=quality, subsampling=0),
                                             scale))
        _assert_as_pil(path)


def test_adobe_rgb_with_a_jfif_marker_is_ycbcr(tmp_path):
    """libjpeg-turbo takes a 3-component file with a JFIF marker as
    YCbCr, an Adobe marker with transform 0 notwithstanding."""
    data = _encode(_content(21, 30, 2), keep_rgb=True)
    assert not any(m == 0xE0 for m, _, _ in _segments(data))
    jfif = b"\xff\xe0" + struct.pack(">H", 16) + b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    path = tmp_path / "x.jpg"
    path.write_bytes(data[:2] + jfif + data[2:])
    _assert_as_pil(path)
    rgb = tmp_path / "rgb.jpg"
    rgb.write_bytes(data)
    assert not np.array_equal(read_jpeg(str(path)), read_jpeg(str(rgb)))


def test_threads_decode_at_once():
    """The decoder holds no global state: eight threads decoding the
    fixtures over and over give each its single-threaded pixels."""
    names = sorted(MANIFEST) * 6
    want = {n: read_jpeg(os.path.join(FIXTURES, n)) for n in MANIFEST}
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda n: read_jpeg(os.path.join(FIXTURES, n)), names))
    for n, g in zip(names, got):
        np.testing.assert_array_equal(g, want[n])


def test_cmyk_and_patched_variants_raise_naming_item_11(tmp_path):
    path = tmp_path / "cmyk.jpg"
    Image.fromarray(_content(16, 24, 1)).convert("CMYK").save(path)
    with pytest.raises(ValueError, match=re.escape(str(path)) + r".*4 components.*item 11"):
        read_jpeg(str(path))
    base = _encode(_content(24, 40, 3), quality=80)
    (sof, pos, _), = [s for s in _segments(base) if s[0] == 0xC0]
    for what, patch in (("arithmetic coding", {pos + 1: 0xC9}),
                        ("lossless coding", {pos + 1: 0xC3}),
                        ("12-bit precision", {pos + 4: 12}),
                        ("sampling factors 4x1,1x1,1x1", {pos + 11: 0x41})):
        data = bytearray(base)
        for k, v in patch.items():
            data[k] = v
        bad = tmp_path / "patched.jpg"
        bad.write_bytes(bytes(data))
        with pytest.raises(ValueError, match=re.escape(what) + r".*Queue 1 item 11"):
            load_rgb(str(bad))


def test_incomplete_progressive_file_raises(tmp_path):
    """Progressive scans that stop before the last refinement leave
    coefficient bits unsent: libjpeg-turbo would smooth the blocks,
    which the port refuses to imitate."""
    data = _encode(_content(32, 48, 4), progressive=True, quality=90)
    scans = [m.start() for m in re.finditer(b"\xff\xda", data)]
    assert len(scans) > 4
    path = tmp_path / "partial.jpg"
    path.write_bytes(data[:scans[3]] + b"\xff\xd9")
    with Image.open(path) as im:
        im.load()                        # PIL decodes it, smoothed
    with pytest.raises(ValueError, match="coefficient bits unsent.*item 11"):
        read_jpeg(str(path))


def test_truncated_or_corrupt_streams_raise(tmp_path):
    data = open(os.path.join(FIXTURES, "pascal_0.jpg"), "rb").read()
    sos = data.index(b"\xff\xda")
    for cut in (sos + (len(data) - sos) // 2, len(data) - 2, sos - 10):
        path = tmp_path / "cut.jpg"
        path.write_bytes(data[:cut])
        if cut > sos:                    # inside the scan: PIL raises too
            with pytest.raises(OSError):
                _pil(path)
        with pytest.raises(ValueError, match=re.escape(str(path)) + ": corrupt or truncated"):
            read_jpeg(str(path))
    restart = open(os.path.join(FIXTURES, "restart.jpg"), "rb").read()
    rst = restart.index(b"\xff\xd0")
    path = tmp_path / "rst.jpg"
    path.write_bytes(restart[:rst + 1] + b"\xd3" + restart[rst + 2:])   # RST3 for RST0
    with pytest.raises(ValueError, match="expected restart marker RST0"):
        read_jpeg(str(path))
    for junk in (b"", b"\xff\xd8", b"\xff\xd8\xff\xd9"):
        path.write_bytes(junk)
        with pytest.raises(ValueError, match="corrupt or truncated"):
            native.decode_jpeg(junk, str(path))


def test_load_rgb_goes_by_the_leading_bytes(tmp_path):
    """As ``PIL.Image.open``: a PNG named .jpg reads as a PNG, a JPEG
    named .png as a JPEG."""
    arr = _content(19, 23, 6)
    Image.fromarray(arr).save(tmp_path / "png.jpg", format="PNG")
    Image.fromarray(arr).save(tmp_path / "jpeg.png", format="JPEG")
    for name in ("png.jpg", "jpeg.png"):
        np.testing.assert_array_equal(load_rgb(str(tmp_path / name)),
                                      _pil(tmp_path / name)[1])
    np.testing.assert_array_equal(load_rgb(str(tmp_path / "png.jpg")), arr)


def test_ctypes_signatures_match_jpeg_cc():
    """``native._bind`` declares the decoder's two functions as jpeg.cc
    defines them (undeclared, ctypes would cut a size_t to 32 bits)."""
    import ctypes

    with open(native.JPEG_SOURCE) as f:
        src = f.read()

    class Fn:
        argtypes = restype = None

    class Lib:
        def __init__(self):
            self.fns = {}

        def __getattr__(self, name):
            return self.fns.setdefault(name, Fn())

    lib = Lib()
    native._bind(lib)
    want = {"const uint8_t*": np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            "uint8_t*": np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            "int*": np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            "size_t": ctypes.c_size_t, "int": ctypes.c_int, "char*": ctypes.c_char_p}
    for fn in ("jpeg_header", "jpeg_decode"):
        params = re.search(r"^int " + fn + r"\(([^)]*)\)", src, re.M).group(1)
        types = [want[p.strip().rsplit(None, 1)[0]] for p in params.split(",")]
        assert lib.fns[fn].argtypes == types, fn
        assert lib.fns[fn].restype is ctypes.c_int


def test_library_path_hashes_every_source(tmp_path, monkeypatch):
    """An edit to any of the three sources names another build."""
    before = native.library_path()
    for name in ("SOURCE", "JPEG_SOURCE", "IMG_AUG_SOURCE"):
        copy = tmp_path / f"{name}.cc"
        copy.write_bytes(open(getattr(native, name), "rb").read() + b"\n")
        monkeypatch.setattr(native, name, str(copy))
        assert native.library_path() != before
        monkeypatch.undo()
    assert native.library_path() == before
