"""PyTorch port, the classifier's offline augmentation
(``adlm_tpu_torch/data/img_aug.py``, ``native/img_aug.cc``) against the
JAX package's ``adlm_tpu/data/img_aug.py`` and PIL, whose warp and JPEG
encoder that module calls.

Every comparison is exact: the warp bit for bit (``_affine`` of both
packages at fixed angles, the whole-turn copy included), the encoder
byte for byte (``Image.save`` at its defaults over every width and
height in 1..17 and two PASCAL-sized frames, on noise, flat colour and
a 0/255 checkerboard, with and without a comment), and
``augment_directory`` file for file (names, count, bytes) on a tree of
JPEG and PNG sources whose comments PIL carries into every copy.  The
committed manifest (``tests/fixtures/torch_img_aug``), the oracle of a
host without PIL, equals a fresh run of the JAX function.
"""

import ctypes
import importlib.util
import io
import json
import os
import re
import zlib

import numpy as np
import pytest
from PIL import Image, PngImagePlugin

from adlm_tpu.data import img_aug as jax_img_aug
from adlm_tpu_torch import native
from adlm_tpu_torch.data import img_aug
from adlm_tpu_torch.data.image_folder import image_comment, load_rgb, write_jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_img_aug")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
_spec = importlib.util.spec_from_file_location("img_aug_fixtures",
                                               os.path.join(FIXTURES, "make_fixtures.py"))
make_fixtures = importlib.util.module_from_spec(_spec)   # build_tree, outputs
_spec.loader.exec_module(make_fixtures)


class _Fixed:
    """A ``random.Random`` stand-in whose ``uniform`` gives one value."""

    def __init__(self, v):
        self.v = v

    def uniform(self, a, b):
        return self.v


def _pil_jpeg(a, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _contents(h, w, seed):
    rng = np.random.RandomState(seed)
    check = ((np.arange(h)[:, None] + np.arange(w)[None]) % 2 * 255).astype(np.uint8)
    return {"noise": rng.randint(0, 256, (h, w, 3), np.uint8),
            "flat": np.broadcast_to(rng.randint(0, 256, 3).astype(np.uint8), (h, w, 3)).copy(),
            "checker": np.stack([check, 255 - check, check], -1)}


# -- the warp -----------------------------------------------------------------

@pytest.mark.parametrize("angle", [15, -15, 1e-7, -1e-7, 0.0, 11.7, -7.3])
@pytest.mark.parametrize("kind", ["rotate", "shear", "skew"])
def test_affine_matches_pil(kind, angle):
    rng = np.random.RandomState(3)
    for h, w in [(1, 1), (2, 3), (15, 17), (37, 53), (64, 48)]:
        a = rng.randint(0, 256, (h, w, 3), np.uint8)
        want = np.asarray(jax_img_aug._affine(Image.fromarray(a), kind, _Fixed(angle)))
        got = img_aug._affine(a, kind, _Fixed(angle))
        assert got.dtype == np.uint8 and got.shape == a.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} {angle} at {h}x{w}")


def test_rotate_by_a_whole_turn_copies():
    """``Image.rotate`` returns a copy, without resampling, where the angle
    is a multiple of 360."""
    a = np.random.RandomState(5).randint(0, 256, (7, 9, 3), np.uint8)
    for angle in (0.0, 360.0, -360.0):
        got = img_aug._affine(a, "rotate", _Fixed(angle))
        assert got is not a
        np.testing.assert_array_equal(got, a)
    with pytest.raises(ValueError):
        img_aug._affine(a, "zoom", _Fixed(0.0))


# -- the encoder --------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(h, w) for h in range(1, 18) for w in range(1, 18)]
                         + [(375, 500), (500, 375)])
def test_encode_jpeg_matches_pil(h, w):
    """Noise (long AC codes and ZRL), flat colour (EOB only) and the colour
    tables' ends, with and without a comment."""
    for name, a in _contents(h, w, h * 31 + w).items():
        assert native.encode_jpeg(a) == _pil_jpeg(a), (name, h, w)
        assert native.encode_jpeg(a, b"cub \xff\x00") == _pil_jpeg(a, comment=b"cub \xff\x00"), \
            (name, h, w)


def test_write_jpeg_writes_what_pil_saves(tmp_path):
    a = _contents(23, 29, 1)["noise"]
    write_jpeg(str(tmp_path / "port.jpg"), a[:, ::-1], b"flipped")
    im = Image.fromarray(a).transpose(Image.FLIP_LEFT_RIGHT)
    im.info["comment"] = b"flipped"
    im.save(tmp_path / "pil.jpg")
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "pil.jpg").read_bytes()
    # an empty comment writes no COM marker, as PIL's
    assert native.encode_jpeg(a, b"") == native.encode_jpeg(a) == _pil_jpeg(a, comment=b"")


def test_encoder_and_warp_refuse_bad_input():
    a = np.zeros((4, 5, 3), np.uint8)
    for bad in (a[:, :, 0], np.zeros((4, 5, 4), np.uint8), a.astype(np.float32),
                np.zeros((0, 5, 3), np.uint8), np.zeros((4, 0, 3), np.uint8), a.tolist()):
        with pytest.raises(ValueError, match=r"\(H, W, 3\) uint8"):
            native.encode_jpeg(bad)
    with pytest.raises(ValueError, match="65500"):
        native.encode_jpeg(np.zeros((65501, 1, 3), np.uint8))
    with pytest.raises(ValueError, match="comment"):
        native.encode_jpeg(a, b"x" * 65534)
    with pytest.raises(ValueError, match=r"\(H, W, 3\) uint8"):
        native.affine_bilinear_u8(a[:, :, :2], (1, 0, 0, 0, 1, 0))
    with pytest.raises(ValueError, match="6 coefficients"):
        native.affine_bilinear_u8(a, (1, 0, 0, 0, 1))


# -- comments -----------------------------------------------------------------

def _png_with(tmp_path, name, chunks):
    """A PIL palette PNG with the given (kind, body) text chunks added
    before its image data."""
    info = PngImagePlugin.PngInfo()
    for kind, body in chunks:
        info.add(kind, body)
    im = Image.fromarray(_contents(11, 13, 2)["noise"]).quantize(32)   # 8-bit indices
    im.save(tmp_path / name, pnginfo=info)
    return tmp_path / name


def _itxt(text: bytes, compressed: bool) -> bytes:
    return (b"comment\0" + bytes([int(compressed), 0]) + b"en\0Comment\0"
            + (zlib.compress(text) if compressed else text))


COMMENT_CASES = {
    "none": [],
    "tEXt": [(b"tEXt", b"comment\0latin \xe9\xe8")],
    "tEXt_Comment": [(b"tEXt", b"Comment\0not this one")],
    "tEXt_Description": [(b"tEXt", b"Description\0nor this")],
    "tEXt_last_wins": [(b"tEXt", b"comment\0first"), (b"tEXt", b"comment\0second")],
    "tEXt_empty": [(b"tEXt", b"comment\0")],
    "zTXt": [(b"zTXt", b"comment\0\0" + zlib.compress(b"squeezed \xe9"))],
    "iTXt": [(b"iTXt", _itxt("plain ☃".encode(), False))],
    "iTXt_compressed": [(b"iTXt", _itxt("packed ü".encode(), True))],
}


@pytest.mark.parametrize("case", sorted(COMMENT_CASES))
def test_png_comment_is_what_pil_writes_into_a_copy(tmp_path, case):
    path = _png_with(tmp_path, "src.png", COMMENT_CASES[case])
    with Image.open(path) as im:
        im.convert("RGB").save(tmp_path / "pil.jpg")
    write_jpeg(str(tmp_path / "port.jpg"), load_rgb(str(path)), image_comment(str(path)))
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "pil.jpg").read_bytes()


def test_jpeg_comment_is_the_last_com_marker(tmp_path):
    data = _pil_jpeg(_contents(9, 10, 4)["noise"], comment=b"first")
    assert data[20:29] == b"\xff\xfe\x00\x07first"   # right after APP0
    (tmp_path / "two.jpg").write_bytes(data[:29] + b"\xff\xfe\x00\x08second" + data[29:])
    with Image.open(tmp_path / "two.jpg") as im:
        assert im.info["comment"] == b"second"
    assert image_comment(str(tmp_path / "two.jpg")) == b"second"
    (tmp_path / "none.jpg").write_bytes(_pil_jpeg(_contents(9, 10, 4)["noise"]))
    assert image_comment(str(tmp_path / "none.jpg")) is None


# -- augment_directory --------------------------------------------------------

def _tree(root):
    """Class folders of JPEG and PNG sources, comments in several, and
    entries that ``augment_directory`` skips."""
    c = {k: _contents(13 + k, 17 + 2 * k, k) for k in range(6)}
    a, b = root / "bird_a", root / "bird_b"
    a.mkdir(parents=True)
    b.mkdir()
    Image.fromarray(c[0]["noise"]).save(a / "x1.jpg", comment=b"CUB comment")
    Image.fromarray(c[1]["noise"][..., 0]).save(a / "grey.JPEG")
    Image.fromarray(c[2]["noise"]).save(a / "prog.jpg", progressive=True)
    _png_with(a, "pal.png", COMMENT_CASES["tEXt"])
    rgba = np.dstack([c[3]["noise"], c[3]["flat"][..., :1]])
    info = PngImagePlugin.PngInfo()
    info.add_itxt("comment", "itxt é", zip=True)
    Image.fromarray(rgba).save(b / "alpha.PNG", pnginfo=info)
    Image.fromarray(c[4]["checker"]).save(b / "checker.jpg")
    Image.fromarray(c[5]["noise"]).save(b / "skipped.bmp")
    (b / "notes.txt").write_text("not an image")
    (root / "README").write_text("not a class")


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs}


@pytest.mark.parametrize("seed", [0, 7])
def test_augment_directory_matches_jax(tmp_path, seed):
    _tree(tmp_path / "src")
    n_jax = jax_img_aug.augment_directory(str(tmp_path / "src"), str(tmp_path / "jax"),
                                          copies_per_op=2, seed=seed)
    n = img_aug.augment_directory(str(tmp_path / "src"), str(tmp_path / "port"),
                                  copies_per_op=2, seed=seed)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert n == n_jax == len(want) == 6 * 6
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert b"CUB comment" in got[os.path.join("bird_a", "x1_shear1.jpg")]


def test_manifest_is_the_jax_function_output(tmp_path):
    """The committed oracle of phase 19 equals a fresh run of the JAX
    function on its tree, and the port writes the same bytes."""
    make_fixtures.build_tree(MANIFEST["tree"], str(tmp_path / "src"))
    for name, fn in (("jax", jax_img_aug.augment_directory),
                     ("port", img_aug.augment_directory)):
        n = fn(str(tmp_path / "src"), str(tmp_path / name),
               copies_per_op=MANIFEST["copies_per_op"], seed=MANIFEST["seed"])
        assert n == len(MANIFEST["outputs"])
        assert make_fixtures.outputs(str(tmp_path / name)) == MANIFEST["outputs"], name


def test_augment_directory_refuses_what_the_port_does_not_read(tmp_path):
    (tmp_path / "src" / "c").mkdir(parents=True)
    Image.fromarray(_contents(8, 8, 0)["noise"]).save(tmp_path / "src" / "c" / "a.jpg",
                                                      format="WEBP")
    with pytest.raises(ValueError, match="a.jpg: .*WebP: ROADMAP.md Queue 1 item 11"):
        img_aug.augment_directory(str(tmp_path / "src"), str(tmp_path / "dst"), 1)


# -- bindings -----------------------------------------------------------------

def test_ctypes_signatures_match_img_aug_cc():
    """``native._bind`` declares img_aug.cc's two functions as it defines
    them (undeclared, ctypes would cut a size_t to 32 bits)."""
    with open(native.IMG_AUG_SOURCE) as f:
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
            "const double*": np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            "size_t": ctypes.c_size_t, "int": ctypes.c_int, "void": None}
    for fn in ("affine_bilinear_u8", "jpeg_encode"):
        ret, params = re.search(r"^(\w+) " + fn + r"\(([^)]*)\)", src, re.M).groups()
        types = [want[p.strip().rsplit(None, 1)[0]] for p in params.split(",")]
        assert lib.fns[fn].argtypes == types, fn
        assert lib.fns[fn].restype is want[ret], fn
