"""PyTorch port, the dataset preprocessors: ``adlm_tpu_torch.data.preprocess``,
the new PNG types of ``data/image_folder.py`` and the commands
``preprocess-cityscapes``, ``preprocess-pascal`` (JPEG images through
the host library's decoder), ``preprocess-pancreas``, ``gen-image-list``
and ``img-to-numpy`` against ``adlm_tpu.data.preprocess`` and the JAX
CLI, which read and write images with PIL; and a prepared PASCAL split
fed to both packages' eval datasets.

Each case writes a small raw tree, with PIL and with the test's own
encoder (which puts each of the five scanline filters on some rows,
at 8 and 16 bits and for palette images), and runs both packages on
copies of it.  Every comparison is exact: ``.npy`` files and
``all_images.json`` byte for byte, PNGs pixel for pixel (PIL's encoder
chooses other filters than the port's ``write_png``, so their bytes
differ), ``.npz`` files array for array (``np.savez_compressed`` stamps
the time into its zip entries).
"""

import os
import shutil
import zlib

import numpy as np
import pytest
from PIL import Image

from adlm_tpu import cli as jax_cli
from adlm_tpu.core.config import get_experiment as jax_experiment
from adlm_tpu.data import preprocess as jpre
from adlm_tpu.data.dataset import SegmentationDataset as JaxDataset

from adlm_tpu_torch import cli
from adlm_tpu_torch.core.config import get_experiment
from adlm_tpu_torch.data import preprocess as tpre
from adlm_tpu_torch.data.dataset import SegmentationDataset
from adlm_tpu_torch.data.image_folder import read_png, to_rgb

from test_nifti import _make_nifti
from test_torch_image_folder import _smooth, encode_png

H, W = 24, 40
CITIES = {"train": ("aachen", "bremen"), "val": ("frankfurt", "lindau")}


def encode_grey16(path, values: np.ndarray) -> None:
    v = values.astype(np.uint16)
    encode_png(path, np.stack([v >> 8, v & 255], -1).astype(np.uint8), color=0, depth=16)


def _pil(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im)


def _pil_rgb(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def assert_same_tree(got_root, want_root) -> int:
    """The same files under both roots; ``.npy``/``.json`` byte-equal,
    PNGs pixel-equal (decoded with PIL), ``.npz`` array for array.
    Returns the number of files compared."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    def dirs(root):
        return sorted(os.path.relpath(d, root) for d, _, _ in os.walk(root))

    names = files(want_root)
    assert files(got_root) == names
    assert dirs(got_root) == dirs(want_root)
    for name in names:
        a, b = os.path.join(got_root, name), os.path.join(want_root, name)
        if name.endswith(".png"):
            np.testing.assert_array_equal(_pil(a), _pil(b), err_msg=name)
            np.testing.assert_array_equal(read_png(a).reshape(_pil(b).shape), _pil(b),
                                          err_msg=name)
        elif name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files), name
                for k in zb.files:
                    assert za[k].dtype == zb[k].dtype, (name, k)
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{name}:{k}")
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
    return len(names)


# ---------------------------------------------------------------------------
# the reader and to_rgb
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Every type the reader reads, written by PIL and by the encoder."""
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.RandomState(0)
    for mode, ch in (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
        px = _smooth(rng, 21, 30, ch)
        Image.fromarray(px[:, :, 0] if ch == 1 else px, mode).save(root / f"pil_{mode}.png")
    g16 = (_smooth(rng, 19, 33, 1)[:, :, 0].astype(np.uint16) * 257
           + rng.randint(0, 257, (19, 33))).astype(np.uint16)
    g16[0, :6] = [0, 1, 255, 256, 1000, 65535]
    Image.fromarray(g16).save(root / "pil_I16.png")
    encode_grey16(root / "enc_I16.png", g16)
    # 8-bit palette: PIL writes 8 bits from 17 colours on; indices past
    # the table's end are black in convert("RGB")
    table = rng.randint(0, 256, (20, 3)).astype(np.uint8)
    idx = rng.randint(0, 20, (17, 26)).astype(np.uint8)
    pal = Image.fromarray(idx, "P")
    pal.putpalette(table.ravel().tolist())
    pal.save(root / "pil_P.png")
    idx[0, :4] = [20, 21, 200, 255]
    encode_png(root / "enc_P.png", idx[:, :, None], color=3, plte=table)
    return root


def test_read_png_16_bit_grey_and_palette_equal_pil(pngs):
    for name in ("pil_I16", "enc_I16", "pil_P", "enc_P"):
        path = str(pngs / f"{name}.png")
        want = _pil(path)
        got, table = read_png(path, palette=True)
        assert got.dtype == want.dtype and got.shape == want.shape + (1,), name
        np.testing.assert_array_equal(got[:, :, 0], want, err_msg=name)
        np.testing.assert_array_equal(read_png(path), got)
        if name.endswith("_P"):
            with Image.open(path) as im:
                pil_table = np.frombuffer(im.palette.getdata()[1], np.uint8).reshape(-1, 3)
            np.testing.assert_array_equal(table, pil_table[:len(table)])
        else:
            assert table is None
    data = (pngs / "enc_I16.png").read_bytes()
    raw = zlib.decompress(data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8])
    assert set(raw[::2 * 33 + 1]) == {0, 1, 2, 3, 4}


def test_to_rgb_is_pils_convert_rgb(pngs):
    paths = sorted(pngs.glob("*.png"))
    assert len(paths) == 8
    for path in paths:
        got = to_rgb(*read_png(str(path), palette=True))
        want = _pil_rgb(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, path.name
        np.testing.assert_array_equal(got, want, err_msg=path.name)


def test_other_png_types_raise_naming_the_type(tmp_path):
    """The two files the reader once refused (16-bit RGB, PIL's 1-bit
    palette) read as PIL reads them; a combination PNG forbids (16-bit
    palette) raises, naming the file and the type."""
    rgb16 = np.random.RandomState(1).randint(0, 1 << 16, (4, 5, 3))
    encode_png(tmp_path / "rgb16.png", np.stack([rgb16 >> 8, rgb16 & 255], -1).reshape(4, 5, 6),
               color=2, depth=16)
    Image.fromarray(np.eye(8, dtype=np.uint8), "P").save(tmp_path / "p1.png")  # 1-bit
    for name in ("rgb16.png", "p1.png"):
        got = to_rgb(*read_png(str(tmp_path / name), palette=True))
        np.testing.assert_array_equal(got, _pil_rgb(tmp_path / name))
        want = _pil(tmp_path / name)
        np.testing.assert_array_equal(read_png(str(tmp_path / name)).reshape(want.shape), want)
    assert (_pil(tmp_path / "rgb16.png") == rgb16 >> 8).all()
    encode_png(tmp_path / "p16.png", np.zeros((4, 4, 2), np.uint8), color=3, depth=16,
               plte=np.zeros((4, 3), np.uint8))
    with pytest.raises(ValueError, match=r"p16\.png: .*bit depth 16 and colour type 3 \(palette\)"):
        read_png(str(tmp_path / "p16.png"))


# ---------------------------------------------------------------------------
# add_margins_to_image
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("margin", [0, 1, 5, 13])
def test_add_margins_equals_pils_pastes(margin):
    img = np.random.RandomState(margin).randint(0, 256, (9, 11, 3)).astype(np.uint8)
    want = np.asarray(jpre.add_margins_to_image(Image.fromarray(img), margin))
    got = tpre.add_margins_to_image(img, margin)
    assert got.dtype == np.uint8 and got.shape == (9 + 2 * margin, 11 + 2 * margin, 3)
    np.testing.assert_array_equal(got, want)
    if margin > 11:   # wider than the image: black past its edges
        assert not got[:margin - 9].any() and not got[:, :margin - 11].any()


# ---------------------------------------------------------------------------
# Cityscapes
# ---------------------------------------------------------------------------

def write_cityscapes(root, seed: int = 0):
    """2 cities per split (train and val, no test), 2 frames a city, 24x40:
    leftImg8bit RGB, labelIds 8-bit (raw ids 0-33 and some 255), and
    16-bit instanceIds (stuff below 1000, instances from 1000; the first
    frame has no instance); PIL and the encoder take turns."""
    rng = np.random.RandomState(seed)
    n = 0
    for split, cities in CITIES.items():
        for city in cities:
            lab_dir = os.path.join(root, "gtFine_trainvaltest", "gtFine", split, city)
            img_dir = os.path.join(root, "leftImg8bit_trainvaltest", "leftImg8bit", split, city)
            os.makedirs(lab_dir)
            os.makedirs(img_dir)
            for k in range(2):
                fid = f"{city}_{k:06d}_000019"
                rgb = _smooth(rng, H, W, 3) if n % 3 else rng.randint(
                    0, 256, (H, W, 3)).astype(np.uint8)
                ids = rng.randint(0, 34, (H, W)).astype(np.uint8)
                ids[0, :3] = 255
                inst = rng.choice([7, 11, 999, 1000, 24001, 26000], (H, W)).astype(np.uint16)
                if n == 0:
                    inst = np.minimum(inst, 999).astype(np.uint16)
                if n % 2:
                    Image.fromarray(rgb).save(os.path.join(img_dir, fid + "_leftImg8bit.png"))
                    Image.fromarray(ids).save(os.path.join(lab_dir, fid + "_gtFine_labelIds.png"))
                    Image.fromarray(inst).save(
                        os.path.join(lab_dir, fid + "_gtFine_instanceIds.png"))
                else:
                    encode_png(os.path.join(img_dir, fid + "_leftImg8bit.png"), rgb)
                    encode_png(os.path.join(lab_dir, fid + "_gtFine_labelIds.png"),
                               ids[:, :, None])
                    encode_grey16(os.path.join(lab_dir, fid + "_gtFine_instanceIds.png"), inst)
                n += 1
    return root


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    return write_cityscapes(str(tmp_path_factory.mktemp("cityscapes")))


@pytest.mark.parametrize("margin,n_jobs", [(0, 1), (0, 2), (3, 1), (3, 2)])
def test_preprocess_cityscapes_equals_the_jax_function(cityscapes, tmp_path, margin, n_jobs):
    jpre.preprocess_cityscapes(cityscapes, str(tmp_path / "jax"), margin=margin, n_jobs=n_jobs)
    tpre.preprocess_cityscapes(cityscapes, str(tmp_path / "port"), margin=margin,
                               n_jobs=n_jobs)
    n = assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert n == 1 + 8 + 8 * 2      # all_images.json, annotations, images (.npy, .png)
    ann = np.load(tmp_path / "port" / "annotations" / "val" / "lindau_000001_000019.npy")
    raw = _pil(os.path.join(cityscapes, "gtFine_trainvaltest", "gtFine", "val", "lindau",
                            "lindau_000001_000019_gtFine_labelIds.png"))
    np.testing.assert_array_equal(ann, tpre._cityscapes_lut()[raw])
    img = np.load(tmp_path / "port" / f"img_with_margin_{margin}" / "train" /
                  "aachen_000000_000019.npy")
    assert img.shape == (H + 2 * margin, W + 2 * margin, 3)


def test_object_masks_equal_the_jax_function(cityscapes, tmp_path):
    jpre.preprocess_cityscapes_obj_masks(cityscapes, str(tmp_path / "jax"))
    tpre.preprocess_cityscapes_obj_masks(cityscapes, str(tmp_path / "port"))
    assert assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax")) == 8
    with np.load(tmp_path / "port" / "obj_masks" / "train" / "aachen_000000_000019.npz") as z:
        assert z["masks"].shape == (0, H, W) and z["instance_ids"].size == 0
    with np.load(tmp_path / "port" / "obj_masks" / "val" / "lindau_000001_000019.npz") as z:
        assert z["instance_ids"].tolist() == [1000, 24001, 26000]
        assert z["masks"].dtype == np.uint8 and z["masks"].sum() > 0


# ---------------------------------------------------------------------------
# Pancreas
# ---------------------------------------------------------------------------

def write_pancreas(root, n: int, depth: int = 3, seed: int = 0):
    """``n`` int16 CT-like volumes of 20x24x``depth``; every other slice
    annotated (labels 0-2), the rest empty."""
    rng = np.random.RandomState(seed)
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        vol = rng.randint(-1024, 1500, (20, 24, depth)).astype(np.int16)
        seg = np.zeros((20, 24, depth), np.uint8)
        for z in range(0, depth, 2):
            seg[4 + z:12 + z, 5:15, z] = rng.randint(1, 3, (8, 10))
        name = f"pancreas_{i:03d}.nii.gz"
        _make_nifti(os.path.join(root, "imagesTr", name), vol)
        _make_nifti(os.path.join(root, "labelsTr", name), seg)
    return root


@pytest.mark.parametrize("size", [(48, 40), (12, 10)], ids=["up", "down"])
def test_preprocess_pancreas_equals_the_jax_function(tmp_path, size):
    src = write_pancreas(str(tmp_path / "src"), 3)
    kw = dict(train_n=1, val_n=1, upsample_to=size)
    jpre.preprocess_pancreas(src, str(tmp_path / "jax"), **kw)
    tpre.preprocess_pancreas(src, str(tmp_path / "port"), **kw)
    # all_images.json, and 2 annotated slices of 3 per volume, 3 files each
    assert assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax")) == 1 + 3 * 2 * 3
    rgb = np.load(tmp_path / "port" / "img_with_margin_0" / "val" / "pancreas_001_slice002.npy")
    assert rgb.shape == size + (3,)


# ---------------------------------------------------------------------------
# gen-image-list and img-to-numpy
# ---------------------------------------------------------------------------

def test_generate_image_list_equals_the_jax_function(cityscapes, tmp_path):
    tpre.preprocess_cityscapes(cityscapes, str(tmp_path / "port"), margin=2, n_jobs=1)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    for sub in ("port", "jax"):
        os.remove(tmp_path / sub / "all_images.json")
    os.remove(tmp_path / "port" / "img_with_margin_2" / "val" / "frankfurt_000000_000019.npy")
    os.remove(tmp_path / "jax" / "img_with_margin_2" / "val" / "frankfurt_000000_000019.npy")
    want = jpre.generate_image_list(str(tmp_path / "jax"))
    got = tpre.generate_image_list(str(tmp_path / "port"))
    assert got == want and sorted(got) == ["test", "train", "val"] and len(got["val"]) == 3
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    with pytest.raises(FileNotFoundError, match="img_with_margin"):
        tpre.generate_image_list(str(tmp_path / "port" / "annotations"))


def write_png_layout(root, margin: int, seed: int = 0):
    """``img_with_margin_<margin>/{train,val}`` PNGs of every type the
    reader reads (PIL and the encoder), with a sentinel ``.npy`` that
    must stay as it is."""
    rng = np.random.RandomState(seed)
    for split in ("train", "val"):
        os.makedirs(os.path.join(root, f"img_with_margin_{margin}", split))
    d = os.path.join(root, f"img_with_margin_{margin}")
    for mode, ch in (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
        px = _smooth(rng, 15, 18, ch)
        Image.fromarray(px[:, :, 0] if ch == 1 else px, mode).save(
            os.path.join(d, "train", f"{mode}.png"))
    encode_png(os.path.join(d, "val", "enc_rgb.png"), _smooth(rng, 16, 13, 3))
    encode_grey16(os.path.join(d, "val", "enc_i16.png"),
                  rng.randint(0, 600, (12, 14)).astype(np.uint16))
    table = rng.randint(0, 256, (30, 3)).astype(np.uint8)
    encode_png(os.path.join(d, "val", "enc_p.png"),
               rng.randint(0, 32, (11, 9, 1)).astype(np.uint8), color=3, plte=table)
    np.save(os.path.join(d, "train", "RGB.npy"), np.zeros((1,), np.uint8))
    return root


def test_convert_images_to_numpy_equals_the_jax_function(tmp_path):
    write_png_layout(str(tmp_path / "port"), 4)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    assert tpre.convert_images_to_numpy(str(tmp_path / "port"), margin=4) == \
        jpre.convert_images_to_numpy(str(tmp_path / "jax"), margin=4) == 6
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert np.load(tmp_path / "port" / "img_with_margin_4" / "train" / "RGB.npy").shape == (1,)
    assert tpre.convert_images_to_numpy(str(tmp_path / "port"), margin=4) == 0
    assert tpre.convert_images_to_numpy(str(tmp_path / "port"), margin=0) == 0


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------

def test_commands_write_what_the_jax_cli_writes(cityscapes, tmp_path, capsys):
    src = write_pancreas(str(tmp_path / "pancreas"), 2, depth=1)
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
    runs = [["preprocess-cityscapes", cityscapes, "{d}/city"],
            ["preprocess-pancreas", src, "{d}/pancreas"]]
    for argv in runs:
        jax_cli.main([a.format(d=tmp_path / "jax") for a in argv])
        cli.main([a.format(d=tmp_path / "port") for a in argv] + ["--device", "cpu"])
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    img = np.load(tmp_path / "port" / "pancreas" / "img_with_margin_0" / "train" /
                  "pancreas_000_slice000.npy")
    assert img.shape == (1024, 2048, 3)
    for sub in ("jax", "port"):
        d = tmp_path / sub / "city"
        os.remove(d / "all_images.json")
        for f in (d / "img_with_margin_0" / "val").glob("*.npy"):
            os.remove(f)
    capsys.readouterr()
    jax_cli.main(["gen-image-list", str(tmp_path / "jax" / "city")])
    jax_cli.main(["img-to-numpy", str(tmp_path / "jax" / "city"), "--margin", "0"])
    want = capsys.readouterr().out
    # the JAX command returns its dict from main, so ``sys.exit`` prints
    # it and exits 1; the port's returns None (exit 0)
    assert cli.main(["gen-image-list", str(tmp_path / "port" / "city"), "--device", "cpu"]) is None
    cli.main(["img-to-numpy", str(tmp_path / "port" / "city"), "--margin", "0",
              "--device", "cpu"])
    assert capsys.readouterr().out == want == "converted 4 images\n"
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


# ---------------------------------------------------------------------------
# PASCAL VOC: JPEG images, L and P labels
# ---------------------------------------------------------------------------

# (id, (height, width), PIL mode of the JPEG, its save arguments)
VOC = (("2007_000032", (28, 41), "RGB", {}),
       ("2007_000039", (33, 26), "RGB", dict(progressive=True)),
       ("2008_000123", (24, 24), "L", {}),
       ("2009_000001", (30, 37), "RGB", dict(quality=95, subsampling=0)))


def write_voc(root, seed: int, splits=("train_aug", "val"), cmyk: bool = False) -> str:
    """A VOC 2012 + SegmentationClassAug tree: PIL JPEGs (colour at
    4:2:0, progressive and 4:4:4, one grey), labels 0..20 with 255 as
    ``L`` PNGs and one ``P`` PNG, SBD's two-column ``train_aug.txt`` and
    VOC's one-column ``val.txt`` (each written if in ``splits``)."""
    root = str(root)
    rng = np.random.RandomState(seed)
    for sub in ("JPEGImages", "SegmentationClassAug", os.path.join("ImageSets", "SegmentationAug")):
        os.makedirs(os.path.join(root, sub))
    for i, (img_id, hw, mode, kw) in enumerate(VOC):
        px = _smooth(rng, *hw, 3)
        im = Image.fromarray(px[:, :, 0] if mode == "L" else px, mode)
        if cmyk and i == 1:
            im, kw = im.convert("CMYK"), {}
        im.save(os.path.join(root, "JPEGImages", img_id + ".jpg"), **kw)
        lab = rng.randint(0, 21, hw).astype(np.uint8)
        lab[:, :3] = 255
        lim = Image.fromarray(lab, "L")
        if i == 2:
            lim = Image.fromarray(lab, "P")
            lim.putpalette(rng.randint(0, 256, 768).tolist())
        lim.save(os.path.join(root, "SegmentationClassAug", img_id + ".png"))
    lines = {"train_aug": [f"/JPEGImages/{i}.jpg /SegmentationClassAug/{i}.png"
                           for i, *_ in VOC[:3]],
             "val": [i for i, *_ in VOC[1:]]}
    for split in splits:
        with open(os.path.join(root, "ImageSets", "SegmentationAug", split + ".txt"), "w") as f:
            f.write("\n".join(lines[split]) + "\n")
    return root


@pytest.mark.parametrize("margin,splits", [(0, ("train_aug", "val")), (5, ("val",))])
def test_preprocess_pascal_equals_the_jax_function(tmp_path, margin, splits):
    """``.npy`` and ``all_images.json`` byte-equal, PNGs pixel-equal; a
    missing split file is skipped, as the JAX function skips it."""
    voc = write_voc(tmp_path / "voc", 11, splits)
    jpre.preprocess_pascal(voc, str(tmp_path / "jax"), margin=margin)
    tpre.preprocess_pascal(voc, str(tmp_path / "port"), margin=margin)
    n = assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert n == 1 + 3 * (3 * ("train_aug" in splits) + 3)
    p_label = np.load(tmp_path / "port" / "annotations" / "val" / "2008_000123.npy")
    assert p_label.ndim == 2 and p_label.max() == 255 and p_label.dtype == np.uint8
    img = np.load(tmp_path / "port" / f"img_with_margin_{margin}" / "val" / "2007_000039.npy")
    assert img.shape == (33 + 2 * margin, 26 + 2 * margin, 3)


def test_preprocess_pascal_command_and_eval_datasets_equal_the_jax_ones(tmp_path):
    """The slice: ``preprocess-pascal`` through both CLIs, then each
    package's eval dataset on its prepared val split.  Raw uint8 and
    normalized eval batches are bit-equal; with the experiment's own
    513x513 eval resize (``pascal_kld_imnet``), the images within the
    resize's stated 1e-6 (test_torch_data.py, PIL_ATOL) and the labels
    bit-equal.  The model on those batches is held by
    test_torch_evaluate.py."""
    voc = write_voc(tmp_path / "voc", 12)
    jax_cli.main(["preprocess-pascal", voc, str(tmp_path / "jax")])
    assert cli.main(["preprocess-pascal", voc, str(tmp_path / "port"), "--device", "cpu"]) is None
    assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    jdata, tdata = jax_experiment("pascal_kld_imnet").data, get_experiment("pascal_kld_imnet").data
    assert tdata.eval_resize == jdata.eval_resize == (513, 513)
    # batch 2 without the resize (each frame's shape flushes a batch);
    # batch 1, eval-valid's default, with it: both packages stack the
    # labels, which keep each frame's shape
    for resize, batch in ((None, 2), ((513, 513), 1)):
        jds = JaxDataset(_replace(jdata, eval_resize=resize), "val",
                         data_path=str(tmp_path / "jax"), is_eval=True)
        tds = SegmentationDataset(_replace(tdata, eval_resize=resize), "val",
                                  data_path=str(tmp_path / "port"), is_eval=True)
        assert tds.img_ids == jds.img_ids and len(tds) == 3
        for raw in ((False, True) if resize is None else (False,)):
            got = list(tds.eval_batches(batch, with_counts=True, raw=raw))
            want = list(jds.eval_batches(batch, with_counts=True, raw=raw))
            assert len(got) == len(want) == 3
            for (gi, gl, gn), (wi, wl, wn) in zip(got, want):
                assert gn == wn and gi.dtype == wi.dtype and gi.shape == wi.shape
                np.testing.assert_array_equal(gl, wl)
                if resize is None:
                    np.testing.assert_array_equal(gi, wi)
                else:
                    assert gi.shape[1:3] == resize
                    np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-6)


def _replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


def test_preprocess_pascal_is_refused_naming_item_11(tmp_path):
    """The command reads PASCAL's JPEGs; one of a variant the port does
    not decode (CMYK) stops it with the file's name and item 11."""
    voc = write_voc(tmp_path / "voc", 13, cmyk=True)
    with pytest.raises(ValueError) as e:
        cli.main(["preprocess-pascal", voc, str(tmp_path / "out"), "--device", "cpu"])
    assert "2007_000039.jpg" in str(e.value) and "Queue 1 item 11" in str(e.value)
    assert not (tmp_path / "out" / "all_images.json").exists()
