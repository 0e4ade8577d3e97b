"""PyTorch port, U-Noise's data: the native remap and blur bindings, the
warps, the dataset, ``batches``, the NIfTI reader and
``prepare_unoise_data`` against the JAX package.

Tolerances:

* the port's native ``remap_bilinear`` / ``remap_nearest`` /
  ``gaussian_blur`` against ``adlm_tpu.native``'s (the same C source):
  bit-equal; remaps against their numpy versions: bit-equal; the blur
  against scipy: atol ``BLUR_ATOL`` = 1e-6 (f64 sums in other orders);
* every warp, ``reference_geometric_augment``, dataset items (augmented
  or not, raw or normalized), ``split_datasets`` and ``batches``
  (``n_jobs`` 1 and 4): bit-equal to the JAX package's, which draws the
  same ``RandomState`` values and calls the same C code;
* the NIfTI reader and ``prepare_unoise_data`` on ``.nii.gz`` files the
  test writes: bit-equal.
"""

import os

import numpy as np
import pytest

from adlm_tpu import native as jnative
from adlm_tpu.data import unoise_data as jdata
from adlm_tpu.data import warps as jwarps
from adlm_tpu.data.nifti import load_fdata as jax_load_fdata
from adlm_tpu.data.preprocess import prepare_unoise_data as jax_prepare

from adlm_tpu_torch import native
from adlm_tpu_torch.data import unoise_data as tdata
from adlm_tpu_torch.data import warps as twarps
from adlm_tpu_torch.data.nifti import load_fdata
from adlm_tpu_torch.data.preprocess import prepare_unoise_data

from test_nifti import _make_nifti, _write_decathlon

BLUR_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def jax_native_built():
    """The JAX package's C library (built on demand): without it the JAX
    warps would take their numpy path and the comparison would be of
    another function."""
    assert jnative.available()


def _maps(seed, oh=19, ow=23, span=40.0):
    r = np.random.RandomState(seed)
    # coordinates well outside the image (reflect-101 on both sides),
    # exact .5 ties for the nearest rounding
    my = (r.rand(oh, ow) * span - span / 4).astype(np.float32)
    mx = (r.rand(oh, ow) * span - span / 4).astype(np.float32)
    my[0, :5] = [0.5, 1.5, 2.5, -0.5, -1.5]
    return my, mx


@pytest.mark.parametrize("channels", [0, 1, 3])
def test_remap_bilinear_bit_equal(channels):
    r = np.random.RandomState(channels)
    shape = (17, 13) if channels == 0 else (17, 13, channels)
    img = r.rand(*shape).astype(np.float32)
    my, mx = _maps(channels)
    got = native.remap_bilinear(img, my, mx)
    np.testing.assert_array_equal(got, jnative.remap_bilinear(img, my, mx))
    np.testing.assert_array_equal(got, native.remap_bilinear_plain(img, my, mx))
    assert got.shape == my.shape + img.shape[2:]


@pytest.mark.parametrize("seed", [0, 1])
def test_remap_nearest_bit_equal(seed):
    mask = (np.random.RandomState(seed).rand(11, 9) > 0.5).astype(np.float32)
    my, mx = _maps(seed + 10, span=30.0)
    got = native.remap_nearest(mask, my, mx)
    np.testing.assert_array_equal(got, jnative.remap_nearest(mask, my, mx))
    np.testing.assert_array_equal(got, native.remap_nearest_plain(mask, my, mx))
    # a one-pixel extent reflects everything onto its pixel
    one = np.array([[3.0]], np.float32)
    assert (native.remap_nearest(one, my, mx) == 3.0).all()


@pytest.mark.parametrize("sigma", [1.0, 2.5, 6.0])
def test_gaussian_blur(sigma):
    field = (np.random.RandomState(3).rand(40, 33) * 2 - 1).astype(np.float32)
    got = native.gaussian_blur(field, sigma)
    np.testing.assert_array_equal(got, jnative.gaussian_blur(field, sigma))
    np.testing.assert_allclose(got, native.gaussian_blur_plain(field, sigma), atol=BLUR_ATOL)


def test_bindings_validate_shapes():
    img = np.zeros((4, 4), np.float32)
    my = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        native.remap_bilinear(img, my, np.zeros((3, 2), np.float32))
    with pytest.raises(ValueError):
        native.remap_nearest(np.zeros((4, 4, 1), np.float32), my, my)
    with pytest.raises(ValueError):
        native.gaussian_blur(np.zeros(5, np.float32), 1.0)


def _pair(seed, hw=(48, 40)):
    r = np.random.RandomState(seed)
    img = r.rand(*hw).astype(np.float32)
    mask = (r.rand(*hw) > 0.6).astype(np.float32)
    return img, mask


@pytest.mark.parametrize("name", ["elastic_transform", "grid_distortion",
                                  "optical_distortion", "shift_scale_rotate",
                                  "reference_geometric_augment"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warps_bit_equal(name, seed):
    img, mask = _pair(seed)
    rs_t, rs_j = np.random.RandomState(seed), np.random.RandomState(seed)
    got = getattr(twarps, name)(img, mask, rs_t)
    want = getattr(jwarps, name)(img, mask, rs_j)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    # the same draws, in the same order
    assert rs_t.rand() == rs_j.rand()


def _slices(n=20, hw=24, seed=0):
    r = np.random.RandomState(seed)
    imgs = r.rand(n, hw, hw).astype(np.float32)
    masks = (r.rand(n, hw, hw) > 0.7).astype(np.float32)
    boxes = np.empty(n, dtype=object)
    for i in range(n):
        boxes[i] = None if i % 5 == 3 else np.array([1, 5, 2, 9])
    return imgs, masks, boxes


@pytest.mark.parametrize("raw", [False, True])
def test_split_and_items_bit_equal(raw):
    imgs, masks, boxes = _slices()
    t_splits = tdata.split_datasets(imgs, masks, boxes, seed=4, raw=raw)
    j_splits = jdata.split_datasets(imgs, masks, boxes, seed=4, raw=raw)
    assert [len(d) for d in t_splits] == [len(d) for d in j_splits] == [12, 2, 2]
    for td, jd in zip(t_splits, j_splits):
        assert td.augment == jd.augment
        for i in range(len(td)):
            for g, w in zip(td[i], jd[i]):
                np.testing.assert_array_equal(g, w)
    x, y = t_splits[0][0]
    assert x.shape == ((24, 24, 1) if raw else (24, 24, 3)) and y.shape == (24, 24, 1)


@pytest.mark.parametrize("n_jobs", [1, 4])
@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, True)])
def test_batches_bit_equal(n_jobs, shuffle, drop_last):
    imgs, masks, _ = _slices(n=22, seed=1)
    td = tdata.UNoiseDataset(imgs, masks, augment=True, seed=2, raw=True)
    jd = jdata.UNoiseDataset(imgs, masks, augment=True, seed=2, raw=True)
    got = list(tdata.batches(td, 4, shuffle=shuffle, seed=3, drop_last=drop_last,
                             n_jobs=n_jobs))
    want = list(jdata.batches(jd, 4, shuffle=shuffle, seed=3, drop_last=drop_last,
                              n_jobs=n_jobs))
    assert len(got) == len(want) == (5 if drop_last else 6)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("endian,dtype", [("<", np.int16), (">", np.float32)])
def test_nifti_reader_bit_equal(tmp_path, endian, dtype):
    data = (np.random.RandomState(0).rand(6, 5, 4) * 100).astype(dtype)
    path = str(tmp_path / "vol.nii.gz")
    _make_nifti(path, data, endian=endian, slope=0.5, inter=-3.0, vox_offset=368)
    got = load_fdata(path)
    np.testing.assert_array_equal(got, jax_load_fdata(path))
    np.testing.assert_allclose(got, data.astype(np.float64) * 0.5 - 3.0)


def test_prepare_unoise_data_bit_equal(tmp_path):
    src = _write_decathlon(tmp_path / "src")
    dst_t, dst_j = str(tmp_path / "t"), str(tmp_path / "j")
    prepare_unoise_data(src, dst_t, downscale=2)
    jax_prepare(src, dst_j, downscale=2)
    for name in ("images.npy", "masks.npy", "bounding_boxes.npy"):
        got = np.load(os.path.join(dst_t, name))
        want = np.load(os.path.join(dst_j, name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert np.load(os.path.join(dst_t, "images.npy")).shape == (9, 8, 10)
