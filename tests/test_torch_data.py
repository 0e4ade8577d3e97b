"""PyTorch port, the data slice: ``adlm_tpu_torch.data`` and
``adlm_tpu_torch.native`` against ``adlm_tpu.data`` and
``adlm_tpu.native``, plus the wire dtypes of
``adlm_tpu_torch.train.pipeline``.

Both packages read the same numpy-seeded files in the preprocessed
layout: five 40×60 frames with raw Cityscapes ids 0–33 in blocks of
about 6 pixels (so the LUT maps a real share to void), and a PASCAL-like
split whose frames differ in size (eval batches flush on a change of
shape).  Windows are 33×33.  Tolerances:

* the port's C++ augment, the windows of every loader mode and resume,
  and every dataset method without a resize: exactly equal to the JAX
  package's (the same C source and the same random streams);
* ``augment_sample_plain`` against the C++: labels exact, images within
  ``PLAIN_ATOL`` = 1e-6, a few f32 ulps of normalized values (the two
  round the same f32 operations in the same order; one uint8 step is
  1/255/std ≈ 0.017, so any other sample fails);
* the numpy copies of PIL's resampling (``eval_resize``, overlays)
  against PIL itself and against the JAX package, which calls PIL:
  within ``PIL_ATOL`` = 1e-6 (both sum the taps in double in the same
  order), overlay images within 1 (uint8 truncation of such a value),
  labels exact.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from adlm_tpu import native as jax_native
from adlm_tpu.core.config import DataConfig as JaxDataConfig
from adlm_tpu.data import constants as jax_constants
from adlm_tpu.data import pipeline as jax_pipeline
from adlm_tpu.data.dataset import SegmentationDataset as JaxDataset
from adlm_tpu.train import pipeline as jax_train_pipeline

from adlm_tpu_torch import native
from adlm_tpu_torch.core import config as tcfg
from adlm_tpu_torch.data import constants, pipeline
from adlm_tpu_torch.data.dataset import (
    SegmentationDataset,
    resize_bilinear_pil,
    resize_nearest_pil,
)
from adlm_tpu_torch.train import pipeline as train_pipeline

PLAIN_ATOL = 1e-6
PIL_ATOL = 1e-6
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
WINDOW = (33, 33)


def _blocks(rng, hw, n_ids, block):
    coarse = rng.randint(0, n_ids, (-(-hw[0] // block), -(-hw[1] // block)))
    return np.kron(coarse, np.ones((block, block), np.int64))[:hw[0], :hw[1]]


def _write_split(root, shapes, n_ids, dtype, seed):
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "img_with_margin_0", "train")
    ann_dir = os.path.join(root, "annotations", "train")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    ids = []
    for i, hw in enumerate(shapes):
        ids.append(f"img{i}")
        np.save(os.path.join(img_dir, f"img{i}.npy"),
                rng.randint(0, 256, (*hw, 3)).astype(np.uint8))
        np.save(os.path.join(ann_dir, f"img{i}.npy"),
                _blocks(rng, hw, n_ids, 6).astype(dtype))
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump({"train": ids}, f)
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    return {
        "cityscapes": _write_split(str(base / "cityscapes"), [(40, 60)] * 5, 34,
                                   np.uint8, 0),
        # PASCAL-like: frames of two sizes, int32 labels with 255 = void
        "pascal": _write_split(str(base / "pascal"),
                               [(40, 60), (40, 60), (36, 50), (40, 60)], 22,
                               np.int32, 1),
    }


def _datasets(root, table, **kw):
    jax = JaxDataset(JaxDataConfig(class_table=table, window_size=WINDOW, **kw),
                     "train", data_path=root)
    port = SegmentationDataset(tcfg.DataConfig(class_table=table, window_size=WINDOW,
                                               **kw), "train", data_path=root)
    return jax, port


def _equal_items(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# -- class tables ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jax_constants.CLASS_TABLES))
def test_class_tables_match_jax(name):
    assert sorted(constants.CLASS_TABLES) == sorted(jax_constants.CLASS_TABLES)
    got, want = constants.get_class_table(name), jax_constants.get_class_table(name)
    assert (got.num_classes, got.categories, got.convert, got.class_names) == \
        (want.num_classes, want.categories, want.convert, want.class_names)
    for n in (want.num_classes, want.num_classes + 3):
        np.testing.assert_array_equal(got.submission_lut(n), want.submission_lut(n))
    if want.convert_lut() is None:
        assert got.convert_lut() is None
    else:
        np.testing.assert_array_equal(got.convert_lut(), want.convert_lut())
    raw = np.random.RandomState(0).randint(-3, 300, (7, 9))
    np.testing.assert_array_equal(got.convert_labels(raw), want.convert_labels(raw))


# -- the host C++ augment ----------------------------------------------------

def _frame(seed=0, hw=(40, 60)):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (*hw, 3)).astype(np.uint8),
            _blocks(rng, hw, 34, 5))


# (scale, start, flip): downscaled below the window (mean padding on
# both axes), padding in one axis only, identity, upscaled with crops
DRAWS = [(0.6, (0, 0), False), (0.6, (0, 0), True), (0.85, (0, 10), True),
         (1.0, (3, 20), False), (1.37, (11, 40), True), (1.9, (40, 80), False)]
MODES = {"normalize": dict(), "raw /255": dict(normalize=False),
         "cells": dict(cells=True, normalize=False)}


@pytest.mark.parametrize("label_dtype", ["uint8", "int32"])
@pytest.mark.parametrize("lut", [False, True])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_augment_matches_jax_native(label_dtype, lut, mode):
    img, lab = _frame(1)
    lab = lab.astype(label_dtype)
    table = jax_constants.get_class_table("cityscapes").convert_lut() if lut else None
    for scale, start, flip in DRAWS:
        args = (img, lab, scale, WINDOW, start, flip, MEAN, STD)
        got = native.augment_sample(*args, label_lut=table, **MODES[mode])
        want = jax_native.augment_sample(*args, label_lut=table, **MODES[mode])
        _equal_items(got, want)
        if scale < 0.8:   # padded: label 0 and the padding value past the image
            assert (got[1][int(40 * scale):] == 0).all()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_augment_plain_version_matches_cpp(mode):
    img, lab = _frame(2)
    table = constants.get_class_table("cityscapes").convert_lut()
    for scale, start, flip in DRAWS:
        for lut in (None, table):
            args = (img, lab.astype(np.uint8), scale, WINDOW, start, flip, MEAN, STD)
            got = native.augment_sample_plain(*args, label_lut=lut, **MODES[mode])
            want = native.augment_sample(*args, label_lut=lut, **MODES[mode])
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_allclose(got[0], want[0], rtol=0, atol=PLAIN_ATOL)


def test_fused_augment_equals_resize_then_crop_and_the_resizes_match_jax():
    img, lab = _frame(3)
    for scale, start, flip in DRAWS:
        args = (img, lab.astype(np.int32), scale, WINDOW, start, flip, MEAN, STD)
        _equal_items(native.augment_sample(*args), native.augment_sample_unfused(*args))
        _equal_items(native.augment_sample_unfused(*args),
                     jax_native.augment_sample_unfused(*args))
    for dh, dw in [(13, 17), (74, 106), (40, 60)]:
        np.testing.assert_array_equal(native.resize_bilinear_u8(img, dh, dw),
                                      jax_native.resize_bilinear_u8(img, dh, dw))
        np.testing.assert_array_equal(native.resize_nearest_i32(lab, dh, dw),
                                      jax_native.resize_nearest_i32(lab, dh, dw))


@pytest.mark.parametrize("fn", [native.augment_sample, native.augment_sample_unfused,
                                native.augment_sample_plain])
def test_augment_refuses_what_the_c_code_would_overrun(fn):
    img, lab = _frame(4)
    with pytest.raises(ValueError, match="channels"):
        fn(np.concatenate([img, img[..., :1]], -1), lab, 1.0, WINDOW, (0, 0), False,
           MEAN, STD)
    with pytest.raises(ValueError, match="label"):
        fn(img, lab[1:], 1.0, WINDOW, (0, 0), False, MEAN, STD)
    with pytest.raises(ValueError, match="empty"):
        fn(img, lab, 0.01, WINDOW, (0, 0), False, MEAN, STD)


def test_host_library_build_raises_without_fallback(tmp_path, monkeypatch):
    """A source that does not compile fails the build, whichever of the
    three it is, and leaves no library behind."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    for name in ("SOURCE", "JPEG_SOURCE", "IMG_AUG_SOURCE"):
        with monkeypatch.context() as m:
            m.setattr(native, name, str(bad))
            with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
                native.build()
            assert native.library_path().startswith(str(tmp_path / "_build"))
            assert not os.path.exists(native.library_path())


# -- numpy copies of PIL's resampling ----------------------------------------

@pytest.mark.parametrize("src,dst", [((40, 60), (33, 33)), ((40, 60), (65, 97)),
                                     ((375, 500), (513, 513)), ((37, 53), (37, 54)),
                                     ((36, 50), (7, 3))])
def test_pil_resamplers_match_pil(src, dst):
    rng = np.random.RandomState(4)
    x = (rng.rand(*src) * 5 - 2.5).astype(np.float32)
    lab = rng.randint(0, 300, src).astype(np.int32)
    want = np.asarray(Image.fromarray(x).resize(dst[::-1], resample=Image.BILINEAR))
    np.testing.assert_allclose(resize_bilinear_pil(x, dst), want, rtol=0, atol=PIL_ATOL)
    want = np.asarray(Image.fromarray(lab, mode="I").resize(
        dst[::-1], resample=Image.NEAREST), dtype=np.int32)
    np.testing.assert_array_equal(resize_nearest_pil(lab, dst), want)


# -- SegmentationDataset -----------------------------------------------------

@pytest.mark.parametrize("table", ["cityscapes", "pascal"])
def test_dataset_train_and_raw_items_match_jax(roots, table):
    jds, tds = _datasets(roots[table], table, scales=(0.5, 1.5))
    assert len(tds) == len(jds) and tds.img_ids == jds.img_ids
    for i in range(len(jds)):
        for seed in (i, 1000 + 7 * i):
            _equal_items(tds.get_train_item(i, sample_seed=seed),
                         jds.get_train_item(i, sample_seed=seed))
        _equal_items(tds.get_eval_item_raw(i), jds.get_eval_item_raw(i))
        _equal_items(tds.get_eval_item(i), jds.get_eval_item(i))
        _equal_items(tds.get_overlay_item(i), jds.get_overlay_item(i))
    assert tds.supports_raw_eval() == jds.supports_raw_eval()
    # eval and push datasets: no jitter, no flip; push skips normalize
    for kw in (dict(is_eval=True), dict(push_prototypes=True)):
        jds.is_eval = tds.is_eval = kw.get("is_eval", False)
        jds.push_prototypes = tds.push_prototypes = kw.get("push_prototypes", False)
        _equal_items(tds.get_train_item(0, sample_seed=5), jds.get_train_item(0, sample_seed=5))
        assert tds.supports_raw_eval() == jds.supports_raw_eval()


def test_dataset_eval_resize_matches_jax_through_pil(roots):
    jds, tds = _datasets(roots["pascal"], "pascal", eval_resize=(33, 47))
    assert not tds.supports_raw_eval() and not jds.supports_raw_eval()
    for i in range(len(jds)):
        got, want = tds.get_eval_item(i), jds.get_eval_item(i)
        assert got[0].shape == (33, 47, 3) and got[1].shape == want[1].shape
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=PIL_ATOL)
        np.testing.assert_array_equal(got[1], want[1])
        got, want = tds.get_overlay_item(i), jds.get_overlay_item(i)
        assert got[0].dtype == np.uint8 and got[0].shape == (33, 47, 3)
        assert np.abs(got[0].astype(int) - want[0]).max() <= 1
        np.testing.assert_array_equal(got[1], want[1])
    # push datasets skip the resize
    jds.push_prototypes = tds.push_prototypes = True
    _equal_items(tds.get_eval_item(2), jds.get_eval_item(2))
    assert tds.supports_raw_eval()


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("pad_final,with_counts", [(True, True), (True, False),
                                                   (False, False)])
def test_eval_batches_and_items_match_jax(roots, raw, pad_final, with_counts):
    jds, tds = _datasets(roots["pascal"], "pascal")
    got = list(tds.eval_batches(3, pad_final=pad_final, with_counts=with_counts, raw=raw))
    want = list(jds.eval_batches(3, pad_final=pad_final, with_counts=with_counts, raw=raw))
    # frames (40,60), (40,60), (36,50), (40,60): the change of shape flushes
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        if with_counts:
            assert g[2] == w[2]
        _equal_items(g[:2], w[:2])
    for g, w in zip(tds.eval_items(raw=raw), jds.eval_items(raw=raw)):
        _equal_items(g, w)


# -- the loader --------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_stream(roots):
    jds, tds = _datasets(roots["cityscapes"], "cityscapes", scales=(0.5, 1.5))
    return tds, list(jax_pipeline.superbatch_iterator(jds, 2, 2, 4, seed=7, n_jobs=1))


@pytest.mark.parametrize("n_jobs,mode,start", [(1, "thread", 0), (3, "thread", 0),
                                               (2, "process", 0), (1, "thread", 2),
                                               (3, "thread", 3)])
def test_superbatch_iterator_matches_jax_stream(jax_stream, n_jobs, mode, start):
    tds, want = jax_stream
    assert pipeline.sample_seed(7, 11) == jax_pipeline.sample_seed(7, 11)
    got = list(pipeline.superbatch_iterator(tds, 2, 2, 4, seed=7, n_jobs=n_jobs,
                                            start_window=start, mode=mode))
    assert len(got) == 4 - start
    for g, w in zip(got, want[start:]):
        assert g[0].shape == (2, 2, 33, 33, 3) and g[1].shape == (2, 2, 33, 33)
        _equal_items(g, w)


def test_batch_loader_close_releases_an_abandoned_loader(jax_stream):
    tds, want = jax_stream
    loader = pipeline.BatchLoader(
        pipeline.superbatch_iterator(tds, 2, 2, 1000, seed=7, n_jobs=2), prefetch=2)
    first = next(iter(loader))
    _equal_items(first, want[0])
    time.sleep(0.2)          # the worker fills the queue and blocks on put
    t0 = time.perf_counter()
    loader.close()
    assert time.perf_counter() - t0 < 10
    assert not loader._thread.is_alive()
    assert threading.active_count() < 50


def test_device_prefetch_on_the_cpu(jax_stream):
    _, want = jax_stream
    items = [(img, lab, {"window": i}) for i, (img, lab) in enumerate(want)]
    out = list(pipeline.device_prefetch(iter(items), depth=2, device="cpu"))
    assert len(out) == len(items)
    for (img, lab, meta), (wi, wl, wm) in zip(out, items):
        assert meta == wm and img.device.type == "cpu"
        np.testing.assert_array_equal(img.numpy(), wi)
        np.testing.assert_array_equal(lab.numpy(), wl)
    cast = list(pipeline.device_prefetch(
        iter(want), depth=1, device="cpu", dtypes=(torch.bfloat16, torch.uint8)))
    for (img, lab), (wi, wl) in zip(cast, want):
        assert img.dtype == torch.bfloat16 and lab.dtype == torch.uint8
        assert torch.equal(img, torch.from_numpy(wi).to(torch.bfloat16))
        np.testing.assert_array_equal(lab.numpy(), wl)



class _Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


def test_device_prefetch_never_stages_two_leaves_of_an_item_in_one_buffer():
    """Two leaves of one shape and dtype (U-Noise's raw images and masks)
    need two pinned buffers: the first leaf's slot is not free for the
    second until the item's copy event is recorded, whatever its old
    event says."""
    a, b = ["a", None], ["b", _Event(False)]
    assert pipeline._free_slot([a, b], []) is a
    assert pipeline._free_slot([a, b], [a]) is None   # b's last copy is pending
    b[1] = _Event(True)
    assert pipeline._free_slot([a, b], [a]) is b
    a[1] = _Event(True)
    assert pipeline._free_slot([a, b], [b, a]) is None

# -- wire dtypes -------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(compute_dtype="bfloat16"),
                                dict(wire_uint8=True),
                                dict(wire_uint8=True, compute_dtype="bfloat16")])
@pytest.mark.parametrize("experiment", ["cityscapes_kld_imnet", "cells"])
def test_ship_dtypes_and_wire_uint8_match_jax(kw, experiment):
    import dataclasses

    from adlm_tpu.core.config import get_experiment as jax_experiment

    jcfg, pcfg = jax_experiment(experiment), tcfg.get_experiment(experiment)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, **kw))
    pcfg = dataclasses.replace(pcfg, train=dataclasses.replace(pcfg.train, **kw))
    if pcfg.train.wire_uint8 and pcfg.data.cells:
        with pytest.raises(ValueError, match="cells"):
            train_pipeline.ship_dtypes(pcfg)
        return
    got = [str(d).replace("torch.", "") for d in train_pipeline.ship_dtypes(pcfg)]
    assert got == [np.dtype(d).name for d in jax_train_pipeline.ship_dtypes(jcfg)]
    rng = np.random.RandomState(5)
    images = ((rng.rand(2, 9, 9, 3) - np.asarray(MEAN)) / np.asarray(STD)).astype(np.float32)
    np.testing.assert_array_equal(train_pipeline.wire_uint8_images(images, MEAN, STD),
                                  jax_train_pipeline.wire_uint8_images(images, MEAN, STD))
