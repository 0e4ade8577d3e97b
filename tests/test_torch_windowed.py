"""PyTorch port, windowed eval: ``adlm_tpu_torch.interpret.windowed``
against ``adlm_tpu.interpret.windowed`` on shared weights.

The cases of tests/test_windowed.py, each run through both packages on
the smoke geometry (6 prototypes x 8 channels, 3 classes, blocks
(1,1,1,1); 96x128 images, 65² windows), with the port's own
invariants beside them, plus the port's fused driver against its
per-window driver.  Budgets, those of test_torch_evaluate.py:

* counters (I/U/correct) within ``TIE_BUDGET`` pixels (XLA and PyTorch
  sum in other orders, which may flip an argmax between near-equal
  logits); ``total`` exactly;
* ``agree_counts`` within 2·``TIE_BUDGET``; ``topk_purity`` atol 1e-3;
* stitched logits within the model-logits ``ATOL`` of
  test_torch_models.py.

Inside the port, the drivers (fused, per-window with a device canvas,
per-window with a host canvas, deferred sync) are held to each other
exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adlm_tpu.interpret import windowed as jax_win
from adlm_tpu.interpret.stats import ProtoStatsAccumulator as JaxAccumulator
from adlm_tpu.models.ppnet import default_proto_class as jax_proto_class
from adlm_tpu.ops.resize import resize_bilinear as jax_resize

from adlm_tpu_torch.interpret import evaluate as port_eval
from adlm_tpu_torch.interpret import windowed as win
from adlm_tpu_torch.interpret.stats import ProtoStatsAccumulator
from adlm_tpu_torch.models.ppnet import default_proto_class

from test_torch_evaluate import TIE_BUDGET
from test_torch_models import ATOL, jax_pair

P, K = 6, 3
SMOKE = dict(num_prototypes=P, num_classes=K, prototype_channels=8,
             deeplab_n_features=8, deeplab_n_blocks=(1, 1, 1, 1))
MEAN_STD = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
WIN = (65, 65)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny convs run op by op: one torch thread per test worker."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def pair():
    """(JAX PPNet, params, constants, port PPNet, JAX proto_class, port
    proto_class): one set of weights for every case."""
    jm, params, constants, tm = jax_pair(seed=31, **SMOKE)
    return jm, params, constants, tm, jax_proto_class(P, K), default_proto_class(P, K)


def _data(seed, B=2, H=96, W=128, raw=False, label_hw=None):
    rng = np.random.RandomState(seed)
    images = (rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8) if raw
              else rng.rand(B, H, W, 3).astype(np.float32))
    labels = rng.randint(0, K + 1, size=(B,) + (label_hw or (H, W))).astype(np.int32)
    return images, labels


def _jax_update(pair, images, labels, **kw):
    jm, params, constants, _, jpc, _ = pair
    ev = jax_win.WindowedSegEvaluator(jm, K, kw.pop("window", WIN), **kw)
    return ev, ev.update(params, constants, jpc, images, labels)


def _port_update(pair, images, labels, **kw):
    tm, pc = pair[3], pair[5]
    ev = win.WindowedSegEvaluator(tm, K, kw.pop("window", WIN), device="cpu", **kw)
    return ev, ev.update(pc, images, labels)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _counters_close(got_ev, want_ev):
    assert got_ev.total == want_ev.total
    assert abs(got_ev.correct - want_ev.correct) <= TIE_BUDGET
    for key in ("intersection", "union"):
        diff = np.abs(getattr(got_ev, key) - np.asarray(getattr(want_ev, key)))
        assert diff.sum() <= TIE_BUDGET, (key, getattr(got_ev, key), getattr(want_ev, key))


def _stats_close(got, want):
    assert got["stat_windows"] == want["stat_windows"]
    diff = np.abs(_np(got["agree_counts"]).astype(np.int64)
                  - np.asarray(want["agree_counts"]))
    assert diff.sum() <= 2 * TIE_BUDGET
    np.testing.assert_allclose(_np(got["topk_purity"]), np.asarray(want["topk_purity"]),
                               atol=1e-3)


def _same_outputs(a, b):
    """Two port runs with statistics, exactly."""
    for k in ("pred", "intersection", "union", "correct", "total", "agree_counts",
              "topk_purity", "stat_pred", "nearest_proto"):
        np.testing.assert_array_equal(_np(a[k]), _np(b[k]), err_msg=k)


def test_window_grid_covers_everything():
    for size, window, stride in [(100, 33, 25), (33, 33, 25), (20, 33, 25),
                                 (1024, 513, 385), (2048, 513, 384)]:
        starts = win._window_grid(size, window, stride)
        assert starts == jax_win._window_grid(size, window, stride)
        covered = np.zeros(size, bool)
        for s in starts:
            covered[s:s + window] = True
        assert covered.all(), (size, window, stride)
        assert starts[0] == 0
        if size > window:
            assert starts[-1] == size - window
    assert win._strides((513, 513), 0.25) == jax_win._strides((513, 513), 0.25)
    # the flagship's 1024x2048 frame in 513² windows: a 3 x 5 grid
    assert len(win.window_offsets(1024, 2048, (513, 513), 0.25)) == 15
    assert win._grid_extent((513, 513), 513, 513, 65, 65) == (65, 65)


def test_windowed_matches_jax_and_whole_image_in_interior(pair):
    jm, params, constants, tm, _, _ = pair
    image, _ = _data(0, B=1)
    want = jax_win.make_windowed_inference_fn(jm, WIN, overlap=0.5)(
        params, constants, jnp.asarray(image))
    got = win.make_windowed_inference_fn(tm, WIN, overlap=0.5, device="cpu")(image)
    assert got.shape == want.shape == (1, 96, 128, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)

    # whole-image logits upsampled to the pixel grid: the interiors agree
    logits, _ = jm.apply({"params": params, "constants": constants},
                         jnp.asarray(image), train=False, return_distances=False)
    whole = np.asarray(jax_resize(logits, (96, 128)))
    pa = np.argmax(whole[0, 16:-16, 16:-16], -1)
    pb = np.argmax(got.numpy()[0, 16:-16, 16:-16], -1)
    assert np.mean(pa == pb) > 0.85


def test_windowed_handles_image_smaller_than_window(pair):
    jm, params, constants, tm, _, _ = pair
    image, _ = _data(1, B=1, H=40, W=50)
    got = win.make_windowed_inference_fn(tm, WIN, device="cpu")(image)
    want = jax_win.make_windowed_inference_fn(jm, WIN)(params, constants, jnp.asarray(image))
    assert got.shape == (1, 40, 50, K)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_windowed_stats_accumulates_like_jax(pair):
    """Grid stat maps per window, a window-mean purity per image; the
    accumulator counts each image once, and the device agreement counts
    equal the map-derived bincount exactly."""
    images, labels = _data(2)
    jev, want = _jax_update(pair, images, labels, with_stats=True, n_random_pixels=20)
    pev, got = _port_update(pair, images, labels, with_stats=True, n_random_pixels=20)
    assert got["stat_windows"] == 6  # 2 x 3 windows over 96x128 at overlap 0.25
    assert got["stat_pred"].shape[0] == 2 * 6
    assert got["topk_purity"].shape == (2, P)
    _counters_close(pev, jev)
    _stats_close(got, want)
    assert (_np(got["stat_pred"]) == np.asarray(want["stat_pred"])).mean() >= 0.99

    acc = ProtoStatsAccumulator(P, K, pair[5])
    acc.update(got["stat_pred"], got["nearest_proto"], topk_purity=got["topk_purity"],
               n_images=2)
    res = acc.results()
    assert acc.n_images == 2 and res["nearest_proto_counts"].sum() > 0
    assert np.all((res["mean_top_k_purity"] >= 0) & (res["mean_top_k_purity"] <= 100 + 1e-6))
    # purity at K = P is protos_per_class / P · 100 with equal shares
    np.testing.assert_allclose(res["mean_top_k_purity"][-1], 100.0 * 2 / 6, atol=1e-4)
    acc2 = ProtoStatsAccumulator(P, K, pair[5])
    acc2.update_counts(got["agree_counts"], got["topk_purity"], n_images=2)
    np.testing.assert_array_equal(acc2.results()["nearest_proto_counts"],
                                  res["nearest_proto_counts"])
    jacc = JaxAccumulator(P, K, np.asarray(pair[4]))
    jacc.update_counts(np.asarray(want["agree_counts"]), np.asarray(want["topk_purity"]))
    assert np.abs(acc2.results()["nearest_proto_counts"]
                  - jacc.results()["nearest_proto_counts"]).sum() <= 2 * TIE_BUDGET


def test_windowed_device_stitch_matches_host_stitch(pair):
    """The device canvas against the host canvas (and the JAX package's
    host stitching): counters, pred and statistics; then the auto rule
    with labels larger than the image (the resize branch)."""
    images, labels = _data(9)
    kw = dict(with_stats=True, n_random_pixels=8, fused=False)
    jev, want = _jax_update(pair, images, labels, device_stitch=False, **kw)
    host_ev, host = _port_update(pair, images, labels, device_stitch=False, **kw)
    dev_ev, dev = _port_update(pair, images, labels, device_stitch=True, **kw)
    _same_outputs(host, dev)
    assert host_ev.results() == dev_ev.results()
    _counters_close(host_ev, jev)
    _stats_close(host, want)

    image, _ = _data(10, B=1)
    big = np.random.RandomState(11).randint(0, K + 1, size=(1, 120, 160))
    auto_ev, auto = _port_update(pair, image, big)
    ref_ev, ref = _port_update(pair, image, big, device_stitch=False, fused=False)
    np.testing.assert_array_equal(_np(auto["pred"]), _np(ref["pred"]))
    assert auto["pred"].shape == (1, 120, 160)
    assert auto_ev.results() == ref_ev.results()
    jev2, _ = _jax_update(pair, image, big, device_stitch=False)
    _counters_close(auto_ev, jev2)


def test_windowed_stats_single_window_equals_whole_image(pair):
    """One window covering the whole image: the stat maps equal
    make_inference_fn's grid maps (same forward) in the port, and the
    JAX package's within the tie budget."""
    images, labels = _data(5, B=1, H=64, W=64)
    _, got = _port_update(pair, images, labels, window=(64, 64), with_stats=True,
                          n_random_pixels=16)
    assert got["stat_windows"] == 1
    zeros = np.zeros((1, 16), np.float32)
    ref = port_eval.make_inference_fn(pair[3], K, with_stats=True, device="cpu")(
        pair[5], images, labels, zeros, zeros)
    np.testing.assert_array_equal(got["stat_pred"].numpy(), ref["stat_pred"].numpy())
    np.testing.assert_array_equal(got["nearest_proto"].numpy(), ref["nearest_proto"].numpy())
    _, want = _jax_update(pair, images, labels, window=(64, 64), with_stats=True,
                          n_random_pixels=16)
    assert (got["stat_pred"].numpy() == np.asarray(want["stat_pred"])).mean() >= 0.99


def test_windowed_raw_uint8_matches_f32_and_whole_image(pair):
    """Raw uint8 windows normalized on the device equal host-normalized
    f32 windows exactly (counters, pred, stat maps); one frame-sized
    window equals the whole-image raw SegEvaluator; both against JAX."""
    raw, labels = _data(7, B=1, raw=True)
    mean, std = (np.asarray(m, np.float32) for m in MEAN_STD)
    f32 = (raw.astype(np.float32) / 255.0 - mean) / std
    kw = dict(with_stats=True, n_random_pixels=16)
    a_ev, a = _port_update(pair, f32, labels, **kw)
    b_ev, b = _port_update(pair, raw, labels, normalize=MEAN_STD, **kw)
    _same_outputs(a, b)
    np.testing.assert_array_equal(a_ev.intersection, b_ev.intersection)
    np.testing.assert_array_equal(a_ev.union, b_ev.union)
    jev, want = _jax_update(pair, raw, labels, normalize=MEAN_STD, **kw)
    _counters_close(b_ev, jev)
    _stats_close(b, want)

    w_ev, w = _port_update(pair, raw, labels, window=(96, 128), normalize=MEAN_STD)
    whole = port_eval.SegEvaluator(pair[3], K, normalize=MEAN_STD, device="cpu")
    ref = whole.update(pair[5], raw, labels)
    np.testing.assert_array_equal(w["pred"].numpy(), ref["pred"].numpy())
    np.testing.assert_array_equal(w_ev.intersection, whole.intersection)


def test_windowed_stats_exclude_pad_cells(pair):
    """An image smaller than the window: grid cells over padding only
    get stat_pred = -1; the valid cells equal the whole-image stats of
    the zero-padded image; the accumulator ignores the -1 cells."""
    images, labels = _data(9, B=1, H=40, W=50)
    _, out = _port_update(pair, images, labels, with_stats=True, n_random_pixels=16)
    assert out["stat_windows"] == 1
    sp = out["stat_pred"][0].numpy()
    gh, gw = sp.shape
    vgh, vgw = win._grid_extent(WIN, 40, 50, gh, gw)
    assert vgh < gh and vgw < gw  # the case under test exists
    assert (sp[vgh:, :] == -1).all() and (sp[:, vgw:] == -1).all()
    assert (sp[:vgh, :vgw] >= 0).all()
    padded = np.zeros((1,) + WIN + (3,), np.float32)
    padded[:, :40, :50] = images
    uv = np.zeros((1, 16), np.float32)
    ref = port_eval.make_inference_fn(pair[3], K, with_stats=True, device="cpu")(
        pair[5], padded, np.zeros((1,) + WIN, np.int32), uv, uv)
    np.testing.assert_array_equal(sp[:vgh, :vgw], ref["stat_pred"][0, :vgh, :vgw].numpy())
    np.testing.assert_array_equal(out["nearest_proto"][0, :vgh, :vgw].numpy(),
                                  ref["nearest_proto"][0, :vgh, :vgw].numpy())
    a = ProtoStatsAccumulator(P, K, pair[5])
    a.update(out["stat_pred"], out["nearest_proto"], topk_purity=out["topk_purity"],
             n_images=1)
    b = ProtoStatsAccumulator(P, K, pair[5])
    b.update(out["stat_pred"][:, :vgh, :vgw], out["nearest_proto"][:, :vgh, :vgw],
             topk_purity=out["topk_purity"], n_images=1)
    np.testing.assert_array_equal(a.results()["nearest_proto_counts"],
                                  b.results()["nearest_proto_counts"])
    _, want = _jax_update(pair, images, labels, with_stats=True, n_random_pixels=16)
    np.testing.assert_array_equal(sp == -1, np.asarray(want["stat_pred"])[0] == -1)
    _stats_close(out, want)


def test_windowed_defer_sync_counters_identical(pair):
    """defer_sync queues the packed counters and statistics on the
    device and drains them in one fetch: the same results as the
    synchronous driver, and JAX's within the budgets."""
    data = [_data(11 + i, B=1) for i in range(3)]
    kw = dict(with_stats=True, n_random_pixels=8, fused=True, window_batch=4)
    sync = win.WindowedSegEvaluator(pair[3], K, WIN, device="cpu", **kw)
    defer = win.WindowedSegEvaluator(pair[3], K, WIN, device="cpu", defer_sync=True, **kw)
    jsync = jax_win.WindowedSegEvaluator(pair[0], K, WIN, window_batch=3, defer_sync=True,
                                         **{k: v for k, v in kw.items() if k != "window_batch"})
    sync_stats = []
    for img, lab in data:
        o = sync.update(pair[5], img, lab)
        sync_stats.append((o["topk_purity"].numpy(), o["agree_counts"].numpy(),
                           o["stat_windows"]))
        defer.update(pair[5], img, lab)
        jsync.update(pair[1], pair[2], pair[4], img, lab)
    assert len(defer._pending) == 3
    defer_stats = defer.drain()
    assert not defer._pending
    assert sync.results() == defer.results()
    for (ts, as_, ns), (td, ad, nd) in zip(sync_stats, defer_stats):
        np.testing.assert_array_equal(ts, td)
        np.testing.assert_array_equal(as_, ad)
        assert ns == nd == 6
    jstats = jsync.drain()
    _counters_close(defer, jsync)
    for (td, ad, _), (tj, aj, _) in zip(defer_stats, jstats):
        np.testing.assert_allclose(td, tj, atol=1e-3)
        assert np.abs(ad - aj).sum() <= 2 * TIE_BUDGET

    # results() drains what is still queued
    d2 = win.WindowedSegEvaluator(pair[3], K, WIN, device="cpu", defer_sync=True)
    s2 = win.WindowedSegEvaluator(pair[3], K, WIN, device="cpu")
    d2.update(pair[5], *data[0])
    s2.update(pair[5], *data[0])
    assert d2.results() == s2.results()


def test_fused_driver_matches_per_window_driver(pair):
    """The fused driver (4 windows per forward, the last chunk of 2
    short) against the per-window driver with a device canvas: the same
    counters, pred, statistics and stat maps."""
    images, labels = _data(13, raw=True)
    kw = dict(with_stats=True, n_random_pixels=8, normalize=MEAN_STD)
    f_ev, f = _port_update(pair, images, labels, fused=True, window_batch=4, **kw)
    w_ev, w = _port_update(pair, images, labels, fused=False, device_stitch=True, **kw)
    assert f["stat_windows"] == w["stat_windows"] == 6
    _same_outputs(f, w)
    assert f_ev.results() == w_ev.results()
    assert (f_ev.correct, f_ev.total) == (w_ev.correct, w_ev.total)
