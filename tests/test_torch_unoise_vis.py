"""PyTorch port, U-Noise interpretation and figures:
``adlm_tpu_torch.interpret.unoise_vis`` and ``interpret.figures`` against
the JAX package's, on shared random weights (``unet_state_dict_from_jax``).

Tolerances (f32, XLA's CPU convs against PyTorch's):

* ``unoise_importance``: atol ``ATOL`` = 1e-5 (a sigmoid of logits that
  agree within 1e-4);
* ``grad_cam``: atol ``CAM_ATOL`` = 1e-4 (a max-normalized map);
* occlusion, both sweeps, the coverage curve and dice@median: dice
  values within ``DICE_ATOL`` = 1e-6.  A pixel flips where a logit lies
  within rounding of the threshold 0, so the utility model's head is
  scaled by ``HEAD_GAIN`` (its random logits sit near 1e-2 otherwise),
  and the test asserts that no logit of its unmasked inputs lies within
  ``NEAR_ZERO`` = 1e-3 of 0;
* the results pickle: read back by the other package exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adlm_tpu.interpret import figures as jfig
from adlm_tpu.interpret import unoise_vis as jvis

from adlm_tpu_torch.interpret import figures as tfig
from adlm_tpu_torch.interpret import unoise_vis as tvis

from test_torch_unet import port_unet, random_unet_variables

ATOL = 1e-5
CAM_ATOL = 1e-4
DICE_ATOL = 1e-6
NEAR_ZERO = 1e-3
HEAD_GAIN = 300.0
HW = 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def nets():
    """(JAX model, its variables, the port's model) for the utility and
    the noise U-Net."""
    out = {}
    for name, (depth, cf, seed) in {"util": (3, 2, 21), "noise": (2, 2, 22)}.items():
        jm, params, bs = random_unet_variables(depth, cf, seed)
        if name == "util":
            params["head"] = {k: w * HEAD_GAIN for k, w in params["head"].items()}
        out[name] = (jm, {"params": params, "batch_stats": bs},
                     port_unet(depth, cf, params, bs).eval())
    return out


def _data(seed, n=4):
    r = np.random.RandomState(seed)
    x = (r.rand(n, HW, HW, 3).astype(np.float32) - 0.4) * 3
    y = (r.rand(n, HW, HW, 1) > 0.5).astype(np.float32)
    return x, y


def _assert_no_near_ties(nets, x):
    jm, v, _ = nets["util"]
    logits = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    assert np.abs(logits).min() > NEAR_ZERO


def test_unoise_importance_matches_jax(nets):
    jm, v, model = nets["noise"]
    x, _ = _data(0)
    got = tvis.unoise_importance(model, torch.from_numpy(x))
    want = jvis.unoise_importance(jm, v, jnp.asarray(x))
    assert got.shape == want.shape == (4, HW, HW, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("px", [(8, 8), (3, 12)])
def test_grad_cam_matches_jax(nets, px):
    jm, v, model = nets["util"]
    x, _ = _data(1, n=1)
    got = tvis.grad_cam(model, torch.from_numpy(x), x=px[1], y=px[0])
    want = jvis.grad_cam(jm, v, jnp.asarray(x), x=px[1], y=px[0])
    assert got.shape == want.shape == (HW // 4, HW // 4)
    np.testing.assert_allclose(got, want, atol=CAM_ATOL)
    assert got.max() == pytest.approx(1.0) or got.max() == 0.0


@pytest.mark.parametrize("patch,stride,chunk", [(5, 3, 4), (4, 4, 64)])
def test_occlusion_matches_jax(nets, patch, stride, chunk):
    jm, v, model = nets["util"]
    x, y = _data(2, n=2)
    _assert_no_near_ties(nets, x)
    got = tvis.occlusion_sensitivity(model, torch.from_numpy(x), torch.from_numpy(y),
                                     patch=patch, stride=stride, chunk=chunk)
    want = jvis.occlusion_sensitivity(jm, v, jnp.asarray(x), jnp.asarray(y),
                                      patch=patch, stride=stride)
    n = (HW - patch) // stride + 1
    assert got.shape == want.shape == (2, n, n)
    np.testing.assert_allclose(got, want, atol=DICE_ATOL)


def _predicts(nets):
    jm, v, model = nets["util"]
    return (tfig.make_predict(model),
            jax.jit(lambda im: jm.apply(v, im, train=False)), jm, v)


def test_threshold_sweeps_match_jax(nets):
    tpred, jpred, jm, v = _predicts(nets)
    x, y = _data(3, n=5)
    _assert_no_near_ties(nets, x)
    imp = tvis.unoise_importance(nets["noise"][2], torch.from_numpy(x))
    want = jfig.threshold_sweep(jpred, imp, x, y, batch_size=2)
    host = tfig.threshold_sweep(tpred, imp, x, y, batch_size=2)
    dev = tfig.device_threshold_sweep(tpred, imp, x, y, batch_size=2, chunk=5,
                                     device="cpu")
    jdev = jfig.device_threshold_sweep(jm, v, imp, x, y, batch_size=2)
    for got in (host, dev):
        assert got[2] == want[2] and len(got[0]) == 21
        np.testing.assert_allclose(got[0], want[0], atol=DICE_ATOL)
        np.testing.assert_allclose(got[1], want[1], atol=DICE_ATOL)
    np.testing.assert_allclose(dev[0], jdev[0], atol=DICE_ATOL)


def test_dice_at_median_and_coverage_curve_match_jax(nets):
    tpred, jpred, jm, v = _predicts(nets)
    x, y = _data(4, n=3)
    _assert_no_near_ties(nets, x)
    imp = tvis.unoise_importance(nets["noise"][2], torch.from_numpy(x))
    got = tfig.dice_at_median_importance(tpred, imp, x, y, batch_size=2)
    want = jfig.dice_at_median_importance(jpred, imp, x, y, batch_size=2)
    assert got == pytest.approx(want, abs=DICE_ATOL)
    curve = tfig.coverage_dice_curve(tpred, imp, x, y, coverages=(0.25, 0.5, 1.0))
    jcurve = jfig.coverage_dice_curve(jm, v, imp, jnp.asarray(x), jnp.asarray(y),
                                      coverages=(0.25, 0.5, 1.0))
    np.testing.assert_allclose(curve, jcurve, atol=DICE_ATOL)


def test_median_is_the_lower_middle_element():
    """An even count: ``torch.median``'s lower middle, not numpy's mean."""
    imp = np.array([0.1, 0.2, 0.3, 0.4], np.float32).reshape(1, 2, 2, 1)
    images = np.ones((1, 2, 2, 3), np.float32)
    seen = []

    def predict(im):
        seen.append(np.asarray(im)[0, :, :, 0])
        return torch.zeros(1, 1, 2, 2)

    tfig.dice_at_median_importance(predict, imp, images, np.ones((1, 2, 2, 1)))
    np.testing.assert_array_equal(seen[0], [[1, 1], [0, 0]])


def test_results_pickle_is_read_by_both(tmp_path):
    results = {"run": {"thresholds": np.linspace(0, 1, 21), "num_params": 1234,
                       "dice": list(np.linspace(0.1, 0.9, 21)),
                       "coverage": list(np.linspace(0, 1, 21)),
                       "dice_at_half_coverage": 0.42}}
    path = str(tmp_path / "sub" / "results.pickle")
    tfig.save_results_pickle(path, results)
    assert jfig.load_results_pickle(path) == tfig.load_results_pickle(path)
    jpath = str(tmp_path / "jax.pickle")
    jfig.save_results_pickle(jpath, results)
    curves, params, at_half = tfig.load_results_pickle(jpath)
    assert params == {"run": 1234} and at_half == {"run": 0.42}
    assert curves["run"][0] == (0.0, pytest.approx(0.1))


def test_plot_curves_writes_where_matplotlib_imports(tmp_path):
    out = str(tmp_path / "curves.png")
    drew = tfig.plot_curves({"a": [(0.1, 0.2), (0.5, 0.6)]}, out, {"a": 10}, {"a": 0.6})
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert drew is False and not os.path.exists(out)
    else:
        assert drew is True and os.path.exists(out)
        assert os.path.exists(out.replace(".png", "_params.png"))


def test_interpretation_timing_counts_each_method():
    calls = {"a": 0}

    def fn():
        calls["a"] += 1
        return np.zeros(1)

    t = tvis.interpretation_timing({"a": fn}, repeats=2)
    assert calls["a"] == 3 and set(t) == {"a"} and t["a"] >= 0.0
