"""PyTorch port, the artifacts: ``adlm_tpu_torch.interpret.visualize``,
``analysis._denorm`` and the artifact passes of push and the nearest
scan against the JAX package.

* ``upsample_cubic`` against ``jax.image.resize(method="cubic")``:
  within 1e-6 on [0, 1] maps, non-square maps and factors up to ~6.
  At larger factors JAX's own f32 contraction strays further from the
  exact contraction of its weights than the port's does (checked below
  against float64), so there the port is held to JAX's own error.
* PNG files: the port writes them with zlib; PIL (a dependency of the
  tests and the JAX package, not of the port) decodes both packages'
  files.  PNG arrays equal within 1 count of
  uint8 (the cubic resize rounds differently in the last bits), boxes,
  ``.npy`` files and the file tree equal.
* The push's artifact pass, batched and sequential, and
  ``save_nearest_artifacts`` on the shared-weight model pair
  (test_torch_push.py).
"""

import os

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp

from adlm_tpu.interpret import analysis as jax_analysis
from adlm_tpu.interpret import nearest as jax_nearest
from adlm_tpu.interpret import push as jax_push
from adlm_tpu.interpret import visualize as jax_vz

from adlm_tpu_torch.interpret import analysis as port_analysis
from adlm_tpu_torch.interpret import nearest as port_nearest
from adlm_tpu_torch.interpret import push as port_push
from adlm_tpu_torch.interpret import visualize as port_vz
from adlm_tpu_torch.models.ppnet import default_proto_class

from test_torch_push import P, K, jax_pc, make_data, model_pair

QUIET = dict(log=lambda *_: None)


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def assert_trees_match(got_dir, want_dir):
    """The same files; .npy equal (floats within 1e-5), PNG pixels
    within 1 count of uint8."""
    files = tree(want_dir)
    assert tree(got_dir) == files
    assert any(f.endswith(".png") for f in files)
    for rel in files:
        a, b = os.path.join(got_dir, rel), os.path.join(want_dir, rel)
        if rel.endswith(".png"):
            pa, pb = (np.asarray(Image.open(p)).astype(int) for p in (a, b))
            assert pa.shape == pb.shape, rel
            assert np.abs(pa - pb).max(initial=0) <= 1, rel
        elif rel.endswith(".npy"):
            na, nb = np.load(a), np.load(b)
            if np.issubdtype(nb.dtype, np.floating):
                np.testing.assert_allclose(na, nb, rtol=1e-5, atol=1e-5, err_msg=rel)
            else:
                np.testing.assert_array_equal(na, nb, err_msg=rel)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("src,size", [((5, 7), (33, 47)), ((7, 5), (41, 57)),
                                      ((13, 9), (65, 33)), ((5, 5), (33, 33)),
                                      ((17, 11), (17, 40)), ((40, 30), (17, 11))])
def test_upsample_cubic_matches_jax(src, size):
    x = np.random.RandomState(sum(src)).rand(*src).astype(np.float32)
    got = port_vz.upsample_cubic(x, size)
    want = np.asarray(jax.image.resize(x, size, method="cubic"))
    assert got.dtype == np.float32 and got.shape == size
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,size", [((9, 13), (65, 97)), ((9, 17), (257, 513))])
def test_upsample_cubic_large_factors_within_jax_error(src, size):
    """At ×7 and more, compare both with the float64 contraction of
    JAX's weights: the port is no further from it than JAX's own f32
    result, and within 3e-6 of JAX.  The weights are equal for inputs
    under 16 wide; from 16 on, XLA sums a column's taps in an order not
    reproduced here, and they are within 1 ulp."""
    from jax._src.image import scale as jax_scale

    x = np.random.RandomState(sum(src)).rand(*src).astype(np.float32)
    weights = [np.asarray(jax.jit(lambda s, t, m=m, n=n: jax_scale.compute_weight_mat(
        m, n, s, t, jax_scale._fill_keys_cubic_kernel, True))(
            jnp.float32(n / m), jnp.float32(0.0))) for m, n in zip(src, size)]
    for m, n, w in zip(src, size, weights):
        np.testing.assert_allclose(port_vz._cubic_weights(m, n), w, rtol=0,
                                   atol=0 if m < 16 else 1.2e-7)
    exact = weights[0].T.astype(np.float64) @ x @ weights[1].astype(np.float64)
    got = port_vz.upsample_cubic(x, size)
    want = np.asarray(jax.image.resize(x, size, method="cubic"))
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-6)


def test_png_files_decode_with_pil(tmp_path):
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (13, 29, 3)).astype(np.uint8)
    grey = rng.randint(0, 256, (7, 5)).astype(np.uint8)
    port_vz.write_png(str(tmp_path / "rgb.png"), rgb)
    port_vz.write_png(str(tmp_path / "grey.png"), grey)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "rgb.png")), rgb)
    assert Image.open(tmp_path / "rgb.png").mode == "RGB"
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "grey.png")), grey)
    with pytest.raises(ValueError):
        port_vz.write_png(str(tmp_path / "bad.png"), np.zeros((4, 4, 2), np.uint8))


def test_helpers_match_jax():
    rng = np.random.RandomState(1)
    x = rng.rand(6, 9) * 1.4 - 0.2
    np.testing.assert_array_equal(port_vz.jet_colormap(x), jax_vz.jet_colormap(x))
    act = rng.rand(40, 50)
    thr = np.percentile(act, 95)
    for box in [(10, 13, 20, 23), (0, 3, 0, 3), (37, 40, 47, 50)]:
        assert (port_vz.grow_high_activation_box(act, box, thr)
                == jax_vz.grow_high_activation_box(act, box, thr))
    assert port_vz.high_activation_crop(act) == jax_vz.high_activation_crop(act)
    np.testing.assert_array_equal(port_vz.normalize01(act), jax_vz.normalize01(act))
    np.testing.assert_array_equal(port_vz.normalize01(np.ones(3)), np.zeros(3))
    img = rng.randn(5, 6, 3).astype(np.float32)
    for cells in (False, True):
        np.testing.assert_array_equal(port_analysis._denorm(img, cells=cells),
                                      jax_analysis._denorm(img, cells=cells))

    class Data:
        mean, std, cells = (0.4, 0.5, 0.45), (0.2, 0.25, 0.3), False

    np.testing.assert_array_equal(port_analysis.make_denorm(Data)(img),
                                  jax_analysis.make_denorm(Data)(img))


@pytest.mark.parametrize("activation", ["log", "linear"])
def test_save_prototype_artifacts_matches_jax(tmp_path, activation):
    """The same numpy image, label and f32 distance map: the same grown
    bound box, file tree, activation array and PNG pixels (±1)."""
    rng = np.random.RandomState(2)
    image = rng.rand(65, 97, 3).astype(np.float32)
    label = rng.randint(0, 4, (65, 97))
    dist_map = (rng.rand(9, 13) * 5).astype(np.float32)
    kw = dict(proto_idx=3, image=image, label=label, dist_map=dist_map,
              rf_box=(21, 29, 37, 45), target_class=1, class_names={1: "road"},
              activation=activation)
    want = jax_vz.save_prototype_artifacts(run_dir=str(tmp_path / "jax"), **kw)
    got = port_vz.save_prototype_artifacts(run_dir=str(tmp_path / "port"), **kw)
    assert got == want
    assert_trees_match(tmp_path / "port", tmp_path / "jax")


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=41)


def test_push_visualizations_match_jax_and_batched_matches_sequential(pair, tmp_path):
    """The port's batched artifact pass (winners re-forwarded) writes the
    tree of its batch_size=1 pass, and both match JAX's."""
    jm, params, constants, port = pair
    data = make_data(25, n=4)
    kw = dict(dedup=False, save_visualizations=True, **QUIET)
    want = jax_push.push_prototypes(jm, params, constants, jax_pc(), data, K,
                                    run_dir=str(tmp_path / "jax"), **kw)
    runs = {}
    for bs in (1, 2):
        runs[bs] = port_push.push_prototypes(
            port(), default_proto_class(P, K), data, K, run_dir=str(tmp_path / f"port{bs}"),
            batch_size=bs, get_item=lambda i: data[i], device="cpu", **kw)
        np.testing.assert_array_equal(runs[bs][2]["proto_bound_boxes"],
                                      want[2]["proto_bound_boxes"])
        assert_trees_match(tmp_path / f"port{bs}", tmp_path / "jax")
    assert tree(tmp_path / "port1") == tree(tmp_path / "port2")
    np.testing.assert_array_equal(np.load(tmp_path / "port1" / "bb.npy"),
                                  np.load(tmp_path / "port2" / "bb.npy"))
    # the grown boxes differ from the receptive-field boxes somewhere
    info = runs[2][2]
    assert (info["proto_bound_boxes"] != info["proto_rf_boxes"]).any()


def test_save_nearest_artifacts_matches_jax(pair, tmp_path):
    jm, params, constants, port = pair
    data = make_data(27, n=3)
    ids, info = jax_nearest.find_k_nearest_patches(jm, params, constants, jax_pc(),
                                                   data, K, k=2, return_info=True)
    jax_nearest.save_nearest_artifacts(jm, params, constants, jax_pc(), lambda i: data[i],
                                       ids, info, str(tmp_path / "jax"))
    port_nearest.save_nearest_artifacts(port(), default_proto_class(P, K),
                                        lambda i: data[i], ids, info,
                                        str(tmp_path / "port"), device="cpu")
    assert_trees_match(tmp_path / "port", tmp_path / "jax")
    # global_analysis with full_save writes the same set
    port_analysis.global_analysis(port(), default_proto_class(P, K), data, K, k=2,
                                  save_dir=str(tmp_path / "global"), full_save=True,
                                  get_item=lambda i: data[i], device="cpu")
    assert_trees_match(tmp_path / "global", tmp_path / "jax")
