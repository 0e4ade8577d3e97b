"""PyTorch port, the k-nearest scan and purity pruning:
``adlm_tpu_torch.interpret.{nearest,prune,analysis}`` against the JAX
package on shared weights (``model_pair`` of test_torch_push.py: 12
prototypes, 4 classes, 65×97 images with block labels).

* ``_nearest_one_image`` on the same numpy distance map: equal exactly,
  with exact ties in the map (first index wins) and in the box's
  majority vote (first class wins).
* ``find_k_nearest_patches``: ids, image indices and patch positions
  equal, distances rtol 1e-5 (the two packages' convolutions sum in
  other orders); sequential, batched with a padded partial batch,
  ragged shapes and raw uint8.  Tie budget 0, for the reason
  test_torch_push.py gives.
* ``prune_by_purity``: kept and pruned indices, ``prune_info`` and the
  pruned state dict equal; ``global_analysis``'s files equal.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adlm_tpu.interpret import analysis as jax_analysis
from adlm_tpu.interpret import nearest as jax_nearest
from adlm_tpu.interpret import prune as jax_prune

from adlm_tpu_torch.core.config import PPNetConfig
from adlm_tpu_torch.interpret import analysis as port_analysis
from adlm_tpu_torch.interpret import nearest as port_nearest
from adlm_tpu_torch.interpret import prune as port_prune
from adlm_tpu_torch.models.ppnet import PPNet, default_proto_class

from test_torch_models import TINY
from test_torch_push import MEAN_STD, P, K, jax_pc, make_data, model_pair

QUIET = dict(log=lambda *_: None)


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=37)


@pytest.mark.parametrize("H,W,h,w", [(33, 33, 5, 5), (65, 97, 9, 13), (40, 50, 7, 9)])
def test_nearest_one_image_matches_jax(H, W, h, w):
    """Void penalty, first-min ties (values on a coarse grid, a void
    patch band) and the target-else-majority box label, the majority
    vote with ties (two labels per box in equal counts)."""
    rng = np.random.RandomState(H + W)
    d = np.round(rng.rand(h, w, P) * 4).astype(np.float32)     # many exact ties
    y = rng.randint(-1, K, (H, W)).astype(np.int32)
    y[: H // 4] = -1                                           # void rows
    y[H // 2:, ::2] = 0                                        # even columns: ties
    y[H // 2:, 1::2] = 1
    pc = np.arange(P) // (P // K)
    want = jax_nearest._nearest_one_image(jnp.asarray(d), jnp.asarray(y),
                                          jnp.asarray(pc), K)
    got = port_nearest._nearest_one_image(torch.from_numpy(d), torch.from_numpy(y).long(),
                                          torch.from_numpy(pc), K)
    for name, g, wnt in zip(("min", "label", "i", "j"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt), err_msg=name)


def _scan_both(pair, data, **kw):
    jm, params, constants, port = pair
    want = jax_nearest.find_k_nearest_patches(jm, params, constants, jax_pc(), data, K,
                                              return_info=True, **kw)
    got = port_nearest.find_k_nearest_patches(port(), default_proto_class(P, K), data, K,
                                              return_info=True, device="cpu", **kw)
    return want, got


def _assert_scan_equal(want, got):
    (wids, winfo), (gids, ginfo) = want, got
    np.testing.assert_array_equal(gids, wids)
    for key in ("image_idx", "patch_i", "patch_j"):
        np.testing.assert_array_equal(ginfo[key], winfo[key], err_msg=key)
    np.testing.assert_allclose(ginfo["distances"], winfo["distances"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_find_k_nearest_matches_jax(pair, batch_size):
    """k = 3 over five images; batch 2 ends on a partial batch padded
    with its first image."""
    want, got = _scan_both(pair, make_data(13), k=3, batch_size=batch_size)
    _assert_scan_equal(want, got)
    assert (got[1]["image_idx"] >= 0).all()
    ids_only = port_nearest.find_k_nearest_patches(
        pair[3](), default_proto_class(P, K), make_data(13), K, k=3,
        batch_size=batch_size, device="cpu")
    np.testing.assert_array_equal(ids_only, got[0])


def test_find_k_nearest_ragged_and_raw_match_jax(pair):
    """A smaller image mid-stream forces a flush (batch 3), and raw uint8
    images are normalized on the device (batch 2)."""
    rng = np.random.RandomState(17)
    small = (rng.rand(1, 33, 41, 3).astype(np.float32),
             rng.randint(0, K + 1, (1, 33, 41)).astype(np.int32))
    data = make_data(15, n=4)
    ragged = data[:2] + [small] + data[2:]
    _assert_scan_equal(*_scan_both(pair, ragged, k=3, batch_size=3))
    raw = make_data(19, n=3, raw=True)
    _assert_scan_equal(*_scan_both(pair, raw, k=2, batch_size=2, raw_normalize=MEAN_STD))
    with pytest.raises(ValueError):
        port_nearest.find_k_nearest_patches(pair[3](), default_proto_class(P, K), raw, K,
                                            raw_normalize=MEAN_STD, device="cpu")


@pytest.mark.parametrize("threshold,batch_size", [(1, 1), (2, 2)])
def test_prune_by_purity_matches_jax(pair, threshold, batch_size):
    jm, params, constants, port = pair
    data = make_data(21)
    kw = dict(k=3, prune_threshold=threshold, batch_size=batch_size, **QUIET)
    jp, jpc, jinfo = jax_prune.prune_by_purity(jm, params, constants, jax_pc(), data,
                                               K, **kw)
    sd, pc, info = port_prune.prune_by_purity(port(), default_proto_class(P, K), data,
                                              K, device="cpu", **kw)
    np.testing.assert_array_equal(info, jinfo)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jpc))
    kept = np.asarray(jp["prototype_vectors"])
    np.testing.assert_array_equal(sd["prototype_vectors"].numpy()[:, :, 0, 0], kept)
    np.testing.assert_array_equal(sd["last_layer.weight"].numpy().T,
                                  np.asarray(jp["last_layer"]))
    PPNet(PPNetConfig(**dict(TINY, num_prototypes=kept.shape[0]))).load_state_dict(
        sd, strict=True)
    assert 0 < kept.shape[0] <= P


def test_global_analysis_files_match_jax(pair, tmp_path):
    jm, params, constants, port = pair
    data = make_data(23, n=3)
    want = jax_analysis.global_analysis(jm, params, constants, jax_pc(), data, K, k=2,
                                        save_dir=str(tmp_path / "jax"))
    got = port_analysis.global_analysis(port(), default_proto_class(P, K), data, K, k=2,
                                        save_dir=str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(got, want)
    for rel in ["full_class_id.npy"] + [f"{j}/class_id.npy" for j in range(P)]:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / rel),
                                      np.load(tmp_path / "jax" / rel))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
