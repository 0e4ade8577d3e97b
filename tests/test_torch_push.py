"""PyTorch port, push: ``adlm_tpu_torch.interpret.push`` against
``adlm_tpu.interpret.push`` on shared weights.

The tiny PPNet of test_torch_models.py (12 prototypes of 16 channels,
4 classes, ``n_blocks=(1,1,1,1)``) gets the same random weights in both
packages (``state_dict_from_jax``), with prototype 1 a copy of prototype
0 (same class), so both push them onto the same patch and dedup has a
duplicate to remove.  The inputs are five 65×97 numpy-seeded images
(9×13 output grid) with labels in blocks of about 7 pixels, so that
eligibility masks a real share of the patches.  The JAX side runs on the
CPU (its head takes the XLA branch), the port with ``device="cpu"``
(the plain versions).  Tolerances:

* ``min_distances`` and the pushed vectors rtol 1e-5 / atol 1e-6
  (XLA's and PyTorch's CPU convolutions sum in other orders);
* winners (``proto_rf_boxes``, ``proto_bound_boxes``), ``unique_index``,
  the pruned prototype count and the three files exactly equal.  Tie
  budget 0: the two packages' distances differ by ~1e-6 here, and a
  winner flips only if its runner-up lies that close; the seeded inputs
  have no such pair (a flip would fail naming its prototype).  Exact
  ties (the all-void padded image, an all-1e30 column) resolve to the
  first index in both, which ``test_batched_step_ties_match_jax`` holds.

The JAX models and results are built once per module.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adlm_tpu.core.config import PPNetConfig as JaxPPNetConfig
from adlm_tpu.interpret import push as jax_push
from adlm_tpu.models.ppnet import PPNet as JaxPPNet

from adlm_tpu_torch.core.config import PPNetConfig
from adlm_tpu_torch.interpret import push as port_push
from adlm_tpu_torch.models.ppnet import PPNet, default_proto_class
from adlm_tpu_torch.utils.jax_weights import state_dict_from_jax

from test_torch_models import TINY, random_variables

P, K = TINY["num_prototypes"], TINY["num_classes"]
H, W = 65, 97
MEAN_STD = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
QUIET = dict(log=lambda *_: None)


def block_labels(rng, n, H, W, K, block=7):
    """(n, 1, H, W) int32 labels 0..K (0 = void) in blocks of ~``block``
    pixels, so eligibility masks a real share of the patches."""
    bh, bw = -(-H // block), -(-W // block)
    blocks = rng.randint(0, K + 1, (n, bh, bw))
    lab = blocks[:, (np.arange(H) * bh) // H][:, :, (np.arange(W) * bw) // W]
    return lab[:, None].astype(np.int32)


def make_data(seed, n=5, raw=False):
    rng = np.random.RandomState(seed)
    if raw:
        images = [rng.randint(0, 256, (1, H, W, 3)).astype(np.uint8) for _ in range(n)]
    else:
        images = [rng.rand(1, H, W, 3).astype(np.float32) for _ in range(n)]
    return list(zip(images, list(block_labels(rng, n, H, W, K))))


def normalized(raw_data):
    mean, std = (np.asarray(v, np.float32) for v in MEAN_STD)
    return [((im.astype(np.float32) / 255.0 - mean) / std, lab) for im, lab in raw_data]


def model_pair(seed=31):
    """(JAX PPNet, params, constants, port PPNet factory): prototype 1
    copies prototype 0; the factory builds a fresh port model (push
    moves and reads it) with the same weights."""
    jm = JaxPPNet(cfg=JaxPPNetConfig(**TINY))
    params, constants = random_variables(jm, seed)
    pv = np.array(params["prototype_vectors"])
    pv[1] = pv[0]
    params = dict(params, prototype_vectors=pv)
    sd = state_dict_from_jax(params, constants)

    def port():
        tm = PPNet(PPNetConfig(**TINY))
        tm.load_state_dict(sd, strict=True)
        return tm.eval()

    return jm, params, constants, port


@pytest.fixture(scope="module")
def pair():
    return model_pair()


def jax_pc():
    return jnp.arange(P) // (P // K)


def _push_both(pair, data, tmp_path, **kw):
    jm, params, constants, port = pair
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jax_push.push_prototypes(jm, params, constants, jax_pc(), data, K,
                                    run_dir=jdir, **QUIET, **kw)
    got = port_push.push_prototypes(port(), default_proto_class(P, K), data, K,
                                    run_dir=pdir, device="cpu", **QUIET, **kw)
    return want, got, jdir, pdir


def _assert_push_equal(want, got, jdir=None, pdir=None):
    (jp, jpc, jinfo), (sd, pc, info) = want, got
    np.testing.assert_allclose(info["min_distances"], jinfo["min_distances"],
                               rtol=1e-5, atol=1e-6)
    for key in ("proto_rf_boxes", "proto_bound_boxes"):
        np.testing.assert_array_equal(info[key], jinfo[key], err_msg=key)
    assert info["unique_index"] == jinfo["unique_index"]
    want_vecs = np.asarray(jp["prototype_vectors"])
    n_kept = want_vecs.shape[0]
    assert sd["prototype_vectors"].shape == (n_kept, want_vecs.shape[1], 1, 1)
    np.testing.assert_allclose(sd["prototype_vectors"].numpy()[:, :, 0, 0], want_vecs,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(sd["last_layer.weight"].numpy().T,
                                  np.asarray(jp["last_layer"]))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jpc))
    # the pushed state dict loads strictly into a PPNet with P' prototypes
    PPNet(PPNetConfig(**dict(TINY, num_prototypes=n_kept))).load_state_dict(
        sd, strict=True)
    if jdir is not None:
        for name in ("bb.npy", "bb-receptive_field.npy"):
            np.testing.assert_array_equal(np.load(os.path.join(pdir, name)),
                                          np.load(os.path.join(jdir, name)))
        with open(os.path.join(pdir, "unique_prototypes.json")) as f:
            got_u = json.load(f)
        with open(os.path.join(jdir, "unique_prototypes.json")) as f:
            assert got_u == json.load(f)


@pytest.mark.parametrize("shape,grid,C", [
    ((67, 41), (9, 6), 5), ((64, 33), (64, 33), 3), ((129, 257), (17, 33), 19),
    ((3, 50, 70), (7, 9), 3), ((2, 1024 // 8, 2048 // 8), (17, 33), 31)])
def test_patch_class_bits_matches_jax(shape, grid, C):
    """The bit-pooled eligibility at awkward non-divisible ratios,
    batched and not, up to 31 classes (bit 30)."""
    label = np.random.RandomState(sum(shape)).randint(0, C + 1, size=shape)
    got = port_push.patch_class_bits(torch.from_numpy(label), grid, C)
    want = jax_push.patch_class_bits(jnp.asarray(label), grid, C)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        port_push.patch_class_eligibility(torch.from_numpy(label), grid, C).numpy(),
        np.asarray(jax_push.patch_class_eligibility(jnp.asarray(label), grid, C)))
    with pytest.raises(ValueError):
        port_push.patch_class_bits(torch.from_numpy(label), grid, 32)


@pytest.mark.parametrize("n_px", [1, 7, 33, 97, 513, 1024, 2048])
def test_block_gathers_follow_the_integer_rule(n_px):
    """The pixel blocks that ``patch_class_bits`` gathers, built from the
    shapes on the device, are those of the rule (p·h)//H (found with
    ``np.searchsorted``) at every grid size up to ``n_px``: the
    flagship's 1024 → 129 and 2048 → 257 included."""
    pix = np.arange(n_px)
    for n_grid in range(1, n_px + 1):
        cell = (pix * n_grid) // n_px
        starts = np.searchsorted(cell, np.arange(n_grid))
        ends = np.searchsorted(cell, np.arange(n_grid), side="right")
        want = np.stack([np.minimum(starts + k, ends - 1)
                         for k in range(int((ends - starts).max()))])
        got = port_push._block_gathers(n_px, n_grid, torch.device("cpu"))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{n_px} -> {n_grid}")


@pytest.mark.parametrize("batch_size", [1, 2])
def test_push_matches_jax(pair, tmp_path, batch_size):
    """Both paths, with dedup: five images, so batch 2 ends on a padded
    partial batch."""
    want, got, jdir, pdir = _push_both(pair, make_data(3), tmp_path,
                                       batch_size=batch_size)
    _assert_push_equal(want, got, jdir, pdir)
    assert len(got[2]["unique_index"]) < P  # the copied prototype went
    assert (got[2]["proto_rf_boxes"][:, 0] >= 0).any()


def test_push_raw_uint8_matches_jax(pair):
    """uint8 images normalized on the device, against JAX's raw path and
    the port's own f32 path on the same images."""
    jm, params, constants, port = pair
    raw = make_data(5, n=3, raw=True)
    kw = dict(dedup=False, batch_size=2, **QUIET)
    want = jax_push.push_prototypes(jm, params, constants, jax_pc(), raw, K,
                                    raw_uint8=True, raw_normalize=MEAN_STD, **kw)
    got = port_push.push_prototypes(port(), default_proto_class(P, K), raw, K,
                                    raw_uint8=True, raw_normalize=MEAN_STD,
                                    device="cpu", **kw)
    _assert_push_equal(want, got)
    f32 = port_push.push_prototypes(port(), default_proto_class(P, K),
                                    normalized(raw), K, device="cpu", **kw)
    np.testing.assert_array_equal(f32[2]["proto_rf_boxes"], got[2]["proto_rf_boxes"])
    np.testing.assert_allclose(f32[2]["min_distances"], got[2]["min_distances"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batch_size", [1, 2])
def test_push_absent_class_keeps_its_vectors(pair, batch_size):
    """A class absent from every label keeps its prototype vectors and
    its boxes stay −1 (the 1e30 sentinel never counts as seen)."""
    jm, params, constants, port = pair
    data = [(im, np.where(lab == K, 0, lab)) for im, lab in make_data(7, n=3)]
    kw = dict(dedup=False, batch_size=batch_size, **QUIET)
    want = jax_push.push_prototypes(jm, params, constants, jax_pc(), data, K, **kw)
    got = port_push.push_prototypes(port(), default_proto_class(P, K), data, K,
                                    device="cpu", **kw)
    _assert_push_equal(want, got)
    last = slice(P - P // K, P)
    old = np.asarray(params["prototype_vectors"])[last]
    np.testing.assert_array_equal(got[0]["prototype_vectors"].numpy()[last, :, 0, 0], old)
    assert (got[2]["proto_rf_boxes"][last, 0] == -1).all()
    assert np.isinf(got[2]["min_distances"][last]).all()


def test_batched_step_ties_match_jax(pair):
    """The batched step on a batch with an all-void image (every patch of
    it at 1e30) and a class absent from the batch (an all-1e30 column,
    where every candidate ties): (min, image, i, j, fmap) equal to JAX,
    the absent class at index 0 with 1e30."""
    jm, params, constants, port = pair
    (im0, lab0), (im1, _) = make_data(9, n=2)
    images = np.concatenate([im0, im1])
    labels = np.concatenate([np.where(lab0 == K, 1, lab0), np.zeros_like(lab0)])
    jfn = jax_push.make_push_batched_fn(jm, K)
    want = [np.asarray(a) for a in jfn(params, constants, jax_pc(), jnp.asarray(images),
                                       jnp.asarray(labels))]
    pfn = port_push.make_push_batched_fn(port(), K, device="cpu")
    got = [t.numpy() for t in pfn(default_proto_class(P, K), images, labels)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5, atol=1e-6)
    absent = np.arange(P) // (P // K) == K - 1
    assert (got[0][absent] == np.float32(1e30)).all()
    assert (got[1][absent] == 0).all() and (got[2][absent] == 0).all()
    assert (got[1][~absent] == 0).all()  # the void image never wins
    # the one-image step agrees with the batched one on image 0 (the
    # convolutions' batch tiling moves d by ulps)
    one = port_push.make_push_batch_fn(port(), K, device="cpu")(
        default_proto_class(P, K), images[:1], labels[:1])
    np.testing.assert_allclose(one[0].numpy(), got[0], rtol=1e-5, atol=1e-6)
    assert one[4].shape == (1, 9, 13, P)


def test_push_value_errors(pair, tmp_path):
    _, _, _, port = pair
    raw = make_data(11, n=2, raw=True)
    pc = default_proto_class(P, K)
    with pytest.raises(ValueError, match="batch_size > 1"):
        port_push.push_prototypes(port(), pc, raw, K, raw_uint8=True,
                                  raw_normalize=MEAN_STD, device="cpu", **QUIET)
    with pytest.raises(ValueError, match="raw_normalize"):
        port_push.push_prototypes(port(), pc, raw, K, raw_uint8=True,
                                  batch_size=2, device="cpu", **QUIET)
    with pytest.raises(ValueError, match="get_item"):
        port_push.push_prototypes(port(), pc, make_data(11, n=2), K, batch_size=2,
                                  run_dir=str(tmp_path), save_visualizations=True,
                                  device="cpu", **QUIET)
