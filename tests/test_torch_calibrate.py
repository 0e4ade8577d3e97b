"""PyTorch port, the from-scratch init: ``adlm_tpu_torch.models.calibrate``
against ``adlm_tpu.models.calibrate`` on shared weights.

The smoke preset (``n_blocks=(1,1,1,1)``, 8 channels, 6 prototypes of 3
classes, deeplab_simple add-on; the other add-on kinds for the
presigmoid fold) gets ``random_variables`` of test_torch_models.py in
both packages, carried to the port by ``state_dict_from_jax``, with
identity frozen BNs (those of a from-scratch init) where the test
calibrates.  Both calibrate on the same numpy-seeded 2×65×65 images (the
inputs of tests/test_calibrate.py).  Tolerances:

* calibrated BN constants: each buffer within ``RTOL`` = 1e-4 of the
  largest entry of its JAX counterpart.  Both compose the affine in
  float64 from f32 moment sums, but XLA and PyTorch sum the
  convolutions and the moments in other orders (about 1e-6 apart), and
  each BN's update feeds every later one;
* presigmoid producers and data-initialized prototypes: ``RTOL`` of
  the largest entry as well (the prototypes are features at the same
  cells: ``np.random.RandomState(seed).choice`` draws the same cells in
  both);
* the update order and the sweep count: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adlm_tpu.core.config import get_experiment as jax_experiment
from adlm_tpu.models import calibrate as jax_cal
from adlm_tpu.models.ppnet import PPNet as JaxPPNet

from adlm_tpu_torch.core.config import get_experiment
from adlm_tpu_torch.models import calibrate
from adlm_tpu_torch.models.ppnet import PPNet
from adlm_tpu_torch.utils.jax_weights import state_dict_from_jax

from test_torch_models import random_variables

RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny convs run op by op.  With a thread pool per op, parallel
    test workers on a busy host wait on each other's threads, and the
    calibration's hundred small forwards take many times longer."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    g, w = got.detach().double().numpy(), want.double().numpy()
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
    assert err <= RTOL, f"{what}: {err:.2e} of its largest entry"


def _models(add_on: str = "deeplab_simple", from_scratch: bool = True):
    jcfg, tcfg = jax_experiment("smoke"), get_experiment("smoke")
    jm = JaxPPNet(cfg=dataclasses.replace(jcfg.model, add_on_layers_type=add_on))
    tm = PPNet(dataclasses.replace(tcfg.model, add_on_layers_type=add_on))
    params, consts = random_variables(jm, 3, (1, 65, 65, 3))
    if from_scratch:   # the frozen BNs of a from-scratch init: identity
        consts = jax.tree_util.tree_map_with_path(
            lambda path, v: np.full_like(v, path[-1].key in ("gamma", "var")), consts)
    tm.load_state_dict(state_dict_from_jax(params, consts), strict=True)
    return jm, params, consts, tm


def _images(seed, n=2):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 65, 65, 3) * 4 - 2).astype(np.float32)


@pytest.fixture(scope="module")
def calibrated():
    """Both packages' calibration of the same from-scratch smoke model."""
    jm, params, consts, tm = _models()
    x = _images(0)
    jlog, tlog = [], []
    jconsts = _host(jax_cal.calibrate_frozen_bn(jm, params, consts, jnp.asarray(x),
                                                log=jlog.append))
    info = calibrate.calibrate_frozen_bn(tm, x, log=tlog.append, device="cpu")
    return dict(jm=jm, params=params, consts=consts, jconsts=jconsts, tm=tm, x=x,
                info=info, jlog=jlog, tlog=tlog)


def test_bn_update_order_is_the_jax_layout_order(calibrated):
    c = calibrated
    shapes = jax.eval_shape(
        lambda p, k, x: c["jm"].apply({"params": p, "constants": k}, x,
                                      method=JaxPPNet.push_forward,
                                      capture_intermediates=jax_cal._is_fbn)[1],
        c["params"], c["consts"], jnp.asarray(c["x"]))["intermediates"]
    layout = sorted((path for path, _ in jax_cal._walk_captures(shapes)),
                    key=jax_cal._topo_key)
    order = calibrate.bn_update_order(c["tm"])
    assert order == [".".join(p) for p in layout]
    assert len(order) == 17 and order[0] == "features.base.layer1.conv1.bn"
    # within a bottleneck: reduce and shortcut (both read the block input),
    # then conv3x3, then increase
    assert order[1:5] == [f"features.base.layer2.block1.{m}.bn"
                          for m in ("reduce", "shortcut", "conv3x3", "increase")]


def test_calibrated_constants_match_jax(calibrated):
    c = calibrated
    want = state_dict_from_jax(c["params"], c["jconsts"])
    got = c["tm"].state_dict()
    bn_keys = [k for k in want if ".bn." in k]
    assert len(bn_keys) == 4 * 17
    for k in bn_keys:
        _close(got[k], want[k], k)
    # the same sweeps, logged alike (JAX stops after its second sweep)
    assert c["info"]["sweeps"] == sum("max |mean|" in m for m in c["jlog"]) == 2
    assert c["info"]["forwards"] == 2 * 17
    assert [m[:40] for m in c["tlog"]] == [m[:40] for m in c["jlog"]]


def test_calibration_meets_the_stop_rule(calibrated):
    """After calibration every live BN output is standardized on the
    calibration batch (dead channels, var ≈ 0, cannot be)."""
    c = calibrated
    moments = calibrate.bn_output_moments(c["tm"], c["x"], device="cpu")
    assert list(moments) == calibrate.bn_update_order(c["tm"])
    for name, (mean, var) in moments.items():
        live = var > 1e-3
        assert live.any(), name
        assert np.all(np.abs(mean[live]) < calibrate.STOP_MEAN), name
        assert np.all(np.abs(var[live] - 1.0) < calibrate.STOP_VAR), name
    assert c["info"]["max_abs_mean"] < calibrate.STOP_MEAN
    assert c["info"]["max_abs_var_minus_1"] < calibrate.STOP_VAR


@pytest.mark.parametrize("add_on", ["deeplab_simple", "regular", "bottleneck"])
def test_standardize_presigmoid_matches_jax(calibrated, add_on):
    if add_on == "deeplab_simple":   # the flagship's path: after calibration
        c = calibrated
        jm, params, consts, tm, x = c["jm"], c["params"], c["jconsts"], c["tm"], c["x"]
        tm.load_state_dict(state_dict_from_jax(params, consts), strict=True)
    else:
        jm, params, consts, tm = _models(add_on, from_scratch=False)
        x = _images(1)
    jparams = _host(jax_cal.standardize_presigmoid(jm, params, consts, jnp.asarray(x),
                                                   log=lambda *_: None))
    info = calibrate.standardize_presigmoid(tm, x, log=lambda *_: None, device="cpu")
    want = state_dict_from_jax(jparams, consts)
    got = tm.state_dict()
    before = state_dict_from_jax(params, consts)
    changed = [k for k in want if not torch.equal(want[k], before[k])]
    assert changed, "the JAX fold changed nothing"
    for k in want:
        _close(got[k], want[k], k)
    assert info["post_abs_mean"] < 1e-4 and info["post_abs_std_minus_1"] < 1e-4


def test_init_prototypes_from_data_matches_jax():
    jm, params, consts, tm = _models(from_scratch=False)
    rng = np.random.RandomState(6)
    images = _images(2, n=4)
    labels = rng.randint(0, 3, (4, 65, 65)).astype(np.uint8)   # class 2 (id 3) absent
    pc = np.arange(6) // 2
    jlog, tlog = [], []
    want = np.asarray(jax_cal.init_prototypes_from_data(
        jm, params, consts, pc, images, labels, seed=11, log=jlog.append))
    got = calibrate.init_prototypes_from_data(tm, torch.as_tensor(pc), images, labels,
                                              seed=11, log=tlog.append, device="cpu")
    assert got.shape == (6, 8)
    want = torch.from_numpy(want.copy())
    _close(got, want, "prototype vectors")
    _close(tm.prototype_vectors.flatten(1), want, "the model's vectors")
    # class 2 keeps its random init, in both
    np.testing.assert_array_equal(got[4:].numpy(), params["prototype_vectors"][4:])
    assert tlog == jlog and "[2]" in tlog[0]
