"""PyTorch port, the training slice: ``adlm_tpu_torch.train.protoseg``
against ``adlm_tpu.train.protoseg`` on shared weights.

Both packages get the same random weights (``random_variables`` of
test_torch_models.py, carried by ``state_dict_from_jax``) and the same
numpy-seeded windows, at the tiny shape of tests/test_train.py
(``n_blocks=(1,1,1,1)``, 8 channels, 6 prototypes over 3 classes, 33²
windows → a 5×5 output grid).  Tolerances:

* ``loss_fn``: loss and metrics rtol ``METRIC_RTOL``; each gradient
  tensor within ``GRAD_RTOL`` relative L2 error (XLA's and PyTorch's
  CPU convs sum in other orders).
* Train steps, after every window: metrics as above, ``n_correct``
  within ``TIE_BUDGET`` patches.  Parameters are compared by their
  window update Δ = p_now − p_before: a tensor JAX leaves exactly
  unchanged must stay exactly unchanged, and a moving tensor's Δ agrees
  within ``UPDATE_RTOL`` relative L2 error.  Element-wise equality is the
  wrong test for Adam: its first update is ±lr·sign(g) for every entry,
  so an entry whose gradient sits at rounding noise may step the other
  way (test_trajectory_golden.py's ``_DeltaChecker`` says the same); the
  absolute drift is bounded by ``DRIFT_LRS`` learning rates per window.
* bf16: finite, and within the loose ``BF16_RTOL`` of JAX's bf16 run
  (the two round bf16 at other places).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adlm_tpu.core import config as jcfg_mod
from adlm_tpu.models.ppnet import PPNet as JaxPPNet
from adlm_tpu.models.ppnet import default_proto_class as jax_proto_class
from adlm_tpu.train import protoseg as jtrain

from adlm_tpu_torch.core import config as tcfg_mod
from adlm_tpu_torch.models.ppnet import PPNet, default_proto_class
from adlm_tpu_torch.train import protoseg as ttrain
from adlm_tpu_torch.utils.jax_weights import state_dict_from_jax

from test_torch_models import random_variables

METRIC_RTOL = 1e-4
GRAD_RTOL = 1e-4
UPDATE_RTOL = 1e-3
DRIFT_LRS = 2.0
TIE_BUDGET = 1
BF16_RTOL = 5e-2

TINY_MODEL = dict(num_prototypes=6, num_classes=3, prototype_channels=8,
                  deeplab_n_features=8, deeplab_n_blocks=(1, 1, 1, 1),
                  img_size=33, add_on_layers_type="regular")
METRICS = ("loss", "cross_entropy", "kld_loss", "l1")


def _configs(model_kw=None, **train_kw):
    """The same tiny experiment in both packages' config classes."""
    out = []
    for mod in (jcfg_mod, tcfg_mod):
        out.append(mod.ExperimentConfig(
            name="tiny",
            model=mod.PPNetConfig(**dict(TINY_MODEL, **(model_kw or {}))),
            data=mod.DataConfig(window_size=(33, 33)),
            train=mod.TrainConfig(**dict(dict(iter_size=2, loss_weight_kld=0.25),
                                         **train_kw))))
    return out


def _pair(jcfg, tcfg, seed):
    jm = JaxPPNet(cfg=jcfg.model)
    params, constants = random_variables(jm, seed)
    tm = PPNet(tcfg.model)
    tm.load_state_dict(state_dict_from_jax(params, constants), strict=True)
    return jm, params, constants, tm


def _windows(seed, n, n_micro=2, bs=2, K=3, uint8=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if uint8:
            images = rng.randint(0, 256, (n_micro, bs, 33, 33, 3)).astype(np.uint8)
        else:
            images = rng.rand(n_micro, bs, 33, 33, 3).astype(np.float32)
        labels = rng.randint(0, K + 1, (n_micro, bs, 33, 33)).astype(np.int32)
        out.append((images, labels))
    return out


def _named(jax_tree):
    """A JAX params-shaped tree → {port parameter name: float64 array}."""
    sd = state_dict_from_jax(jax.tree.map(np.asarray, jax_tree))
    return {k: v.numpy().astype(np.float64) for k, v in sd.items()}


def _port_params(tm):
    return {n: p.detach().numpy().astype(np.float64)
            for n, p in tm.named_parameters()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_metrics(got, want, tag):
    for k in METRICS + ("grad_norm",):
        if k in want:
            np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                       rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=f"{tag}: {k}")
    assert float(got["n_patches"]) == float(want["n_patches"]), tag
    assert abs(float(got["n_correct"]) - float(want["n_correct"])) <= TIE_BUDGET, tag


# ---------------------------------------------------------------------------
# loss_fn: value, metrics and every gradient
# ---------------------------------------------------------------------------

LOSS_CASES = {
    "kld_raw_indexing": dict(kld_raw_label_indexing=True),
    "kld_shifted_indexing": dict(kld_raw_label_indexing=False),
    "no_void_class": dict(ignore_void_class=False),
    "no_kld": dict(loss_weight_kld=0.0),
    "uint8_images": dict(wire_uint8=True),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_fn_and_gradients_match_jax(case):
    jcfg, tcfg = _configs(**LOSS_CASES[case])
    jm, params, constants, tm = _pair(jcfg, tcfg, seed=3)
    images, labels = _windows(5, 1, uint8=case == "uint8_images")[0]
    images, labels = images[0], labels[0]
    pc = jax_proto_class(6, 3)
    grad_fn = jax.jit(jax.value_and_grad(jtrain.loss_fn, has_aux=True),
                      static_argnums=(2, 4, 6))
    (_, want), jgrads = grad_fn(params, constants, jm, pc, jcfg,
                                (jnp.asarray(images), jnp.asarray(labels)), True)

    total, got = ttrain.loss_fn(tm, default_proto_class(6, 3), tcfg,
                                (torch.from_numpy(images), torch.from_numpy(labels)),
                                True)
    total.backward()
    _assert_metrics(got, want, case)
    want_g = _named(jgrads)
    for n, p in tm.named_parameters():
        assert _rel(p.grad.numpy().astype(np.float64), want_g[n]) <= GRAD_RTOL, n


# ---------------------------------------------------------------------------
# make_train_step: three windows, parameters and metrics after each
# ---------------------------------------------------------------------------

STEP_CASES = {
    "warmup": (0, {}, {}),
    "joint": (1, {}, {}),
    "last_layer": (2, {}, {}),
    "joint_fused": (1, {}, dict(fused_accumulation=True)),
    "joint_clip_ramp": (1, {}, dict(grad_clip_norm=0.5, joint_lr_warmup_updates=2)),
    "joint_msc": (1, dict(msc_scales=(0.75,)), {}),
    "joint_remat": (1, {}, dict(remat=True)),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_windows_match_jax(case):
    phase, model_kw, train_kw = STEP_CASES[case]
    jcfg, tcfg = _configs(model_kw, **train_kw)
    jm, params, constants, tm = _pair(jcfg, tcfg, seed=7)
    n_windows = 3
    max_steps = n_windows * jcfg.train.iter_size
    jstate = jtrain.init_protoseg_state(
        jm, jcfg, phase, max_steps, jax.random.PRNGKey(0),
        jnp.zeros((1, 33, 33, 3)), params=params, constants=constants,
        proto_class=jax_proto_class(6, 3))
    jstep = jtrain.make_train_step(jm, jcfg, phase, max_steps)
    tstate = ttrain.init_protoseg_state(tm, tcfg, phase, max_steps, device="cpu")
    tstep = ttrain.make_train_step(tm, tcfg, phase, max_steps, device="cpu")

    lr_max = max(g["base_lr"] for g in tstate.optimizer.param_groups)
    prev_j, prev_t = _named(jstate.params), _port_params(tm)
    for w, (images, labels) in enumerate(_windows(11, n_windows)):
        jstate, want = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
        tstate, got = tstep(tstate, images, labels)
        tag = f"{case} window {w}"
        _assert_metrics(got, want, tag)
        cur_j, cur_t = _named(jstate.params), _port_params(tm)
        for n in cur_t:
            dj, dt = cur_j[n] - prev_j[n], cur_t[n] - prev_t[n]
            if not np.any(dj):
                assert not np.any(dt), f"{tag}: {n} moved, JAX kept it"
            else:
                assert _rel(dt, dj) <= UPDATE_RTOL, f"{tag}: {n} {_rel(dt, dj)}"
            drift = np.abs(cur_t[n] - cur_j[n]).max()
            assert drift <= DRIFT_LRS * lr_max * (w + 1), f"{tag}: {n} drift {drift}"
        prev_j, prev_t = cur_j, cur_t
    assert tstate.step == n_windows


def test_bf16_step_is_finite_and_near_jax():
    jcfg, tcfg = _configs(compute_dtype="bfloat16")
    jm, params, constants, tm = _pair(jcfg, tcfg, seed=9)
    images, labels = _windows(13, 1)[0]
    jstate = jtrain.init_protoseg_state(
        jm, jcfg, 1, 10, jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 3)),
        params=params, constants=constants, proto_class=jax_proto_class(6, 3))
    jstate, want = jtrain.make_train_step(jm, jcfg, 1, 10)(
        jstate, jnp.asarray(images), jnp.asarray(labels))
    tstate = ttrain.init_protoseg_state(tm, tcfg, 1, 10, device="cpu")
    tstate, got = ttrain.make_train_step(tm, tcfg, 1, 10, device="cpu")(
        tstate, images, labels)
    for k in METRICS + ("grad_norm",):
        assert np.isfinite(float(got[k])), k
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=BF16_RTOL, err_msg=k)
    for n, p in tm.named_parameters():
        assert p.dtype == torch.float32 and bool(torch.isfinite(p).all()), n


def test_eval_step_with_n_valid_matches_jax():
    jcfg, tcfg = _configs()
    jm, params, constants, tm = _pair(jcfg, tcfg, seed=15)
    rng = np.random.RandomState(17)
    images = rng.rand(3, 33, 33, 3).astype(np.float32)
    labels = rng.randint(0, 4, (3, 33, 33)).astype(np.int32)
    jstate = jtrain.init_protoseg_state(
        jm, jcfg, 1, 10, jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 3)),
        params=params, constants=constants, proto_class=jax_proto_class(6, 3))
    tstate = ttrain.init_protoseg_state(tm, tcfg, 1, 10, device="cpu")
    jeval = jtrain.make_eval_step(jm, jcfg)
    teval = ttrain.make_eval_step(tm, tcfg, device="cpu")
    for n_valid in (2, None):
        want = jeval(jstate, jnp.asarray(images), jnp.asarray(labels), n_valid)
        got = teval(tstate, images, labels, n_valid)
        _assert_metrics(got, want, f"eval n_valid={n_valid}")
    # the masked image adds nothing: n_valid=2 equals the first two alone
    got2 = teval(tstate, images[:2], labels[:2])
    got_masked = teval(tstate, images, labels, 2)
    for k in METRICS + ("n_correct", "n_patches"):
        assert float(got_masked[k]) == pytest.approx(float(got2[k]), rel=1e-6), k


def test_train_step_refuses_a_state_built_for_other_max_steps():
    """The state records the ``max_steps`` its schedule was built for; a
    step made for another budget raises (the JAX step would use its own
    schedule), and the matching budget trains as before."""
    jcfg, tcfg = _configs()
    jm, params, constants, tm = _pair(jcfg, tcfg, seed=19)
    max_steps = 2 * tcfg.train.iter_size
    tstate = ttrain.init_protoseg_state(tm, tcfg, 1, max_steps, device="cpu")
    assert tstate.max_steps == max_steps
    images, labels = _windows(23, 1)[0]
    with pytest.raises(ValueError, match="max_steps"):
        ttrain.make_train_step(tm, tcfg, 1, max_steps + 1, device="cpu")(
            tstate, images, labels)
    assert tstate.step == 0
    jstate = jtrain.init_protoseg_state(
        jm, jcfg, 1, max_steps, jax.random.PRNGKey(0), jnp.zeros((1, 33, 33, 3)),
        params=params, constants=constants, proto_class=jax_proto_class(6, 3))
    jstate, want = jtrain.make_train_step(jm, jcfg, 1, max_steps)(
        jstate, jnp.asarray(images), jnp.asarray(labels))
    tstate, got = ttrain.make_train_step(tm, tcfg, 1, max_steps, device="cpu")(
        tstate, images, labels)
    _assert_metrics(got, want, "matching max_steps")
    assert tstate.step == 1
