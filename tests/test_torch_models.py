"""PyTorch port, models: the port's PPNet against the JAX PPNet.

Both get the same weights: random flax variable trees (numpy seed) go
through ``adlm_tpu_torch.utils.jax_weights.state_dict_from_jax`` into
the port, whose result must equal the JAX package's own exporter
(``export_protoseg_state_dict``) key for key and value for value and
load with ``strict=True``.  Then logits and distances of one numpy
input agree within atol 1e-4 (f32 accumulation order: XLA's CPU convs
vs PyTorch's), for every add-on kind, with and without space-to-batch
dilated convs, with MSC scales, at 33x33 and 65x97.

``jax_pair`` is shared with the other ``test_torch_*`` files.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adlm_tpu.core.config import PPNetConfig as JaxPPNetConfig
from adlm_tpu.models.ppnet import PPNet as JaxPPNet
from adlm_tpu.utils.torch_import import export_protoseg_state_dict

from adlm_tpu_torch.core.config import PPNetConfig
from adlm_tpu_torch.models.ppnet import PPNet, default_proto_class, prune_params
from adlm_tpu_torch.utils.jax_weights import state_dict_from_jax

ATOL = 1e-4

TINY = dict(num_prototypes=12, num_classes=4, prototype_channels=16,
            deeplab_n_features=16, deeplab_n_blocks=(1, 1, 1, 1))


def random_variables(model, seed, shape=(1, 33, 33, 3)):
    """Random flax variables of ``model`` from a numpy seed: conv
    kernels at 1/sqrt(fan_in), frozen-BN constants away from identity."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros(shape)))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            v = rng.normal(0.0, std, s.shape)
        elif name in ("gamma", "scale"):
            v = rng.uniform(0.5, 1.0, s.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "prototype_vectors":
            v = rng.uniform(0.0, 1.0, s.shape)
        elif name == "last_layer":
            v = rng.normal(0.0, 1.0, s.shape)
        else:  # biases, BN beta / mean
            v = rng.uniform(-0.1, 0.1, s.shape)
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v["constants"]


def jax_pair(seed=0, **overrides):
    """(JAX PPNet, params, constants, port PPNet with the same weights)."""
    kw = dict(TINY, **overrides)
    jm = JaxPPNet(cfg=JaxPPNetConfig(**kw))
    params, constants = random_variables(jm, seed)
    tm = PPNet(PPNetConfig(**kw))
    tm.load_state_dict(state_dict_from_jax(params, constants), strict=True)
    return jm, params, constants, tm.eval()


def _jax_forward(jm, params, constants, x):
    fn = jax.jit(lambda p, c, x: jm.apply({"params": p, "constants": c}, x,
                                          train=False))
    logits, d = fn(params, constants, jnp.asarray(x))
    return np.asarray(logits), np.asarray(d)


def _torch_forward(tm, x):
    with torch.inference_mode():
        logits, d = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    return logits.numpy(), d.numpy()


CASES = {
    "deeplab_simple": {},
    "bottleneck": dict(add_on_layers_type="bottleneck", prototype_channels=8),
    "bottleneck_pool": dict(add_on_layers_type="bottleneck_pool",
                            prototype_channels=8, bottleneck_stride=2),
    "regular": dict(add_on_layers_type="regular", prototype_channels=8),
    "regular_presigmoid_ln": dict(add_on_layers_type="regular",
                                  prototype_channels=8, presigmoid_ln=True),
    "linear_activation": dict(prototype_activation="linear"),
    "s2b": dict(dilated_space_to_batch=True),
    "msc": dict(msc_scales=(0.5, 0.75)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("size", [(33, 33), (65, 97)])
def test_ppnet_matches_jax(case, size):
    jm, params, constants, tm = jax_pair(seed=len(case), **CASES[case])
    x = np.random.RandomState(7).rand(2, *size, 3).astype(np.float32)
    want_logits, want_d = _jax_forward(jm, params, constants, x)
    got_logits, got_d = _torch_forward(tm, x)
    assert got_logits.shape == want_logits.shape
    assert got_d.shape == want_d.shape
    np.testing.assert_allclose(got_logits, want_logits, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["deeplab_simple", "bottleneck_pool",
                                  "regular", "msc"])
def test_state_dict_from_jax_equals_export(case):
    """The port's converter against the JAX package's exporter, the
    oracle: same keys, same values (exactly), strict load."""
    _, params, constants, _ = jax_pair(seed=3, **CASES[case])
    got = state_dict_from_jax(params, constants)
    want = export_protoseg_state_dict(params, constants)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_presigmoid_ln_state_dict_names():
    """The LayerNorm (which the JAX exporter cannot name) maps to
    ``add_on_layers.presigmoid_ln`` and loads strictly."""
    _, params, constants, tm = jax_pair(**CASES["regular_presigmoid_ln"])
    sd = state_dict_from_jax(params, constants)
    np.testing.assert_array_equal(
        sd["add_on_layers.presigmoid_ln.weight"].numpy(),
        params["add_on"]["presigmoid_ln"]["scale"])
    assert set(sd) == set(tm.state_dict())


def test_backbone_full_depth_matches_jax():
    """ResNet-101 block structure (3, 4, 23, 3) at 33x33: the deep stack
    compounds rounding, so the tolerance is relative (1e-3)."""
    jm, params, constants, tm = jax_pair(seed=5, deeplab_n_blocks=(3, 4, 23, 3))
    x = np.random.RandomState(2).rand(1, 33, 33, 3).astype(np.float32)
    want_logits, want_d = _jax_forward(jm, params, constants, x)
    got_logits, got_d = _torch_forward(tm, x)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-3, atol=1e-3)


def test_push_forward_and_global_head_match_jax():
    jm, params, constants, tm = jax_pair(seed=11)
    x = np.random.RandomState(4).rand(1, 33, 33, 3).astype(np.float32)
    variables = {"params": params, "constants": constants}
    f_j, d_j = jm.apply(variables, jnp.asarray(x), method=JaxPPNet.push_forward)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        f_t, d_t = tm.push_forward(xt)
        g_t, m_t = tm.global_head(tm.conv_features(xt))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=ATOL)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=ATOL)
    g_j, m_j = jm.apply(
        variables, jm.apply(variables, jnp.asarray(x),
                            method=JaxPPNet.conv_features),
        method=JaxPPNet.global_head)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), atol=ATOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=ATOL)


def test_prune_params_and_proto_class_match_jax():
    from adlm_tpu.models.ppnet import default_proto_class as jax_pc
    from adlm_tpu.models.ppnet import prune_params as jax_prune

    _, params, constants, tm = jax_pair(seed=2)
    pc = default_proto_class(12, 4)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jax_pc(12, 4)))
    keep = [0, 3, 4, 9, 11]
    sd, pc_new = prune_params(tm.state_dict(), pc, keep)
    jp, jpc = jax_prune(params, jax_pc(12, 4), keep)
    np.testing.assert_array_equal(pc_new.numpy(), np.asarray(jpc))
    want = state_dict_from_jax(jax.tree.map(np.asarray, jp), constants)
    small = PPNet(dataclasses.replace(PPNetConfig(**TINY), num_prototypes=5))
    small.load_state_dict(sd, strict=True)
    for k in ("prototype_vectors", "ones", "last_layer.weight"):
        np.testing.assert_array_equal(sd[k].numpy(), want[k].numpy())


def test_reset_parameters_is_seeded():
    cfg = PPNetConfig(**TINY)
    a = PPNet(cfg, generator=torch.Generator().manual_seed(1)).state_dict()
    b = PPNet(cfg, generator=torch.Generator().manual_seed(1)).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    w = a["last_layer.weight"]  # (K, P): +1 own class, −0.5 elsewhere
    assert w.shape == (4, 12)
    assert torch.equal(w.argmax(0), default_proto_class(12, 4))
