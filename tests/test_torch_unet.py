"""PyTorch port, U-Noise's U-Net: ``adlm_tpu_torch.models.unet`` against
``adlm_tpu.models.unet``, the weight converters and the losses.

Both packages get the same weights: random flax trees (numpy seed,
running statistics away from 0/1) go through
``unet_state_dict_from_jax`` into the port, which loads them with
``strict=True``.  Tolerances (f32; XLA's CPU convs against PyTorch's,
and F.batch_norm's variance against JAX's one-pass ``E[x²]−E[x]²``):

* logits, eval and train mode: atol ``ATOL`` = 1e-4 (|logits| ≲ 10);
* post-forward running statistics: rtol 1e-4, atol 1e-5;
* bf16 forward against the JAX bf16 forward: atol ``BF16_ATOL`` = 0.15
  (two bf16 roundings per layer, logits of order 1–10);
* the converter round trip through the JAX package's own importer
  (``load_unoise_unet``) and ``load_unoise_checkpoint``: exact;
* ``bce_with_logits`` and ``dice_coeff``: rtol 1e-6.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from adlm_tpu.models.unet import UNet as JaxUNet
from adlm_tpu.ops import losses as jlosses
from adlm_tpu.utils import torch_import as jimport

from adlm_tpu_torch.models.unet import UNet, UNetBatchNorm, forward_in, num_params
from adlm_tpu_torch.ops import losses as tlosses
from adlm_tpu_torch.utils.jax_weights import unet_state_dict_from_jax
from adlm_tpu_torch.utils.torch_import import load_unoise_checkpoint

ATOL = 1e-4
BF16_ATOL = 0.15
STATS = dict(rtol=1e-4, atol=1e-5)
DEPTH, CF, HW = 3, 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def random_unet_variables(depth, cf, seed, hw=HW):
    """(params, batch_stats) of the JAX U-Net from a numpy seed: kernels at
    1/sqrt(fan_in), BN scale/bias and running statistics away from
    identity."""
    model = JaxUNet(out_channels=1, depth=depth, cf=cf)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 3)), train=True))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:  # biases, BN bias, running mean
            v = rng.uniform(-0.1, 0.1, s.shape)
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return model, tree["params"], tree["batch_stats"]


def port_unet(depth, cf, params, batch_stats):
    model = UNet(depth=depth, cf=cf)
    model.load_state_dict(unet_state_dict_from_jax(params, batch_stats))
    return model


@pytest.fixture(scope="module")
def pair():
    jmodel, params, bs = random_unet_variables(DEPTH, CF, seed=3)
    return jmodel, params, bs


def _x(seed, n=2, hw=HW):
    return np.random.RandomState(seed).rand(n, hw, hw, 3).astype(np.float32) * 2 - 0.5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def assert_same_running_stats(model, params, batch_stats):
    """The port's running statistics against a JAX batch_stats tree."""
    want = unet_state_dict_from_jax(params, batch_stats)
    got = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys and len(keys) == sum(1 for k in got if k.startswith("running", k.rfind(".") + 1))
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **STATS)


@pytest.mark.parametrize("hw", [16, 24])
def test_forward_eval_mode(pair, hw):
    jmodel, params, bs = pair
    model = port_unet(DEPTH, CF, params, bs).eval()
    x = _x(1, hw=hw)
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": bs},
                                   jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, hw, hw, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_forward_train_mode_and_running_stats(pair):
    jmodel, params, bs = pair
    model = port_unet(DEPTH, CF, params, bs).train()
    x = _x(2, n=3)
    want, upd = jmodel.apply({"params": params, "batch_stats": bs}, jnp.asarray(x),
                             train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = model(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    assert_same_running_stats(model, params, upd["batch_stats"])


def test_bf16_forward_within_bf16_rounding(pair):
    jmodel, params, bs = pair
    model = port_unet(DEPTH, CF, params, bs).eval()
    x = _x(4)
    bf = jax.tree.map(lambda v: jnp.asarray(v, jnp.bfloat16), params)
    want = np.asarray(jmodel.apply({"params": bf, "batch_stats": bs},
                                   jnp.asarray(x, jnp.bfloat16), train=False)
                      ).astype(np.float32)
    with torch.no_grad():
        got = forward_in(model, _nchw(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_ATOL)
    # the BN statistics stay f32 under a bf16 forward
    assert all(b.dtype == torch.float32 for b in model.buffers())


@pytest.mark.parametrize("depth,cf", [(2, 2), (3, 3), (5, 6)])
def test_param_count_and_keys_match_jax(depth, cf):
    jmodel = JaxUNet(out_channels=1, depth=depth, cf=cf)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=True))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    model = UNet(depth=depth, cf=cf)
    assert num_params(model) == n_jax
    if (depth, cf) == (5, 6):
        assert n_jax == 34_527_041   # the shipped model
    # the reference's module names (adlm_tpu/utils/torch_import.py:374-424)
    keys = set(model.state_dict())
    assert {"downs.0.0.weight", "downs.0.1.running_var", "downs.0.4.bias",
            "ups.0.up.1.weight", "ups.0.up.2.running_mean", "ups.0.conv.3.weight",
            "conv1x1.weight", "conv1x1.bias"} <= keys
    assert model.ups[0].up[1].in_channels == 2 ** (cf + depth - 1)


def test_converter_round_trip_through_jax_importer(pair):
    """port state_dict → the JAX package's load_unoise_unet → the original
    trees, exactly; and the port's own converter back to the same keys."""
    jmodel, params, bs = pair
    model = port_unet(DEPTH, CF, params, bs)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    p2 = jax.tree.map(lambda v: np.full_like(v, np.nan), params)
    b2 = jax.tree.map(lambda v: np.full_like(v, np.nan), bs)
    report = jimport.load_unoise_unet(p2, b2, sd)
    assert not report["unexpected_keys"] and not report["negative_variance_keys"]
    assert len(report["loaded"]) == len(sd)
    jax.tree.map(np.testing.assert_array_equal, p2, jax.tree.map(np.asarray, params))
    jax.tree.map(np.testing.assert_array_equal, b2, jax.tree.map(np.asarray, bs))
    # gradient trees (params only) map onto the parameter names
    assert set(unet_state_dict_from_jax(params)) == {n for n, _ in model.named_parameters()}


def _lightning_file(tmp_path, sd, prefix, name):
    """A file shaped like a pytorch-lightning checkpoint of the reference
    (its state_dict under ``state_dict``, the U-Net under ``prefix``,
    BN ``num_batches_tracked`` buffers and another submodule beside it)."""
    out = {prefix + k: v.clone() for k, v in sd.items()}
    for k in sd:
        if k.endswith("running_var"):
            out[prefix + k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    payload = {"epoch": 3, "global_step": 120, "state_dict": out} if prefix else out
    if prefix == "noise_model.":
        out.update({"utility_model." + k: v.clone() for k, v in sd.items()})
    path = tmp_path / name
    torch.save(payload, path)
    return str(path)


@pytest.mark.parametrize("prefix,kind", [("model.", "utility"), ("noise_model.", "noise"),
                                         ("", "utility")])
def test_load_unoise_checkpoint_matches_jax(tmp_path, pair, prefix, kind):
    jmodel, params, bs = pair
    sd = port_unet(DEPTH, CF, params, bs).state_dict()
    path = _lightning_file(tmp_path, sd, prefix, f"ckpt_{kind}_{len(prefix)}.ckpt")
    got, depth, cf = load_unoise_checkpoint(path, kind)
    assert (depth, cf) == (DEPTH, CF)
    model = UNet(depth=depth, cf=cf)
    model.load_state_dict(got)   # strict
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    # the JAX package's loader reads the same file into the same trees
    want = jimport.load_unoise_checkpoint(path, kind)
    assert set(want) - {k for k in want if k.endswith("num_batches_tracked")} == set(got)
    p2 = jax.tree.map(lambda v: np.full_like(v, np.nan), params)
    b2 = jax.tree.map(lambda v: np.full_like(v, np.nan), bs)
    jimport.load_unoise_unet(p2, b2, want)
    np.testing.assert_array_equal(
        np.transpose(p2["down0"]["conv0"]["kernel"], (3, 2, 0, 1)),
        got["downs.0.0.weight"].numpy())


def test_load_unoise_checkpoint_refuses_negative_variance(tmp_path, pair):
    jmodel, params, bs = pair
    sd = port_unet(DEPTH, CF, params, bs).state_dict()
    sd["downs.1.1.running_var"][0] = -1.0
    path = _lightning_file(tmp_path, sd, "model.", "bad.ckpt")
    with pytest.raises(ValueError, match="running_var"):
        load_unoise_checkpoint(path, "utility")


def test_init_draws_flax_defaults_from_the_generator():
    a = UNet(depth=3, cf=4, generator=torch.Generator().manual_seed(5))
    b = UNet(depth=3, cf=4, generator=torch.Generator().manual_seed(5))
    c = UNet(depth=3, cf=4, generator=torch.Generator().manual_seed(6))
    for (n, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
        if n.endswith("weight") and p.ndim == 4:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert float(p.abs().max()) <= 2 * std + 1e-7
            assert not torch.equal(p, r)
            if p.numel() >= 4096:   # lecun_normal: variance 1/fan_in
                assert abs(float(p.var()) * fan_in - 1.0) < 0.1
        elif n.endswith("bias"):
            assert float(p.abs().max()) == 0.0
    for m in a.modules():
        if isinstance(m, UNetBatchNorm):
            assert bool((m.weight == 1).all()) and bool((m.running_var == 1).all())
            assert bool((m.running_mean == 0).all())


def test_odd_sizes_floor_as_flax_pooling():
    jmodel, params, bs = random_unet_variables(2, 2, seed=9, hw=10)
    model = port_unet(2, 2, params, bs).eval()
    x = _x(5, n=1, hw=10)
    act, skips = model.encode(_nchw(x))
    assert act.shape[-2:] == (5, 5) and skips[0].shape[-2:] == (10, 10)
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": bs},
                                   jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(2, 8, 8, 1) * 30).astype(np.float32)   # both tails
    target = (rng.rand(2, 8, 8, 1) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(tlosses.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(target))),
        float(jlosses.bce_with_logits(jnp.asarray(logits), jnp.asarray(target))), rtol=1e-6)
    pred = logits > 0
    np.testing.assert_allclose(
        float(tlosses.dice_coeff(torch.from_numpy(pred), torch.from_numpy(target))),
        float(jlosses.dice_coeff(jnp.asarray(pred), jnp.asarray(target))), rtol=1e-6)
    zero = np.zeros_like(target)
    assert float(tlosses.dice_coeff(torch.from_numpy(zero), torch.from_numpy(zero))) == 0.0


def test_bce_gradient_at_an_exact_zero_logit_is_sigmoid_minus_target():
    """σ(0) − t = 0.5 − t, as torch's BCEWithLogitsLoss (the reference's
    loss); the JAX package's gives −t there (ROADMAP.md, Queue 3)."""
    x = torch.tensor([0.0, 0.0, 2.0, -3.0], requires_grad=True)
    t = torch.tensor([0.0, 1.0, 1.0, 0.0])
    got, = torch.autograd.grad(tlosses.bce_with_logits(x, t), x)
    want, = torch.autograd.grad(F.binary_cross_entropy_with_logits(x, t), x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-7)
    jax_grad = np.asarray(jax.grad(jlosses.bce_with_logits)(jnp.asarray(x.detach().numpy()),
                                                              jnp.asarray(t.numpy())))
    np.testing.assert_allclose(jax_grad[:2] * 4, [0.0, -1.0], atol=1e-7)
