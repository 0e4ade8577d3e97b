"""PyTorch port, ops: each plain op against its JAX counterpart.

Runs on the CPU, where ``prototype_head`` takes the plain PyTorch
version (the kernel's oracle on the card); the JAX head on the CPU is
its XLA composition.  Inputs come from numpy seeds.  Tolerances:

* head, f32: distances rtol 1e-5 / atol 1e-4, logits rtol 1e-4 /
  atol 1e-3 (matmul summation order), equal argmin over prototypes;
  bf16 inputs are the same bf16 values in both and widen exactly, so
  the same tolerances hold;
* resize: atol 1e-5 on N(0, 1) inputs, normalize: atol 1e-6 (the
  same f32 formula in different kernels).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adlm_tpu.core import config as jax_config
from adlm_tpu.ops import normalize as jax_normalize
from adlm_tpu.ops import prototype as jax_proto
from adlm_tpu.ops import resize as jax_resize

from adlm_tpu_torch.core import config as port_config
from adlm_tpu_torch.core.device import (
    cast_params,
    compute_dtype,
    ieee_f32,
    resolve_device,
)
from adlm_tpu_torch.ops import prototype as port_proto
from adlm_tpu_torch.ops.normalize import normalize
from adlm_tpu_torch.ops.resize import (
    resize_bilinear,
    resize_bilinear_factor,
    resize_label_nearest,
)


def test_every_experiment_config_equals_jax():
    assert port_config.list_experiments() == jax_config.list_experiments()
    for name in port_config.list_experiments():
        got = port_config.get_experiment(name)
        assert got.to_json() == jax_config.get_experiment(name).to_json()
        assert port_config.ExperimentConfig.from_json(got.to_json()) == got


def test_config_from_json_reads_a_jax_run_config():
    cfg = dataclasses.replace(
        jax_config.get_experiment("smoke"), name="run1")
    got = port_config.ExperimentConfig.from_json(cfg.to_json())
    assert got.to_json() == cfg.to_json()
    assert got.model.num_prototypes_per_class == 2


def _head_inputs(seed, dtype, lead=(2, 9, 11), C=64, P=30, K=5):
    rng = np.random.RandomState(seed)
    x = rng.rand(*lead, C).astype(np.float32)
    p = rng.rand(P, C).astype(np.float32)
    w = rng.randn(P, K).astype(np.float32)
    if dtype == "bfloat16":
        # the same bf16 values for both packages
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        p = np.array(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
    return x, p, w


def _check_head_against_jax(x, p, w, dtype, activation, return_distances=True):
    tdt, jdt = compute_dtype(dtype), jnp.dtype(dtype)
    logits, d = port_proto.prototype_head(
        torch.from_numpy(x).to(tdt), torch.from_numpy(p).to(tdt),
        torch.from_numpy(w), activation, return_distances=return_distances)
    want_logits, want_d = jax_proto.prototype_head(
        jnp.asarray(x, jdt), jnp.asarray(p, jdt), jnp.asarray(w), activation,
        1e-4, True)
    assert logits.dtype == torch.float32
    assert logits.shape == (*x.shape[:-1], w.shape[1])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-3)
    if not return_distances:
        assert d is None
        return
    np.testing.assert_allclose(d.numpy(), np.asarray(want_d),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(d.argmin(-1).numpy(),
                                  np.asarray(want_d).argmin(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["log", "linear"])
@pytest.mark.parametrize("return_distances", [True, False])
def test_prototype_head_matches_jax(dtype, activation, return_distances):
    x, p, w = _head_inputs(len(dtype) + len(activation), dtype)
    _check_head_against_jax(x, p, w, dtype, activation, return_distances)


# shapes off the card kernel's tiles: N off its 64-row tile, P off its
# 64-prototype and K off its 4-class tiles (ragged); and the pascal
# presets' P=210, K=21, which take its widest prototype tile
@pytest.mark.parametrize("shape", [((1001,), 97, 7), ((3, 7, 13), 210, 21)],
                         ids=["ragged", "pascal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["log", "linear"])
def test_prototype_head_matches_jax_at_kernel_edge_shapes(shape, dtype,
                                                          activation):
    lead, P, K = shape
    x, p, w = _head_inputs(P + K, dtype, lead=lead, P=P, K=K)
    _check_head_against_jax(x, p, w, dtype, activation)


def test_plain_l2_ops_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 7, 16).astype(np.float32)
    p = rng.rand(9, 16).astype(np.float32)
    wts = rng.rand(9, 16).astype(np.float32)
    xt, pt, wt = (torch.from_numpy(a) for a in (x, p, wts))
    np.testing.assert_allclose(
        port_proto.l2_distances(xt, pt).numpy(),
        np.asarray(jax_proto.l2_distances(x, p)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        port_proto.weighted_l2_distances(xt, pt, wt).numpy(),
        np.asarray(jax_proto.weighted_l2_distances(x, p, wts)),
        rtol=1e-5, atol=1e-4)
    d = np.abs(x[..., :9])
    for act in ("log", "linear"):
        np.testing.assert_allclose(
            port_proto.distance_to_similarity(torch.from_numpy(d), act).numpy(),
            np.asarray(jax_proto.distance_to_similarity(d, act)),
            rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        port_proto.distance_to_similarity(torch.from_numpy(d), "cosine")


def test_prototype_head_cuda_wrapper_refuses_cpu_tensors():
    x, p, w = (torch.from_numpy(a) for a in _head_inputs(0, "float32"))
    with pytest.raises(ValueError, match="CUDA"):
        port_proto.prototype_head_cuda(x, p, w)


def test_prototype_head_plain_path_keeps_gradients_on_cpu():
    x, p, w = (torch.from_numpy(a).requires_grad_()
               for a in _head_inputs(1, "float32", lead=(3,), C=8, P=4, K=2))
    logits, _ = port_proto.prototype_head(x, p, w)
    logits.sum().backward()
    assert x.grad is not None and p.grad is not None and w.grad is not None


@pytest.mark.parametrize("src,size", [((9, 13), (33, 47)), ((33, 65), (257, 513)),
                                      ((40, 30), (17, 11))])
def test_resize_bilinear_matches_jax(src, size):
    x = np.random.RandomState(5).randn(2, *src, 3).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(x), size).numpy()
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), size))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got_nchw = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), size,
                               channel_last=False)
    np.testing.assert_array_equal(got_nchw.permute(0, 2, 3, 1).numpy(), got)


@pytest.mark.parametrize("factor", [0.5, 0.75])
@pytest.mark.parametrize("hw", [(33, 33), (65, 97)])
def test_resize_bilinear_factor_matches_jax(factor, hw):
    x = np.random.RandomState(6).randn(1, *hw, 3).astype(np.float32)
    got = resize_bilinear_factor(torch.from_numpy(x), factor).numpy()
    want = np.asarray(jax_resize.resize_bilinear_factor(jnp.asarray(x), factor))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_resize_label_nearest_matches_jax():
    lab = np.random.RandomState(7).randint(0, 20, size=(2, 37, 53))
    for size in ((65, 65), (17, 29), (37, 53)):
        got = resize_label_nearest(torch.from_numpy(lab), size).numpy()
        want = np.asarray(jax_resize.resize_label_nearest(jnp.asarray(lab), size))
        np.testing.assert_array_equal(got, want)


def test_normalize_matches_jax():
    img = np.random.RandomState(8).randint(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    ms = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
    got = normalize(torch.from_numpy(img), ms)
    want = np.asarray(jax_normalize.normalize_in_jit(jnp.asarray(img), ms))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    same = torch.from_numpy(img)
    assert normalize(same, None) is same


def test_device_resolution_never_falls_back_silently(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_cast_params_keeps_buffers_f32_and_ieee_scope_restores():
    from adlm_tpu_torch.models.layers import ConvBN

    m = cast_params(ConvBN(3, 4, 3), "bfloat16")
    assert m.conv.weight.dtype == torch.bfloat16
    assert m.bn.running_var.dtype == torch.float32
    with pytest.raises(ValueError):
        compute_dtype("float16")
    before = torch.backends.cudnn.allow_tf32
    with ieee_f32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.backends.cudnn.allow_tf32 == before
