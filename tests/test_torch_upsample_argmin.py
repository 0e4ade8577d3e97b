"""PyTorch port, upsample + argmin: the plain version (the CUDA kernel's
oracle on the card) against the JAX package.

The plain version must EQUAL, index for index, the JAX chunked scan
with the exact f32 blend (``_upsampled_argmin_scan(exact=True)``) and
the Pallas kernel in interpret mode (``upsampled_argmin_pallas(...,
interpret=True)``) on the shapes of tests/test_upsample_argmin.py, the
all-equal tie case and the exact-flag case.  The integer-scale path
equals ``_upsampled_nearest_integer`` and serves CPU maps only: every
CUDA map goes to the kernel.  The bf16 fast path (bf16 resize,
no ``exact``) differs from JAX's bf16 resize in rounding: ≥ 99% agree.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from adlm_tpu.interpret.evaluate import (
    _upsampled_argmin_scan,
    _upsampled_nearest_integer,
)
from adlm_tpu.ops.upsample_argmin import upsampled_argmin_pallas

from adlm_tpu_torch.ops import upsample_argmin as port_ua
from adlm_tpu_torch.ops.upsample_argmin import (
    upsampled_argmin_cuda,
    upsampled_argmin_reference,
    upsampled_nearest,
    upsampled_nearest_integer,
)

SHAPES = [
    ((2, 9, 13, 7), (33, 47)),     # ragged everything
    ((1, 5, 5, 3), (10, 10)),      # integer scale
    ((2, 17, 33, 21), (129, 257)), # 2^n+1 grids, as the flagship's
    ((1, 9, 9, 40), (65, 65)),     # P > chunk: several chunks
]


@pytest.mark.parametrize("shape,size", SHAPES)
def test_plain_version_equals_jax_scan_and_pallas(shape, size):
    rng = np.random.RandomState(hash(shape) % (2**31))
    d = rng.rand(*shape).astype(np.float32)
    got = upsampled_argmin_reference(torch.from_numpy(d), size, chunk=4)
    assert got.dtype == torch.int32 and got.shape == (shape[0], *size)
    scan = np.asarray(_upsampled_argmin_scan(jnp.asarray(d), size, chunk=4,
                                             exact=True))
    np.testing.assert_array_equal(got.numpy(), scan)
    pallas = np.asarray(upsampled_argmin_pallas(
        jnp.asarray(d), size, th=16, tw=128, c=8, interpret=True, exact=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    # the chunk width is a scheduling choice only
    np.testing.assert_array_equal(
        upsampled_argmin_reference(torch.from_numpy(d), size, chunk=64).numpy(),
        scan)


# The inputs the CUDA kernel's tiling is sensitive to, as the card checks
# them at full size: values on three levels, so that most outputs tie
# with several prototypes across prototype chunks and output tiles; and
# H, W, P off every tile and chunk width.
TILING_CASES = [
    ("near_tie", (2, 9, 17, 23), (65, 129)),
    ("ragged", (1, 11, 21, 29), (83, 163)),
]


@pytest.mark.parametrize("kind,shape,size", TILING_CASES)
def test_plain_version_equals_jax_on_ties_and_ragged_tiles(kind, shape, size):
    rng = np.random.RandomState(7)
    if kind == "near_tie":
        d = rng.randint(0, 3, shape).astype(np.float32)
    else:
        d = rng.rand(*shape).astype(np.float32)
    got = upsampled_argmin_reference(torch.from_numpy(d), size, chunk=4)
    scan = np.asarray(_upsampled_argmin_scan(jnp.asarray(d), size, chunk=4,
                                             exact=True))
    np.testing.assert_array_equal(got.numpy(), scan)
    pallas = np.asarray(upsampled_argmin_pallas(
        jnp.asarray(d), size, th=16, tw=128, c=8, interpret=True, exact=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    if kind == "near_tie":  # ties are common, and the first one wins
        y0, y1, wy = port_ua._src_coords(size[0], shape[1], "cpu")
        x0, x1, wx = port_ua._src_coords(size[1], shape[2], "cpu")
        t = torch.from_numpy(d)
        fx = t[:, :, x0] * (1.0 - wx[:, None]) + t[:, :, x1] * wx[:, None]
        full = fx[:, y0] * (1.0 - wy[:, None, None]) + fx[:, y1] * wy[:, None, None]
        ties = (full == full.min(-1, keepdim=True).values).sum(-1) > 1
        assert ties.float().mean() > 0.1
        first = (full == full.min(-1, keepdim=True).values).int().argmax(-1)
        np.testing.assert_array_equal(first.numpy(), scan)


def test_first_occurrence_tie_break():
    d = torch.ones((1, 4, 4, 5))
    assert (upsampled_argmin_reference(d, (8, 9), chunk=2) == 0).all()
    assert (upsampled_nearest(d, (8, 8)) == 0).all()


def test_exact_flag_on_bf16_equals_f32_cast():
    """``exact=True`` on bf16 maps equals the f32 path on the f32 cast,
    as JAX's does; sub-bf16-ulp prototype pairs make the fast bf16 path
    differ (construction of tests/test_upsample_argmin.py)."""
    rng = np.random.RandomState(11)
    base = rng.rand(2, 6, 8, 1).astype(np.float32)
    d = np.concatenate([base, base - 2e-4,
                        rng.rand(2, 6, 8, 6).astype(np.float32) + 1.0], axis=-1)
    d16 = torch.from_numpy(d).to(torch.bfloat16)
    size = (17, 23)
    want = upsampled_argmin_reference(d16.float(), size, chunk=3)
    got = upsampled_argmin_reference(d16, size, chunk=3, exact=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jax_exact = np.asarray(_upsampled_argmin_scan(
        jnp.asarray(d, jnp.bfloat16), size, chunk=3, exact=True))
    np.testing.assert_array_equal(got.numpy(), jax_exact)
    fast = upsampled_argmin_reference(d16, size, chunk=3)
    assert (fast.numpy() != want.numpy()).any()


def test_bf16_fast_path_agrees_with_jax_within_budget():
    rng = np.random.RandomState(3)
    d = rng.rand(1, 9, 13, 17).astype(np.float32)
    d16 = torch.from_numpy(d).to(torch.bfloat16)
    got = upsampled_argmin_reference(d16, (33, 47), chunk=8).numpy()
    want = np.asarray(_upsampled_argmin_scan(jnp.asarray(d, jnp.bfloat16),
                                             (33, 47), chunk=8))
    assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("shape,scale", [((2, 5, 7, 6), (2, 3)),
                                         ((1, 4, 4, 9), (8, 8)),
                                         ((1, 3, 6, 4), (1, 4))])
def test_integer_path_equals_jax(shape, scale):
    d = np.random.RandomState(4).rand(*shape).astype(np.float32)
    got = upsampled_nearest_integer(torch.from_numpy(d), *scale)
    want = np.asarray(_upsampled_nearest_integer(jnp.asarray(d), *scale))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the dispatch takes it
    size = (shape[1] * scale[0], shape[2] * scale[1])
    np.testing.assert_array_equal(
        upsampled_nearest(torch.from_numpy(d), size).numpy(), want)


def test_dispatch_takes_the_scan_on_cpu():
    d = np.random.RandomState(5).rand(1, 9, 13, 7).astype(np.float32)
    got = upsampled_nearest(torch.from_numpy(d), (33, 47), chunk=3)
    want = upsampled_argmin_reference(torch.from_numpy(d), (33, 47), chunk=3)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="CUDA"):
        upsampled_argmin_cuda(torch.from_numpy(d), (33, 47))


class _CudaLike(torch.Tensor):
    """A CPU tensor that reports itself on the card, to follow the
    dispatch without one."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("shape,size", [
    ((1, 5, 5, 3), (10, 10)),        # integer scale: the CPU phase path
    ((2, 5, 7, 6), (10, 21)),
    ((1, 4, 4, 9), (32, 32)),
    ((2, 9, 13, 7), (33, 47)),       # ragged: the CPU scan
    ((1, 65, 97, 19), (33, 47)),     # downsampling
])
def test_dispatch_sends_every_cuda_map_to_the_kernel(monkeypatch, shape, size):
    calls = []
    monkeypatch.setattr(port_ua, "upsampled_argmin_cuda",
                        lambda d, s: calls.append((type(d), s)) or "kernel")
    d = torch.rand(shape).as_subclass(_CudaLike)
    assert upsampled_nearest(d, size, exact=True) == "kernel"
    assert calls == [(_CudaLike, size)]
