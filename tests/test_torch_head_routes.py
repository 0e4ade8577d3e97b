"""PyTorch port, the prototype head asked for its distances alone.

``prototype_head(..., return_logits=False)`` returns ``(None, d)``: on
the card the kernel's distances-only route (general-path shapes) or the
persistent kernel with its logits dropped, on the CPU (here) the plain
``l2_distances``, the same d that ``prototype_head_reference`` returns.
Inputs come from numpy seeds; both packages get the same values (bf16
rounded once).  Held against the JAX package's ``prototype_head``:

* d within rtol 1e-5 / atol 1e-4 with the same argmin over prototypes
  (``test_torch_ops.py``'s head tolerance), and bit-equal to the d of
  the same call with logits;
* the gradients of x and the prototypes with a cotangent on d alone
  against ``jax.vjp`` of the JAX head with a zero logits cotangent:
  within 1e-5 of the largest gradient in f32, 1e-2 in bf16 (gradients
  rounded to bf16, ``test_torch_losses.py``'s ``HEAD_BF16_RTOL``); the
  weight's gradient None or zero.

Shapes: a cut of a general-path shape (C = 20 is not a multiple of 8,
P = 300 > 256, K = 70 > 64, N = 2·7·7 rows) and a persistent one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adlm_tpu.ops import prototype as jax_proto

from adlm_tpu_torch.ops import prototype as port_proto

SHAPES = {"general": ((2, 7, 7), 20, 300, 70),
          "persistent": ((2, 9, 11), 64, 30, 5)}
D_RTOL, D_ATOL = 1e-5, 1e-4
GRAD_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(shape, dtype, seed):
    lead, C, P, K = SHAPES[shape]
    rng = np.random.RandomState(seed)
    x = rng.rand(*lead, C).astype(np.float32)
    p = rng.rand(P, C).astype(np.float32)
    w = rng.randn(P, K).astype(np.float32)
    g_dist = rng.randn(*lead, P).astype(np.float32)
    if dtype == "bfloat16":  # the same bf16 values for both packages
        x, p = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in (x, p))
    return x, p, w, g_dist


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_distances_only_match_jax(shape, dtype):
    x, p, w, _ = _inputs(shape, dtype, seed=len(shape) + len(dtype))
    tdt = getattr(torch, dtype)
    xt, pt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(p).to(tdt), torch.from_numpy(w)
    logits, d = port_proto.prototype_head(xt, pt, wt, "log", return_logits=False)
    assert logits is None
    assert d.dtype == torch.float32 and d.shape == (*x.shape[:-1], p.shape[0])
    _, want = jax_proto.prototype_head(jnp.asarray(x, dtype), jnp.asarray(p, dtype),
                                       jnp.asarray(w), "log", 1e-4, True)
    want = np.asarray(want)
    np.testing.assert_allclose(d.numpy(), want, rtol=D_RTOL, atol=D_ATOL)
    np.testing.assert_array_equal(d.argmin(-1).numpy(), want.argmin(-1))
    _, d_full = port_proto.prototype_head(xt, pt, wt, "log")
    assert torch.equal(d, d_full)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_distances_only_gradients_match_jax_vjp(shape, dtype):
    x, p, w, g_dist = _inputs(shape, dtype, seed=7 + len(shape) + len(dtype))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    (logits_j, _), vjp = jax.vjp(
        lambda a, b, c: jax_proto.prototype_head(a, b, c, "log", 1e-4, True),
        jnp.asarray(x, jdt), jnp.asarray(p, jdt), jnp.asarray(w))
    want_x, want_p, _ = vjp((jnp.zeros_like(logits_j), jnp.asarray(g_dist)))

    ins = [torch.tensor(a, dtype=t, requires_grad=True)
           for a, t in ((x, tdt), (p, tdt), (w, torch.float32))]
    logits, d = port_proto.prototype_head(*ins, "log", 1e-4, True, return_logits=False)
    assert logits is None
    (d * torch.from_numpy(g_dist)).sum().backward()
    for got, want in ((ins[0].grad, want_x), (ins[1].grad, want_p)):
        assert got.dtype == tdt
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=GRAD_RTOL[dtype],
                                   atol=GRAD_RTOL[dtype] * np.abs(want).max())
    assert ins[2].grad is None or not ins[2].grad.any()


def test_head_refuses_a_call_for_nothing():
    x, p, w, _ = _inputs("persistent", "float32", seed=0)
    with pytest.raises(ValueError, match="neither"):
        port_proto.prototype_head(torch.from_numpy(x), torch.from_numpy(p),
                                  torch.from_numpy(w), return_distances=False,
                                  return_logits=False)
