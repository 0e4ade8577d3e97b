"""Prototype-layer compute (counterpart of ``adlm_tpu.ops.prototype``).

Prototypes are 1x1 kernels in every shipped config, so the reference's
"L2 convolution" (reference model.py:203-221), its log activation
(:231-237) and its bias-free last layer (:266-283) are

    d      = max(|x|^2 - 2 x.P^T + |P|^2, 0)      (N, P)
    act    = log((d+1)/(d+eps))  or  -d           (N, P)
    logits = act . W                              (N, K)

``prototype_head`` calls the registered operator
``adlm_tpu_torch::prototype_head`` (``torch.library.custom_op``): a CUDA
tensor goes to the hand-written kernel (``csrc/prototype_head.cu``),
which keeps ``act`` on chip and writes ``d`` only when asked; a CPU
tensor goes to the plain PyTorch version ``prototype_head_reference``,
which is also the kernel's oracle.  With ``return_logits=False`` a
caller asks for ``d`` alone (the classifier's min-pooled head): the
kernel's general path then skips the logits.  Eager calls and programs
exported with ``torch.export`` run the same op, so a loaded artifact
launches the kernel and counts its launches; a process that loads one
imports this module first, which registers the op.

The op's gradient (``register_autograd``) is ``prototype_head_backward``,
plain PyTorch to the JAX package's custom VJP (``_head_bwd``), which is
plain XLA there too.  So the CPU tests hold the backward that the card
runs.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from adlm_tpu_torch.ops import _build

EPSILON = 1e-4  # reference model.py:50
_F32 = torch.float32


def l2_distances(x: torch.Tensor, prototypes: torch.Tensor) -> torch.Tensor:
    """Squared-L2 distance from each row of ``x`` (..., C) to each
    prototype (P, C) → (..., P), clamped at 0 (reference model.py:219)."""
    x = x.to(_F32)
    p = prototypes.to(_F32)
    x2 = (x * x).sum(-1, keepdim=True)
    p2 = (p * p).sum(-1)
    xp = torch.matmul(x, p.t())
    return torch.clamp(x2 - 2.0 * xp + p2, min=0.0)


def weighted_l2_distances(x: torch.Tensor, prototypes: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """``d[n,p] = Σ_c w[p,c]·(x[n,c] − proto[p,c])²`` (reference
    model.py:177-201); x (..., C), prototypes and weights (P, C)."""
    x = x.to(_F32)
    p = prototypes.to(_F32)
    w = weights.to(_F32)
    x2w = torch.matmul(x * x, w.t())
    xpw = torch.matmul(x, (w * p).t())
    p2w = (w * p * p).sum(-1)
    return torch.clamp(x2w - 2.0 * xpw + p2w, min=0.0)


def distance_to_similarity(distances: torch.Tensor, activation: str = "log",
                           epsilon: float = EPSILON) -> torch.Tensor:
    """Distance → similarity (reference model.py:231-237)."""
    if activation == "log":
        return torch.log((distances + 1.0) / (distances + epsilon))
    if activation == "linear":
        return -distances
    raise ValueError(f"unknown prototype activation {activation!r}")


def prototype_head_reference(x: torch.Tensor, prototypes: torch.Tensor,
                             last_layer_weight: torch.Tensor,
                             activation: str = "log",
                             epsilon: float = EPSILON
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch head: (logits (..., K), distances (..., P)), f32."""
    d = l2_distances(x, prototypes)
    act = distance_to_similarity(d, activation, epsilon)
    logits = torch.matmul(act, last_layer_weight.to(_F32))
    return logits, d


def _lib() -> ctypes.CDLL:
    lib = _build.load("prototype_head")
    f = lib.adlm_prototype_head
    if f.argtypes is None:  # first use: declare the C signature
        vp = ctypes.c_void_p
        f.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, vp, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, vp]
        f.restype = ctypes.c_int
        lib.adlm_prototype_head_smem.argtypes = [ctypes.c_int] * 4
        lib.adlm_prototype_head_smem.restype = ctypes.c_size_t
        lib.adlm_prototype_head_scratch.argtypes = [ctypes.c_int64] + [ctypes.c_int] * 4
        lib.adlm_prototype_head_scratch.restype = ctypes.c_size_t
    return lib


def head_route(C: int, P: int, K: int, dtype: torch.dtype) -> str:
    """Which kernel of ``csrc/prototype_head.cu`` a CUDA call at this
    shape launches: ``"persistent"`` (the register-tiled kernel, C a
    multiple of 8, P <= 256, K <= 64) or ``"general"`` (any shape)."""
    smem = _lib().adlm_prototype_head_smem(C, P, K, int(dtype == torch.bfloat16))
    return "persistent" if smem else "general"


def prototype_head_cuda(x: torch.Tensor, prototypes: torch.Tensor,
                        last_layer_weight: torch.Tensor,
                        activation: str = "log", epsilon: float = EPSILON,
                        return_distances: bool = True, return_logits: bool = True
                        ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch the fused head kernel on CUDA tensors.

    x: (..., C) float32 or bfloat16; prototypes (P, C); weight (P, K),
    any C, P, K >= 1 (``head_route`` says which kernel takes the shape).
    Returns logits (..., K) f32 or None and distances (..., P) f32 or
    None.  ``return_logits=False`` asks for the distances alone: on a
    general-path shape the kernel's distances-only route, which never
    computes the logits; the persistent kernel computes them and they
    are dropped.
    """
    if activation not in ("log", "linear"):
        raise ValueError(f"unknown prototype activation {activation!r}")
    if not (return_logits or return_distances):
        raise ValueError("prototype head asked for neither logits nor distances")
    if not (x.is_cuda and prototypes.is_cuda and last_layer_weight.is_cuda):
        raise ValueError("prototype_head_cuda takes CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    lead, C = x.shape[:-1], x.shape[-1]
    P, K = last_layer_weight.shape
    if prototypes.shape != (P, C):
        raise ValueError(f"prototypes {tuple(prototypes.shape)} vs x C={C}, "
                         f"weight P={P}")
    lib = _lib()
    bf16 = int(x.dtype == torch.bfloat16)
    x2d = x.reshape(-1, C).contiguous()
    if x2d.data_ptr() % 16:  # the kernel reads rows in 16-byte pieces
        x2d = x2d.clone()
    n = x2d.shape[0]
    protos = prototypes.to(_F32).contiguous()
    if protos.data_ptr() % 16:
        protos = protos.clone()
    # the persistent kernel always writes logits; the general path takes
    # a null pointer as the distances-only route, which reads no W
    with_logits = return_logits or head_route(C, P, K, x.dtype) == "persistent"
    w = last_layer_weight.to(_F32).contiguous() if with_logits else None
    logits = (torch.empty((n, K), dtype=_F32, device=x.device)
              if with_logits else None)
    dist = (torch.empty((n, P), dtype=_F32, device=x.device)
            if return_distances else None)
    with torch.cuda.device(x.device):
        # the general path's partial logits (none for the other routes)
        nbytes = lib.adlm_prototype_head_scratch(n, C, P, K, bf16) if with_logits else 0
        scratch = (torch.empty(nbytes // 4, dtype=_F32, device=x.device)
                   if nbytes else None)
        status = lib.adlm_prototype_head(
            x2d.data_ptr(), bf16, protos.data_ptr(),
            w.data_ptr() if with_logits else None,
            logits.data_ptr() if with_logits else None,
            dist.data_ptr() if dist is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            n, C, P, K, int(activation == "linear"), float(epsilon),
            _build.stream_ptr(x))
    _build.check(lib, status, "prototype_head")
    _build.LAUNCHES["prototype_head"] += 1
    return (logits.reshape(*lead, K) if return_logits else None,
            dist.reshape(*lead, P) if dist is not None else None)


def _empty(x: torch.Tensor) -> torch.Tensor:
    """The op's stand-in for an output the call did not ask for: a
    registered operator returns tensors, never None."""
    return x.new_empty((0,), dtype=_F32)


def _check_request(return_distances: bool, return_logits: bool) -> None:
    if not (return_logits or return_distances):
        raise ValueError("prototype head asked for neither logits nor distances")


@torch.library.custom_op("adlm_tpu_torch::prototype_head", mutates_args=(),
                         device_types="cpu")
def _head_op(x: torch.Tensor, prototypes: torch.Tensor,
             last_layer_weight: torch.Tensor, activation: str, epsilon: float,
             return_distances: bool, return_logits: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head as a registered operator, ``adlm_tpu_torch::prototype_head``:
    (logits, distances), an output the call did not ask for empty.

    This is its CPU implementation, the plain version (for the distances
    alone its ``l2_distances``: the same d, no logits).  The CUDA one is
    the kernel (``_head_op_cuda``); ``torch.export`` records the op and
    its shapes (``_head_op_fake``), so an exported program launches the
    kernel, and counts the launch, each time it runs on the card."""
    _check_request(return_distances, return_logits)
    if not return_logits:
        return _empty(x), l2_distances(x, prototypes)
    logits, d = prototype_head_reference(x, prototypes, last_layer_weight,
                                         activation, epsilon)
    return logits, (d if return_distances else _empty(x))


@_head_op.register_kernel("cuda")
def _head_op_cuda(x, prototypes, last_layer_weight, activation, epsilon,
                  return_distances, return_logits):
    logits, d = prototype_head_cuda(x, prototypes, last_layer_weight, activation,
                                    epsilon, return_distances, return_logits)
    return (_empty(x) if logits is None else logits,
            _empty(x) if d is None else d)


@_head_op.register_fake
def _head_op_fake(x, prototypes, last_layer_weight, activation, epsilon,
                  return_distances, return_logits):
    _check_request(return_distances, return_logits)
    lead = tuple(x.shape[:-1])
    P, K = last_layer_weight.shape
    return (x.new_empty(lead + (K,) if return_logits else (0,), dtype=_F32),
            x.new_empty(lead + (P,) if return_distances else (0,), dtype=_F32))


def prototype_head_backward(x: torch.Tensor, prototypes: torch.Tensor,
                            last_layer_weight: torch.Tensor,
                            g_logits: Optional[torch.Tensor],
                            g_dist: Optional[torch.Tensor],
                            activation: str = "log", epsilon: float = EPSILON
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gx, gp, gw) of the head, cast to the inputs' dtypes: the JAX
    package's ``_head_bwd`` (adlm_tpu/ops/prototype.py:260-288).

    ``d`` is recomputed in f32 from ``x`` and the prototypes; the relu
    of the forward passes the gradient where ``d > 0`` only (JAX's mask;
    autograd through ``torch.clamp`` would pass it at ``d == 0`` too).
    ``g_logits`` or ``g_dist`` may be None (no gradient reached it).
    """
    xf = x.to(_F32)
    p = prototypes.to(_F32)
    w = last_layer_weight.to(_F32)
    d = l2_distances(xf, p)                                     # (..., P)
    if g_logits is None:
        d_bar = torch.zeros_like(d)
    else:
        if activation == "log":
            # act = log(d+1) - log(d+eps); dact/dd = 1/(d+1) - 1/(d+eps)
            dact_dd = 1.0 / (d + 1.0) - 1.0 / (d + epsilon)
        else:
            dact_dd = -torch.ones_like(d)
        d_bar = torch.matmul(g_logits.to(_F32), w.t()) * dact_dd
    if g_dist is not None:
        d_bar = d_bar + g_dist.to(_F32)
    d_bar = torch.where(d > 0.0, d_bar, 0.0)
    rows_bar = d_bar.reshape(-1, d_bar.shape[-1])               # (N, P)
    rows_x = xf.reshape(-1, xf.shape[-1])                       # (N, C)
    # d = x2 - 2 x.p + p2  =>  gx = 2 (x Σ_p d_bar - d_bar P),
    # gp = 2 (p Σ_n d_bar - d_barᵀ x)
    gx = 2.0 * (xf * d_bar.sum(-1, keepdim=True)
                - torch.matmul(d_bar, p))
    gp = 2.0 * (p * rows_bar.sum(0)[:, None]
                - torch.matmul(rows_bar.t(), rows_x))
    if g_logits is None:
        gw = torch.zeros_like(w)
    else:
        act = distance_to_similarity(d, activation, epsilon)
        gw = torch.matmul(act.reshape(-1, act.shape[-1]).t(),
                          g_logits.reshape(-1, g_logits.shape[-1]).to(_F32))
    return (gx.to(x.dtype), gp.to(prototypes.dtype),
            gw.to(last_layer_weight.dtype))


def _head_setup_context(ctx, inputs, output) -> None:
    """Like ``jax.custom_vjp`` in the JAX package, the op saves only its
    inputs and recomputes ``d`` backward."""
    x, prototypes, last_layer_weight, activation, epsilon, with_d, with_logits = inputs
    ctx.save_for_backward(x, prototypes, last_layer_weight)
    ctx.activation, ctx.epsilon = activation, epsilon
    ctx.returned = (with_logits, with_d)
    ctx.set_materialize_grads(False)


def _head_backward(ctx, g_logits, g_dist):
    x, prototypes, w = ctx.saved_tensors
    with_logits, with_d = ctx.returned
    gx, gp, gw = prototype_head_backward(
        x, prototypes, w, g_logits if with_logits else None,
        g_dist if with_d else None, ctx.activation, ctx.epsilon)
    need = ctx.needs_input_grad
    return (gx if need[0] else None, gp if need[1] else None,
            gw if need[2] else None, None, None, None, None)


_head_op.register_autograd(_head_backward, setup_context=_head_setup_context)


def prototype_head(x: torch.Tensor, prototypes: torch.Tensor,
                   last_layer_weight: torch.Tensor, activation: str = "log",
                   epsilon: float = EPSILON, return_distances: bool = True,
                   return_logits: bool = True
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Fused prototype head: logits (+ distances) from feature rows.

    Args:
      x: (..., C) feature rows.
      prototypes: (P, C).
      last_layer_weight: (P, K) — the JAX package's layout (transposed
        vs the torch ``last_layer.weight``).
      return_logits: False for the distances alone (``(None, d)``), as
        the classifier's min-pooled head reads them.

    Returns:
      (logits (..., K) or None, distances (..., P) or None), float32.

    Every call goes through the registered op
    ``adlm_tpu_torch::prototype_head``: CUDA tensors to the kernel, CPU
    tensors to the plain version, and a gradient through
    ``prototype_head_backward`` (without logits the weight's gradient is
    zero).
    """
    logits, d = torch.ops.adlm_tpu_torch.prototype_head(
        x, prototypes, last_layer_weight, activation, float(epsilon),
        return_distances, return_logits)
    return (logits if return_logits else None), (d if return_distances else None)
