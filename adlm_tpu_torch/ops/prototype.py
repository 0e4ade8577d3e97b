"""Prototype-layer compute (counterpart of ``adlm_tpu.ops.prototype``).

Prototypes are 1x1 kernels in every shipped config, so the reference's
"L2 convolution" (reference model.py:203-221), its log activation
(:231-237) and its bias-free last layer (:266-283) are

    d      = max(|x|^2 - 2 x.P^T + |P|^2, 0)      (N, P)
    act    = log((d+1)/(d+eps))  or  -d           (N, P)
    logits = act . W                              (N, K)

``prototype_head`` sends a CUDA tensor to the hand-written kernel
(``csrc/prototype_head.cu``), which keeps ``act`` on chip and writes
``d`` only when asked; a CPU tensor goes to the plain PyTorch version
``prototype_head_reference``, which is also the kernel's oracle.

The head's backward waits for the training slice: a call that would
need a gradient through the kernel raises.
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
        f.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, vp]
        f.restype = ctypes.c_int
        lib.adlm_prototype_head_smem.argtypes = [ctypes.c_int] * 4
        lib.adlm_prototype_head_smem.restype = ctypes.c_size_t
    return lib


def prototype_head_cuda(x: torch.Tensor, prototypes: torch.Tensor,
                        last_layer_weight: torch.Tensor,
                        activation: str = "log", epsilon: float = EPSILON,
                        return_distances: bool = True
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the fused head kernel on CUDA tensors.

    x: (..., C) float32 or bfloat16; prototypes (P, C); weight (P, K).
    Returns logits (..., K) f32 and distances (..., P) f32 or None.
    """
    if activation not in ("log", "linear"):
        raise ValueError(f"unknown prototype activation {activation!r}")
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
    if not lib.adlm_prototype_head_smem(C, P, K, bf16):
        raise ValueError(f"the prototype-head kernel does not take C={C}, "
                         f"P={P}, K={K}: it needs C a multiple of 8, P <= 256, "
                         "K <= 64, and tiles that fit in a block's shared "
                         "memory")
    x2d = x.reshape(-1, C).contiguous()
    if x2d.data_ptr() % 16:  # the kernel reads rows in 16-byte pieces
        x2d = x2d.clone()
    n = x2d.shape[0]
    protos = prototypes.to(_F32).contiguous()
    if protos.data_ptr() % 16:
        protos = protos.clone()
    w = last_layer_weight.to(_F32).contiguous()
    logits = torch.empty((n, K), dtype=_F32, device=x.device)
    dist = (torch.empty((n, P), dtype=_F32, device=x.device)
            if return_distances else None)
    with torch.cuda.device(x.device):
        status = lib.adlm_prototype_head(
            x2d.data_ptr(), bf16, protos.data_ptr(),
            w.data_ptr(), logits.data_ptr(),
            dist.data_ptr() if dist is not None else None,
            n, C, P, K, int(activation == "linear"), float(epsilon),
            _build.stream_ptr(x))
    _build.check(lib, status, "prototype_head")
    _build.LAUNCHES["prototype_head"] += 1
    logits = logits.reshape(*lead, K)
    return logits, (dist.reshape(*lead, P) if dist is not None else None)


def prototype_head(x: torch.Tensor, prototypes: torch.Tensor,
                   last_layer_weight: torch.Tensor, activation: str = "log",
                   epsilon: float = EPSILON, return_distances: bool = True
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused prototype head: logits (+ distances) from feature rows.

    Args:
      x: (..., C) feature rows.
      prototypes: (P, C).
      last_layer_weight: (P, K) — the JAX package's layout (transposed
        vs the torch ``last_layer.weight``).

    Returns:
      (logits (..., K), distances (..., P) or None), float32.

    CUDA tensors go to the kernel, CPU tensors to the plain version.
    The kernel has no backward yet (training slice): with autograd
    recording and any input requiring a gradient, this raises.
    """
    if x.is_cuda:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, prototypes, last_layer_weight)):
            raise NotImplementedError(
                "the prototype-head kernel has no backward yet; call it "
                "under torch.inference_mode() or torch.no_grad()")
        return prototype_head_cuda(x, prototypes, last_layer_weight,
                                   activation, epsilon, return_distances)
    logits, d = prototype_head_reference(x, prototypes, last_layer_weight,
                                         activation, epsilon)
    return logits, (d if return_distances else None)
