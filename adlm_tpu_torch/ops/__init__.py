"""Ops of the PyTorch port: plain PyTorch functions and the wrappers of
the hand-written CUDA kernels (``csrc/``), each beside its plain
version."""

from adlm_tpu_torch.ops.normalize import normalize
from adlm_tpu_torch.ops.prototype import (
    distance_to_similarity,
    l2_distances,
    prototype_head,
    prototype_head_reference,
    weighted_l2_distances,
)
from adlm_tpu_torch.ops.resize import (
    resize_bilinear,
    resize_bilinear_factor,
    resize_label_nearest,
)
from adlm_tpu_torch.ops.upsample_argmin import upsampled_nearest

__all__ = [
    "distance_to_similarity",
    "l2_distances",
    "normalize",
    "prototype_head",
    "prototype_head_reference",
    "resize_bilinear",
    "resize_bilinear_factor",
    "resize_label_nearest",
    "upsampled_nearest",
    "weighted_l2_distances",
]
