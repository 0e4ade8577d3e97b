"""Evaluation, push, pruning and interpretability of the PyTorch port."""

from adlm_tpu_torch.interpret.push import push_prototypes, make_push_batch_fn
from adlm_tpu_torch.interpret.nearest import find_k_nearest_patches
from adlm_tpu_torch.interpret.prune import prune_by_purity
from adlm_tpu_torch.interpret.evaluate import (
    SegEvaluator,
    make_inference_fn,
    make_overlay_fn,
    mean_iou_from_confusion,
    upsampled_nearest,
)

__all__ = [
    "push_prototypes",
    "make_push_batch_fn",
    "find_k_nearest_patches",
    "prune_by_purity",
    "SegEvaluator",
    "make_inference_fn",
    "make_overlay_fn",
    "mean_iou_from_confusion",
    "upsampled_nearest",
]
