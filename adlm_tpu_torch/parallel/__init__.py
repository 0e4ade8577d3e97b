"""Data-parallel training and batch-sharded eval over ``torch.distributed``
(counterpart of ``adlm_tpu.parallel``)."""

from adlm_tpu_torch.parallel.sharding import (
    make_sharded_cls_step,
    make_sharded_inference_fn,
    make_sharded_train_step,
    shard_state,
)

__all__ = [
    "make_sharded_cls_step",
    "make_sharded_train_step",
    "make_sharded_inference_fn",
    "shard_state",
]
