"""Sharded training and inference over a (data, model) mesh (counterpart
of ``adlm_tpu.parallel.sharding``).

The JAX package annotates a batch as split over the ``data`` axis and
lets XLA place the reductions, so a sharded step is the single-device
program: every mean stays a mean over the GLOBAL batch.  Here each rank
is a process (``core/mesh.py``) and the reductions are explicit:

* the loss terms' denominators (valid CE patches and KLD pairs per
  group, image counts) are summed over the data ranks before the loss,
  and each rank's local sums are scaled by them; a term of the
  parameters alone (the masked L1) enters on the first data rank only;
* one flattened SUM per accumulation window reduces the gradients (and
  the metrics) before the global norm, the clip and the optimizer;
* the trainable BatchNorms reduce Σx, Σx² and the count over the data
  ranks inside the forward (``set_batch_norm_reduce``);
* random draws (U-Noise's ε, the evaluator's sample pixels) are made at
  the global batch's shape and each rank takes its rows.

So each rank makes the single-device step's update on the global batch,
up to the order of the sums, and the ranks' parameters stay bit-equal
(every rank reduces to the same bits and applies the same update).
``DistributedDataParallel`` is not used: it would average each rank's
own mean, and reduce on every microbatch's backward.

The spatial mode (``spatial=True`` with ``model`` > 1: image H over the
``model`` axis, a row exchange at every convolution) is
``parallel/spatial.py``.  Its MSC models and the tensor-parallel head
(``prototype_parallel=True``) are ROADMAP item 9b and raise.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from adlm_tpu_torch.core.mesh import Mesh
from adlm_tpu_torch.parallel.spatial import ITEM_9B


def set_batch_norm_reduce(model: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Make the trainable BatchNorms of ``model`` (``FlaxBatchNorm``,
    ``UNetBatchNorm``) take their training statistics over ``mesh``'s
    data ranks (a differentiable SUM); ``mesh=None`` restores the local
    statistics."""
    from adlm_tpu_torch.models.backbones import FlaxBatchNorm
    from adlm_tpu_torch.models.unet import UNetBatchNorm

    fn = None if mesh is None or not mesh.distributed else mesh.all_reduce_grad
    for m in model.modules():
        if isinstance(m, (FlaxBatchNorm, UNetBatchNorm)):
            m.stats_reduce = fn
    return model


def shard_state(state: Any, mesh: Mesh) -> Any:
    """Replicate a train state over the mesh: rank 0's parameters, buffers
    and optimizer moments broadcast to every rank (in place)."""
    model = getattr(state, "model", None)
    mods = [model] if model is not None else []
    tensors = [t for m in mods for t in list(m.parameters()) + list(m.buffers())]
    for name in ("proto_class",):
        t = getattr(state, name, None)
        if isinstance(t, torch.Tensor):
            tensors.append(t)
    opt = getattr(state, "optimizer", None)
    if opt is not None:
        for st in opt.state.values():
            tensors += [v for v in st.values() if isinstance(v, torch.Tensor)]
    with torch.no_grad():
        mesh.broadcast_([t.data for t in tensors])
    return state


def make_sharded_train_step(model, cfg, phase: int, mesh: Mesh,
                            max_steps: Optional[int] = None):
    """The ProtoSeg train step over ``mesh``: each rank takes its
    (iter_size, bs/data, H, W, 3) slice of the window (plain and fused
    accumulation).  The update is in place (the JAX package's
    ``donate=True``, which has no counterpart here)."""
    from adlm_tpu_torch.train.protoseg import make_train_step

    return make_train_step(model, cfg, phase, max_steps, mesh=mesh)


def make_sharded_utility_step(cfg, mesh: Mesh, raw: bool = False):
    """The U-Noise utility step over ``mesh`` (global BN statistics)."""
    from adlm_tpu_torch.train.unoise import make_utility_train_step

    return make_utility_train_step(cfg, raw=raw, mesh=mesh)


def make_sharded_noise_step(cfg, mesh: Mesh, raw: bool = False):
    """The U-Noise noise step over ``mesh``: ε at the global shape, each
    rank's rows."""
    from adlm_tpu_torch.train.unoise import make_noise_train_step

    return make_noise_train_step(cfg, raw=raw, mesh=mesh)


def make_sharded_cls_step(model, cfg, phase: str, mesh: Mesh):
    """The classifier's step over ``mesh`` (the BN stems' statistics
    global).  The JAX function's ``steps_per_epoch`` lives in the port's
    state (``init_classifier_state``)."""
    from adlm_tpu_torch.train.classification import make_cls_train_step

    return make_cls_train_step(model, cfg, phase, mesh=mesh)


def make_sharded_inference_fn(model, num_classes: int, mesh: Mesh,
                              spatial: bool = True,
                              with_stats: bool = False,
                              prototype_parallel: bool = False,
                              stats_upsampled: bool = False,
                              normalize=None,
                              stats_exact: bool = False):
    """The whole-image eval step over ``mesh``:
    ``fn(proto_class, images, labels, *uv)`` on this rank's slice of the
    batch, with the counters summed over the ranks and the statistic rows
    of the global batch; ``uv`` are this rank's rows of the sample
    pixels.  With ``spatial`` and ``mesh.model`` > 1 image H splits over
    the model ranks too (``parallel/spatial.py``: ``pred`` and the maps
    of the rank's rows; ``fn`` also takes ``n_valid``).  An MSC model
    there and ``prototype_parallel=True`` raise (item 9b)."""
    if prototype_parallel:
        raise NotImplementedError(f"the tensor-parallel prototype head {ITEM_9B}")
    if spatial and mesh.model > 1:
        from adlm_tpu_torch.parallel.spatial import make_spatial_inference_fn

        return make_spatial_inference_fn(model, num_classes, mesh, with_stats,
                                         stats_upsampled, normalize, stats_exact)
    from adlm_tpu_torch.interpret.evaluate import SegEvaluator

    ev = SegEvaluator(model, num_classes, with_stats=with_stats,
                      stats_upsampled=stats_upsampled, normalize=normalize,
                      stats_exact=stats_exact, mesh=mesh, spatial=False)

    def fn(proto_class, images, labels, *uv):
        return ev._sharded_update(proto_class, images, labels, uv, images.shape[0])

    return fn


class RankStore:
    """A ``CheckpointStore`` whose writes happen on the first rank only,
    the others waiting at a barrier until the write is on disk; reads go
    to the store on every rank."""

    def __init__(self, store, mesh: Mesh):
        self._store, self._mesh = store, mesh
        self.run_dir = store.run_dir

    def _write(self, name: str, *args):
        out = getattr(self._store, name)(*args) if self._mesh.is_main else None
        self._mesh.barrier()
        return out

    def save(self, stage, kind, payload):
        return self._write("save", stage, kind, payload)

    def save_config(self, config_json):
        return self._write("save_config", config_json)

    def save_metadata(self, name, obj):
        return self._write("save_metadata", name, obj)

    def __getattr__(self, name):
        return getattr(self._store, name)


class QuietLogger:
    """The ``RunLogger`` of a rank that writes nothing."""

    def log(self, msg: str) -> None:
        pass

    def metrics(self, *args, **kwargs) -> None:
        pass

    def log_hyperparams(self, params) -> None:
        pass

    def close(self) -> None:
        pass


def rank_logger(mesh: Optional[Mesh], make):
    """``make()`` (a ``RunLogger``) on the first rank, a ``QuietLogger``
    on the others."""
    return make() if mesh is None or mesh.is_main else QuietLogger()
