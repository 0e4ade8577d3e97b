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
``parallel/spatial.py``.

The tensor-parallel prototype head (``prototype_parallel_params``,
``prototype_parallel=True``) splits the bank and the last layer's
prototype dimension over the model ranks: each rank runs the head
kernel on its slice, the partial logits are a SUM over the model group,
the nearest prototype a (value, index) minimum over it, and the sampled
pixels' distances a zero-filled buffer each rank fills at its slice,
SUM-reduced.  As in the JAX package, no CLI flag reaches it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
from torch import nn

from adlm_tpu_torch.core.mesh import Mesh, row_range


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


@dataclass(frozen=True)
class PrototypeSlice:
    """A model rank's block of the prototype head: rows [start, start +
    P') of the (P, C) bank and of the (P, K) last layer, ``total`` = P."""

    prototypes: torch.Tensor
    last_layer: torch.Tensor
    start: int
    total: int

    @property
    def bank(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.prototypes, self.last_layer


def prototype_parallel_params(model, mesh: Mesh) -> PrototypeSlice:
    """Tensor-parallel placement of the prototype head (the JAX package's
    ``prototype_parallel_params``): this rank keeps the contiguous block
    ``row_range(model index, P, model)`` of ``prototype_vectors`` and of
    the last layer's prototype dimension, as copies on its device (the
    module's own parameters stay whole, so the same model still serves
    one-process eval); everything else stays replicated in the module.
    ``make_sharded_inference_fn(..., prototype_parallel=True)`` takes it."""
    P = model.prototype_vectors.shape[0]
    lo, hi = row_range(mesh.model_index, P, mesh.model)
    if hi == lo:
        raise ValueError(f"{P} prototypes do not split over {mesh.model} model ranks")
    with torch.no_grad():
        protos, last = (t[lo:hi].to(mesh.device).clone(memory_format=torch.contiguous_format)
                        for t in (model.prototypes(), model.last_layer_pk()))
    return PrototypeSlice(protos, last, lo, P)


def gather_bank(tp: PrototypeSlice, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole (P, C) bank and (P, K) last layer from the model group's
    slices: zero-filled buffers each rank fills at its rows, SUM-reduced
    in f32 (each entry has one writer, so the sum adds zeros: exact)."""
    out = []
    for part in tp.bank:
        buf = torch.zeros((tp.total,) + tuple(part.shape[1:]), dtype=torch.float32,
                          device=part.device)
        buf[tp.start:tp.start + part.shape[0]] = part
        out.append(mesh.all_reduce_model_(buf).to(part.dtype))
    return out[0], out[1]


def _prototype_parallel_step(model, num_classes: int, mesh: Mesh, with_stats: bool,
                             stats_upsampled: bool, normalize, stats_exact: bool,
                             proto_chunk: int = 16):
    """``step(tp, proto_class, images, labels, *uv)``: the eval step of
    ``interpret.evaluate.make_inference_fn`` on this rank's data slice
    with the head on its ``PrototypeSlice``.  The counters are this data
    slice's (``sharded_update`` sums them over the data group only: every
    model rank holds the same ``pred``)."""
    # the evaluator's and the kernel's functions are looked up at each
    # call, as make_inference_fn's are (a caller may wrap them)
    from adlm_tpu_torch.core.device import ieee_f32, to_device
    from adlm_tpu_torch.interpret import evaluate as E
    from adlm_tpu_torch.ops import upsample_argmin as UA
    from adlm_tpu_torch.ops.normalize import normalize as normalize_images
    from adlm_tpu_torch.ops.resize import resize_bilinear

    dev = E._prepare(model, mesh.device)
    f32 = torch.float32

    def step(tp: PrototypeSlice, proto_class, images, labels, *uv):
        with torch.inference_mode(), ieee_f32():
            x = normalize_images(to_device(images, dev), normalize)
            labels = to_device(labels, dev)
            pc = to_device(proto_class, dev)
            feats = model.conv_features(E._images_nchw(model, x))
            part_logits, dist = model.head(feats, with_stats, tp.bank)
            grid_logits = mesh.all_reduce_model_(part_logits.contiguous())
            H, W = labels.shape[1], labels.shape[2]
            pred = torch.argmax(resize_bilinear(grid_logits, (H, W)), dim=-1)
            out = dict(E.confusion_counts(pred, labels, num_classes), pred=pred)
            if not with_stats:
                return out
            B = dist.shape[0]
            u = torch.atleast_2d(to_device(uv[0], dev, f32))
            v = torch.atleast_2d(to_device(uv[1], dev, f32))
            u, v = u.expand(B, u.shape[-1]), v.expand(B, v.shape[-1])
            bidx = torch.arange(B, device=dev)[:, None]
            if stats_upsampled:
                sh, sw = H, W
                stat_pred = pred
                chunk = max(1, min(proto_chunk, (64 * 1024 * 1024) // (B * sh * sw)))
                idx, val = UA.upsampled_nearest(dist, (H, W), chunk, exact=stats_exact,
                                                with_value=True)
            else:
                sh, sw = dist.shape[1], dist.shape[2]
                stat_pred = torch.argmax(grid_logits, dim=-1)
                val, idx = dist.amin(dim=-1), torch.argmin(dist, dim=-1)
            _, nearest = mesh.lexmin(val, idx.long() + tp.start, over="model")
            nearest = nearest.to(torch.int32)
            rows = torch.clamp((u * sh).to(torch.int32), max=sh - 1).long()
            cols = torch.clamp((v * sw).to(torch.int32), max=sw - 1).long()
            local = (E._bilinear_gather(dist, rows, cols, sh, sw) if stats_upsampled
                     else dist[bidx, rows, cols])
            sample_d = local.new_zeros(local.shape[:2] + (tp.total,))
            sample_d[..., tp.start:tp.start + local.shape[-1]] = local
            mesh.all_reduce_model_(sample_d)
            out.update(stat_pred=stat_pred, nearest_proto=nearest,
                       agree_counts=E.agreement_counts(nearest, stat_pred, pc),
                       topk_purity=E._topk_purity(sample_d, stat_pred[bidx, rows, cols], pc))
            return out

    return step


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
    of the rank's rows; ``fn`` also takes ``n_valid``).

    ``prototype_parallel=True``: ``fn(tp, proto_class, images, labels,
    *uv, n_valid=None)`` with ``tp`` this rank's ``PrototypeSlice``
    (``prototype_parallel_params``).  Without ``spatial`` (or with one
    model rank) the head runs tensor-parallel on the rank's slice of the
    bank over the whole frame: the counters summed over the data group,
    ``pred`` and the statistic maps of the rank's images, each model rank
    holding the same.  With ``spatial`` and ``mesh.model`` > 1 both split
    over the one model axis, so the model group gathers the bank and the
    last layer (``gather_bank``) and the spatial step runs with them."""
    if prototype_parallel and spatial and mesh.model > 1:
        from adlm_tpu_torch.parallel.spatial import make_spatial_inference_fn

        sp = make_spatial_inference_fn(model, num_classes, mesh, with_stats,
                                       stats_upsampled, normalize, stats_exact)

        def spatial_fn(tp, proto_class, images, labels, *uv, n_valid=None):
            return sp(proto_class, images, labels, *uv, n_valid=n_valid,
                      bank=gather_bank(tp, mesh))

        return spatial_fn
    if prototype_parallel:
        from adlm_tpu_torch.interpret.evaluate import sharded_update

        step = _prototype_parallel_step(model, num_classes, mesh, with_stats,
                                        stats_upsampled, normalize, stats_exact)

        def tp_fn(tp, proto_class, images, labels, *uv, n_valid=None):
            b = images.shape[0]
            share = b if n_valid is None else mesh.share(n_valid, b)
            return sharded_update(functools.partial(step, tp), mesh, num_classes,
                                  with_stats, proto_class, images, labels, uv, share)

        return tp_fn
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
