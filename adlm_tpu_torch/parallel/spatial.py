"""Spatial eval: image H split over the ranks of a model group.

The JAX package gets this mode from annotations alone: ``P(data,
model)`` on (B, H, W, C) (``adlm_tpu.core.mesh.spatial_sharding``), and
XLA inserts a halo exchange at every convolution.  Here each rank is a
process and the exchange is explicit (``Mesh.exchange_rows``, one
collective each):

* the row plan: rank r of M owns rows [⌊r·n/M⌋, ⌊(r+1)·n/M⌋) of every
  activation of height n (``core.mesh.row_range``), so ownership
  depends on the height alone and the two branches of a bottleneck own
  the same output rows;
* an operator whose output rows read other rows (``RowOp``: a conv of
  any kernel, stride, dilation and padding, the ceil-mode max pool, a
  1x1 stride-2 conv) fetches the input rows its outputs read, with the
  rows past the image edge filled (0, or −inf for the pool), and runs
  with no padding in H (W keeps its padding);
* frozen BN, relu, the residual add, the add-on 1x1 convs and the
  prototype head work row by row and need nothing;
* the logits' bilinear resize to the label reads the grid rows around
  each rank's label rows (``ops.resize.resize_bilinear_rows``: the
  whole-frame resize of those rows in a zero-filled grid, so the rank's
  rows are the one-process resize's bit for bit), and the upsampled
  statistics run the upsample-argmin kernel on the rank's label rows
  (its output-row window) over the distance rows they read.

``forward_rows`` runs DeepLabV2 and the PPNet head on a rank's rows with
the modules' own parameters; the single-device forward in
``models/*.py`` is not touched.  The first convolution reads its input
rows, with the stem's halo, straight from the frame the data rank
loaded.  The dilated convs run as dilated convs (the ``s2b`` route is
the same function).

An MSC model (``msc_scales``) runs the trunk once more per scale: each
rank resizes the whole frame by the scale (the call one process makes,
so the same bits, and no exchange), runs the trunk on its rows of that
scale's grid (a row plan of its own), fetches the pyramid rows its
base-grid rows read (one exchange per scale) and resizes them as the
logits are resized (a zero-filled whole grid), then takes the max over
the scales.

The tensor-parallel head (``parallel/sharding.py``) runs here with the
bank its model group gathered (``bank``).

``make_spatial_inference_fn`` is the eval step of
``make_inference_fn`` over such a mesh: the counters summed over the
world (int64), ``pred`` (and the statistic maps) of the rank's own rows,
``agree_counts`` summed, and ``topk_purity`` from the sampled pixels,
each pixel's distances and class taken from the rank that holds its
row (a zero-filled buffer, SUM over the world).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from adlm_tpu_torch.core.mesh import Mesh, row_range
from adlm_tpu_torch.ops.resize import (
    bilinear_source_rows,
    resize_bilinear_factor,
    resize_bilinear_rows,
)

Rows = Tuple[int, int]
_F32 = torch.float32


def row_plan(n: int, parts: int) -> List[Rows]:
    """Each part's rows of an activation of height ``n``; every part must
    hold one at least."""
    if n < parts:
        raise ValueError(f"an activation of {n} rows does not split over {parts} ranks")
    return [row_range(q, n, parts) for q in range(parts)]


@dataclass(frozen=True)
class RowOp:
    """The H geometry of an operator whose output row o reads input rows
    o·stride − padding + j·dilation, j < kernel; ``ceil`` for a ceil-mode
    pool."""

    kernel: int
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    ceil: bool = False

    def out_rows(self, n: int) -> int:
        span = n + 2 * self.padding - self.dilation * (self.kernel - 1) - 1
        if not self.ceil:
            return span // self.stride + 1
        out = -(-span // self.stride) + 1
        # the last window starts inside the input or its leading padding
        return out - 1 if (out - 1) * self.stride >= n + self.padding else out

    def reads(self, rows: Rows) -> Rows:
        """Input rows [lo, hi) that output rows ``rows`` read."""
        lo, hi = rows
        first = lo * self.stride - self.padding
        return first, (hi - 1) * self.stride - self.padding + self.dilation * (self.kernel - 1) + 1


def conv_op(conv: nn.Conv2d, dilation: Optional[int] = None) -> RowOp:
    """The H geometry of ``conv`` (``dilation`` overrides the module's,
    for the space-to-batch route of ``ConvBN``, which holds its dilation
    outside the conv)."""
    d = conv.dilation[0] if dilation is None else dilation
    pad = d * (conv.kernel_size[0] - 1) // 2 if dilation is not None else conv.padding[0]
    return RowOp(conv.kernel_size[0], conv.stride[0], pad, d)


STEM_POOL = RowOp(3, 2, 1, ceil=True)


class Rank:
    """One rank's side of the row plan: what it holds and fetches."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.M, self.me = mesh.model, mesh.model_index

    def fetch(self, x: torch.Tensor, n_in: int, op: RowOp, n_out: int,
              fill: float = 0.0) -> torch.Tensor:
        """The input rows (NCHW, this rank's rows of ``n_in``) that this
        rank's output rows of ``op`` read."""
        need = [op.reads(r) for r in row_plan(n_out, self.M)]
        if all(n == o for n, o in zip(need, row_plan(n_in, self.M))):
            return x
        return self.exchange(x, n_in, need, fill)

    def exchange(self, x: torch.Tensor, n: int, need: Sequence[Rows],
                 fill: float = 0.0) -> torch.Tensor:
        """``Mesh.exchange_rows`` on an NCHW tensor, through its
        (B, H, W, C) view: the layout the port keeps (channels-last), so
        each piece is a contiguous run of rows."""
        y = self.mesh.exchange_rows(x.permute(0, 2, 3, 1).contiguous(), 1,
                                    row_plan(n, self.M), need, fill)
        return y.permute(0, 3, 1, 2)

    def rows(self, n: int) -> Rows:
        return row_range(self.me, n, self.M)


def _conv_rows(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on fetched rows: no padding in H, the module's in W."""
    return F.conv2d(x, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]),
                    conv.dilation, conv.groups)


def _conv_bn_rows(cb: nn.Module, x: torch.Tensor, op: RowOp) -> torch.Tensor:
    """A ``ConvBN`` on fetched rows (its ``s2b`` route as the dilated
    conv it computes)."""
    y = F.conv2d(x, cb.conv.weight, None, op.stride, (0, op.padding), op.dilation)
    y = cb.bn(y)
    return F.relu(y) if cb.relu else y


def _convbn_op(cb: nn.Module) -> RowOp:
    return conv_op(cb.conv, cb.dilation if getattr(cb, "s2b", False) else None)


def check_model(model: nn.Module) -> None:
    """Spatial eval runs the DeepLabV2 segmentation models, MSC or not."""
    cfg = model.cfg
    if cfg.base_architecture != "deeplabv2_resnet101" or not cfg.patch_classification:
        raise ValueError("spatial eval runs the DeepLabV2 segmentation models")


def trunk_rows(base: nn.Module, images: torch.Tensor, rank: Rank
               ) -> Tuple[torch.Tensor, int]:
    """DeepLabV2 (stem to the ASPP sum) on this rank's rows: (its rows of
    the output, NCHW, the output's height).  ``images`` are whole frames
    (B, 3, H, W) in the model's dtype (any strides)."""
    n = images.shape[2]
    # the stem conv reads its rows (zero-filled past the edge) from the frame
    cb = base.layer1.conv1
    op = _convbn_op(cb)
    n1 = op.out_rows(n)
    lo, hi = op.reads(rank.rows(n1))
    x = images[:, :, max(lo, 0):min(hi, n)]
    if lo < 0 or hi > n:
        x = F.pad(x, (0, 0, max(-lo, 0), max(hi - n, 0)))
    x = _conv_bn_rows(cb, x.contiguous(memory_format=torch.channels_last), op)
    # the ceil-mode max pool: −inf past the edge
    n2 = STEM_POOL.out_rows(n1)
    x = F.max_pool2d(rank.fetch(x, n1, STEM_POOL, n2, -math.inf), 3, 2, (0, 1),
                     ceil_mode=True)
    n = n2
    for li in range(2, 6):
        for block in getattr(base, f"layer{li}"):
            s = block.reduce.conv.stride[0]
            n_out = RowOp(1, s).out_rows(n)
            xs = rank.fetch(x, n, RowOp(1, s), n_out)
            h = block.reduce(xs)                      # 1x1, no padding
            op = _convbn_op(block.conv3x3)
            h = _conv_bn_rows(block.conv3x3, rank.fetch(h, n_out, op, n_out), op)
            h = block.increase(h)
            sc = block.shortcut(xs) if block.shortcut is not None else x
            x, n = F.relu(h + sc), n_out
    # ASPP: the widest rate's rows once, each rate its own window of them
    aspp = base.aspp
    convs = [getattr(aspp, f"c{i}") for i in range(aspp.n)]
    r_max = max(c.dilation[0] for c in convs)
    xs = rank.fetch(x, n, RowOp(3, 1, r_max, r_max), n)
    own = rank.rows(n)[1] - rank.rows(n)[0]
    parts = []
    for c in convs:
        r = c.dilation[0]
        sub = xs[:, :, r_max - r:r_max - r + own + 2 * r]
        parts.append(_conv_rows(c, sub))
    return sum(parts), n


def msc_rows(base: nn.Module, images: torch.Tensor, rank: Rank, x: torch.Tensor,
             n: int, scales: Sequence[float]) -> torch.Tensor:
    """``models.deeplab.MSC``'s eval output on this rank's rows of the
    base grid (``n`` rows; ``x`` its trunk rows at scale 1): the max of
    ``x`` and of each scale's trunk output resized to the base grid."""
    lo, hi = rank.rows(n)
    size = (n, x.shape[3])
    parts = [x]
    for s in scales:
        y, n_s = trunk_rows(base, resize_bilinear_factor(images, s, channel_last=False), rank)
        need = [bilinear_source_rows(n, n_s, *r) for r in row_plan(n, rank.M)]
        y = rank.exchange(y, n_s, need).permute(0, 2, 3, 1)
        up = resize_bilinear_rows(y, size, lo, hi, first_row=need[rank.me][0], in_h=n_s)
        parts.append(up.permute(0, 3, 1, 2))
    return torch.stack(parts).amax(dim=0)


def forward_rows(model: nn.Module, images: torch.Tensor, rank: Rank,
                 return_distances: bool = True,
                 bank: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """The PPNet forward on this rank's rows: (logits (B, h_r, w, K),
    distances (B, h_r, w, P) or None, the grid height h).

    ``images`` are the data rank's whole normalized frames, (B, 3, H, W)
    in the model's dtype (any strides); ``bank`` replaces the head's
    prototypes and last layer (``PPNet.head``)."""
    features = model.features
    x, n = trunk_rows(features.base, images, rank)
    if features.scales:
        x = msc_rows(features.base, images, rank, x, n, features.scales)
    for m in model.add_on_layers.children():
        if isinstance(m, nn.Conv2d) and (m.kernel_size[0] > 1 or m.stride[0] > 1):
            op = conv_op(m)
            n_out = op.out_rows(n)
            x, n = _conv_rows(m, rank.fetch(x, n, op, n_out)), n_out
        else:
            x = m(x)
    logits, dist = model.head(x, return_distances, bank)
    return logits, dist, n


def _gather(mesh: Mesh, local: torch.Tensor, b: int) -> torch.Tensor:
    """The (b·data, ...) rows of the global batch from each rank's
    partial ``local`` (b, ...): a zero-filled buffer each rank fills at
    its data rows, SUM over the world (which also sums the model group's
    partials)."""
    buf = local.new_zeros((b * mesh.data,) + tuple(local.shape[1:]))
    buf[mesh.data_index * b:(mesh.data_index + 1) * b] = local
    return mesh.all_reduce_world_(buf)


def make_spatial_inference_fn(model: nn.Module, num_classes: int, mesh: Mesh,
                              with_stats: bool = False, stats_upsampled: bool = False,
                              normalize=None, stats_exact: bool = False,
                              proto_chunk: int = 16) -> Callable:
    """The eval step of ``interpret.evaluate.make_inference_fn`` with
    image H over ``mesh``'s model ranks (and the batch over its data
    ranks): ``fn(proto_class, images, labels, *uv, n_valid=None,
    bank=None)`` on this data rank's (b, H, W, ·) slice of a global batch
    whose first ``n_valid`` images are real (default: all); ``bank``
    replaces the head's prototypes and last layer.

    Returns ``intersection``/``union``/``correct``/``total`` summed over
    the world (int64), ``pred`` (b, H_r, W) of this rank's label rows
    (``Rank(mesh).rows(H)``) and, with stats, ``stat_pred`` and
    ``nearest_proto`` of its rows (of the grid, or of the label with
    ``stats_upsampled``), ``agree_counts`` (b·data, P) summed, and
    ``topk_purity`` (b·data, P) from the sampled pixels, zero for
    padding images.  A data rank whose slice is all padding runs no
    forward (its model group skips the exchanges together) and returns
    no maps."""
    # the evaluator's and the kernel's functions are looked up at each
    # call, as make_inference_fn's are (a caller may wrap them)
    from adlm_tpu_torch.core.device import ieee_f32, to_device
    from adlm_tpu_torch.interpret import evaluate as E
    from adlm_tpu_torch.ops import upsample_argmin as UA
    from adlm_tpu_torch.ops.normalize import normalize as normalize_images

    check_model(model)
    dev = E._prepare(model, mesh.device)
    rank = Rank(mesh)
    K = num_classes

    def fn(proto_class, images, labels, *uv, n_valid: Optional[int] = None,
           bank: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
           ) -> Dict[str, torch.Tensor]:
        with torch.inference_mode(), ieee_f32():
            b, H, W = labels.shape[0], labels.shape[1], labels.shape[2]
            share = b if n_valid is None else mesh.share(n_valid, b)
            lo, hi = rank.rows(H)
            pc = to_device(proto_class, dev)
            P = pc.shape[0]
            out = {}
            counts = torch.zeros(2 * K + 2, dtype=torch.long, device=dev)
            if share > 0:
                x = normalize_images(to_device(images, dev), normalize)
                lab = to_device(labels, dev)[:, lo:hi]
                grid_logits, dist, h = forward_rows(model, E._images_nchw(model, x), rank,
                                                    with_stats, bank)
                g_plan = row_plan(h, mesh.model)
                need = bilinear_source_rows(H, h, lo, hi)
                lg = rank.exchange(grid_logits.permute(0, 3, 1, 2), h,
                                   [bilinear_source_rows(H, h, *r)
                                    for r in row_plan(H, mesh.model)])
                logits = resize_bilinear_rows(lg.permute(0, 2, 3, 1), (H, W), lo, hi,
                                              first_row=need[0], in_h=h)
                pred = torch.argmax(logits, dim=-1)
                c = E.confusion_counts(pred, lab, K)
                counts = torch.cat([c["intersection"].long(), c["union"].long(),
                                    c["correct"].long().reshape(1),
                                    c["total"].long().reshape(1)])
                out["pred"] = pred
            mesh.all_reduce_world_(counts)
            out.update(intersection=counts[:K], union=counts[K:2 * K],
                       correct=counts[2 * K], total=counts[2 * K + 1])
            if not with_stats:
                return out
            n = uv[0].shape[-1]
            agree = torch.zeros((b, P), dtype=torch.int32, device=dev)
            sample_d = torch.zeros((b, n, P), dtype=_F32, device=dev)
            sample_pred = torch.zeros((b, n), dtype=torch.long, device=dev)
            if share > 0:
                u = torch.atleast_2d(to_device(uv[0], dev, _F32)).expand(b, n)
                v = torch.atleast_2d(to_device(uv[1], dev, _F32)).expand(b, n)
                bidx = torch.arange(b, device=dev)[:, None]
                if stats_upsampled:
                    sh, sw, s_lo, s_hi = H, W, lo, hi
                    stat_pred = pred
                    first = UA.tap_rows(H, h, lo, hi)[0]
                    d = rank.exchange(dist.permute(0, 3, 1, 2), h,
                                      [UA.tap_rows(H, h, *r) for r in row_plan(H, mesh.model)])
                    d = d.permute(0, 2, 3, 1).contiguous()
                    chunk = max(1, min(proto_chunk, (64 * 1024 * 1024) // (b * (hi - lo) * W)))
                    nearest = UA.upsampled_nearest(d, (H, W), chunk, exact=stats_exact,
                                                   out_rows=(lo, hi - lo), map_rows=(first, h))
                else:
                    sh, sw = h, dist.shape[2]
                    s_lo, s_hi = g_plan[mesh.model_index]
                    stat_pred = torch.argmax(grid_logits, dim=-1)
                    nearest = torch.argmin(dist, dim=-1).to(torch.int32)
                rows = torch.clamp((u * sh).to(torch.int32), max=sh - 1).long()
                cols = torch.clamp((v * sw).to(torch.int32), max=sw - 1).long()
                mine = (rows >= s_lo) & (rows < s_hi)
                at = torch.where(mine, rows, s_lo)
                if stats_upsampled:
                    got_d = E._bilinear_gather(d, at, cols, sh, sw, first_row=first, in_h=h)
                else:
                    got_d = dist[bidx, at - s_lo, cols]
                got_pred = stat_pred[bidx, at - s_lo, cols]
                keep = torch.arange(b, device=dev)[:, None] < share
                sample_d = torch.where((mine & keep)[..., None], got_d, 0.0)
                sample_pred = torch.where(mine & keep, got_pred, 0)
                agree[:share] = E.agreement_counts(nearest, stat_pred, pc)[:share]
                out.update(stat_pred=stat_pred, nearest_proto=nearest)
            out["agree_counts"] = _gather(mesh, agree, b)
            sample_d = _gather(mesh, sample_d, b)
            sample_pred = _gather(mesh, sample_pred, b)
            purity = E._topk_purity(sample_d, sample_pred, pc)
            n_real = b * mesh.data if n_valid is None else n_valid
            purity[n_real:] = 0.0
            out["topk_purity"] = purity
            return out

    return fn
