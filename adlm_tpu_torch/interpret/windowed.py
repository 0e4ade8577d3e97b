"""Sliding-window full-resolution inference (counterpart of
``adlm_tpu.interpret.windowed``).

The image is covered by overlapping windows on a fixed grid, the last
window of a row or column clamped to the image's edge.  Each window's
logits are resized bilinearly to the window, weighted by a cosine taper
(about 1 at the centre, 0.05 at the border, which damps the convs' zero
padding) and added into a (B, H, W, K) canvas, the taper into a
(B, H, W, 1) norm beside it; the stitched logits are their quotient.
The output matches whole-image inference in the window interiors and
differs near the seams.  Activation memory is bounded by the window,
not the frame.  With ``with_stats`` the same forward also gives each
window's grid-resolution prototype statistics (reference
eval_valid.py:191-214), one forward per window, not two.

Two drivers:

* the fused driver takes the batch's frames once and slices
  ``window_batch`` windows at a time from them on the device, each
  chunk one batched forward (one head launch on the card; the last
  chunk runs short rather than padded);
* the per-window driver runs one forward per window, into a canvas on
  the device (``device_stitch``) or on the host, and also takes images
  smaller than the window: they are zero-padded and the pad-only cells
  of the statistics grid get ``stat_pred = -1``.

Every driver adds the windows into the canvas one at a time in grid
order, as the JAX package's ``fori_loop`` does, so the stitched logits
are the same f32 sums of the window logits.  The drivers then give the
same counters only where the backbone's convolutions give the same bits
at the fused chunk's batch and at the image batch: on an H100 in IEEE
f32 with 513² windows, cuDNN's do under its default settings (those of
the CLI) and under ``cudnn.deterministic`` (``chip_smoke.py`` phase 13);
other cards, dtypes, windows or PyTorch's CPU convolutions of the
full-depth backbone need not.  The purity pixels (``u`` then ``v`` per window,
grid order, one ``np.random.RandomState(seed)``) are the JAX package's.

Entry points run on the card unless the caller passes ``device``, in
IEEE f32 (``core.device.ieee_f32``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adlm_tpu_torch.core.device import DeviceLike, ieee_f32, to_device
from adlm_tpu_torch.interpret import evaluate
from adlm_tpu_torch.interpret.evaluate import (
    MeanStd,
    _images_nchw,
    _prepare,
    confusion_counts,
    mean_iou_from_confusion,
)
from adlm_tpu_torch.ops.normalize import normalize as normalize_images
from adlm_tpu_torch.ops.resize import resize_bilinear

_F32 = torch.float32
Canvas = Union[np.ndarray, torch.Tensor]
Window = Tuple[int, int]

# the share of the card's memory that the auto rule lets the canvas and
# one window batch's forward fill; the rest is left to the CUDA context,
# cuDNN's workspaces and the allocator's fragmentation
_MEMORY_SHARE = 0.9


def _window_grid(size: int, window: int, stride: int) -> List[int]:
    """Start offsets covering [0, size) with the final window clamped."""
    if size <= window:
        return [0]
    starts = list(range(0, size - window + 1, stride))
    if starts[-1] != size - window:
        starts.append(size - window)
    return starts


def _strides(window: Window, overlap: float) -> Window:
    wh, ww = window
    return (max(int(wh * (1.0 - overlap)), 1),
            max(int(ww * (1.0 - overlap)), 1))


def window_offsets(H: int, W: int, window: Window, overlap: float
                   ) -> List[Window]:
    """(row, column) starts of the windows over an H x W image, in grid
    order (row-major)."""
    sh, sw = _strides(window, overlap)
    return [(r, c) for r in _window_grid(H, window[0], sh)
            for c in _window_grid(W, window[1], sw)]


def _taper(window: Window, device) -> torch.Tensor:
    """(1, wh, ww, 1) cosine taper, 0.05 + 0.95·sin(π·(i + 0.5)/n) along
    each axis, in f32 as the JAX package computes it."""
    def axis(n: int) -> torch.Tensor:
        i = torch.arange(n, dtype=_F32, device=device)
        return 0.05 + 0.95 * torch.sin(math.pi * (i + 0.5) / n)

    return (axis(window[0])[:, None] * axis(window[1])[None, :])[None, :, :, None]


def _stitched_metrics(canvas: torch.Tensor, norm: torch.Tensor,
                      labels: torch.Tensor, num_classes: int
                      ) -> Dict[str, torch.Tensor]:
    """The canvas → metrics epilogue of every driver: the taper-weighted
    canvas normalized, resized to the label size if that differs, argmax,
    then the void-masked counters (``evaluate.confusion_counts``)."""
    logits = canvas / norm.clamp_min(1e-8)
    size = (labels.shape[1], labels.shape[2])
    if tuple(logits.shape[1:3]) != size:
        logits = resize_bilinear(logits, size)
    pred = torch.argmax(logits, dim=-1)
    return dict(confusion_counts(pred, labels, num_classes), pred=pred)


def _grid_extent(window: Window, ph: int, pw: int, gh: int, gw: int
                 ) -> Tuple[int, int]:
    """Valid extent of a (gh, gw) statistics grid for a window whose real
    content is (ph, pw) of its (wh, ww).  The grid is read off the
    forward's own output (65 x 65 for a 513² DeepLab window)."""
    wh, ww = window
    return (max(1, math.ceil(ph * gh / wh)), max(1, math.ceil(pw * gw / ww)))


def _forward(model: nn.Module, patches: torch.Tensor, normalize: MeanStd,
             with_stats: bool, mask: Optional[torch.Tensor] = None):
    """(logits (n, gh, gw, K), distances or None) of (n, wh, ww, 3)
    windows.  Raw uint8 windows are normalized here; ``mask`` re-zeroes
    the padding of a window that overhangs the image, as the host path
    pads normalized images with zeros."""
    x = normalize_images(patches, normalize)
    if mask is not None:
        x = x * mask
    return model(_images_nchw(model, x.contiguous()), return_distances=with_stats)


def _window_stats(logits: torch.Tensor, dist: torch.Tensor,
                  proto_class: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  extent: Tuple[int, int]) -> Tuple[torch.Tensor, ...]:
    """Grid statistics of n windows from their forward (reference
    eval_valid.py:191-214): ``stat_pred`` (−1 on cells outside the valid
    ``extent``, which then match no prototype), ``nearest``, top-K purity
    (n, P) at the (u, v) pixels scaled into the valid extent, and the
    agreement counts (n, P)."""
    n, gh, gw = logits.shape[0], logits.shape[1], logits.shape[2]
    vgh, vgw = extent
    dev = logits.device
    pred = torch.argmax(logits, dim=-1).to(torch.int32)
    nearest = torch.argmin(dist, dim=-1).to(torch.int32)
    ok = ((torch.arange(gh, device=dev)[:, None] < vgh)
          & (torch.arange(gw, device=dev)[None, :] < vgw))
    stat_pred = torch.where(ok, pred, -1)
    rows = torch.clamp((u * vgh).to(torch.int32), max=vgh - 1).long()
    cols = torch.clamp((v * vgw).to(torch.int32), max=vgw - 1).long()
    bidx = torch.arange(n, device=dev)[:, None]
    topk = evaluate._topk_purity(dist[bidx, rows, cols], pred[bidx, rows, cols],
                                 proto_class)
    return (stat_pred, nearest, topk,
            evaluate.agreement_counts(nearest, stat_pred, proto_class))


def _add_window(canvas: Canvas, norm: Canvas, up: torch.Tensor,
                taper: torch.Tensor, at: Window, size: Window) -> None:
    """Add one window's (B, wh, ww, K) tapered logits, cropped to its
    real ``size``, into the canvas at ``at``: in place on a device
    canvas, through a host copy on a numpy one."""
    (sh, sw), (ph, pw) = at, size
    up, taper = up[:, :ph, :pw], taper[:, :ph, :pw]
    if isinstance(canvas, np.ndarray):
        up, taper = up.cpu().numpy(), taper.cpu().numpy()
    canvas[:, sh:sh + ph, sw:sw + pw] += up
    norm[:, sh:sh + ph, sw:sw + pw] += taper


def _stitch_per_window(model: nn.Module, images: torch.Tensor, window: Window,
                       offsets: Sequence[Window], taper: torch.Tensor,
                       normalize: MeanStd, canvas: Canvas, norm: Canvas,
                       with_stats: bool = False, uv=None,
                       proto_class: Optional[torch.Tensor] = None) -> list:
    """The per-window driver: one forward per window of ``images``
    (B, H, W, 3) in grid order, stitched into ``canvas``/``norm``.
    Returns each window's statistics with ``with_stats`` (``uv``: the
    (N, B, n) pixel draws), else []."""
    wh, ww = window
    stats = []
    for k, (sh, sw) in enumerate(offsets):
        patch = images[:, sh:sh + wh, sw:sw + ww]
        ph, pw = patch.shape[1], patch.shape[2]
        mask = None
        if (ph, pw) != (wh, ww):  # the image is smaller than the window
            patch = F.pad(patch, (0, 0, 0, ww - pw, 0, wh - ph))
            mask = torch.zeros((1, wh, ww, 1), dtype=_F32, device=images.device)
            mask[:, :ph, :pw] = 1.0
        logits, dist = _forward(model, patch, normalize, with_stats, mask)
        up = resize_bilinear(logits, (wh, ww)) * taper
        _add_window(canvas, norm, up, taper, (sh, sw), (ph, pw))
        if with_stats:
            extent = _grid_extent(window, ph, pw, logits.shape[1], logits.shape[2])
            stats.append(_window_stats(logits, dist, proto_class, uv[0][k], uv[1][k],
                                       extent))
    return stats


def make_windowed_inference_fn(model: nn.Module, window: Window,
                               overlap: float = 0.25,
                               normalize: MeanStd = None,
                               device: DeviceLike = None) -> Callable:
    """``fn(image (B, H, W, 3))`` → stitched logits (B, H, W, K) on
    ``device`` (default the card), one forward per window.

    ``normalize=(mean, std)`` takes raw uint8 images and normalizes each
    window on the device."""
    dev = _prepare(model, device)
    taper = _taper(window, dev)
    K = model.cfg.num_classes

    def fn(image) -> torch.Tensor:
        with torch.inference_mode(), ieee_f32():
            image = to_device(image, dev)
            B, H, W = image.shape[0], image.shape[1], image.shape[2]
            canvas = torch.zeros((B, H, W, K), dtype=_F32, device=dev)
            norm = torch.zeros((B, H, W, 1), dtype=_F32, device=dev)
            _stitch_per_window(model, image, window, window_offsets(H, W, window, overlap),
                               taper, normalize, canvas, norm)
            return canvas / norm.clamp_min(1e-8)

    return fn


class WindowedSegEvaluator:
    """``SegEvaluator``-compatible eval over windowed inference, on
    ``device`` (default the card; CLI: ``eval-valid --windowed WH,WW``).

    The metrics are ``evaluate.make_inference_fn``'s (reference
    eval_valid.py:178-189); the stitched logits are resized to the label
    size before the argmax when the two differ.  With ``with_stats`` the
    same forwards give the grid statistics; by construction, cells in
    overlap bands count once per covering window toward the
    nearest-prototype counts, and ``n_random_pixels`` purity pixels are
    drawn per window, not per image.

    ``normalize=(mean, std)`` takes raw uint8 images, normalized on the
    device.  ``fused`` selects the fused driver, ``device_stitch`` the
    per-window driver's device canvas (module docstring).  Left None,
    both follow one rule: the fused driver with its canvas on the card
    when the image is at least window-sized and the frames, the canvas
    and its norm (B·H·W·(K + 4) f32) fit, beside one window batch's
    forward, in ``_MEMORY_SHARE`` of the card's total memory less what
    PyTorch holds allocated; else the per-window driver with its canvas
    on the host.  The forward's bytes per window pixel are measured once
    from the model itself (the peak of one window's forward, which
    launches the head once).  The rule reads neither the momentary free
    memory nor other processes, so one command on one card takes one
    driver every run; on the CPU both canvases live in host memory.
    The drivers' counters agree under the condition in the module
    docstring.

    ``keep_stat_maps=False`` returns only the (B, P) ``agree_counts`` and
    ``topk_purity``, not the (B·N, gh, gw) maps.  ``defer_sync`` keeps
    each update's packed (2C + 2,) counters and its statistics on the
    device; ``drain`` (or ``results``) fetches the whole queue with one
    concatenation and one copy to the host.
    """

    def __init__(self, model: nn.Module, num_classes: int, window: Window,
                 overlap: float = 0.25, with_stats: bool = False,
                 n_random_pixels: int = 100, seed: int = 0,
                 normalize: MeanStd = None,
                 device_stitch: Optional[bool] = None,
                 keep_stat_maps: bool = True, fused: Optional[bool] = None,
                 window_batch: int = 8, defer_sync: bool = False,
                 device: DeviceLike = None):
        self.dev = _prepare(model, device)
        self.model = model
        self.num_classes = num_classes
        self.window = tuple(window)
        self.overlap = overlap
        self.with_stats = with_stats
        self.n_random = n_random_pixels
        self.rng = np.random.RandomState(seed)
        self.normalize = normalize
        self.device_stitch = device_stitch
        self.keep_stat_maps = keep_stat_maps
        self.fused = fused
        self.window_batch = max(1, window_batch)
        self.defer_sync = defer_sync
        self.taper = _taper(self.window, self.dev)
        self._act_bytes_per_pixel: Optional[float] = None
        self.reset()

    def reset(self) -> None:
        self.intersection = np.zeros(self.num_classes, np.int64)
        self.union = np.zeros(self.num_classes, np.int64)
        self.correct = 0
        self.total = 0
        self._pending: List[Dict[str, Any]] = []

    def _forward_bytes_per_pixel(self) -> float:
        """Peak bytes per window pixel of one window's forward (a zero
        window at batch 1), measured on the card once per evaluator; it
        resets the card's peak-memory statistics."""
        if self._act_bytes_per_pixel is None:
            wh, ww = self.window
            torch.cuda.synchronize(self.dev)
            base = torch.cuda.memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
            probe = torch.zeros((1, wh, ww, 3), dtype=_F32, device=self.dev)
            _forward(self.model, probe, None, self.with_stats)
            torch.cuda.synchronize(self.dev)
            peak = torch.cuda.max_memory_allocated(self.dev) - base
            self._act_bytes_per_pixel = peak / (wh * ww)
        return self._act_bytes_per_pixel

    def _canvas_fits(self, B: int, H: int, W: int) -> bool:
        if self.dev.type != "cuda":
            return True
        wh, ww = self.window
        need = (4 * B * H * W * (self.model.cfg.num_classes + 4)
                + self._forward_bytes_per_pixel() * self.window_batch * B * wh * ww)
        total = torch.cuda.get_device_properties(self.dev).total_memory
        return need <= _MEMORY_SHARE * total - torch.cuda.memory_allocated(self.dev)

    def _draw_uv(self, n_windows: int, B: int):
        """(u, v), each (N, B, n) f32 on the device: u then v per window,
        in grid order."""
        u = np.empty((n_windows, B, self.n_random), np.float32)
        v = np.empty_like(u)
        for k in range(n_windows):
            u[k] = self.rng.random_sample((B, self.n_random))
            v[k] = self.rng.random_sample((B, self.n_random))
        return to_device(u, self.dev), to_device(v, self.dev)

    def _fused_pass(self, images, offsets, uv, proto_class):
        """The fused driver: (device canvas, norm, statistics per chunk)."""
        wh, ww = self.window
        B, H, W = images.shape[0], images.shape[1], images.shape[2]
        K = self.model.cfg.num_classes
        frames = normalize_images(images, self.normalize)
        canvas = torch.zeros((B, H, W, K), dtype=_F32, device=self.dev)
        norm = torch.zeros((B, H, W, 1), dtype=_F32, device=self.dev)
        stats = []
        for c in range(0, len(offsets), self.window_batch):
            chunk = offsets[c:c + self.window_batch]
            patches = torch.stack([frames[:, sh:sh + wh, sw:sw + ww] for sh, sw in chunk])
            logits, dist = _forward(self.model, patches.flatten(0, 1), None,
                                    self.with_stats)
            up = (resize_bilinear(logits, (wh, ww)) * self.taper).unflatten(0, (len(chunk), B))
            for i, at in enumerate(chunk):
                _add_window(canvas, norm, up[i], self.taper, at, self.window)
            if self.with_stats:
                sel = slice(c, c + len(chunk))
                stats.append(_window_stats(
                    logits, dist, proto_class, uv[0][sel].flatten(0, 1),
                    uv[1][sel].flatten(0, 1), (logits.shape[1], logits.shape[2])))
        return canvas, norm, stats

    def update(self, proto_class, images, labels) -> Dict[str, Any]:
        """One batch of images (B, H, W, 3) and raw labels (B, H, W):
        accumulates the counters and returns ``pred`` (B, H, W),
        ``intersection``/``union``, ``correct``/``total`` and, with
        stats, ``agree_counts`` and
        ``topk_purity`` (B, P), ``stat_windows`` and (``keep_stat_maps``)
        the image-major ``stat_pred``/``nearest_proto`` maps."""
        wh, ww = self.window
        K = self.model.cfg.num_classes
        with torch.inference_mode(), ieee_f32():
            images = to_device(images, self.dev)
            labels = to_device(labels, self.dev)
            proto_class = to_device(proto_class, self.dev)
            B, H, W = images.shape[0], images.shape[1], images.shape[2]
            offsets = window_offsets(H, W, self.window, self.overlap)
            N = len(offsets)
            uv = self._draw_uv(N, B) if self.with_stats else None
            whole = H >= wh and W >= ww
            auto = self.fused is None or self.device_stitch is None
            fits = auto and whole and self._canvas_fits(B, H, W)
            fused = fits if self.fused is None else self.fused
            if fused and whole:
                canvas, norm, stats = self._fused_pass(images, offsets, uv, proto_class)
            else:
                on_dev = fits if self.device_stitch is None else self.device_stitch
                if on_dev:
                    canvas = torch.zeros((B, H, W, K), dtype=_F32, device=self.dev)
                    norm = torch.zeros((B, H, W, 1), dtype=_F32, device=self.dev)
                else:
                    canvas = np.zeros((B, H, W, K), np.float32)
                    norm = np.zeros((B, H, W, 1), np.float32)
                stats = _stitch_per_window(self.model, images, self.window, offsets,
                                           self.taper, self.normalize, canvas, norm,
                                           self.with_stats, uv, proto_class)
                if not on_dev:  # the host canvas's epilogue runs on the host
                    canvas, norm = torch.from_numpy(canvas), torch.from_numpy(norm)
                    labels = labels.cpu()
            out = _stitched_metrics(canvas, norm, labels, self.num_classes)
            pending = {"counters": torch.cat([out["intersection"], out["union"],
                                              out["correct"][None], out["total"][None]])}
            result = {k: out[k] for k in ("pred", "intersection", "union", "correct", "total")}
            if self.with_stats:
                sp, nr, topk, agree = (torch.cat(s) for s in zip(*stats))
                pending.update(topk_purity=topk.view(N, B, -1).mean(0),
                               agree_counts=agree.view(N, B, -1).sum(0))
                result.update(topk_purity=pending["topk_purity"],
                              agree_counts=pending["agree_counts"], stat_windows=N)
                if self.keep_stat_maps:
                    gh, gw = sp.shape[1], sp.shape[2]
                    result["stat_pred"] = sp.view(N, B, gh, gw).transpose(0, 1).reshape(
                        -1, gh, gw)
                    result["nearest_proto"] = nr.view(N, B, gh, gw).transpose(0, 1).reshape(
                        -1, gh, gw)
        pending["stat_windows"] = N
        self._pending.append(pending)
        if not self.defer_sync:
            self.drain()
        return result

    def drain(self) -> List[Tuple[np.ndarray, np.ndarray, int]]:
        """Fold the queued updates into the host counters: one
        concatenation on the device, one fetch.  Returns each drained
        update's ``(topk_purity (B, P), agree_counts (B, P), n_windows)``
        with stats, else []."""
        if not self._pending:
            return []
        pend, self._pending = self._pending, []
        C = self.num_classes
        n_cnt = 2 * C + 2
        # f64 holds every count and every f32 purity exactly; a host
        # canvas's counters come from the host epilogue and join the
        # device's statistics here
        flat = [p["counters"].to(self.dev, torch.float64) for p in pend]
        if self.with_stats:
            flat += [p[k].flatten().to(self.dev, torch.float64) for p in pend
                     for k in ("topk_purity", "agree_counts")]
        host = torch.cat(flat).cpu().numpy()
        counters = host[:len(pend) * n_cnt].reshape(len(pend), n_cnt).astype(np.int64)
        self.intersection += counters[:, :C].sum(axis=0)
        self.union += counters[:, C:2 * C].sum(axis=0)
        self.correct += int(counters[:, 2 * C].sum())
        self.total += int(counters[:, 2 * C + 1].sum())
        if not self.with_stats:
            return []
        stats, at = [], len(pend) * n_cnt
        for p in pend:
            shape, n = tuple(p["topk_purity"].shape), p["topk_purity"].numel()
            stats.append((host[at:at + n].reshape(shape).astype(np.float32),
                          host[at + n:at + 2 * n].reshape(shape).astype(np.int64),
                          p["stat_windows"]))
            at += 2 * n
        return stats

    def results(self) -> Dict[str, Any]:
        self.drain()
        miou, ious = mean_iou_from_confusion(self.intersection, self.union)
        acc = self.correct * 100.0 / max(self.total, 1)
        return {"mean_iou": miou, "iou_per_class": ious, "pixel_accuracy": acc}
