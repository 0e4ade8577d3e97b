"""npy-backed segmentation dataset with reference-parity augmentation
(counterpart of ``adlm_tpu.data.dataset``).

Disk layout (identical to the reference's preprocessed layout,
reference segmentation/dataset.py:55,72,86):

    DATA_PATH/
      all_images.json                      # {split: [img_id, ...]}
      img_with_margin_<m>/<split>/<id>.npy # HWC uint8 images (+.png for push)
      annotations/<split>/<id>.npy         # HW integer labels

Training augmentation matches reference dataset.py:119-173: class-table
remap, random scale ∈ scales, /255 (unless cells), pad to window with
dataset mean, random crop, random hflip, normalize.  It is always the
host C++ chain (``adlm_tpu_torch.native.augment_sample``, the JAX
package's native path) on memory-mapped images and raw labels; there is
no PIL path.  Where the JAX package resizes with PIL (the eval-time
input resize and the overlays), this module has numpy copies of PIL's
resampling: ``Image.BILINEAR`` on float ("F") channels and
``Image.NEAREST`` on integer ("I") labels.
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import Iterator, List, Optional, Tuple

import numpy as np

from adlm_tpu_torch import native
from adlm_tpu_torch.core.config import DataConfig
from adlm_tpu_torch.data.constants import get_class_table


def _pil_bilinear_coeffs(in_size: int, out_size: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` for its bilinear filter (support 1,
    widened by the scale on downsampling), in double precision: the
    first source index of each output and its (out, taps) normalized
    weights, zero past the output's last tap."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    t = ((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale)
    k = np.where(np.abs(t) < 1.0, 1.0 - np.abs(t), 0.0)
    k = np.where(taps[None, :] < xmax[:, None], k, 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):          # PIL sums the weights in tap order
        total += k[:, j]
    return xmin, k / total[:, None]


def _pil_bilinear_axis(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of PIL's separable resample along ``axis`` of a float32
    2-D array: a double sum over the taps in order, rounded to f32."""
    n = x.shape[axis]
    xmin, k = _pil_bilinear_coeffs(n, out_size)
    src = np.moveaxis(x, axis, -1).astype(np.float64)
    acc = np.zeros(src.shape[:-1] + (out_size,))
    for j in range(k.shape[1]):
        acc += src[..., np.minimum(xmin + j, n - 1)] * k[:, j]
    return np.moveaxis(acc.astype(np.float32), -1, axis)


def resize_bilinear_pil(channel: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(channel_f32).resize((w, h), Image.BILINEAR)`` in
    numpy: horizontal pass first, each pass skipped where its extent is
    unchanged, as PIL's ``ImagingResample`` does."""
    h, w = size
    out = np.asarray(channel, np.float32)
    if out.shape[1] != w:
        out = _pil_bilinear_axis(out, w, 1)
    if out.shape[0] != h:
        out = _pil_bilinear_axis(out, h, 0)
    return out


def _pil_nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's nearest scaling walk: the source coordinate starts at half a
    step and adds the step (in/out, double) once per output, truncated.
    (It differs from floor((i + 0.5)·in/out) where a center lands on an
    integer.)"""
    step = in_size / out_size
    pos = np.add.accumulate(np.concatenate(
        [[0.0 + step * 0.5], np.full(out_size - 1, step)]))
    return pos.astype(np.int64)


def resize_nearest_pil(label: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(label_i32, "I").resize((w, h), Image.NEAREST)``
    in numpy."""
    label = np.asarray(label, np.int32)
    h, w = size
    ys, xs = _pil_nearest_index(label.shape[0], h), _pil_nearest_index(label.shape[1], w)
    return label[ys[:, None], xs[None, :]]


class SegmentationDataset:
    """``rng`` is the unseeded ``random.Random()`` of the JAX package, and
    ``__getitem__`` draws from it, so its windows differ from run to run.
    Every caller in the port draws through ``get_train_item(i,
    sample_seed=...)`` instead, whose stream is a pure function of the
    seed."""

    def __init__(self, cfg: DataConfig, split_key: str,
                 data_path: Optional[str] = None,
                 is_eval: bool = False,
                 push_prototypes: bool = False):
        self.cfg = cfg
        self.split_key = split_key
        self.is_eval = is_eval
        self.push_prototypes = push_prototypes
        self.table = get_class_table(cfg.class_table)
        self.data_path = data_path or os.environ.get("DATA_PATH", "")
        self.img_dir = os.path.join(
            self.data_path, f"img_with_margin_{cfg.image_margin_size}",
            split_key)
        self.annotations_dir = os.path.join(self.data_path, "annotations",
                                            split_key)
        with open(os.path.join(self.data_path, "all_images.json")) as f:
            self.img_ids: List[str] = json.load(f)[split_key]
        self.rng = random.Random()

    def __len__(self) -> int:
        return len(self.img_ids)

    def get_img_path(self, img_id: str) -> str:
        return os.path.join(self.img_dir, img_id + ".npy")

    def _load_raw(self, img_id: str, convert: bool = True,
                  mmap: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """``convert=False`` keeps the RAW annotation ids (the native
        augment applies the class LUT to the cropped pixels only).
        ``mmap=True`` memory-maps the image AND the label, so that only
        the sampled crop region is ever read."""
        if mmap:
            image = np.load(self.get_img_path(img_id), mmap_mode="r")
            if image.dtype != np.uint8:
                image = image.astype(np.uint8)
        else:
            image = np.load(self.get_img_path(img_id)).astype(np.uint8)
        label = np.load(os.path.join(self.annotations_dir, img_id + ".npy"),
                        mmap_mode="r" if (mmap and not convert) else None)
        if label.ndim == 3:
            label = label[:, :, 0]
        if convert:
            label = self.table.convert_labels(label)
            # training ids fit uint8 (void 0, class c at c+1, C ≤ 31), so
            # labels ship in 4× fewer bytes; decided from the LUT, not per
            # item, so batch dtypes never vary
            lut = self.table.convert_lut()
            if lut is None or int(np.max(lut)) <= 255:
                label = label.astype(np.uint8)
            else:
                label = label.astype(np.int32)
        m = self.cfg.image_margin_size
        if m != 0:
            image = image[m:-m, m:-m]
        return image, label

    def get_eval_item(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Full-resolution normalized image + raw training-id label
        (eval/push path, no augmentation; reference eval_valid.py:136-156).
        With ``eval_resize`` set, the normalized INPUT is resized per
        channel with PIL's bilinear filter (PASCAL eval uses 513x513
        inputs) while the label keeps its native size."""
        image, label = self._load_raw(self.img_ids[index])
        img = image.astype(np.float32)
        if not self.cfg.cells:
            img = img / 255.0
        img = (img - np.asarray(self.cfg.mean, np.float32)) / \
            np.asarray(self.cfg.std, np.float32)
        if self.cfg.eval_resize is not None and not self.push_prototypes:
            img = np.stack([resize_bilinear_pil(img[:, :, c], self.cfg.eval_resize)
                            for c in range(3)], axis=-1)
        return img, label

    def get_overlay_item(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Raw uint8 image + label at the EVAL size, for qualitative
        overlays (reference eval_valid.py:277-298: raw image bilinearly
        resized to the eval shape, label nearest-resized)."""
        image, label = self._load_raw(self.img_ids[index])
        if self.cfg.eval_resize is not None and not self.push_prototypes:
            size = self.cfg.eval_resize
            chans = [resize_bilinear_pil(image[:, :, c].astype(np.float32), size)
                     for c in range(3)]
            image = np.clip(np.stack(chans, axis=-1), 0, 255).astype(np.uint8)
            label = resize_nearest_pil(label, size)
        return image, label

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._augment(index, self.rng)

    def get_train_item(self, index: int,
                       sample_seed: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Augmented item with a PER-SAMPLE rng derived from
        ``sample_seed``: the augmentation stream is a pure function of
        (seed, global sample counter), deterministic under any loader
        scheduling and exactly resumable from any window.  ``None`` draws
        from the shared, unseeded ``rng``."""
        rng = random.Random(sample_seed) if sample_seed is not None \
            else self.rng
        return self._augment(index, rng)

    def _augment(self, index: int, rng: random.Random
                 ) -> Tuple[np.ndarray, np.ndarray]:
        # one C call for the whole chain, on raw labels and a memory-mapped
        # image, so that the work scales with the window, not the frame
        image, label = self._load_raw(self.img_ids[index], convert=False,
                                      mmap=True)
        h, w = label.shape[:2]

        # random scale jitter (reference dataset.py:120-128)
        if len(self.cfg.scales) >= 2 and not self.is_eval:
            s = rng.uniform(self.cfg.scales[0], self.cfg.scales[1])
        else:
            s = 1.0
        wh, ww = self.cfg.window_size
        nh, nw = int(h * s), int(w * s)
        max_sh = max(nh, wh) - wh
        max_sw = max(nw, ww) - ww
        start = (rng.randint(0, max_sh) if max_sh > 0 else 0,
                 rng.randint(0, max_sw) if max_sw > 0 else 0)
        flip = (not self.is_eval) and rng.random() < 0.5
        return native.augment_sample(
            image, label, s, (wh, ww), start, flip,
            self.cfg.mean, self.cfg.std, cells=self.cfg.cells,
            normalize=not self.push_prototypes,
            label_lut=self.table.convert_lut())

    def supports_raw_eval(self) -> bool:
        """True when eval items can ship as RAW uint8 with normalization
        done on the device (``make_inference_fn(normalize=...)``): no
        eval-time input resize (which the reference applies AFTER
        normalization) and /255 scaling in effect.  Push items skip the
        eval resize, so they qualify whenever /255 scaling applies."""
        return ((self.push_prototypes or self.cfg.eval_resize is None)
                and not self.cfg.cells)

    def get_eval_item_raw(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """(H, W, 3) uint8 image + raw training-id label, for the
        device-side-normalization eval path (supports_raw_eval)."""
        image, label = self._load_raw(self.img_ids[index])
        return np.ascontiguousarray(image, np.uint8), label

    def eval_items(self, raw: bool = False
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        get = self.get_eval_item_raw if raw else self.get_eval_item
        for i in range(len(self)):
            img, lab = get(i)
            yield img[None], lab[None]

    def eval_batches(self, batch_size: int, pad_final: bool = True,
                     with_counts: bool = False, raw: bool = False,
                     shard: Optional[Tuple[int, int]] = None
                     ) -> Iterator[Tuple[np.ndarray, ...]]:
        """Full-res eval batches; flushes early when image shapes differ
        (Cityscapes is uniform; PASCAL varies per image).

        ``pad_final`` pads partial batches with zero images and all-void
        labels (which contribute nothing to valid/I/U metrics), so the
        consumer sees one batch shape.  ``with_counts`` yields (images,
        labels, n_real) triples: the padded tail images MUST be excluded
        from statistics that don't go through the void-label mask (e.g.
        nearest-prototype counts).

        ``shard=(k, n)``: data rank k of n loads and yields only its
        slice (``batch_size/n`` images) of every padded batch, with the
        global batch's ``n_real``.  Batches are then cut by position, not
        by shape: the dataset must have one image shape (Cityscapes
        does), and a slice of mixed shapes raises.
        """
        if shard is not None:
            yield from self._sharded_eval_batches(batch_size, with_counts, raw, shard)
            return
        imgs: list = []
        labs: list = []

        def flush():
            n_real = len(imgs)
            if pad_final:
                while len(imgs) < batch_size:
                    imgs.append(np.zeros_like(imgs[0]))
                    labs.append(np.zeros_like(labs[0]))
            out = np.stack(imgs), np.stack(labs)
            imgs.clear()
            labs.clear()
            if with_counts:
                return out + (n_real,)
            return out

        get = self.get_eval_item_raw if raw else self.get_eval_item
        for i in range(len(self)):
            img, lab = get(i)
            if imgs and img.shape != imgs[0].shape:
                yield flush()
            imgs.append(img)
            labs.append(lab)
            if len(imgs) == batch_size:
                yield flush()
        if imgs:
            yield flush()

    def _sharded_eval_batches(self, batch_size: int, with_counts: bool,
                              raw: bool, shard: Tuple[int, int]
                              ) -> Iterator[Tuple[np.ndarray, ...]]:
        k, n = shard
        if batch_size % n:
            raise ValueError(f"batch {batch_size} does not divide over {n} data ranks")
        lb = batch_size // n
        get = self.get_eval_item_raw if raw else self.get_eval_item
        for start in range(0, len(self), batch_size):
            n_real = min(batch_size, len(self) - start)
            idxs = range(start + k * lb, start + (k + 1) * lb)
            items = [get(i) for i in idxs if i < len(self)]
            if not items:
                # an all-padding slice takes its shape from the batch's first image
                items = [get(start)]
                items = [(np.zeros_like(items[0][0]), np.zeros_like(items[0][1]))]
            if len({im.shape for im, _ in items}) > 1:
                raise ValueError("sharded eval batches need one image shape")
            while len(items) < lb:
                items.append((np.zeros_like(items[0][0]), np.zeros_like(items[0][1])))
            out = (np.stack([im for im, _ in items]), np.stack([lb_ for _, lb_ in items]))
            yield out + (n_real,) if with_counts else out
