"""U-Noise data pipeline: Pancreas slice arrays → train/val/test splits
(counterpart of ``adlm_tpu.data.unoise_data``; numpy only).

Reference semantics (reference src/data.py:41-93): keep only slices
with bounding boxes, ORDERED 80/10/10 split (no shuffle — consecutive
slices belong to the same patient, so shuffling would leak), tile 1→3
channels, ImageNet-normalize.  Training augmentation mirrors the
reference's albumentations pipeline (src/data.py:14-38): horizontal
flip, OneOf{contrast, gamma, brightness} at p=0.3,
OneOf{elastic, grid, optical distortion} at p=0.3 (see data/warps.py),
and ShiftScaleRotate at p=0.5.  Every draw comes from the same
``np.random.RandomState`` calls in the same order as the JAX package's,
so both packages yield the same items and batches.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

from adlm_tpu_torch.data.warps import reference_geometric_augment

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


class UNoiseDataset:
    def __init__(self, images: np.ndarray, masks: np.ndarray,
                 augment: bool = False, seed: int = 0, raw: bool = False):
        """``raw=True`` returns each augmented slice as (H, W, 1)
        UNNORMALIZED — the train steps tile to 3 channels and apply the
        ImageNet normalization on the device (``make_*_step(...,
        raw=True)``):
        3× less host work, host memory, and host→device transfer than
        the reference's tile-then-normalize-on-host order
        (src/data.py:48).  Every augmentation op acts per-channel on
        identical channel copies, so augment-then-tile is exact."""
        self.images = images.astype(np.float32)  # (N, H, W), 1 channel
        self.masks = (masks > 0).astype(np.float32)
        self.augment = augment
        self.raw = raw
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self.images.shape[0]

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.load(idx, self.rng)

    def load(self, idx: int, rng: np.random.RandomState
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Like ``__getitem__`` with an explicit RandomState — parallel
        loaders pass a per-item RNG (RandomState is not thread-safe)."""
        img = self.images[idx]
        mask = self.masks[idx]
        if self.augment:
            if rng.rand() < 0.5:
                img = img[:, ::-1].copy()
                mask = mask[:, ::-1].copy()
            if rng.rand() < 0.3:
                mode = rng.randint(3)
                if mode == 0:    # contrast
                    c = rng.uniform(0.8, 1.2)
                    img = np.clip((img - 0.5) * c + 0.5, 0, 1)
                elif mode == 1:  # gamma
                    g = rng.uniform(0.8, 1.2)
                    img = np.clip(img, 0, 1) ** g
                else:            # brightness
                    img = np.clip(img + rng.uniform(-0.2, 0.2), 0, 1)
            img, mask = reference_geometric_augment(img, mask, rng)
        if self.raw:
            return img[..., None].astype(np.float32), mask[..., None]
        img = (np.repeat(img[..., None], 3, axis=-1)
               - IMAGENET_MEAN) / IMAGENET_STD
        return img.astype(np.float32), mask[..., None]


def split_datasets(images: np.ndarray, masks: np.ndarray,
                   boxes: Optional[np.ndarray] = None,
                   seed: int = 0, raw: bool = False
                   ) -> Tuple[UNoiseDataset, UNoiseDataset, UNoiseDataset]:
    """Ordered patient-safe 80/10/10 split (reference src/data.py:67-87)."""
    if boxes is not None:
        positive = np.asarray([b is not None for b in boxes])
        images = images[positive]
        masks = masks[positive]
    n = images.shape[0]
    s0, s1 = int(n * 0.8), int(n * 0.9)
    return (
        UNoiseDataset(images[:s0], masks[:s0], augment=True, seed=seed,
                      raw=raw),
        UNoiseDataset(images[s0:s1], masks[s0:s1], raw=raw),
        UNoiseDataset(images[s1:], masks[s1:], raw=raw),
    )


def batches(ds: UNoiseDataset, batch_size: int, shuffle: bool = False,
            seed: int = 0, drop_last: bool = False, n_jobs: int = 1,
            shard: Optional[Tuple[int, int]] = None
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``n_jobs`` > 1 loads samples through a thread pool — the native
    warp/remap calls release the GIL, so the geometric augmentations
    parallelize across cores (the reference relies on torch DataLoader
    workers, src/train_util.py:30-36).

    ``shard=(k, n)``: data rank k of n loads only its ``batch_size/n``
    rows of each batch, with the per-item seeds of the ``n_jobs`` > 1
    stream (whatever ``n_jobs``), so that the ranks' slices concatenated
    in rank order are that stream's batches bit for bit.  A sharded
    stream needs equal slices: use it with ``drop_last``."""
    order = np.arange(len(ds))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    if shard is not None and batch_size % shard[1]:
        raise ValueError(f"batch {batch_size} does not divide over {shard[1]} data ranks")
    pool = ThreadPoolExecutor(max_workers=n_jobs) if n_jobs > 1 else None
    seeder = np.random.RandomState(seed ^ 0x5EED)
    try:
        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            if drop_last and len(idx) < batch_size:
                return
            if pool is not None or shard is not None:
                # per-item RNGs: RandomState is not thread-safe
                seeds = seeder.randint(0, 2 ** 31, size=len(idx))
                if shard is not None:
                    lb = batch_size // shard[1]
                    rows = slice(shard[0] * lb, (shard[0] + 1) * lb)
                    idx, seeds = idx[rows], seeds[rows]
                load = (lambda t: ds.load(int(t[0]), np.random.RandomState(int(t[1]))))
                items = list(pool.map(load, zip(idx, seeds)) if pool is not None
                             else map(load, zip(idx, seeds)))
            else:
                items = [ds[int(j)] for j in idx]
            yield (np.stack([x for x, _ in items]),
                   np.stack([y for _, y in items]))
    finally:
        if pool is not None:
            pool.shutdown(wait=False)
