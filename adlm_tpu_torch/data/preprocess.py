"""Offline preprocessing of U-Noise's data (counterpart of
``adlm_tpu.data.preprocess::prepare_unoise_data``; numpy only).

Medical Decathlon Task07 Pancreas volumes → the slice, mask and
bounding-box arrays U-Noise trains on (reference
data/prepare_data.py:13-60).  Volumes load through the bundled NIfTI-1
reader (``data/nifti.py``).  The JAX package's other preprocessors
(Cityscapes, PASCAL, Pancreas for ProtoSeg) are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np

from adlm_tpu_torch.data.nifti import load_fdata


def prepare_unoise_data(source_path: str, target_path: str,
                        max_slices: int = 5000, downscale: int = 2) -> None:
    """``<source>/imagesTr`` and ``labelsTr`` ``*.nii.gz`` volumes →
    ``<target>/images.npy`` (N, H/downscale, W/downscale) float32 in
    [0, 1] (min-max over every volume), ``masks.npy`` (the label > 0) and
    ``bounding_boxes.npy`` (N, 4) int32 ``[y0, y1, x0, x1]``, for the
    first ``max_slices`` slices with a label, in file and slice order."""
    img_dir = os.path.join(source_path, "imagesTr")
    lab_dir = os.path.join(source_path, "labelsTr")
    files = sorted(f for f in os.listdir(img_dir)
                   if f.endswith(".nii.gz") and not f.startswith("."))
    images, masks, boxes = [], [], []
    gmin, gmax = np.inf, -np.inf
    for fname in files:
        vol = load_fdata(os.path.join(img_dir, fname))
        gmin = min(gmin, float(vol.min()))
        gmax = max(gmax, float(vol.max()))
    for fname in files:
        if len(images) >= max_slices:
            break
        vol = load_fdata(os.path.join(img_dir, fname))
        seg = load_fdata(os.path.join(lab_dir, fname))
        vol = (vol - gmin) / (gmax - gmin + 1e-8)
        for z in range(vol.shape[2]):
            m = seg[::downscale, ::downscale, z]
            ys, xs = np.nonzero(m)
            if len(ys) == 0:
                continue  # only slices with bounding boxes
            images.append(vol[::downscale, ::downscale, z].astype(np.float32))
            masks.append((m > 0).astype(np.float32))
            boxes.append(np.asarray([ys.min(), ys.max(), xs.min(), xs.max()], np.int32))
            if len(images) >= max_slices:
                break
    os.makedirs(target_path, exist_ok=True)
    np.save(os.path.join(target_path, "images.npy"), np.stack(images))
    np.save(os.path.join(target_path, "masks.npy"), np.stack(masks))
    np.save(os.path.join(target_path, "bounding_boxes.npy"), np.stack(boxes))
