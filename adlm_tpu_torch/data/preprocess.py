"""Offline dataset preprocessors (counterpart of
``adlm_tpu.data.preprocess``; numpy only).

Raw datasets → the npy layout that every command reads
(``img_with_margin_<m>/<split>/<id>.{npy,png}``,
``annotations/<split>/<id>.npy``, ``all_images.json``; see
``data/dataset.py``):

* Cityscapes (reference segmentation/preprocess_cityscapes.py:45-158),
  with per-image object masks from ``instanceIds``;
* PASCAL VOC 2012 with SegmentationClassAug (reference
  preprocess_pascal.py:26-104): JPEG images, PNG labels;
* Medical Decathlon Task07 Pancreas NIfTI → 2-D slices
  (reference preprocessPancreasScans.py:10-167);
* ``all_images.json`` from an existing layout, and the PNG → ``.npy``
  pass (reference segmentation/img_to_numpy.py:13-29);
* U-Noise's slice, mask and bounding-box arrays (reference
  data/prepare_data.py:13-60).

The JAX package reads and writes images with PIL; the port with its
own codecs (``data/image_folder.py``: ``read_png``, ``load_rgb`` with
the host library's JPEG decoder, ``to_rgb``, ``write_png``) and its
numpy copies of PIL's 8-bit bilinear and nearest resize, so every
``.npy`` file and ``all_images.json`` is byte-equal to the JAX
package's and every PNG pixel-equal (PIL's encoder picks other
scanline filters).  Volumes load through the bundled NIfTI-1 reader
(``data/nifti.py``).
"""

from __future__ import annotations

import json
import os
from multiprocessing import get_context
from typing import Dict, List, Tuple

import numpy as np

from adlm_tpu_torch.data.constants import CITYSCAPES_CATEGORIES, CITYSCAPES_ID_2_LABEL
from adlm_tpu_torch.data.dataset import resize_nearest_pil
from adlm_tpu_torch.data.image_folder import load_rgb, read_png, resize_bilinear_u8, write_png
from adlm_tpu_torch.data.nifti import load_fdata


def _crop(img: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> np.ndarray:
    """PIL's ``crop((x0, y0, x1, y1))``: black where the box leaves the
    image."""
    h, w = img.shape[:2]
    out = np.zeros((y1 - y0, x1 - x0) + img.shape[2:], img.dtype)
    ya, yb, xa, xb = max(y0, 0), min(y1, h), max(x0, 0), min(x1, w)
    if ya < yb and xa < xb:
        out[ya - y0:yb - y0, xa - x0:xb - x0] = img[ya:yb, xa:xb]
    return out


def add_margins_to_image(img: np.ndarray, margin: int) -> np.ndarray:
    """Mirror-pad an (H, W, 3) uint8 image by ``margin`` on all sides
    (reference segmentation/utils.py:11-39): each side and corner is the
    flipped crop of the image's edge, and a margin wider than the image
    flips a crop that runs past it, black there (PIL's crop), where
    ``np.pad(mode="symmetric")`` would repeat the image."""
    if margin == 0:
        return img
    h, w = img.shape[:2]
    m = margin
    out = np.zeros((h + 2 * m, w + 2 * m, 3), np.uint8)
    out[m:m + h, m:m + w] = img
    out[m:m + h, :m] = _crop(img, 0, 0, m, h)[:, ::-1]
    out[m:m + h, w + m:] = _crop(img, w - m, 0, w, h)[:, ::-1]
    out[:m, m:m + w] = _crop(img, 0, 0, w, m)[::-1]
    out[h + m:, m:m + w] = _crop(img, 0, h - m, w, h)[::-1]
    out[:m, :m] = _crop(img, 0, 0, m, m)[::-1, ::-1]
    out[:m, w + m:] = _crop(img, w - m, 0, w, m)[::-1, ::-1]
    out[h + m:, :m] = _crop(img, 0, h - m, m, h)[::-1, ::-1]
    out[h + m:, w + m:] = _crop(img, w - m, h - m, w, h)[::-1, ::-1]
    return out


def _cityscapes_lut() -> np.ndarray:
    """Raw Cityscapes id → index into ``CITYSCAPES_CATEGORIES`` (0 for
    the ids the table leaves out)."""
    cat2id = {c: i for i, c in enumerate(CITYSCAPES_CATEGORIES)}
    lut = np.zeros(256, np.uint8)
    for raw_id, label in CITYSCAPES_ID_2_LABEL.items():
        if raw_id >= 0:
            lut[raw_id] = cat2id[label]
    return lut


def _process_cityscapes_city(args) -> Tuple[str, List[str]]:
    """One city of one split: each ``*_gtFine_labelIds.png`` → its
    annotation ``.npy`` (the class table applied), and its
    ``leftImg8bit`` image with margins → ``.png`` and ``.npy``."""
    (labels_dir, images_dir, ann_out, img_out, split, city, margin) = args
    lut = _cityscapes_lut()
    city_dir = os.path.join(labels_dir, split, city)
    ids = []
    for fname in sorted(os.listdir(city_dir)):
        if not fname.endswith("_gtFine_labelIds.png"):
            continue
        img_id = fname.split("_gtFine_labelIds.png")[0]
        ids.append(img_id)
        label = load_rgb(os.path.join(city_dir, fname))[:, :, 0]
        np.save(os.path.join(ann_out, split, f"{img_id}.npy"), lut[label])
        img = load_rgb(os.path.join(images_dir, split, city, img_id + "_leftImg8bit.png"))
        img = add_margins_to_image(img, margin)
        write_png(os.path.join(img_out, split, f"{img_id}.png"), img)
        np.save(os.path.join(img_out, split, f"{img_id}.npy"), img)
    return split, ids


def preprocess_cityscapes(source_path: str, target_path: str,
                          margin: int = 0, n_jobs: int = 8) -> None:
    """``<source>/gtFine_trainvaltest/gtFine`` and
    ``leftImg8bit_trainvaltest/leftImg8bit`` → the npy layout, one city
    per job of an ``n_jobs`` process pool (spawned: the caller may hold
    threads, torch's or CUDA's); ``all_images.json`` lists each split's
    ids sorted, all three splits present."""
    labels_dir = os.path.join(source_path, "gtFine_trainvaltest", "gtFine")
    images_dir = os.path.join(source_path, "leftImg8bit_trainvaltest", "leftImg8bit")
    ann_out = os.path.join(target_path, "annotations")
    img_out = os.path.join(target_path, f"img_with_margin_{margin}")
    jobs = []
    for split in ("train", "val", "test"):
        os.makedirs(os.path.join(ann_out, split), exist_ok=True)
        os.makedirs(os.path.join(img_out, split), exist_ok=True)
        split_dir = os.path.join(labels_dir, split)
        if not os.path.isdir(split_dir):
            continue
        for city in sorted(os.listdir(split_dir)):
            jobs.append((labels_dir, images_dir, ann_out, img_out, split, city, margin))
    all_images: Dict[str, List[str]] = {"train": [], "val": [], "test": []}
    with get_context("spawn").Pool(n_jobs) as pool:
        for split, ids in pool.imap_unordered(_process_cityscapes_city, jobs):
            all_images[split].extend(ids)
    for split in all_images:
        all_images[split].sort()
    with open(os.path.join(target_path, "all_images.json"), "w") as f:
        json.dump(all_images, f)


def preprocess_cityscapes_obj_masks(source_path: str, target_path: str) -> None:
    """Per-image binary object masks from gtFine ``instanceIds`` (16-bit
    grey; reference preprocess_cityscapes.py:74-89, 131-154): instances
    have ids ≥ 1000 (class·1000 + instance).  Writes
    ``obj_masks/<split>/<id>.npz`` with ``masks`` (n, H, W) uint8, one per
    sorted instance id, and ``instance_ids`` (n,) int32.  The JAX
    function's ``n_jobs`` is left out: it runs serially there too."""
    labels_dir = os.path.join(source_path, "gtFine_trainvaltest", "gtFine")
    out_root = os.path.join(target_path, "obj_masks")
    for split in ("train", "val", "test"):
        split_dir = os.path.join(labels_dir, split)
        if not os.path.isdir(split_dir):
            continue
        os.makedirs(os.path.join(out_root, split), exist_ok=True)
        for city in sorted(os.listdir(split_dir)):
            city_dir = os.path.join(split_dir, city)
            for fname in sorted(os.listdir(city_dir)):
                if not fname.endswith("_gtFine_instanceIds.png"):
                    continue
                img_id = fname.split("_gtFine_instanceIds.png")[0]
                px = read_png(os.path.join(city_dir, fname))
                inst = (px[:, :, 0] if px.shape[2] == 1 else px).astype(np.int32)
                obj_ids = [i for i in np.unique(inst) if i >= 1000]
                masks = np.stack(
                    [(inst == i).astype(np.uint8) for i in obj_ids]
                ) if obj_ids else np.zeros((0, *inst.shape), np.uint8)
                np.savez_compressed(os.path.join(out_root, split, f"{img_id}.npz"),
                                    masks=masks, instance_ids=np.asarray(obj_ids, np.int32))


def preprocess_pascal(source_path: str, target_path: str, margin: int = 0) -> None:
    """PASCAL VOC 2012 + SegmentationClassAug → the npy layout (reference
    preprocess_pascal.py:26-104), serially as the JAX function runs:
    for each id of ``ImageSets/SegmentationAug/train_aug.txt`` (split
    ``train``) and ``val.txt`` (``val``), a split file that is missing
    being skipped, ``SegmentationClassAug/<id>.png``'s samples (a palette
    label's indices) → ``annotations/<split>/<id>.npy``, and
    ``JPEGImages/<id>.jpg`` as RGB with mirrored margins →
    ``img_with_margin_<m>/<split>/<id>.{png,npy}``; ``all_images.json``
    lists each split's ids sorted."""
    ann_src = os.path.join(source_path, "SegmentationClassAug")
    img_src = os.path.join(source_path, "JPEGImages")
    split_dir = os.path.join(source_path, "ImageSets", "SegmentationAug")
    ann_out = os.path.join(target_path, "annotations")
    img_out = os.path.join(target_path, f"img_with_margin_{margin}")
    all_images: Dict[str, List[str]] = {}
    for split_file, split in (("train_aug.txt", "train"), ("val.txt", "val")):
        path = os.path.join(split_dir, split_file)
        if not os.path.exists(path):
            continue
        os.makedirs(os.path.join(ann_out, split), exist_ok=True)
        os.makedirs(os.path.join(img_out, split), exist_ok=True)
        ids = []
        with open(path) as f:
            for line in f:
                img_id = os.path.basename(line.split()[0]).split(".")[0]
                ids.append(img_id)
                label = read_png(os.path.join(ann_src, img_id + ".png"))
                if label.shape[2] == 1:
                    label = label[:, :, 0]
                np.save(os.path.join(ann_out, split, f"{img_id}.npy"), label.astype(np.uint8))
                img = add_margins_to_image(load_rgb(os.path.join(img_src, img_id + ".jpg")),
                                           margin)
                write_png(os.path.join(img_out, split, f"{img_id}.png"), img)
                np.save(os.path.join(img_out, split, f"{img_id}.npy"), img)
        all_images[split] = sorted(ids)
    with open(os.path.join(target_path, "all_images.json"), "w") as f:
        json.dump(all_images, f)


def preprocess_pancreas(source_path: str, target_path: str,
                        train_n: int = 63, val_n: int = 26,
                        upsample_to: Tuple[int, int] = (1024, 2048)) -> None:
    """Medical Decathlon Task07 ``imagesTr``/``labelsTr`` NIfTI volumes →
    per-slice npy in the ProtoSeg layout with a 63/26/11 patient split
    (reference preprocessPancreasScans.py:10-167): each volume min-max
    normalized to [0, 255] in f64, its annotated slices truncated to
    uint8 and resized to ``upsample_to`` (PIL's 8-bit bilinear for the
    image, replicated to RGB; nearest for the label)."""
    img_dir = os.path.join(source_path, "imagesTr")
    lab_dir = os.path.join(source_path, "labelsTr")
    files = sorted(f for f in os.listdir(img_dir)
                   if f.endswith(".nii.gz") and not f.startswith("."))
    splits = {"train": files[:train_n],
              "val": files[train_n:train_n + val_n],
              "test": files[train_n + val_n:]}
    ann_out = os.path.join(target_path, "annotations")
    img_out = os.path.join(target_path, "img_with_margin_0")
    size = tuple(upsample_to)
    all_images: Dict[str, List[str]] = {}
    for split, split_files in splits.items():
        os.makedirs(os.path.join(ann_out, split), exist_ok=True)
        os.makedirs(os.path.join(img_out, split), exist_ok=True)
        ids = []
        for fname in split_files:
            vol = load_fdata(os.path.join(img_dir, fname))
            seg = load_fdata(os.path.join(lab_dir, fname))
            vmin, vmax = vol.min(), vol.max()
            vol = (vol - vmin) / (vmax - vmin + 1e-8) * 255.0
            for z in range(vol.shape[2]):
                if not np.any(seg[:, :, z]):
                    continue  # keep only annotated slices
                img_id = f"{fname.split('.')[0]}_slice{z:03d}"
                ids.append(img_id)
                sl = vol[:, :, z].astype(np.float32).astype(np.uint8)
                lab = seg[:, :, z].astype(np.uint8)
                grey = resize_bilinear_u8(sl[:, :, None], size)[:, :, 0]
                rgb = np.stack([grey] * 3, axis=-1)
                np.save(os.path.join(img_out, split, f"{img_id}.npy"), rgb)
                write_png(os.path.join(img_out, split, f"{img_id}.png"), rgb)
                np.save(os.path.join(ann_out, split, f"{img_id}.npy"),
                        resize_nearest_pil(lab, size).astype(np.uint8))
        all_images[split] = ids
    with open(os.path.join(target_path, "all_images.json"), "w") as f:
        json.dump(all_images, f)


def generate_image_list(target_path: str) -> Dict[str, List[str]]:
    """Write (and return) ``all_images.json`` from the ``.npy`` files of
    the first ``img_with_margin_*`` directory ``os.listdir`` names, each
    split sorted (the reference's generateImageList.py does not run: a
    syntax error at line 26)."""
    out: Dict[str, List[str]] = {}
    img_root = None
    for d in os.listdir(target_path):
        if d.startswith("img_with_margin_"):
            img_root = os.path.join(target_path, d)
            break
    if img_root is None:
        raise FileNotFoundError(f"no img_with_margin_* dir in {target_path}")
    for split in sorted(os.listdir(img_root)):
        split_dir = os.path.join(img_root, split)
        if not os.path.isdir(split_dir):
            continue
        out[split] = sorted(f[:-4] for f in os.listdir(split_dir) if f.endswith(".npy"))
    with open(os.path.join(target_path, "all_images.json"), "w") as f:
        json.dump(out, f)
    return out


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


def convert_images_to_numpy(data_path: str, margin: int = 0,
                            splits: Tuple[str, ...] = ("train", "train_aug", "val",
                                                       "test")) -> int:
    """Write ``<id>.npy`` (H, W, 3) uint8 beside each ``<id>.png`` of the
    ``img_with_margin_<margin>`` split directories that lacks one
    (reference segmentation/img_to_numpy.py:13-29; ``.npy`` files load
    much faster than PNGs).  Existing ``.npy`` files are left as they
    are.  Returns the number of images converted."""
    n = 0
    for split in splits:
        img_dir = os.path.join(data_path, f"img_with_margin_{margin}", split)
        if not os.path.isdir(img_dir):
            continue
        for fname in sorted(os.listdir(img_dir)):
            if not fname.endswith(".png"):
                continue
            out = os.path.join(img_dir, fname[:-len(".png")] + ".npy")
            if os.path.exists(out):
                continue
            np.save(out, load_rgb(os.path.join(img_dir, fname)))
            n += 1
    return n
