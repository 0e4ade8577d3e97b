"""Offline image augmentation for the classification datasets (CUB),
counterpart of ``adlm_tpu.data.img_aug``: the same draws, the same file
names and the same bytes, on a host without PIL.

The reference uses the Augmentor package to write ~30 augmented copies
per training image: rotate ±15°, skew, shear ±10°, each combined with
random horizontal flips (reference img_aug.py:18-48).  The JAX package
does it with PIL's bilinear affine transform and PIL's JPEG encoder at
its defaults; the port with the host library's copies of both
(``native.affine_bilinear_u8`` and ``native.encode_jpeg``, bit-equal
and byte-equal to PIL's), reading the sources through
``image_folder.load_rgb`` and carrying over the comment that PIL keeps
in ``im.info`` and writes into every copy (``image_folder.image_comment``).
Host work: this module imports no torch.
"""

from __future__ import annotations

import math
import os
import random
from typing import Optional

import numpy as np

from adlm_tpu_torch import native
from adlm_tpu_torch.data import image_folder


def _rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """``Image.rotate(angle, resample=BILINEAR)``: the same matrix, in
    Python floats, about the centre, and a copy at a whole turn."""
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    h, w = img.shape[:2]
    cx, cy = w / 2, h / 2
    angle = -math.radians(angle)
    a, b, d, e = (round(math.cos(angle), 15), round(math.sin(angle), 15),
                  round(-math.sin(angle), 15), round(math.cos(angle), 15))
    c = a * -cx + b * -cy + 0.0 + cx
    f = d * -cx + e * -cy + 0.0 + cy
    return native.affine_bilinear_u8(img, (a, b, c, d, e, f))


def _affine(img: np.ndarray, kind: str, rng: random.Random) -> np.ndarray:
    if kind == "rotate":
        return _rotate(img, rng.uniform(-15, 15))
    if kind == "shear":
        shear = math.tan(math.radians(rng.uniform(-10, 10)))
        return native.affine_bilinear_u8(img, (1, shear, 0, 0, 1, 0))
    if kind == "skew":
        # mild perspective-like skew via vertical shear
        shear = math.tan(math.radians(rng.uniform(-10, 10)))
        return native.affine_bilinear_u8(img, (1, 0, 0, shear, 1, 0))
    raise ValueError(kind)


def augment_directory(src_dir: str, dst_dir: str,
                      copies_per_op: int = 10,
                      seed: Optional[int] = 0) -> int:
    """Write rotate/shear/skew (+flip) variants per image per class dir.

    Mirrors the reference's layout: ``src_dir/<class>/<img>`` →
    ``dst_dir/<class>/<img>_<op><i>.jpg``.  Returns count written.
    """
    rng = random.Random(seed)
    n = 0
    for cls in sorted(os.listdir(src_dir)):
        cls_src = os.path.join(src_dir, cls)
        if not os.path.isdir(cls_src):
            continue
        cls_dst = os.path.join(dst_dir, cls)
        os.makedirs(cls_dst, exist_ok=True)
        for fname in sorted(os.listdir(cls_src)):
            if not fname.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            path = os.path.join(cls_src, fname)
            img = image_folder.load_rgb(path)
            comment = image_folder.image_comment(path)
            stem = os.path.splitext(fname)[0]
            for op in ("rotate", "shear", "skew"):
                for i in range(copies_per_op):
                    out = _affine(img, op, rng)
                    if rng.random() < 0.5:
                        out = out[:, ::-1]
                    image_folder.write_jpeg(
                        os.path.join(cls_dst, f"{stem}_{op}{i}.jpg"), out, comment)
                    n += 1
    return n
