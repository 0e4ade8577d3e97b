"""Dataset class tables (counterpart of ``adlm_tpu.data.constants``,
copied: the port imports nothing of the JAX package).

The ID mappings follow cityscapesScripts' labels (as the reference does,
reference segmentation/constants.py:10-11) and PASCAL VOC conventions
(constants.py:115-163).  The reference selects the Medical-Decathlon
table by *manually overwriting* ``constants.py`` with ``constants1.py``
(reference README.md:67); here every table is registered under a name
and selected via ``DataConfig.class_table``.

Convention: a "raw" preprocessed annotation value v maps through
``convert`` to a training id where 0 = void and class c (model output
channel c) sits at value c+1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# Cityscapes label ids → merged category index (void classes collapsed),
# i.e. index into CITYSCAPES_CATEGORIES (reference constants.py:13-81).
CITYSCAPES_ID_2_LABEL: Dict[int, str] = {
    **{i: "void" for i in range(7)},
    7: "road", 8: "sidewalk", 9: "parking", 10: "rail track",
    11: "building", 12: "wall", 13: "fence", 14: "guard rail",
    15: "bridge", 16: "tunnel", 17: "pole", 18: "polegroup",
    19: "traffic light", 20: "traffic sign", 21: "vegetation",
    22: "terrain", 23: "sky", 24: "person", 25: "rider", 26: "car",
    27: "truck", 28: "bus", 29: "caravan", 30: "trailer", 31: "train",
    32: "motorcycle", 33: "bicycle", -1: "license plate",
}

CITYSCAPES_CATEGORIES: List[str] = [
    "void", "road", "sidewalk", "parking", "rail track", "building",
    "wall", "fence", "guard rail", "bridge", "tunnel", "pole",
    "polegroup", "traffic light", "traffic sign", "vegetation",
    "terrain", "sky", "person", "rider", "car", "truck", "bus",
    "caravan", "trailer", "train", "motorcycle", "bicycle",
    "license plate",
]

# preprocessed category index → 19-class eval id (0 = void)
# (reference constants.py:83-113)
CITYSCAPES_19_EVAL_CATEGORIES: Dict[int, int] = {
    0: 0, 1: 1, 2: 2, 3: 0, 4: 0, 5: 3, 6: 4, 7: 5, 8: 0, 9: 0, 10: 0,
    11: 6, 12: 0, 13: 7, 14: 8, 15: 9, 16: 10, 17: 11, 18: 12, 19: 13,
    20: 14, 21: 15, 22: 16, 23: 0, 24: 0, 25: 17, 26: 18, 27: 19, 28: 0,
}

# raw PASCAL value → training id (255 = ignore → void)
# (reference constants.py:115-138)
PASCAL_ID_MAPPING: Dict[int, int] = {255: 0, **{i: i + 1 for i in range(21)}}

PASCAL_CATEGORIES: List[str] = [
    "void", "__background__", "aeroplane", "bicycle", "bird", "boat",
    "bottle", "bus", "car", "cat", "chair", "cow", "diningtable", "dog",
    "horse", "motorbike", "person", "pottedplant", "sheep", "sofa",
    "train", "tvmonitor",
]

# Medical Decathlon Task07 Pancreas (reference constants1.py:117-133)
MDS_CATEGORIES: List[str] = ["void", "pancreas", "tumour"]


_LUT_CACHE: Dict[str, np.ndarray] = {}


@dataclass(frozen=True)
class ClassTable:
    """Everything the pipeline needs to know about a dataset's classes."""

    name: str
    num_classes: int                      # model classes (void excluded)
    categories: Tuple[str, ...]           # names indexed by pre-remap id
    convert: Optional[Dict[int, int]]     # raw value → training id, or None
    class_names: Dict[int, str]           # model class index → name

    def submission_lut(self, num_classes: int) -> np.ndarray:
        """LUT: model prediction (0..C−1) → source-dataset id, for
        submission-format test PNGs (reference eval_test.py:52-60).

        Cityscapes: eval id → preprocessed category → original labelId
        (via the category-name reverse of CITYSCAPES_ID_2_LABEL); other
        datasets invert their raw→train mapping directly.
        """
        lut = np.arange(num_classes, dtype=np.uint8)
        if self.convert is None:
            return lut
        # eval id -> raw/preproc id; duplicate value 0 resolves to the
        # LAST key like the reference's dict comprehension
        inv: Dict[int, int] = {}
        for k, v in self.convert.items():
            inv[v] = k
        if self.name == "cityscapes":
            rev_origin = {v: k for k, v in CITYSCAPES_ID_2_LABEL.items()}
            inv = {eval_id: rev_origin[CITYSCAPES_CATEGORIES[pre_id]]
                   for eval_id, pre_id in inv.items()}
        for c in range(num_classes):
            if c + 1 in inv:
                lut[c] = inv[c + 1]
        return lut

    def convert_lut(self) -> Optional[np.ndarray]:
        """Cached raw→train-id int32 LUT (None when no remap). The
        native augment kernel applies it to cropped pixels directly."""
        if self.convert is None:
            return None
        cached = _LUT_CACHE.get(self.name)
        if cached is None:
            max_key = max(self.convert)
            lut = np.zeros(max_key + 1, dtype=np.int32)
            for k, v in self.convert.items():
                if k >= 0:
                    lut[k] = v
            _LUT_CACHE[self.name] = cached = lut
        return cached

    def convert_labels(self, labels: np.ndarray) -> np.ndarray:
        """Remap raw annotation values to training ids (vectorized table
        lookup; the reference uses np.vectorize(dict.get),
        dataset.py:63-69)."""
        lut = self.convert_lut()
        if lut is None:
            return labels
        return lut[np.clip(labels, 0, len(lut) - 1)]


def _cityscapes_class_names() -> Dict[int, str]:
    # eval id − 1 → category name (reference push.py:39-43)
    return {v - 1: CITYSCAPES_CATEGORIES[k]
            for k, v in CITYSCAPES_19_EVAL_CATEGORIES.items() if v > 0}


def _pascal_class_names() -> Dict[int, str]:
    # NOTE: the reference's name map drops the last class via an
    # off-by-one (push.py:41 bounds check loses 'tvmonitor'); names are
    # cosmetic, so we fix it here rather than replicate it.
    names = {}
    for raw, train_id in PASCAL_ID_MAPPING.items():
        if train_id > 0 and raw + 1 < len(PASCAL_CATEGORIES):
            names[train_id - 1] = PASCAL_CATEGORIES[raw + 1]
    # background keeps its own name
    names[0] = PASCAL_CATEGORIES[1]
    return names


CLASS_TABLES: Dict[str, ClassTable] = {
    "cityscapes": ClassTable(
        name="cityscapes",
        num_classes=19,
        categories=tuple(CITYSCAPES_CATEGORIES),
        convert=CITYSCAPES_19_EVAL_CATEGORIES,
        class_names=_cityscapes_class_names(),
    ),
    "pascal": ClassTable(
        name="pascal",
        num_classes=21,
        categories=tuple(PASCAL_CATEGORIES),
        convert=PASCAL_ID_MAPPING,
        class_names=_pascal_class_names(),
    ),
    # NOTE: the reference runs MDS through the PASCAL mapping (mds_new.gin
    # sets only_19_from_cityscapes=False and cells=False → dataset.py:65-67
    # applies PASCAL_ID_MAPPING), so labels {0,1,2} shift to {1,2,3}: there
    # is no void pixel and background trains as class 0.
    "mds": ClassTable(
        name="mds",
        num_classes=3,
        categories=tuple(MDS_CATEGORIES),
        convert={0: 1, 1: 2, 2: 3},
        class_names={0: "void", 1: "pancreas", 2: "tumour"},
    ),
    "cells": ClassTable(
        name="cells",
        num_classes=5,
        categories=tuple(f"cell{i}" for i in range(6)),
        convert=None,  # reference: convert_targets is None for cells
        class_names={i: f"cell{i}" for i in range(5)},
    ),
}


def get_class_table(name: str) -> ClassTable:
    if name not in CLASS_TABLES:
        raise KeyError(f"unknown class table {name!r}; have {sorted(CLASS_TABLES)}")
    return CLASS_TABLES[name]
