"""Pretrained torch weights into the port's DeepLabV2 backbone
(counterpart of the DeepLab part of ``adlm_tpu.utils.torch_import``).

The reference initializes its backbone either from torchvision's
ImageNet ResNet-101 through a key remap (reference
deeplab_features.py:8-49, train.py:81-93) or from a COCO deeplab
checkpoint (train.py:71-79).  The port's modules already carry the
deeplab names (``models/deeplab.py``), so both arrive through one key
map onto the port's ``state_dict``:

* torchvision naming (``layer1.0.conv1.weight`` …) is remapped to the
  deeplab naming first (``layer{n+1}.block{b+1}.{reduce,conv3x3,
  increase,shortcut}``, the reference's mapping);
* a deeplab key ``k`` lands on ``features.base.k``: conv weights OIHW
  as they are, BN tensors in the frozen BN's buffers, the ASPP's
  ``aspp.cN.{weight,bias}``.

A key with no home, or whose shape differs from the port's tensor (the
reference's 8 ASPP keys of the ImageNet path), is reported as
unexpected, as the JAX package reports it.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

BACKBONE_PREFIX = "features.base."


def torchvision_key_to_deeplab(key: str) -> Optional[str]:
    """torchvision ResNet key → deeplab-pytorch key (reference
    deeplab_features.py:8-49).  None for keys with no home (``fc``,
    ``num_batches_tracked``)."""
    if key.endswith("num_batches_tracked"):
        return None
    seg = key.split(".")
    if seg[0].startswith("layer"):
        dl_layer = int(seg[0][5:]) + 1
        block = f"block{int(seg[1]) + 1}"
        if seg[2] == "downsample":
            module = {0: "conv", 1: "bn"}[int(seg[3])]
            return f"layer{dl_layer}.{block}.shortcut.{module}.{seg[-1]}"
        kind, num = seg[2][:-1], int(seg[2][-1])
        name = {1: "reduce", 2: "conv3x3", 3: "increase"}[num]
        return f"layer{dl_layer}.{block}.{name}.{kind}.{seg[-1]}"
    if seg[0] in ("conv1", "bn1"):
        return f"layer1.conv1.{seg[0][:-1]}.{seg[-1]}"
    return None


def _numpy(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _port_key(dl_key: str) -> Optional[str]:
    """deeplab key → the port's state_dict key (None: no home)."""
    seg = dl_key.split(".")
    if seg[0] == "aspp":
        return BACKBONE_PREFIX + dl_key if seg[-1] in ("weight", "bias") else None
    kind, leaf = seg[-2], seg[-1]
    if kind == "conv" and leaf == "weight":
        return BACKBONE_PREFIX + dl_key
    if kind == "bn" and leaf in ("weight", "bias", "running_mean", "running_var"):
        return BACKBONE_PREFIX + dl_key
    return None


def load_deeplab_backbone(target: Dict[str, torch.Tensor],
                          state_dict: Mapping[str, Any],
                          naming: str = "torchvision") -> Dict[str, list]:
    """Copy a torch state_dict (tensors or numpy arrays, torchvision or
    deeplab naming) into ``target``, the port PPNet's ``state_dict()``,
    replacing its entries (then ``model.load_state_dict(target)``).

    Returns the report ``{"loaded", "unexpected_keys",
    "negative_variance_keys"}`` over the source keys, as the JAX
    package's loader: a negative BN ``running_var`` would turn every
    forward into NaNs."""
    if naming not in ("torchvision", "deeplab"):
        raise ValueError(f"unknown naming {naming!r}")
    loaded, unexpected = [], []
    for key, value in state_dict.items():
        dl_key = torchvision_key_to_deeplab(key) if naming == "torchvision" else key
        if dl_key is None:
            continue
        port_key = _port_key(dl_key)
        v = _numpy(value)
        have = target.get(port_key) if port_key is not None else None
        if have is None or tuple(have.shape) != v.shape:
            unexpected.append(key)
            continue
        target[port_key] = torch.from_numpy(np.ascontiguousarray(v).copy()).to(have.dtype)
        loaded.append(key)
    bad_var = [k for k, v in state_dict.items()
               if k.endswith("running_var") and np.any(_numpy(v) < 0)]
    return {"loaded": loaded, "unexpected_keys": unexpected,
            "negative_variance_keys": bad_var}
