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

``load_classification_backbone`` and ``load_protopnet_cls`` do the same
for the classifier: the port's stems carry torchvision's names
(``models/backbones.py``), so a torchvision ImageNet stem's key ``k``
lands on ``features.k`` and a reference classification PPNet's keys
map one to one (``ones`` and ``num_batches_tracked`` skipped).
``load_torch_ppnet_checkpoint`` and ``resolve_proto_class`` read such a
checkpoint file and its prototype classes for ``import-protopnet`` and
``import-protoseg``.

``load_protoseg_model`` reads a reference SEGMENTATION PPNet's
state_dict (``import-protoseg``), and ``export_protoseg_state_dict``
writes one (``export-torch``): the port's PPNet carries the reference's
keys and layouts, so both are one key map.

``load_unoise_checkpoint`` reads a reference U-Noise checkpoint: the
port's U-Net carries the reference's module names, so its state_dict is
the checkpoint's with the lightning prefix stripped.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

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


def _copy_into(target: Dict[str, torch.Tensor], key: str, value: Any,
               loaded: List[str], unexpected: List[str], src_key: str) -> None:
    """``target[key] = value`` where ``key`` exists with ``value``'s
    shape (recorded in ``loaded``), else ``src_key`` is unexpected."""
    v = _numpy(value)
    have = target.get(key)
    if have is None or tuple(have.shape) != v.shape:
        unexpected.append(src_key)
        return
    target[key] = torch.from_numpy(np.ascontiguousarray(v).copy()).to(have.dtype)
    loaded.append(src_key)


def _negative_variances(state_dict: Mapping[str, Any]) -> List[str]:
    return [k for k, v in state_dict.items()
            if k.endswith("running_var") and np.any(_numpy(v) < 0)]


def load_classification_backbone(target: Dict[str, torch.Tensor],
                                 state_dict: Mapping[str, Any],
                                 arch: str) -> Dict[str, list]:
    """Copy a torchvision ImageNet stem (``resnet*``, ``vgg*[_bn]``,
    ``densenet*`` keys; tensors or numpy arrays) into ``target``, a
    classification PPNet's ``state_dict()``, under ``features.``
    (then ``model.load_state_dict(target)``).  ``fc``/``classifier`` and
    ``num_batches_tracked`` have no home and are skipped; a DenseNet
    stem may come with or without its ``features.`` prefix.

    Returns the report ``{"loaded", "unexpected_keys",
    "negative_variance_keys"}`` over the source keys (the JAX package's
    contract)."""
    if not arch.startswith(("resnet", "vgg", "densenet")):
        raise NotImplementedError(f"no importer for arch {arch!r}")
    loaded: List[str] = []
    unexpected: List[str] = []
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked") or key.split(".")[0] in ("fc", "classifier"):
            continue
        sub = key
        if arch.startswith("densenet") and not key.startswith("features."):
            sub = "features." + key
        _copy_into(target, "features." + sub, value, loaded, unexpected, key)
    return {"loaded": loaded, "unexpected_keys": unexpected,
            "negative_variance_keys": _negative_variances(state_dict)}


def load_protopnet_cls(target: Dict[str, torch.Tensor],
                       state_dict: Mapping[str, Any], arch: str) -> Dict[str, list]:
    """Copy a reference CLASSIFICATION PPNet state_dict into ``target``,
    the port classification PPNet's ``state_dict()``: the stem under
    ``features.`` (``load_classification_backbone``), the add-on convs
    ``add_on_layers.{2i}``, ``prototype_vectors`` and
    ``last_layer.weight``; the constant ``ones`` is skipped.  Returns the
    same report, its keys those of ``state_dict``."""
    stem = {k[len("features."):]: v for k, v in state_dict.items()
            if k.startswith("features.") and not k.endswith("num_batches_tracked")}
    report = load_classification_backbone(target, stem, arch)
    loaded = [f"features.{k}" for k in report["loaded"]]
    unexpected = [f"features.{k}" for k in report["unexpected_keys"]]
    for key, value in state_dict.items():
        if key.startswith("features.") or key == "ones":
            continue
        _copy_into(target, key, value, loaded, unexpected, key)
    return {"loaded": loaded, "unexpected_keys": unexpected,
            "negative_variance_keys": [f"features.{k}" for k in
                                       report["negative_variance_keys"]]}


def load_protoseg_model(target: Dict[str, torch.Tensor],
                        state_dict: Mapping[str, Any]) -> Dict[str, list]:
    """Copy a full reference SEGMENTATION PPNet state_dict (reference
    model.py:54-143, as ``torch.save`` of its stage modules holds it,
    reference segmentation/train.py:60-65) into ``target``, the port
    PPNet's ``state_dict()`` built with the checkpoint's prototype count:
    ``features.base.*`` through ``load_deeplab_backbone`` (deeplab
    naming), the add-on convs at even indices of ``add_on_layers``,
    ``prototype_vectors`` (P, C, 1, 1) and ``last_layer.weight`` (K, P),
    all in the port's own layouts.  ``ones`` (the constant of the
    reference's L2 convolution, model.py:140) and ``num_batches_tracked``
    are skipped.  Returns the report ``{"loaded", "unexpected_keys",
    "negative_variance_keys"}`` over the source keys, as the JAX
    package's ``load_protoseg_model``."""
    base = {k[len(BACKBONE_PREFIX):]: v for k, v in state_dict.items()
            if k.startswith(BACKBONE_PREFIX) and not k.endswith("num_batches_tracked")}
    report = load_deeplab_backbone(target, base, naming="deeplab")
    loaded = [BACKBONE_PREFIX + k for k in report["loaded"]]
    unexpected = [BACKBONE_PREFIX + k for k in report["unexpected_keys"]]
    for key, value in state_dict.items():
        if (key.startswith(BACKBONE_PREFIX) or key == "ones"
                or key.endswith("num_batches_tracked")):
            continue
        seg = key.split(".")
        head = key in ("prototype_vectors", "last_layer.weight") or (
            seg[0] == "add_on_layers" and seg[1].isdigit() and int(seg[1]) % 2 == 0)
        if head:
            _copy_into(target, key, value, loaded, unexpected, key)
        else:
            unexpected.append(key)
    return {"loaded": loaded, "unexpected_keys": unexpected,
            "negative_variance_keys": [BACKBONE_PREFIX + k for k in
                                       report["negative_variance_keys"]]}


def export_protoseg_state_dict(state_dict: Mapping[str, torch.Tensor]
                               ) -> Dict[str, torch.Tensor]:
    """The port PPNet's ``state_dict`` as the reference's torch
    state_dict, the inverse of ``load_protoseg_model``: the port's keys
    and layouts are the reference's, so every tensor goes out as it is
    (contiguous, on the CPU), with ``ones`` regenerated from the
    prototypes' shape.  ``prototype_class_identity`` is not part of a
    torch state_dict (a plain attribute in the reference): callers save
    the class ids beside it."""
    out = {k: v.detach().cpu().contiguous() for k, v in state_dict.items()}
    out["ones"] = torch.ones_like(out["prototype_vectors"])
    return out


def load_torch_ppnet_checkpoint(path: str
                                ) -> Tuple[Dict[str, np.ndarray], Optional[np.ndarray]]:
    """(numpy state_dict, proto_class or None) of a reference PPNet
    checkpoint file: a whole-module pickle (their save format), a plain
    state_dict or a ``{"state_dict": ...}`` wrapper.  ``proto_class`` is
    the argmax of the module's ``prototype_class_identity`` when it has
    one.  A pickle runs code when read: load only files you trust."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError) as e:
        raise SystemExit(
            f"could not unpickle {path} ({e}); the reference saves whole-module "
            "pickles, which need its classes importable: in the reference "
            "environment run `torch.save(torch.load(f).state_dict(), out)` and "
            "import that state_dict instead")
    proto_class = None
    if hasattr(obj, "state_dict") and callable(obj.state_dict):
        if getattr(obj, "prototype_class_identity", None) is not None:
            proto_class = np.argmax(_numpy(obj.prototype_class_identity), axis=1)
        sd = obj.state_dict()
    elif isinstance(obj, dict):
        sd = obj.get("state_dict", obj)
    else:
        raise SystemExit(f"unsupported checkpoint object {type(obj)!r}")
    return {k: _numpy(v) for k, v in sd.items()}, proto_class


def resolve_proto_class(proto_class: Optional[np.ndarray],
                        proto_class_file: Optional[str], n_proto: int,
                        num_classes: int) -> np.ndarray:
    """The (P,) class ids of an imported checkpoint: the ``--proto-class``
    file, else the module's attribute, else contiguous equal blocks
    (valid only where P divides evenly: pruned checkpoints are
    ragged)."""
    if proto_class_file:
        proto_class = np.load(proto_class_file)
    if proto_class is None:
        if n_proto % num_classes:
            raise SystemExit(
                f"{n_proto} prototypes do not divide into {num_classes} classes — "
                "this looks like a pruned checkpoint; pass --proto-class "
                "<file.npy> with the (P,) class-id array (in the reference: "
                "`ppnet.prototype_class_identity.argmax(1)`)")
        proto_class = np.arange(n_proto) // (n_proto // num_classes)
    if proto_class.shape != (n_proto,):
        raise SystemExit(f"proto_class shape {proto_class.shape} != ({n_proto},)")
    return proto_class


UNOISE_PREFIX = {"utility": "model.", "noise": "noise_model."}


def load_unoise_checkpoint(path: str, kind: str = "utility"
                           ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """(U-Net state_dict, depth, channel factor) of a reference
    pytorch-lightning U-Noise checkpoint (counterpart of the JAX
    package's ``load_unoise_checkpoint`` and ``_torch_unet_payload``).

    ``kind`` 'utility' strips the UtilityModel's ``model.`` prefix,
    'noise' the NoiseModel's ``noise_model.`` (reference
    train_util.py:12-16, train_noise.py:37-44); a file without it is
    taken as a raw U-Net state_dict.  ``num_batches_tracked`` entries are
    dropped; depth and channel factor come from the keys.  The result
    loads into ``models.unet.UNet(depth=..., cf=...)`` with
    ``strict=True``.  A lightning checkpoint pickles more than tensors,
    so the file is read with ``weights_only=False``: load only files you
    trust.  A negative BN ``running_var`` raises."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    prefix = UNOISE_PREFIX[kind]
    if not any(k.startswith(prefix) for k in sd):
        prefix = ""  # a raw U-Net state_dict
    out = {k[len(prefix):]: torch.as_tensor(_numpy(v)) for k, v in sd.items()
           if k.startswith(prefix) and not k.endswith("num_batches_tracked")}
    downs = [int(k.split(".")[1]) for k in out if k.startswith("downs.")]
    if not downs:
        raise ValueError(f"{path}: no U-Net keys (prefix {prefix!r}); it has "
                         f"{sorted(sd)[:4]}...")
    bad_var = [k for k, v in out.items() if k.endswith("running_var") and bool((v < 0).any())]
    if bad_var:
        raise ValueError(f"{path}: corrupt BN running_var in {bad_var[:8]}")
    cf = int(round(math.log2(out["downs.0.0.weight"].shape[0])))
    return out, max(downs) + 1, cf
