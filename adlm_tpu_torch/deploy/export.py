"""Ahead-of-time export of the inference programs for deployment and
serving (counterpart of ``adlm_tpu.deploy.export``).

The reference has no deployment story: its eval scripts rebuild the
torch model from source and reload the checkpoint on every run
(reference segmentation/eval_valid.py:64-101).  Here the whole
inference program (uint8 normalization on the device, backbone, the
prototype head, bilinear logit upsample, argmax and the
nearest-prototype map) is traced ONCE with ``torch.export`` into a
``.pt2`` file that holds the weights.  A serving process loads and calls
it without the model code or the checkpoint directory: it imports
``adlm_tpu_torch.ops`` alone, which registers the head's operator
``adlm_tpu_torch::prototype_head``, the one custom node of the graph
(``ops/prototype.py``).  On the card that node launches the hand-written
kernel, and counts the launch, every time the program runs.

One artifact is written PER device (``platforms=("cpu", "cuda")`` by
default), as the JAX package writes one per platform: a program is
traced with its weights on its device.  A CUDA artifact needs the card
at export time; asking for one without a card raises before anything is
written.

Mixed precision: ``compute_dtype=torch.bfloat16`` (the default) casts
the parameters and the normalized images to bf16
(``core/device.py::cast_params``); buffers (frozen-BN statistics) stay
f32, as the JAX package keeps its ``constants`` in f32.  The head and
every output are f32.

TF32 is a process setting that the graph does not record: the call that
``load_inference_artifact`` returns runs under ``core.device.ieee_f32``,
as the port's eval does, so a float32 artifact serves the eval's IEEE
f32 numbers.

Artifact layout (``<out_dir>/``):

* ``inference_<platform>.pt2``: the ``torch.export`` program, one per
  device, shapes static at the exported batch;
* ``manifest.json``: the JAX manifest's keys (input shape/dtype, output
  names, normalization constants, prototype→class identity, class
  count, platforms), with ``torch_version`` in place of ``jax_version``.
"""

from __future__ import annotations

import copy
import json
import os
import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from adlm_tpu_torch.core.device import cast_params, ieee_f32, resolve_device, to_device
from adlm_tpu_torch.ops.normalize import normalize as normalize_images
from adlm_tpu_torch.ops.prototype import distance_to_similarity
from adlm_tpu_torch.ops.resize import resize_bilinear

_MANIFEST = "manifest.json"
PLATFORMS = ("cpu", "cuda")
MeanStd = Optional[Tuple[Sequence[float], Sequence[float]]]


def _artifact_name(platform: str) -> str:
    return f"inference_{platform}.pt2"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


class _SegProgram(nn.Module):
    """images (B, H, W, 3) → pred (B, H, W), grid_logits (B, gh, gw, K),
    nearest_proto (B, gh, gw)."""

    def __init__(self, model: nn.Module, size: Tuple[int, int],
                 normalize: MeanStd, dtype: torch.dtype):
        super().__init__()
        self.model, self.size, self.normalize, self.dtype = model, size, normalize, dtype

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = normalize_images(images, self.normalize).to(self.dtype)
        grid_logits, dist = self.model(x.permute(0, 3, 1, 2), return_distances=True)
        logits = resize_bilinear(grid_logits, self.size)
        return {"pred": torch.argmax(logits, dim=-1).to(torch.int32),
                "grid_logits": grid_logits.to(torch.float32),
                "nearest_proto": torch.argmin(dist, dim=-1).to(torch.int32)}


class _UNoiseProgram(nn.Module):
    """Raw slices (B, H, W, 1) → {mask_prob, mask} (utility) or
    {importance} (noise), each (B, H, W, 1)."""

    def __init__(self, model: nn.Module, kind: str, dtype: torch.dtype):
        super().__init__()
        self.model, self.kind, self.dtype = model, kind, dtype

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        from adlm_tpu_torch.train.unoise import _prep_images

        logits = self.model(_prep_images(images, True).to(self.dtype)).permute(0, 2, 3, 1)
        prob = torch.sigmoid(logits.to(torch.float32))
        if self.kind == "utility":
            return {"mask_prob": prob, "mask": (logits > 0).to(torch.int32)}
        return {"importance": prob}


class _ClsProgram(nn.Module):
    """images (B, H, W, 3) → logits (B, K), pred (B,), proto_activation
    (B, P), min_distances (B, P)."""

    def __init__(self, model: nn.Module, normalize: MeanStd, dtype: torch.dtype):
        super().__init__()
        self.model, self.normalize, self.dtype = model, normalize, dtype

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = normalize_images(images, self.normalize).to(self.dtype)
        logits, min_d = self.model(x.permute(0, 3, 1, 2))
        min_d = min_d.to(torch.float32)
        cfg = self.model.cfg
        return {"logits": logits.to(torch.float32),
                "pred": torch.argmax(logits, dim=-1).to(torch.int32),
                "proto_activation": distance_to_similarity(
                    min_d, cfg.prototype_activation, cfg.epsilon),
                "min_distances": min_d}


def _on_device(model: nn.Module, dev: torch.device, dtype: torch.dtype) -> nn.Module:
    """A copy of ``model`` on ``dev`` (channels-last on the card), in
    eval mode, its parameters in ``dtype``; the caller's model is left
    as it was."""
    m = copy.deepcopy(model).to(dev).eval()
    if dev.type == "cuda":
        m = m.to(memory_format=torch.channels_last)
    return cast_params(m, dtype)


def _write_artifact(program: Callable[[torch.device], nn.Module],
                    in_shape: Sequence[int], in_dtype: torch.dtype, out_dir: str,
                    platforms: Sequence[str], manifest: Dict[str, Any]) -> Dict[str, Any]:
    """Export ``program(device)`` once per platform, then the manifest.
    Every platform is checked before anything is written: ``cuda``
    without a card raises."""
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms {list(platforms)}: each one of {PLATFORMS}")
    devices = [resolve_device(p) for p in platforms]
    os.makedirs(out_dir, exist_ok=True)
    for platform, dev in zip(platforms, devices):
        example = torch.zeros(tuple(in_shape), dtype=in_dtype, device=dev)
        with torch.no_grad():
            ep = torch.export.export(program(dev), (example,), strict=False)
        with warnings.catch_warnings():
            # a channels-last weight is not contiguous, so the archive
            # writer does not see that it covers its whole storage; each
            # one owns its storage, which is written as it is, with the
            # strides beside it
            warnings.filterwarnings("ignore", message="No complete tensor found")
            torch.export.save(ep, os.path.join(out_dir, _artifact_name(platform)))
        del ep
    manifest = {**manifest, "platforms": list(platforms),
                "torch_version": torch.__version__}
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _input_manifest(shape: Sequence[int], dtype: torch.dtype) -> Dict[str, Any]:
    return {"shape": list(shape), "dtype": _dtype_name(dtype)}


def _normalize_manifest(normalize: MeanStd):
    if normalize is None:
        return None
    return [[float(v) for v in normalize[0]], [float(v) for v in normalize[1]]]


def export_inference_artifact(
    model: nn.Module, proto_class: Any, out_dir: str, batch: int,
    size: Tuple[int, int], normalize: MeanStd = None,
    platforms: Sequence[str] = PLATFORMS,
    compute_dtype: torch.dtype = torch.bfloat16,
    class_names: Optional[list] = None,
) -> Dict[str, Any]:
    """Export the ProtoSeg inference program of ``model`` (a PPNet) for
    ``(batch, *size, 3)`` inputs (uint8 when ``normalize`` is given, else
    pre-normalized f32) and write artifact and manifest to ``out_dir``.
    images → {pred (B,H,W) int32, grid_logits (B,gh,gw,K) f32,
    nearest_proto (B,gh,gw) int32}.  Returns the manifest."""
    H, W = size
    in_dtype = torch.uint8 if normalize is not None else torch.float32
    return _write_artifact(
        lambda dev: _SegProgram(_on_device(model, dev, compute_dtype), (H, W),
                                normalize, compute_dtype),
        (batch, H, W, 3), in_dtype, out_dir, platforms, {
            "input": _input_manifest((batch, H, W, 3), in_dtype),
            "outputs": ["pred", "grid_logits", "nearest_proto"],
            "normalize": _normalize_manifest(normalize),
            "proto_class": np.asarray(torch.as_tensor(proto_class).cpu()).astype(int).tolist(),
            "num_classes": int(model.cfg.num_classes),
            "class_names": class_names,
            "compute_dtype": _dtype_name(compute_dtype),
        })


def export_unoise_artifact(
    model: nn.Module, kind: str, out_dir: str, batch: int, size: Tuple[int, int],
    platforms: Sequence[str] = PLATFORMS,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Dict[str, Any]:
    """Export a U-Noise U-Net for serving.

    ``kind='utility'``: raw (B,H,W,1) slice → segmentation
    ``{mask_prob, mask}`` (σ(logits), logits>0, the reference's val-dice
    threshold, src/train_util.py:36).  ``kind='noise'``: slice →
    ``{importance}``, the per-pixel noise tolerance ``B =
    σ(noise_unet(x))`` (reference src/train_noise.py:54-64).  Inputs are
    raw unnormalized slices; the tile to 3 channels and the ImageNet
    normalization are in the program (``train/unoise.py::_prep_images``).
    """
    if kind not in ("utility", "noise"):
        raise ValueError(f"unknown U-Noise model {kind!r}")
    H, W = size
    return _write_artifact(
        lambda dev: _UNoiseProgram(_on_device(model, dev, compute_dtype), kind,
                                   compute_dtype),
        (batch, H, W, 1), torch.float32, out_dir, platforms, {
            "model": f"unoise_{kind}",
            "input": {"shape": [batch, H, W, 1], "dtype": "float32",
                      "note": "raw unnormalized slice values"},
            "outputs": (["mask_prob", "mask"] if kind == "utility" else ["importance"]),
            "unet": {"depth": int(model.depth), "channel_factor": int(model.cf)},
            "compute_dtype": _dtype_name(compute_dtype),
        })


def export_cls_artifact(
    model: nn.Module, proto_class: Any, out_dir: str, batch: int,
    size: Tuple[int, int], normalize: MeanStd = None,
    platforms: Sequence[str] = PLATFORMS,
    compute_dtype: torch.dtype = torch.bfloat16,
    class_names: Optional[list] = None,
) -> Dict[str, Any]:
    """Export a ProtoPNet classifier (a PPNet with
    ``patch_classification=False``) for serving.

    images → ``{logits (B,K) f32, pred (B,) int32, proto_activation
    (B,P) f32, min_distances (B,P) f32}``.  The distances come from
    ``PPNet.global_head``, which asks the head for its distances alone
    (the kernel's distances-only route on the card).
    ``proto_activation`` is the reference's ``prototype_activations``
    vector, and ``proto_class`` in the manifest maps each prototype to
    its class."""
    H, W = size
    in_dtype = torch.uint8 if normalize is not None else torch.float32
    return _write_artifact(
        lambda dev: _ClsProgram(_on_device(model, dev, compute_dtype), normalize,
                                compute_dtype),
        (batch, H, W, 3), in_dtype, out_dir, platforms, {
            "model": "protopnet_classifier",
            "input": _input_manifest((batch, H, W, 3), in_dtype),
            "outputs": ["logits", "pred", "proto_activation", "min_distances"],
            "normalize": _normalize_manifest(normalize),
            "proto_class": np.asarray(torch.as_tensor(proto_class).cpu()).astype(int).tolist(),
            "num_classes": int(model.cfg.num_classes),
            "class_names": class_names,
            "compute_dtype": _dtype_name(compute_dtype),
        })


def load_inference_artifact(out_dir: str, device: Any = None
                            ) -> Tuple[Callable, Dict[str, Any]]:
    """Load an exported artifact.  Returns ``(call, manifest)``:
    ``call(images)`` (a tensor or numpy array of the manifest's input
    shape and dtype) runs the program held in the file on ``device``
    (default the card; without one this raises unless ``"cpu"`` is
    asked for) under ``ieee_f32``, and returns its outputs on the
    device.  No model code or checkpoint is needed: only the head's
    operator, registered by ``adlm_tpu_torch.ops``, which this module
    imports."""
    dev = resolve_device(device)
    with open(os.path.join(out_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    if dev.type not in manifest["platforms"]:
        raise ValueError(f"device {dev.type!r} has no artifact in {out_dir} "
                         f"(exported: {manifest['platforms']})")
    program = torch.export.load(os.path.join(out_dir, _artifact_name(dev.type))).module()

    def call(images) -> Dict[str, torch.Tensor]:
        with torch.inference_mode(), ieee_f32():
            return program(to_device(images, dev))

    return call, manifest
