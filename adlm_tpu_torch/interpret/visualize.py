"""Prototype visualization writers, PNG artifacts (counterpart of
``adlm_tpu.interpret.visualize``).

The artifact set of the reference push (reference
segmentation/push.py:361-481): per improved prototype, the original
image, activation-heatmap overlays (full and ground-truth-masked), the
receptive-field crop, and the highly activated crop found by greedy box
growth from the patch at the ≥95th-percentile activation level
(reference helpers.py:48-82).

Host numpy only, as in the JAX package.  Two pieces are written out
here because their libraries are not the port's:

* ``upsample_cubic`` is ``jax.image.resize(method="cubic")``: Keys'
  cubic with a = −0.5, weights renormalized over the taps inside the
  image, in f32.  ``F.interpolate(mode="bicubic")`` is another filter
  (a = −0.75, border clamp), so the weight matrices are built here.
* PNG files are written with ``data/image_folder.py::write_png``
  (``zlib``, 8-bit RGB or grey, no filter), not PIL.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from adlm_tpu_torch.data.image_folder import write_png

_F32 = np.float32


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """x in [0,1] → RGB in [0,1], matching OpenCV's COLORMAP_JET curve
    closely enough for qualitative heatmaps."""
    x = np.clip(x, 0.0, 1.0)
    four = 4.0 * x
    r = np.clip(np.minimum(four - 1.5, -four + 4.5), 0, 1)
    g = np.clip(np.minimum(four - 0.5, -four + 3.5), 0, 1)
    b = np.clip(np.minimum(four + 0.5, -four + 2.5), 0, 1)
    return np.stack([r, g, b], axis=-1)


def _fma(a: np.ndarray, b: float, c: float) -> np.ndarray:
    """f32 a·b + c rounded once (the product of two f32 is exact in f64)."""
    return (a.astype(np.float64) * b + c).astype(_F32)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel, a = −0.5, at |offsets| ``x`` (f32), each
    step a fused multiply-add as XLA compiles the JAX package's
    polynomial: ((1.5x − 2.5)·x)·x + 1 inside 1, ((−0.5x + 2.5)·x − 4)·x
    + 2 up to 2."""
    near = _fma(_fma(x, 1.5, -2.5) * x, x, 1.0)
    far = _fma(_fma(_fma(x, -0.5, 2.5), x, -4.0), x, 2.0)
    return np.where(x >= 2.0, _F32(0.0), np.where(x >= 1.0, far, near)).astype(_F32)


def _cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) f32 resampling weights of
    ``jax.image.resize(method="cubic", antialias=True)`` along one axis:
    half-pixel sample positions, each column renormalized to sum 1 over
    the taps inside the input, zero where the sample lies outside it."""
    scale = _F32(out_size / in_size)
    inv = _F32(1.0) / scale
    kernel_scale = max(inv, _F32(1.0))  # widened only when downsampling
    sample = (np.arange(out_size, dtype=_F32) + _F32(0.5)) * inv - _F32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=_F32)[:, None]) / kernel_scale
    w = _keys_cubic(x)
    total = np.zeros((1, out_size), _F32)
    for row in w:  # in input order: XLA's order below 16 taps, within
        total += row  # an ulp of it above
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, _F32(1.0)), _F32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, _F32(0.0)).astype(_F32)


def upsample_cubic(x: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bicubic resize of a 2-D map to ``size`` (reference uses
    cv2.INTER_CUBIC, push.py:319), f32 as the JAX package computes it."""
    x = np.asarray(x, _F32)
    (h, w), (oh, ow) = x.shape, size
    if h != oh:  # an axis whose size does not change is left as it is
        x = _cubic_weights(h, oh).T @ x
    if w != ow:
        x = x @ _cubic_weights(w, ow)
    return x


def grow_high_activation_box(act: np.ndarray, seed_box, threshold: float,
                             add_margin: int = 5) -> Tuple[int, int, int, int]:
    """Greedy 4-direction growth of ``seed_box`` while the adjacent
    row/column still contains activation ≥ threshold
    (reference helpers.py:48-82). Returns (h0, h1, w0, w1), end-exclusive.
    """
    # the reference uses the box's end-exclusive coordinates as inclusive
    # ones (helpers.py:49-56 never subtracts 1): kept, so that the crops
    # are the reference's
    h0, h1, w0, w1 = seed_box
    hot = act >= threshold
    H, W = act.shape
    growing = [True, True, True, True]
    while any(growing):
        if growing[0]:
            if h0 > 0 and hot[h0 - 1, w0:w1 + 1].any():
                h0 -= 1
            else:
                growing[0] = False
        if growing[1]:
            if h1 < H - 1 and hot[h1 + 1, w0:w1 + 1].any():
                h1 += 1
            else:
                growing[1] = False
        if growing[2]:
            if w0 > 0 and hot[h0:h1 + 1, w0 - 1].any():
                w0 -= 1
            else:
                growing[2] = False
        if growing[3]:
            if w1 < W - 1 and hot[h0:h1 + 1, w1 + 1].any():
                w1 += 1
            else:
                growing[3] = False
    h0 = max(h0 - add_margin, 0)
    w0 = max(w0 - add_margin, 0)
    h1 = min(h1 + add_margin, H - 1)
    w1 = min(w1 + add_margin, W - 1)
    return h0, h1 + 1, w0, w1 + 1


def high_activation_crop(act: np.ndarray, percentile: float = 95
                         ) -> Tuple[int, int, int, int]:
    """Tight box around all pixels ≥ the percentile threshold
    (reference helpers.py:24-45)."""
    thr = np.percentile(act, percentile)
    hot = act >= thr
    rows = np.where(hot.any(axis=1))[0]
    cols = np.where(hot.any(axis=0))[0]
    if len(rows) == 0:
        return 0, act.shape[0], 0, act.shape[1]
    return int(rows[0]), int(rows[-1]) + 1, int(cols[0]), int(cols[-1]) + 1


def normalize01(a: np.ndarray) -> np.ndarray:
    """Min-max normalize to [0,1]; constant maps normalize to zeros."""
    lo, hi = a.min(), a.max()
    return (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def _save(path: str, img: np.ndarray) -> None:
    write_png(path, _to_uint8(img))


def _overlay(img: np.ndarray, act_norm: np.ndarray) -> np.ndarray:
    """0.5·img + 0.3·jet(act) (reference push.py:417)."""
    return np.clip(0.5 * img + 0.3 * jet_colormap(act_norm), 0, 1)


def _draw_box(img: np.ndarray, box, color=(1.0, 0.0, 0.0),
              width: int = 2) -> np.ndarray:
    h0, h1, w0, w1 = box
    out = img.copy()
    h1 = min(h1, out.shape[0]) - 1
    w1 = min(w1, out.shape[1]) - 1
    c = np.asarray(color)
    out[h0:h0 + width, w0:w1 + 1] = c
    out[max(h1 - width + 1, 0):h1 + 1, w0:w1 + 1] = c
    out[h0:h1 + 1, w0:w0 + width] = c
    out[h0:h1 + 1, max(w1 - width + 1, 0):w1 + 1] = c
    return out


def save_prototype_artifacts(run_dir: str, proto_idx: int,
                             image: np.ndarray, label: np.ndarray,
                             dist_map: np.ndarray,
                             rf_box: Tuple[int, int, int, int],
                             target_class: int,
                             class_names: Optional[Dict[int, str]] = None,
                             activation: str = "log",
                             epsilon: float = 1e-4,
                             percentile: float = 95
                             ) -> Tuple[int, int, int, int]:
    """Write the artifact set for one prototype; returns the grown
    high-activation bound box (reference push.py:329-350).

    ``image`` is the un-normalized RGB image in [0,1]; ``dist_map`` the
    (h, w) prototype distance map (f32, as the head writes it);
    ``rf_box`` the winning-patch pixel box.
    """
    cls_name = (class_names or {}).get(target_class, f"class{target_class}")
    out_dir = os.path.join(run_dir, cls_name)
    os.makedirs(out_dir, exist_ok=True)

    if activation == "log":
        act = np.log((dist_map + 1.0) / (dist_map + epsilon))
    else:
        act = dist_map.max() - dist_map
    H, W = image.shape[0], image.shape[1]
    act_up = upsample_cubic(act, (H, W))

    threshold = np.percentile(act_up, percentile)
    y_mask = (label == target_class + 1)
    act_gt = act_up * y_mask

    bound = grow_high_activation_box(act_gt, rf_box, threshold)

    norm = normalize01
    prefix = os.path.join(out_dir, f"prototype-img_{proto_idx}")
    np.save(os.path.join(out_dir, f"prototype-self-act{proto_idx}.npy"), act)
    _save(prefix + "-original.png", image)
    _save(prefix + "-original_with_box.png", _draw_box(image, rf_box))
    _save(prefix + "-original_with_self_act.png", _overlay(image, norm(act_up)))
    _save(prefix + "-original_with_self_act_gt_only.png",
          _overlay(image, norm(act_gt)))
    _save(prefix + "-receptive_field.png",
          image[rf_box[0]:rf_box[1], rf_box[2]:rf_box[3]])
    _save(prefix + ".png", image[bound[0]:bound[1], bound[2]:bound[3]])
    return bound
