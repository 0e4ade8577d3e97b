"""Receptive-field arithmetic for the prototype layer (counterpart of
``adlm_tpu.utils.receptive_field``; the port keeps its own copy).

Forward RF propagation through a conv stack, used to map a prototype's
feature-map location back to input pixels for visualization (reference
receptive_field.py:119-140; consumed by the classification push at
reference push.py:14-313).  State per layer: (n, jump, rf_size, start).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

LayerPad = Union[int, str]  # int pad-per-side, or 'SAME'/'VALID'

RFInfo = Tuple[int, float, float, float]  # (n, jump, rf, start)


def propagate_rf(rf: RFInfo, kernel: int, stride: int,
                 padding: LayerPad) -> RFInfo:
    n_in, j_in, r_in, start_in = rf
    if padding == "SAME":
        n_out = math.ceil(n_in / stride)
        pad = max(kernel - stride, 0) if n_in % stride == 0 \
            else max(kernel - (n_in % stride), 0)
    elif padding == "VALID":
        n_out = math.ceil((n_in - kernel + 1) / stride)
        pad = 0
    else:
        pad = int(padding) * 2
        n_out = (n_in - kernel + pad) // stride + 1
    p_left = pad // 2
    return (
        n_out,
        j_in * stride,
        r_in + (kernel - 1) * j_in,
        start_in + ((kernel - 1) / 2 - p_left) * j_in,
    )


def proto_layer_rf_info(img_size: int,
                        kernels: Sequence[int],
                        strides: Sequence[int],
                        paddings: Sequence[LayerPad],
                        prototype_kernel_size: int = 1) -> List:
    """RF info of the prototype layer given the backbone's conv_info()."""
    assert len(kernels) == len(strides) == len(paddings)
    rf: RFInfo = (img_size, 1, 1, 0.5)
    for k, s, p in zip(kernels, strides, paddings):
        rf = propagate_rf(rf, k, s, p)
    rf = propagate_rf(rf, prototype_kernel_size, 1, "VALID")
    return list(rf)


def rf_box_at(img_hw: Tuple[int, int], loc_hw: Tuple[int, int],
              rf: Sequence[float]) -> List[int]:
    """Input-pixel box [h0, h1, w0, w1] seen by feature location
    (reference receptive_field.py:37-55)."""
    n, j, r, start = rf
    h_idx, w_idx = loc_hw
    assert h_idx < n and w_idx < n
    ch = start + h_idx * j
    cw = start + w_idx * j
    return [
        max(int(ch - r / 2), 0), min(int(ch + r / 2), img_hw[0]),
        max(int(cw - r / 2), 0), min(int(cw + r / 2), img_hw[1]),
    ]
