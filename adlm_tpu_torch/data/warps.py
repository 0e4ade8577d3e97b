"""Geometric warp augmentations of U-Noise (counterpart of
``adlm_tpu.data.warps``).

The reference trains U-Noise with albumentations' geometric transforms
(reference src/data.py:14-38):

    OneOf([ElasticTransform(alpha=120, sigma=6, alpha_affine=3.6),
           GridDistortion(),
           OpticalDistortion(distort_limit=2, shift_limit=0.5)], p=0.3)
    ShiftScaleRotate()          # p=0.5 default

These are the JAX package's numpy re-implementations of the same math
(albumentations 0.x formulas), drawing the same ``np.random.RandomState``
values in the same order.  The coordinate remaps (bilinear for images,
nearest for masks, BORDER_REFLECT_101) and the displacement field's
gaussian blur run in the port's host C++ library (``native``); there is
no numpy path behind it: a failed build raises.  The numpy versions of
those three functions (``native.*_plain``) serve the tests and
``chip_smoke.py`` only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from adlm_tpu_torch import native

Arrays = Tuple[np.ndarray, np.ndarray]


def remap_pair(image: np.ndarray, mask: np.ndarray, map_y: np.ndarray,
               map_x: np.ndarray) -> Arrays:
    """cv2.remap semantics: linear for the image, nearest for the mask."""
    return (native.remap_bilinear(image, map_y, map_x),
            native.remap_nearest(mask, map_y, map_x))


def _gaussian(field: np.ndarray, sigma: float) -> np.ndarray:
    """gaussian_filter(mode='constant') of a float32 field."""
    return native.gaussian_blur(field, sigma)


def _affine_maps(matrix: np.ndarray, h: int, w: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Destination→source coordinate maps for a 2×3 forward affine
    (cv2.warpAffine inverts the matrix to sample)."""
    m = np.vstack([matrix, [0.0, 0.0, 1.0]])
    inv = np.linalg.inv(m)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    src_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    src_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    return src_y, src_x


def _get_affine_transform(pts_src: np.ndarray, pts_dst: np.ndarray
                          ) -> np.ndarray:
    """cv2.getAffineTransform: 2×3 matrix from 3 point correspondences."""
    a = np.zeros((6, 6))
    b = np.zeros(6)
    for i in range(3):
        x, y = pts_src[i]
        a[2 * i] = [x, y, 1, 0, 0, 0]
        a[2 * i + 1] = [0, 0, 0, x, y, 1]
        b[2 * i] = pts_dst[i][0]
        b[2 * i + 1] = pts_dst[i][1]
    coeff = np.linalg.solve(a, b)
    return coeff.reshape(2, 3)


def elastic_transform(image: np.ndarray, mask: np.ndarray,
                      rs: np.random.RandomState,
                      alpha: float = 120.0, sigma: float = 6.0,
                      alpha_affine: float = 3.6) -> Arrays:
    """albumentations.ElasticTransform (Simard 2003 variant):
    random 3-point affine jitter (±alpha_affine px) followed by a
    gaussian-smoothed random displacement field scaled by alpha."""
    h, w = image.shape[:2]

    if alpha_affine > 0:
        center = np.float32([w, h]) // 2
        sq = min(h, w) // 3
        pts1 = np.float32([center + sq,
                           [center[0] + sq, center[1] - sq],
                           center - sq])
        pts2 = pts1 + rs.uniform(-alpha_affine, alpha_affine,
                                 size=pts1.shape).astype(np.float32)
        m = _get_affine_transform(pts1, pts2)
        my, mx = _affine_maps(m, h, w)
        image, mask = remap_pair(image, mask, my, mx)

    dx = _gaussian((rs.rand(h, w) * 2 - 1).astype(np.float32),
                   sigma) * alpha
    dy = _gaussian((rs.rand(h, w) * 2 - 1).astype(np.float32),
                   sigma) * alpha
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return remap_pair(image, mask, ys + dy.astype(np.float32),
                      xs + dx.astype(np.float32))


def grid_distortion(image: np.ndarray, mask: np.ndarray,
                    rs: np.random.RandomState,
                    num_steps: int = 5,
                    distort_limit: float = 0.3) -> Arrays:
    """albumentations.GridDistortion: the image is cut into
    ``num_steps`` cells per axis and each cell's extent is stretched by
    an independent factor in 1 ± distort_limit; the piecewise-linear
    coordinate map is then resampled."""
    h, w = image.shape[:2]
    stepsx = 1 + rs.uniform(-distort_limit, distort_limit, num_steps + 1)
    stepsy = 1 + rs.uniform(-distort_limit, distort_limit, num_steps + 1)

    def axis_map(n, steps):
        step = n // num_steps
        xx = np.zeros(n, np.float32)
        prev = 0.0
        for idx, x in enumerate(range(0, n, step)):
            end = x + step
            if end > n:
                end = n
                cur = float(n)
            else:
                cur = prev + step * steps[idx]
            xx[x:end] = np.linspace(prev, cur, end - x, endpoint=False)
            prev = cur
        return xx

    map_x = np.tile(axis_map(w, stepsx)[None, :], (h, 1))
    map_y = np.tile(axis_map(h, stepsy)[:, None], (1, w))
    return remap_pair(image, mask, map_y, map_x)


def optical_distortion(image: np.ndarray, mask: np.ndarray,
                       rs: np.random.RandomState,
                       distort_limit: float = 2.0,
                       shift_limit: float = 0.5) -> Arrays:
    """albumentations.OpticalDistortion: pinhole-camera radial
    distortion (k1 = k2 = k) with a shifted principal point, i.e.
    cv2.initUndistortRectifyMap with camera matrix
    [[w, 0, cx+dx], [0, h, cy+dy]] and distortion [k, k, 0, 0]."""
    h, w = image.shape[:2]
    k = rs.uniform(-distort_limit, distort_limit)
    dx = round(rs.uniform(-shift_limit, shift_limit))
    dy = round(rs.uniform(-shift_limit, shift_limit))
    fx, fy = float(w), float(h)
    cx = w * 0.5 + dx
    cy = h * 0.5 + dy

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xn = (xs - cx) / fx
    yn = (ys - cy) / fy
    r2 = xn * xn + yn * yn
    scale = 1.0 + k * r2 + k * r2 * r2
    map_x = (xn * scale * fx + cx).astype(np.float32)
    map_y = (yn * scale * fy + cy).astype(np.float32)
    return remap_pair(image, mask, map_y, map_x)


def shift_scale_rotate(image: np.ndarray, mask: np.ndarray,
                       rs: np.random.RandomState,
                       shift_limit: float = 0.0625,
                       scale_limit: float = 0.1,
                       rotate_limit: float = 45.0) -> Arrays:
    """albumentations.ShiftScaleRotate: rotation about the image center
    + isotropic scale + fractional translation (cv2.warpAffine with
    getRotationMatrix2D)."""
    h, w = image.shape[:2]
    angle = rs.uniform(-rotate_limit, rotate_limit)
    scale = 1.0 + rs.uniform(-scale_limit, scale_limit)
    dx = rs.uniform(-shift_limit, shift_limit)
    dy = rs.uniform(-shift_limit, shift_limit)

    cx, cy = w / 2.0, h / 2.0
    a = np.deg2rad(angle)
    alpha = scale * np.cos(a)
    beta = scale * np.sin(a)
    # cv2.getRotationMatrix2D convention (y axis points down → the
    # rotation appears clockwise for positive angles)
    m = np.array([[alpha, beta, (1 - alpha) * cx - beta * cy + dx * w],
                  [-beta, alpha, beta * cx + (1 - alpha) * cy + dy * h]])
    my, mx = _affine_maps(m, h, w)
    return remap_pair(image, mask, my, mx)


def reference_geometric_augment(image: np.ndarray, mask: np.ndarray,
                                rs: np.random.RandomState) -> Arrays:
    """The reference's geometric block (src/data.py:26-36): OneOf
    {elastic, grid, optical} at p=0.3, then ShiftScaleRotate at p=0.5."""
    if rs.rand() < 0.3:
        choice = rs.randint(3)
        if choice == 0:
            image, mask = elastic_transform(image, mask, rs)
        elif choice == 1:
            image, mask = grid_distortion(image, mask, rs)
        else:
            image, mask = optical_distortion(image, mask, rs)
    if rs.rand() < 0.5:
        image, mask = shift_scale_rotate(image, mask, rs)
    return image, mask
