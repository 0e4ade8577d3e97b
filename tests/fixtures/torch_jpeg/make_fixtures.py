"""Write the JPEG fixtures of ``tests/test_torch_jpeg.py`` and
``chip_smoke.py`` (phase 18) with PIL, and their ``manifest.json``.

    python tests/fixtures/torch_jpeg/make_fixtures.py

Every image is drawn from a seed with numpy (smooth gradients, filled
shapes with sharp edges, mild noise, which keeps the files small) and
written by PIL's JPEG encoder (libjpeg-turbo).  The manifest maps each
file to its ``shape`` and PIL ``mode`` and the SHA-256 of
``np.asarray(Image.open(f).convert("RGB"))``'s bytes: the oracle of a
host without PIL.  The files are committed; run this again only to
change the set (the tests check the manifest against PIL's decode of
the committed files, not against a fresh run).
"""

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image, ImageFile

HERE = os.path.dirname(os.path.abspath(__file__))

# (file, (height, width), grey, PIL save arguments).  The four frames
# have PASCAL VOC's shapes at PIL's defaults (quality 75, 4:2:0); the
# rest are small, odd-sized variants.
FIXTURES = [
    ("pascal_0.jpg", (375, 500), False, {}),
    ("pascal_1.jpg", (500, 375), False, {}),
    ("pascal_2.jpg", (333, 500), False, {}),
    ("pascal_3.jpg", (375, 500), False, {}),
    ("grey.jpg", (37, 53), True, {}),
    ("q95_444.jpg", (45, 61), False, dict(quality=95, subsampling=0)),
    ("s422.jpg", (29, 67), False, dict(subsampling=1)),
    ("progressive.jpg", (51, 43), False, dict(progressive=True)),
    ("progressive_grey.jpg", (43, 51), True, dict(progressive=True)),
    ("restart.jpg", (41, 57), False, dict(restart_marker_blocks=3)),
    ("adobe_rgb.jpg", (33, 47), False, dict(keep_rgb=True, quality=90)),
    ("q100_optimize.jpg", (39, 45), False, dict(quality=100, optimize=True)),
    ("q10.jpg", (47, 39), False, dict(quality=10)),
]


def content(h: int, w: int, seed: int, grey: bool = False) -> np.ndarray:
    """(h, w, 3) or (h, w) uint8: per-channel gradients, a few filled
    ellipses and rectangles of random colours, Gaussian noise of sigma 3."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    y, x = y / max(h - 1, 1), x / max(w - 1, 1)
    img = np.stack([rng.uniform(40, 200) + rng.uniform(-60, 60) * x
                    + rng.uniform(-60, 60) * y for _ in range(3)], -1)
    for _ in range(6):
        cy, cx, ry, rx = rng.uniform(0, 1, 4) * [1, 1, 0.3, 0.3] + [0, 0, 0.05, 0.05]
        colour = rng.uniform(0, 255, 3)
        if rng.rand() < 0.5:
            inside = ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 < 1
        else:
            inside = (np.abs(y - cy) < ry) & (np.abs(x - cx) < rx)
        img[inside] = colour
    img += rng.normal(0, 3, img.shape)
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img.mean(-1).astype(np.uint8) if grey else img


def encode(arr: np.ndarray, **kw) -> bytes:
    """PIL's JPEG bytes of ``arr`` (``L`` for (h, w), ``RGB`` otherwise)."""
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pil_rgb(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def entry(path) -> dict:
    with Image.open(path) as im:
        mode = im.mode
    rgb = pil_rgb(path)
    return {"shape": list(rgb.shape), "mode": mode,
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}


def main() -> None:
    # progressive and optimized files are written whole: PIL's default
    # block is too small for some of their scans
    ImageFile.MAXBLOCK = 1 << 22
    manifest = {}
    for seed, (name, (h, w), grey, kw) in enumerate(FIXTURES):
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(encode(content(h, w, seed, grey), **kw))
        manifest[name] = entry(path)
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
