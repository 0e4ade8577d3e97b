"""Write the augmentation fixtures of ``tests/test_torch_img_aug.py`` and
``chip_smoke.py`` (phase 19) with PIL, and their ``manifest.json``.

    python tests/fixtures/torch_img_aug/make_fixtures.py

Two sources are written here by PIL: ``comment.jpg``, a JPEG with a COM
marker, and ``palette.png``, a palette PNG with a ``tEXt`` chunk keyed
``comment`` (latin-1 text, which PIL's JPEG encoder writes in UTF-8).
``TREE`` lays them out with the JPEG fixtures of ``../torch_jpeg`` as a
class folder; the manifest records that tree and, for every file that
the JAX package's ``augment_directory`` writes from it (seed 0, two
copies per operation), its size and SHA-256: PIL's bytes, the oracle of
a host without PIL.  The files are committed; run this again only to
change the set (the tests hold the manifest against a fresh run of the
JAX function).  ``build_tree`` and ``outputs`` need no PIL: the tests
and ``chip_smoke.py`` import them.
"""

import hashlib
import importlib.util
import io
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.dirname(HERE)
REPO = os.path.dirname(os.path.dirname(FIXTURES))
SEED, COPIES = 0, 2

# class folder -> sources, relative to tests/fixtures.  class_000 holds
# the four PASCAL-sized frames (CUB's typical size); class_001 small
# variants: grey, progressive, restart markers, Adobe RGB, a comment.
TREE = {
    "class_000": [f"torch_jpeg/pascal_{i}.jpg" for i in range(4)],
    "class_001": ["torch_jpeg/grey.jpg", "torch_jpeg/progressive.jpg",
                  "torch_jpeg/restart.jpg", "torch_jpeg/adobe_rgb.jpg",
                  "torch_img_aug/comment.jpg", "torch_img_aug/palette.png"],
}


def build_tree(tree: dict, dst: str) -> None:
    """Copy ``tree``'s sources into ``dst/<class>/``."""
    for cls, files in tree.items():
        os.makedirs(os.path.join(dst, cls), exist_ok=True)
        for rel in files:
            shutil.copy(os.path.join(FIXTURES, rel), os.path.join(dst, cls))


def outputs(dst: str) -> dict:
    """``<class>/<file>`` -> {size, sha256} of every file under ``dst``."""
    out = {}
    for cls in sorted(os.listdir(dst)):
        for name in sorted(os.listdir(os.path.join(dst, cls))):
            with open(os.path.join(dst, cls, name), "rb") as f:
                data = f.read()
            out[f"{cls}/{name}"] = {"size": len(data),
                                    "sha256": hashlib.sha256(data).hexdigest()}
    return out


def _content():
    spec = importlib.util.spec_from_file_location(
        "torch_jpeg_fixtures", os.path.join(FIXTURES, "torch_jpeg", "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.content


def main() -> None:
    from PIL import Image, PngImagePlugin

    content = _content()
    buf = io.BytesIO()
    Image.fromarray(content(33, 41, 101)).save(buf, "JPEG", comment=b"CUB-200-2011 fixture")
    with open(os.path.join(HERE, "comment.jpg"), "wb") as f:
        f.write(buf.getvalue())
    info = PngImagePlugin.PngInfo()
    info.add_text("comment", "palette fixture, caf\xe9 cr\xe8me")
    im = Image.fromarray(content(29, 31, 102)).quantize(24)
    im.save(os.path.join(HERE, "palette.png"), pnginfo=info)

    sys.path.insert(0, REPO)
    from adlm_tpu.data.img_aug import augment_directory

    with tempfile.TemporaryDirectory() as tmp:
        build_tree(TREE, os.path.join(tmp, "src"))
        n = augment_directory(os.path.join(tmp, "src"), os.path.join(tmp, "dst"),
                              copies_per_op=COPIES, seed=SEED)
        files = outputs(os.path.join(tmp, "dst"))
    assert n == len(files)
    manifest = {"seed": SEED, "copies_per_op": COPIES, "tree": TREE, "outputs": files}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
