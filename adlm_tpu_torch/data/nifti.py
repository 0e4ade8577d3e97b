"""Minimal dependency-free NIfTI-1 reader (a copy of
``adlm_tpu.data.nifti``).

The reference reads Medical Decathlon volumes through nibabel
(reference preprocessPancreasScans.py:10-167, data/prepare_data.py:13-60);
the port reads them with this reader alone.  It implements exactly the
subset those flows use —
``nib.load(path).get_fdata()``: the 348-byte NIfTI-1 header, the raw
data block at ``vox_offset`` in Fortran order, and nibabel's
``scl_slope``/``scl_inter`` scaling semantics, for plain ``.nii`` and
gzipped ``.nii.gz`` files in either endianness.
"""

from __future__ import annotations

import gzip
from typing import IO

import numpy as np

_DTYPES = {
    2: "u1", 4: "i2", 8: "i4", 16: "f4", 64: "f8", 256: "i1",
    512: "u2", 768: "u4", 1024: "i8", 1280: "u8",
}


def _read_exact(f: IO[bytes], n: int) -> bytes:
    buf = f.read(n)
    if len(buf) != n:
        raise ValueError(f"truncated NIfTI file: wanted {n} bytes, "
                         f"got {len(buf)}")
    return buf


def load_fdata(path: str) -> np.ndarray:
    """Array data as float64 with scl_slope/scl_inter applied —
    equivalent to ``nibabel.load(path).get_fdata()`` for NIfTI-1."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        hdr = _read_exact(f, 348)
        endian = "<"
        if int.from_bytes(hdr[0:4], "little") != 348:
            if int.from_bytes(hdr[0:4], "big") != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file "
                                 "(sizeof_hdr != 348)")
            endian = ">"
        magic = hdr[344:348]
        if magic not in (b"n+1\x00", b"ni1\x00"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
        if magic == b"ni1\x00":
            raise ValueError(f"{path}: two-file (.hdr/.img) NIfTI is "
                             "not supported")

        dim = np.frombuffer(hdr, endian + "i2", 8, offset=40)
        ndim = int(dim[0])
        if not 1 <= ndim <= 7:
            raise ValueError(f"{path}: bad ndim {ndim}")
        shape = tuple(int(d) for d in dim[1:1 + ndim])
        datatype = int(np.frombuffer(hdr, endian + "i2", 1, offset=70)[0])
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype "
                             f"{datatype}")
        dt = np.dtype(endian + _DTYPES[datatype])
        vox_offset = int(np.frombuffer(hdr, endian + "f4", 1,
                                       offset=108)[0])
        scl_slope = float(np.frombuffer(hdr, endian + "f4", 1,
                                        offset=112)[0])
        scl_inter = float(np.frombuffer(hdr, endian + "f4", 1,
                                        offset=116)[0])

        _read_exact(f, max(vox_offset, 348) - 348)  # header extensions
        count = int(np.prod(shape))
        data = np.frombuffer(_read_exact(f, count * dt.itemsize), dt,
                             count)

    arr = data.reshape(shape, order="F").astype(np.float64)
    # nibabel applies scaling when slope is finite and non-zero;
    # slope 0 / nan means "no scaling stored"
    if np.isfinite(scl_slope) and scl_slope != 0.0 \
            and (scl_slope, scl_inter) != (1.0, 0.0):
        inter = scl_inter if np.isfinite(scl_inter) else 0.0
        arr = arr * scl_slope + inter
    return arr
