"""Dependency-free TensorBoard event-file writer (the port's own copy of
``adlm_tpu.utils.tensorboard``, which is pure Python).

The reference wires a TensorBoard logger for every run (reference
segmentation/train.py:97-131) and logs scalars from the training module
(reference segmentation/module.py:246-256).  This writes the same
scalar streams as standard ``events.out.tfevents.*`` files readable by
TensorBoard, without depending on tensorflow/tensorboardX: the Event
protobuf wire format and the TFRecord framing (length + masked-CRC32C)
are small enough to encode by hand.

Format notes:

* TFRecord record = u64 length | u32 maskedcrc(length) | payload |
  u32 maskedcrc(payload); masked crc = rotr15(crc32c(x)) + 0xa282ead8.
* Event proto: 1=double wall_time, 2=int64 step, 3=string file_version,
  5=Summary; Summary: repeated 1=Value; Value: 1=string tag,
  2=float simple_value.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict

_CRC_TABLE = []


def _crc32c_table():
    # Castagnoli polynomial (reflected)
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if not _CRC_TABLE:
        _CRC_TABLE = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _bytes_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _scalar_value(tag: str, value: float) -> bytes:
    v = (_bytes_field(1, tag.encode("utf-8"))
         + _field(2, 5) + struct.pack("<f", float(value)))
    return _bytes_field(1, v)  # Summary.value entry


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    return (_field(1, 1) + struct.pack("<d", wall_time)
            + _field(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
            + body)


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class TBEventWriter:
    """Minimal scalar-only TensorBoard writer.

    Usage::

        w = TBEventWriter(logdir)
        w.add_scalars(step, {"train/loss": 0.3, "train/lr": 1e-3})
        w.close()
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        # version header event (what TB expects first)
        self._f.write(_record(_event(
            time.time(), 0, _bytes_field(3, b"brain.Event:2"))))
        self._f.flush()

    def add_scalar(self, step: int, tag: str, value: float) -> None:
        self.add_scalars(step, {tag: value})

    def add_scalars(self, step: int, values: Dict[str, float]) -> None:
        summary = b"".join(_scalar_value(t, v) for t, v in values.items())
        self._f.write(_record(_event(time.time(), step,
                                     _bytes_field(5, summary))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_scalars(path: str) -> Dict[str, list]:
    """Tiny reader for tests: parse an events file written by
    :class:`TBEventWriter` back into {tag: [(step, value), ...]}.
    Validates the TFRecord CRCs (so a TB-compatibility bug fails loudly).
    """
    out: Dict[str, list] = {}
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        assert hcrc == _masked_crc(data[pos:pos + 8]), "header crc"
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        assert pcrc == _masked_crc(payload), "payload crc"
        pos += 12 + length + 4
        _parse_event(payload, out)
    return out


def _read_varint(buf: bytes, pos: int):
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _parse_event(buf: bytes, out: Dict[str, list]) -> None:
    pos = 0
    step = 0
    summary = None
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            if num == 2:
                step = val
        elif wire == 1:
            pos += 8
        elif wire == 5:
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            if num == 5:
                summary = buf[pos:pos + ln]
            pos += ln
    if summary is None:
        return
    pos = 0
    while pos < len(summary):
        key, pos = _read_varint(summary, pos)
        ln, pos = _read_varint(summary, pos)
        value = summary[pos:pos + ln]
        pos += ln
        vp = 0
        tag, sv = None, None
        while vp < len(value):
            k, vp = _read_varint(value, vp)
            num, wire = k >> 3, k & 7
            if wire == 2:
                ln2, vp = _read_varint(value, vp)
                if num == 1:
                    tag = value[vp:vp + ln2].decode("utf-8")
                vp += ln2
            elif wire == 5:
                if num == 2:
                    (sv,) = struct.unpack_from("<f", value, vp)
                vp += 4
            elif wire == 1:
                vp += 8
            elif wire == 0:
                _, vp = _read_varint(value, vp)
        if tag is not None and sv is not None:
            out.setdefault(tag, []).append((step, sv))
