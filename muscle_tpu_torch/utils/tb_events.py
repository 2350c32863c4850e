"""TensorBoard event-file writer, dependency-free (a copy of
``muscle_tpu/utils/tb_events.py``).

Writes ``events.out.tfevents.*`` files that stock TensorBoard reads,
without tensorflow or tensorboardX, the reference's scalar and image
streams:

* records are TFRecord-framed (length, masked crc32c(length), payload,
  masked crc32c(payload)) with the Castagnoli CRC table computed locally;
* the Event/Summary protos are hand-encoded: varint-tagged fields, and the
  five used (wall_time, step, file_version, simple_value, image) are
  stable public protocol.

API: the tensorboardX subset the reference uses, ``add_scalar``,
``add_image`` (HWC uint8), ``flush``/``close``.  PIL is imported inside
``add_image``.
"""

from __future__ import annotations

import io
import os
import socket
import struct
import threading
import time

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven; masked per the TFRecord spec
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reflected Castagnoli
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tbl = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal proto encoding (wire types 0 = varint, 1 = fixed64, 2 = bytes,
# 5 = fixed32)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _f_str(field: int, v: str) -> bytes:
    return _f_bytes(field, v.encode("utf-8"))


# Event proto (tensorboard/compat/proto/event.proto):
#   1 wall_time (double), 2 step (int64), 3 file_version (string),
#   5 summary (Summary)
# Summary: 1 repeated Value; Value: 1 tag (string) [older: also node_name 7],
#   2 simple_value (float), 4 image (Summary.Image)
# Summary.Image: 1 height, 2 width, 3 colorspace, 4 encoded_image_string


def _event(step: int | None, summary: bytes | None, file_version: str | None = None) -> bytes:
    out = _f_double(1, time.time())
    if step is not None:
        out += _f_int(2, step)
    if file_version is not None:
        out += _f_str(3, file_version)
    if summary is not None:
        out += _f_bytes(5, summary)
    return out


class EventWriter:
    """Append-only writer for one events file (thread-safe adds)."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = "events.out.tfevents.%010d.%s%s" % (
            int(time.time()),
            socket.gethostname(),
            filename_suffix,
        )
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._lock = threading.Lock()
        self._write(_event(None, None, file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        buf = (
            header
            + struct.pack("<I", _masked_crc(header))
            + record
            + struct.pack("<I", _masked_crc(record))
        )
        with self._lock:
            self._f.write(buf)

    # -- tensorboardX-compatible subset ------------------------------------

    def add_scalar(self, tag: str, value: float, global_step: int = 0) -> None:
        val = _f_str(1, tag) + _f_float(2, float(value))
        self._write(_event(int(global_step), _f_bytes(1, val)))

    def add_image(self, tag: str, img_hwc, global_step: int = 0) -> None:
        """img_hwc: (H, W, 3) uint8 (or float in [0, 1]) numpy array.
        Encoded as PNG via PIL (the only image codec on the box)."""
        import numpy as np
        from PIL import Image

        arr = np.asarray(img_hwc)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if arr.ndim == 2:
            arr = np.stack([arr] * 3, axis=-1)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        image = (
            _f_int(1, arr.shape[0])
            + _f_int(2, arr.shape[1])
            + _f_int(3, 3)
            + _f_bytes(4, buf.getvalue())
        )
        val = _f_str(1, tag) + _f_bytes(4, image)
        self._write(_event(int(global_step), _f_bytes(1, val)))

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.flush()
            self._f.close()
