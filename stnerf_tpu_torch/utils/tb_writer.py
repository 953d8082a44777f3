"""TensorBoard event-file writer on the standard library alone — the
port's copy of ``stnerf_tpu/utils/tb_writer.py``.

The reference logs training scalars and validation image panels through
``torch.utils.tensorboard.SummaryWriter`` (ref: engine/layered_trainer.py:
295-309, engine/render.py:60-74), which needs the ``tensorboard`` package.
This module writes the on-disk format directly — it is small and stable:

* a ``tfevents`` file is a sequence of TFRecords (length + masked CRC32C of
  the length + payload + masked CRC32C of the payload),
* each payload is a serialized ``tensorflow.Event`` proto; scalars are
  ``Summary.Value{tag, simple_value}`` and images are
  ``Summary.Value{tag, image: Summary.Image{h, w, colorspace, png bytes}}``.

Only the three proto messages and two field types TensorBoard actually
reads are encoded (hand-rolled wire format; no protobuf runtime needed).
PNG encoding is stdlib zlib. API mirrors the SummaryWriter subset the
engine uses: ``add_scalar``, ``add_image`` (CHW, float [0,1] or uint8),
``flush``, ``close``. :func:`read_events` reads such a file back.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib

__all__ = ["EventWriter", "read_events"]


# ---------------------------------------------------------------- CRC32C --
def _make_crc32c_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return tuple(table)


_CRC_TABLE = _make_crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- proto wire --
def _varint(n: int) -> bytes:
    # negative ints would shift-right forever (protobuf encodes them as
    # 10-byte two's complement; no caller needs that — fail loudly instead)
    if n < 0:
        raise ValueError(f"varint field must be non-negative, got {n}")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


# --------------------------------------------------------------- PNG ------
def _encode_png(img) -> tuple[bytes, int, int, int]:
    """uint8 HWC (C in {1, 3, 4}) -> (png bytes, height, width, colorspace)."""
    import numpy as np

    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    return png, h, w, c


# --------------------------------------------------------------- writer ---
class EventWriter:
    """Drop-in for the SummaryWriter subset the engine uses."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s.%d" % (
            int(time.time()), socket.gethostname(), os.getpid())
        self._path = os.path.join(log_dir, fname)
        self._f = open(self._path, "wb")
        # Event{wall_time=1: double, file_version=3: string}
        self._write_event(_f_double(1, time.time())
                          + _f_bytes(3, b"brain.Event:2"))
        self.flush()

    # -- framing
    def _write_event(self, event_payload: bytes) -> None:
        header = struct.pack("<Q", len(event_payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + event_payload
                      + struct.pack("<I", _masked_crc(event_payload)))

    def _emit(self, step: int, value_payload: bytes) -> None:
        # Event{wall_time=1, step=2, summary=5: Summary{value=1}}
        summary = _f_bytes(1, value_payload)
        self._write_event(_f_double(1, time.time())
                          + _f_varint(2, int(step)) + _f_bytes(5, summary))

    # -- public API (SummaryWriter subset)
    def add_scalar(self, tag: str, value: float, global_step: int = 0) -> None:
        # Summary.Value{tag=1: string, simple_value=2: float}
        self._emit(global_step,
                   _f_bytes(1, tag.encode()) + _f_float(2, float(value)))

    def add_image(self, tag: str, img, global_step: int = 0) -> None:
        """``img`` is CHW (torch SummaryWriter's default dataformat), float
        in [0, 1] or uint8, C in {1, 3, 4}."""
        import numpy as np

        img = np.asarray(img)
        if img.ndim == 2:
            img = img[None]
        img = np.moveaxis(img, 0, -1)  # CHW -> HWC
        if img.dtype != np.uint8:
            img = (np.clip(np.nan_to_num(np.asarray(img, np.float32)), 0, 1)
                   * 255.0 + 0.5).astype(np.uint8)
        png, h, w, c = _encode_png(img)
        # Summary.Image{height=1, width=2, colorspace=3, encoded=4}
        image_msg = (_f_varint(1, h) + _f_varint(2, w) + _f_varint(3, c)
                     + _f_bytes(4, png))
        # Summary.Value{tag=1, image=4: Summary.Image}
        self._emit(global_step, _f_bytes(1, tag.encode())
                   + _f_bytes(4, image_msg))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------- reader ---
def _fields(buf: bytes) -> list:
    """Proto wire payload -> [(field, value)]: varints as ints, 64- and
    32-bit fields as double / float, length-delimited fields as bytes."""
    out, i = [], 0

    def varint():
        nonlocal i
        v = shift = 0
        while True:
            b = buf[i]
            i += 1
            v |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return v

    while i < len(buf):
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            v = varint()
        elif wire == 1:
            v, i = struct.unpack("<d", buf[i:i + 8])[0], i + 8
        elif wire == 5:
            v, i = struct.unpack("<f", buf[i:i + 4])[0], i + 4
        elif wire == 2:
            n = varint()
            v, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported proto wire type {wire}")
        out.append((field, v))
    return out


def read_events(path: str) -> list:
    """The summaries of an event file, CRCs checked -> [(step, tag, value)]:
    a scalar's float, an image's (height, width, channels)."""
    records = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        payload = data[i + 12:i + 12 + n]
        if (struct.unpack("<I", data[i + 8:i + 12])[0] != _masked_crc(header)
                or struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0]
                != _masked_crc(payload)):
            raise ValueError(f"{path}: a record's CRC does not match")
        i += 16 + n
        event = dict(_fields(payload))
        if 5 not in event:
            continue
        for field, value in _fields(event[5]):
            entry = dict(_fields(value))
            if 2 in entry:
                v = entry[2]
            else:
                image = dict(_fields(entry[4]))
                v = (image[1], image[2], image[3])
            records.append((event.get(2, 0), entry[1].decode(), v))
    return records
