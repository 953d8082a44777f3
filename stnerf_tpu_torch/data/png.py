"""A small PNG codec on ``zlib``, ``struct`` and NumPy.

The JAX package opens and saves images with PIL (``data/scene.py:26-35``,
``:185-188``; ``data/synthetic.py:250``); the port keeps to the standard
library and NumPy instead. The reader takes what capture tools and PIL
write for RGB frames: 8-bit greyscale, grey with alpha, RGB and RGBA,
non-interlaced, with any of the five row filters (PIL chooses filters row
by row). The writer writes 8-bit greyscale, RGB or RGBA with filter 0.
Anything else — another bit depth, a palette, interlacing, a JPEG — raises
and names the file.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunks(path: str, data: bytes):
    """(type, payload) of every chunk, CRCs checked."""
    if not data.startswith(_SIGNATURE):
        kind = "a JPEG" if data[:3] == b"\xff\xd8\xff" else "not a PNG"
        raise ValueError(f"{path}: {kind} file; only PNG images are read")
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in the {ctype.decode('latin-1')} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _header(path: str, body: bytes) -> tuple[int, int, int]:
    """IHDR -> (width, height, channels); refuses what the reader lacks."""
    width, height, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", body)
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"{path}: bit depth {depth}, colour type {ctype}; the reader "
                         "takes 8-bit grey, grey+alpha, RGB and RGBA")
    if comp != 0 or filt != 0 or interlace != 0:
        raise ValueError(f"{path}: interlaced or non-standard PNG (compression {comp}, "
                         f"filter {filt}, interlace {interlace}) is not read")
    return width, height, _CHANNELS[ctype]


def png_size(path: str) -> tuple[int, int]:
    """(width, height) from the header alone, as ``PIL.Image.size``."""
    with open(path, "rb") as f:
        data = f.read(len(_SIGNATURE) + 25)   # the signature and IHDR
    ctype, body = next(_chunks(path, data))
    if ctype != b"IHDR":
        raise ValueError(f"{path}: no IHDR chunk first")
    return _header(path, body)[:2]


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(path: str, raw: bytes, width: int, height: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters -> (height, width * bpp) uint8."""
    stride = width * bpp
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{path}: image data of {len(raw)} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:    # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(width, bpp), 0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:    # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: each byte needs its left neighbour
            cur = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: unknown row filter {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """-> uint8 (H, W) for greyscale, else (H, W, C) with C = 2, 3 or 4, as
    ``np.asarray(PIL.Image.open(path))`` gives."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for ctype, body in _chunks(path, data):
        if ctype == b"IHDR":
            header = _header(path, body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"PLTE":
            raise ValueError(f"{path}: palette PNG is not read")
    if header is None or not idat:
        raise ValueError(f"{path}: missing IHDR or IDAT chunk")
    width, height, channels = header
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from e
    img = _unfilter(path, raw, width, height, channels).reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """uint8 (H, W) greyscale, or (H, W, C) with C = 1-4, every row with
    filter 0."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise TypeError(f"{path}: write_png takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"{path}: cannot write an image of shape {arr.shape}")
    h, w, c = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], 1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))
