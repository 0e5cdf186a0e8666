"""A PNG codec on the standard library (zlib + struct) and numpy.

The image I/O's last codec, for PNG where neither the native codec
(``runtime/native.py``) nor OpenCV serves (``io/images.py`` takes them
first; ``chip_smoke.py`` prints which codec the card's machine uses).  It
handles what the pipeline writes and most of what it reads: 8-bit
grayscale, RGB and RGBA, non-interlaced.  Arrays use OpenCV's
conventions: HxW for gray, HxWx3 BGR, HxWx4 BGRA, uint8.

Encoding applies the Up filter to every row and deflates with zlib's
Z_RLE strategy: the JAX package's measured-fast recipe for large SR
outputs.  Decoding undoes all five filter types; None, Sub and Up are
vectorized, Average and Paeth run per pixel.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode(img: np.ndarray) -> bytes:
    """uint8 HxW / HxWx3 (BGR) / HxWx4 (BGRA) -> PNG bytes."""
    if img.dtype != np.uint8:
        raise ValueError(f"the stdlib PNG codec writes 8-bit images, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        ctype, rgb = 0, img[:, :, None]
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        ctype = 2 if img.shape[2] == 3 else 6
        order = [2, 1, 0] if img.shape[2] == 3 else [2, 1, 0, 3]
        rgb = img[:, :, order]
    else:
        raise ValueError(f"cannot write an image of shape {img.shape} as PNG")
    h, w, c = rgb.shape
    rows = rgb.reshape(h, w * c)
    up = rows.copy()
    up[1:] -= rows[:-1]  # uint8 arithmetic wraps mod 256, as the filter needs
    raw = np.empty((h, w * c + 1), np.uint8)
    raw[:, 0] = 2        # filter type Up on every row (row 0: Up == None)
    raw[:, 1:] = up
    comp = zlib.compressobj(6, zlib.DEFLATED, zlib.MAX_WBITS, 8, zlib.Z_RLE)
    idat = comp.compress(raw.tobytes()) + comp.flush()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return _SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat) + _chunk(b"IEND", b"")


def _paeth_avg_row(ftype: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = line.astype(np.int32)
    up = prev.astype(np.int32)
    for i in range(out.shape[0]):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return out.astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 HxW / HxWx3 (BGR) / HxWx4 (BGRA)."""
    if not data.startswith(_SIG):
        raise ValueError("not a PNG file")
    pos, idat, hdr = len(_SIG), [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        kind = data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"the stdlib PNG codec reads 8-bit gray/RGB/RGBA non-interlaced "
            f"images; got depth {depth}, colour type {ctype}, interlace {interlace}")
    c = _CHANNELS[ctype]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(raw[y, 0]), raw[y, 1:]
        if ftype == 0:
            row = line.copy()
        elif ftype == 1:  # Sub: running sum per channel, mod 256
            row = np.cumsum(line.reshape(w, c), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:
            row = line + prev
        elif ftype in (3, 4):
            row = _paeth_avg_row(ftype, line, prev, c)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = row
        prev = row
    img = out.reshape(h, w, c)
    if c == 1:
        return img[:, :, 0]
    return img[:, :, [2, 1, 0]] if c == 3 else img[:, :, [2, 1, 0, 3]]


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def write(path: str, img: np.ndarray) -> None:
    data = encode(img)
    with open(path, "wb") as f:
        f.write(data)
