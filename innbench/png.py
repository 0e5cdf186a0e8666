"""The benchmark's own PNG codec, on zlib and NumPy alone.

It writes the directory cells' inputs and reads back the PNGs the program
wrote, so that neither the inputs nor the check of the outputs goes through
the program's codec.  It handles 8-bit RGB without interlacing, which is
what both sides write; rows may use any of the five filters (None, Sub and
Up are undone for many rows at once, Average and Paeth row by row).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode(rgb: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 RGB array as PNG bytes: the Up filter on every
    row but the first, deflated at level 1 (fast: inputs are made anew in
    every run)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode takes (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    flat = rgb.reshape(h, w * 3)
    rows = np.empty((h, w * 3 + 1), np.uint8)
    rows[:, 0] = 2
    rows[0, 0] = 0
    rows[0, 1:] = flat[0]
    rows[1:, 1:] = flat[1:] - flat[:-1]  # uint8 arithmetic wraps, as the filter does
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def write(path: str, rgb: np.ndarray) -> int:
    """Write ``rgb`` as a PNG file; returns the bytes written."""
    data = encode(rgb)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def size(path: str):
    """(height, width) from a PNG's header."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    return struct.unpack(">II", head[16:24])[::-1]


def _unfilter_row(kind: int, row: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4), one row: each byte depends on the one
    ``bpp`` bytes before it."""
    out = row.astype(np.int32)
    up = prev.astype(np.int32)
    for i in range(out.size):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 3:
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 255
        else:
            ul = up[i - bpp] if i >= bpp else 0
            p = left + up[i] - ul
            pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
            pred = left if pa <= pb and pa <= pc else (up[i] if pb <= pc else ul)
            out[i] = (out[i] + pred) & 255
    return out.astype(np.uint8)


def read(path: str) -> np.ndarray:
    """An 8-bit RGB PNG file as an (H, W, 3) uint8 RGB array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: no IHDR")
    w, h, depth, color, _comp, _filt, interlace = hdr
    if depth != 8 or color != 2 or interlace != 0:
        raise ValueError(f"{path}: only 8-bit RGB without interlacing is read "
                         f"(depth {depth}, colour type {color}, interlace {interlace})")
    stride = w * 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for {h}x{w}")
    rows = raw.reshape(h, stride + 1)
    kinds, filt = rows[:, 0], rows[:, 1:]
    out = np.empty((h, stride), np.uint8)
    zero = np.zeros(stride, np.uint8)
    y = 0
    while y < h:
        k = int(kinds[y])
        end = y + 1
        while end < h and kinds[end] == k and k in (0, 1, 2):
            end += 1
        block = filt[y:end]
        if k == 0:
            out[y:end] = block
        elif k == 1:
            out[y:end] = np.cumsum(block.reshape(end - y, w, 3), axis=1,
                                   dtype=np.uint8).reshape(end - y, stride)
        elif k == 2:
            prev = out[y - 1] if y else zero
            out[y:end] = np.cumsum(np.concatenate([prev[None], block]), axis=0,
                                   dtype=np.uint8)[1:]
        elif k in (3, 4):
            out[y] = _unfilter_row(k, filt[y], out[y - 1] if y else zero, 3)
        else:
            raise ValueError(f"{path}: filter {k} on row {y}")
        y = end
    return out.reshape(h, w, 3)
