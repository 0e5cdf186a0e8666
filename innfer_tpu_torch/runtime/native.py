"""ctypes bindings of the port's native host runtime: a PNG/JPEG codec
(``src/imgcodec.cpp``) and a prefetch loader (``src/loader.cpp``), the
counterpart of the JAX package's ``runtime/native.py`` with its public
names.

The library is built with g++ at first use, never at import, into
``innfer_tpu_torch/build/`` (listed in .gitignore), named by a hash of the
sources and the flags and written through a temporary file and a rename
(``ops/_build.compile_into``): an edited source builds a library of its
own, and a build cut short leaves nothing that could be loaded.  PNG needs
zlib alone (``zlib.h``, ``-lz``); JPEG is compiled in, with ``-ljpeg``,
only where g++ finds ``jpeglib.h``, and the flags are part of the hash.
Where it cannot build (no g++, no zlib headers), ``decode`` returns None
and ``encode_png`` False, and the callers take OpenCV: the JAX package's
semantics for its host codec.  ``available`` and ``unavailable_reason``
say which codec ran, and why; ``version`` names zlib and the formats.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from innfer_tpu_torch.ops import _build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
SOURCES = ("imgcodec.cpp", "loader.cpp")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
REQUIRED = ("zlib.h",)          # the build needs these; PNG is done on zlib
HEADERS = REQUIRED + ("jpeglib.h",)
JPEG_FLAGS = ("-DINNFER_WITH_JPEG", "-ljpeg")  # only where jpeglib.h is found

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None   # why the library is unavailable, once known

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_ip = ctypes.POINTER(ctypes.c_int)


def build_flags() -> Tuple[str, ...]:
    """The compile and link flags of this host: zlib always, JPEG where g++
    finds ``jpeglib.h``."""
    jpeg = JPEG_FLAGS if "jpeglib.h" not in missing_headers() else ()
    return (*CXX_FLAGS, *jpeg, "-lz")


def source_digest(flags: Optional[Sequence[str]] = None) -> str:
    """Hash of the sources and the flags: the library's name."""
    flags = build_flags() if flags is None else flags
    h = hashlib.sha256(" ".join((CXX, *flags)).encode())
    for name in SOURCES:
        with open(os.path.join(SRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path(flags: Optional[Sequence[str]] = None) -> str:
    return os.path.join(_build.BUILD_DIR, f"libinnfer_runtime_{source_digest(flags)}.so")


def missing_headers() -> List[str]:
    """The headers of ``HEADERS`` that g++ cannot find on its include path
    (all of them where there is no g++)."""
    if shutil.which(CXX) is None:
        return list(HEADERS)
    return [hdr for hdr in HEADERS
            if subprocess.run([CXX, "-x", "c++", "-E", "-", "-o", os.devnull],
                              input=f"#include <{hdr}>\n", capture_output=True,
                              text=True).returncode != 0]


def _declare(lib: ctypes.CDLL) -> None:
    lib.decode_png.argtypes = [ctypes.c_char_p, ctypes.POINTER(_u8p), _ip, _ip, _ip]
    lib.decode_png.restype = ctypes.c_int
    lib.decode_jpeg.argtypes = lib.decode_png.argtypes
    lib.decode_jpeg.restype = ctypes.c_int
    lib.decode_png16.argtypes = [ctypes.c_char_p, ctypes.POINTER(_u16p), _ip, _ip, _ip]
    lib.decode_png16.restype = ctypes.c_int
    lib.encode_png.argtypes = [ctypes.c_char_p, _u8p] + [ctypes.c_int] * 4
    lib.encode_png.restype = ctypes.c_int
    lib.free_image.argtypes = [_u8p]
    lib.free_image.restype = None
    lib.loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p)] + [ctypes.c_int] * 3
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(_u8p), _ip, _ip, _ip, _ip]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.loader_destroy.restype = None
    lib.codec_has_jpeg.argtypes = []
    lib.codec_has_jpeg.restype = ctypes.c_int
    lib.codec_zlib_version.argtypes = []
    lib.codec_zlib_version.restype = ctypes.c_char_p


def _load() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    """Build (where needed) and load the library: (lib, None) or (None, why)."""
    if shutil.which(CXX) is None:
        return None, f"{CXX} is not on PATH"
    flags = build_flags()
    try:
        out = library_path(flags)
    except OSError as e:
        return None, f"cannot read the sources: {e}"
    if not os.path.isfile(out):
        proc = _build.compile_into(
            [CXX, *(os.path.join(SRC, s) for s in SOURCES), *flags], out)
        if proc.returncode != 0:
            missing = [h for h in missing_headers() if h in REQUIRED]
            why = f"missing {', '.join(missing)}; " if missing else ""
            return None, f"{why}{CXX} failed: {proc.stderr.strip()[-800:]}"
    try:
        lib = ctypes.CDLL(out)
    except OSError as e:
        return None, f"cannot load {out}: {e}"
    _declare(lib)
    return lib, None


def get_lib() -> Optional[ctypes.CDLL]:
    """The native runtime, built on first use; None where it cannot be."""
    global _lib, _reason
    with _lock:
        if _lib is None and _reason is None:
            _lib, _reason = _load()
        return _lib


def available() -> bool:
    return get_lib() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library is unavailable (the tail of the compiler's errors,
    the missing headers, or the loader's error); None when it is loaded."""
    return None if get_lib() is not None else _reason


def has_jpeg() -> bool:
    """Whether the loaded library was built with libjpeg."""
    return bool(get_lib().codec_has_jpeg())


def version() -> str:
    """The zlib the loaded library runs on and the formats it reads, as
    ``zlib 1.3; PNG, JPEG`` (``zlib 1.3; PNG`` without libjpeg)."""
    z = get_lib().codec_zlib_version().decode()
    return f"zlib {z}; PNG" + (", JPEG" if has_jpeg() else "")


def _take(lib, data_p, h: int, w: int, c: int, ctype) -> np.ndarray:
    """Copy a C buffer of h x w x c ``ctype`` values out and free it."""
    arr = np.ctypeslib.as_array(ctypes.cast(data_p, ctypes.POINTER(ctype)),
                                shape=(h * w * c,)).reshape(h, w, c).copy()
    lib.free_image(ctypes.cast(data_p, _u8p))
    return arr[:, :, 0] if c == 1 else arr


def decode(path: str) -> Optional[np.ndarray]:
    """Decode a PNG or JPEG to HWC BGR(A) uint8, or uint16 for a 16-bit PNG
    (HW for gray), as ``cv2.imread(path, IMREAD_UNCHANGED)``; None for
    another format, a file it cannot decode or no library."""
    lib = get_lib()
    low = path.lower()
    if lib is None or not low.endswith((".png", ".jpg", ".jpeg")):
        return None
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    dims = (ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    data8 = _u8p()
    fpath = os.fsencode(path)
    if low.endswith(".png"):
        rc = lib.decode_png(fpath, ctypes.byref(data8), *dims)
        if rc == -3:  # IMG_ERR_UNSUPPORTED: a 16-bit PNG
            data16 = _u16p()
            if lib.decode_png16(fpath, ctypes.byref(data16), *dims) != 0:
                return None
            return _take(lib, data16, h.value, w.value, c.value, ctypes.c_uint16)
    else:
        rc = lib.decode_jpeg(fpath, ctypes.byref(data8), *dims)
    if rc != 0:
        return None
    return _take(lib, data8, h.value, w.value, c.value, ctypes.c_uint8)


def encode_png(path: str, img: np.ndarray, compression_level: int = 1) -> bool:
    """Write an HWC BGR(A) or HW gray uint8 array as PNG (level <= 1: the UP
    filter and Z_RLE, the JAX package's bytes); False where the library
    is unavailable or the array is not such an image."""
    lib = get_lib()
    if lib is None or img.dtype != np.uint8 or img.ndim not in (2, 3):
        return False
    img = np.ascontiguousarray(img.reshape(img.shape[:2] + (-1,)))
    h, w, c = img.shape
    return lib.encode_png(os.fsencode(path), img.ctypes.data_as(_u8p), h, w, c,
                          compression_level) == 0


def _jpeg(path: str) -> bool:
    return path.lower().endswith((".jpg", ".jpeg"))


class PrefetchLoader:
    """Iterate ``(index, path, image)`` over ``paths`` in their order,
    decoding up to ``capacity`` images ahead of the consumer on ``threads``
    threads: the native library's, or a Python pool where the library is
    unavailable or was built without libjpeg and the list holds a JPEG.
    On the library's threads a file it cannot read (TIFF, WEBP, BMP, DNG,
    a corrupt file) decodes through ``fallback`` on the consumer's thread,
    as in the JAX package; the pool reads each file natively where it can
    and through ``fallback`` where not.  Without a fallback such an image
    is None.  ``close`` stops the threads and frees what they decoded
    ahead."""

    def __init__(self, paths: Sequence[str], capacity: int = 4, threads: int = 2,
                 fallback: Optional[Callable[[str], Optional[np.ndarray]]] = None):
        self.paths = list(paths)
        self.fallback = fallback
        self.capacity = capacity
        self._lib = get_lib()
        self._handle = None
        self._pool = None
        self._ahead: deque = deque()
        # the library's threads decode a JPEG only where libjpeg is built
        # in: a JPEG on them would otherwise decode on the consumer's thread
        reads_all = self._lib is not None and (
            self._lib.codec_has_jpeg() or not any(map(_jpeg, self.paths)))
        if reads_all and self.paths:
            self._names = (ctypes.c_char_p * len(self.paths))(
                *[os.fsencode(p) for p in self.paths])  # alive while the threads read it
            self._handle = self._lib.loader_create(self._names, len(self.paths),
                                                   capacity, threads)
        elif fallback is not None and self.paths:
            self._pool = ThreadPoolExecutor(threads, thread_name_prefix="innfer-decode")

    def _read(self, path: str) -> Optional[np.ndarray]:
        return self.fallback(path) if self.fallback is not None else None

    def _decode(self, path: str) -> Optional[np.ndarray]:
        """Natively where the library reads the file, else ``fallback``."""
        img = decode(path) if self._lib is not None else None
        return img if img is not None else self._read(path)

    def __iter__(self) -> Iterator[Tuple[int, str, Optional[np.ndarray]]]:
        if self._handle is not None:
            yield from self._native()
        elif self._pool is not None:
            yield from self._pooled()
        else:
            for i, p in enumerate(self.paths):
                yield i, p, self._decode(p)

    def _native(self):
        lib = self._lib
        for _ in self.paths:
            data_p = _u8p()
            h, w, c, idx = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            # blocks without the GIL until the next image in order is decoded
            rc = lib.loader_next(self._handle, ctypes.byref(data_p), ctypes.byref(h),
                                 ctypes.byref(w), ctypes.byref(c), ctypes.byref(idx))
            if rc == 1:
                return
            path = self.paths[idx.value]
            img = (_take(lib, data_p, h.value, w.value, c.value, ctypes.c_uint8)
                   if rc == 0 else self._read(path))
            yield idx.value, path, img

    def _pooled(self):
        n = len(self.paths)
        self._ahead.extend(self._pool.submit(self._decode, p)
                           for p in self.paths[:self.capacity])
        for i, p in enumerate(self.paths):
            img = self._ahead.popleft().result()
            if i + self.capacity < n:
                self._ahead.append(self._pool.submit(self._decode,
                                                     self.paths[i + self.capacity]))
            yield i, p, img

    def close(self) -> None:
        if self._handle is not None:
            self._lib.loader_destroy(self._handle)
            self._handle = None
        if self._pool is not None:
            for f in self._ahead:
                f.cancel()
            self._pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
