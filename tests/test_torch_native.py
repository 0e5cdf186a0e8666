"""The port's native host runtime (innfer_tpu_torch/runtime/) against OpenCV
and the JAX package's runtime, on the CPU.

Each case of tests/test_native_runtime.py has its counterpart here, and the
parity cases hold the port's ``io.images`` to the JAX package's: the same
pixels read, byte-identical PNG files written (the same C sources, the same
UP filter and Z_RLE recipe).  The library builds with g++ and zlib at first use; the
cases that need it skip inside a fixture where g++ or a header is missing.

The port's PNG codec is written on zlib alone, and the JAX package's
libpng build is its yardstick: the files the port writes are compared
byte for byte with libpng's, and the files it reads (every colour type,
bit depth, row filter, tRNS and Adam7, made here by ``_png``) pixel for
pixel with libpng's arrays.
"""
import os
import shutil
import struct
import zlib

import cv2
import numpy as np
import pytest

from innfer_tpu.io import images as jio
from innfer_tpu.runtime import native as jnative
from innfer_tpu_torch.io import images as iio
from innfer_tpu_torch.ops import _build
from innfer_tpu_torch.runtime import native


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip(f"native runtime unavailable: {native.unavailable_reason()}")
    return lib


def test_png_roundtrip_matches_cv2(lib, tmp_path, rng):
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    p_cv, p_nat = str(tmp_path / "cv.png"), str(tmp_path / "nat.png")
    cv2.imwrite(p_cv, img)
    assert native.encode_png(p_nat, img)
    for p in (p_cv, p_nat):
        np.testing.assert_array_equal(native.decode(p), img)
    np.testing.assert_array_equal(cv2.imread(p_nat, cv2.IMREAD_UNCHANGED), img)


@pytest.mark.parametrize("shape", [(9, 11, 4), (9, 11)], ids=["rgba", "gray"])
def test_png_rgba_and_gray(lib, tmp_path, rng, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / "x.png")
    cv2.imwrite(p, img)
    np.testing.assert_array_equal(native.decode(p), img)


@pytest.mark.parametrize("shape", [(8, 8, 3), (7, 9)])
def test_16bit_png_native_decode(lib, tmp_path, rng, shape):
    img16 = rng.integers(0, 65536, shape, dtype=np.uint16)
    p = str(tmp_path / "deep.png")
    cv2.imwrite(p, img16)
    dec = native.decode(p)
    assert dec is not None and dec.dtype == np.uint16
    np.testing.assert_array_equal(dec, cv2.imread(p, cv2.IMREAD_UNCHANGED))


def test_palette_png_matches_cv2(lib, tmp_path, rng):
    from PIL import Image

    img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    p = str(tmp_path / "pal.png")
    Image.fromarray(img[:, :, ::-1]).convert("P", palette=Image.ADAPTIVE).save(p)
    np.testing.assert_array_equal(native.decode(p), cv2.imread(p, cv2.IMREAD_UNCHANGED))


def test_jpeg_decode_equals_jax_native(lib, tmp_path, rng):
    img = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    p = str(tmp_path / "img.jpg")
    cv2.imwrite(p, img, [cv2.IMWRITE_JPEG_QUALITY, 95])
    ours = native.decode(p)
    assert ours is not None and ours.shape == (32, 48, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, jnative.decode(p))
    # another libjpeg build's IDCT may differ from OpenCV's by a level or two
    theirs = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    assert np.mean(np.abs(ours.astype(int) - theirs.astype(int))) < 3.0


def test_corrupt_files_return_none(lib, tmp_path, rng):
    """A truncated PNG and a JPEG with a broken header decode to None (the
    longjmp handlers, which free the pixel buffers)."""
    img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    p_png, p_jpg = str(tmp_path / "t.png"), str(tmp_path / "t.jpg")
    cv2.imwrite(p_png, img)
    cv2.imwrite(p_jpg, img)
    data = open(p_png, "rb").read()
    open(p_png, "wb").write(data[: len(data) // 2])
    assert native.decode(p_png) is None
    # libjpeg fills a stream cut mid-scan with gray, as OpenCV does: the
    # error path needs a broken header
    data = open(p_jpg, "rb").read()
    open(p_jpg, "wb").write(data[:24])
    assert native.decode(p_jpg) is None
    assert native.decode(str(tmp_path / "missing.png")) is None


def _loader_files(tmp_path, rng):
    paths, imgs = [], []
    for i in range(6):
        img = rng.integers(0, 256, (10 + i, 12, 3), dtype=np.uint8)
        paths.append(str(tmp_path / f"im{i}.png"))
        imgs.append(img)
        cv2.imwrite(paths[-1], img)
    # files the native codec leaves to the fallback: 16-bit PNG, TIFF
    deep = rng.integers(0, 65536, (7, 7, 3), dtype=np.uint16)
    tiff = rng.integers(0, 256, (5, 9, 3), dtype=np.uint8)
    for k, (name, img) in enumerate((("deep.png", deep), ("flat.tif", tiff))):
        paths.insert(2 + 2 * k, str(tmp_path / name))
        imgs.insert(2 + 2 * k, img)
        cv2.imwrite(paths[2 + 2 * k], img)
    return paths, imgs


@pytest.mark.parametrize("threads", ["native", "python"])
def test_prefetch_loader_order_and_fallback(lib, tmp_path, rng, monkeypatch, threads):
    """In order, with the 16-bit PNG and the TIFF through the fallback, on
    the library's threads or (without the library) a Python pool."""
    if threads == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    paths, imgs = _loader_files(tmp_path, rng)
    fell_back = []

    def fallback(p):
        fell_back.append(os.path.basename(p))
        return cv2.imread(p, cv2.IMREAD_UNCHANGED)

    loader = native.PrefetchLoader(paths, capacity=3, threads=2, fallback=fallback)
    try:
        seen = []
        for idx, path, img in loader:
            assert path == paths[idx]
            seen.append(idx)
            np.testing.assert_array_equal(img, imgs[idx])
    finally:
        loader.close()
    assert seen == list(range(len(paths)))
    if threads == "native":
        assert fell_back == ["deep.png", "flat.tif"]
    else:
        assert sorted(fell_back) == sorted(os.path.basename(p) for p in paths)


@pytest.mark.parametrize("threads", ["native", "python"])
def test_prefetch_loader_keeps_order_with_more_threads_than_cores(lib, tmp_path, rng,
                                                                 monkeypatch, threads):
    """48 files on twice as many decode threads as cores, with a short
    switch interval: every image arrives once, in order, with its pixels."""
    import sys

    if threads == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    imgs = [rng.integers(0, 256, (4 + i % 7, 5 + i % 5, 3), dtype=np.uint8) for i in range(48)]
    paths = [str(tmp_path / f"s{i:02d}.png") for i in range(48)]
    for p, img in zip(paths, imgs):
        cv2.imwrite(p, img)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    loader = native.PrefetchLoader(paths, capacity=8, threads=2 * (os.cpu_count() or 4),
                                   fallback=lambda p: cv2.imread(p, cv2.IMREAD_UNCHANGED))
    try:
        got = [(idx, img) for idx, _, img in loader]
    finally:
        loader.close()
        sys.setswitchinterval(switch)
    assert [idx for idx, _ in got] == list(range(48))
    for idx, img in got:
        np.testing.assert_array_equal(img, imgs[idx])


def test_prefetch_loader_closes_before_the_end(lib, tmp_path, rng):
    paths, _ = _loader_files(tmp_path, rng)
    loader = native.PrefetchLoader(paths, capacity=2, threads=2)
    first = next(iter(loader))
    assert first[0] == 0 and first[2] is not None
    loader.close()  # frees the images decoded ahead; joins the threads
    loader.close()
    assert loader._handle is None


@pytest.fixture
def src_copy(tmp_path, monkeypatch):
    d = tmp_path / "src"
    shutil.copytree(native.SRC, d)
    monkeypatch.setattr(native, "SRC", str(d))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", None)
    return d


def test_edited_sources_build_a_library_of_their_own(lib, src_copy):
    """The library is named by a hash of its sources: a library built from
    other sources is never loaded for these, however new its file."""
    stale = native.library_path()
    assert native.library_path() == stale  # stable
    with open(src_copy / "loader.cpp", "a") as f:
        f.write("\n// edited\n")
    fresh = native.library_path()
    assert fresh != stale and os.path.dirname(fresh) == os.path.dirname(stale)
    assert native.get_lib() is not None and native.available()
    assert os.listdir(os.path.dirname(fresh)) == [os.path.basename(fresh)]
    assert native.unavailable_reason() is None


def test_corrupt_library_file_degrades_to_none(lib, src_copy):
    """A file under the library's name that does not load (written by
    something else than the build) gives None and the loader's error."""
    os.makedirs(_build.BUILD_DIR)
    with open(native.library_path(), "wb") as f:
        f.write(b"not an elf")
    assert native.get_lib() is None and not native.available()
    assert "cannot load" in native.unavailable_reason()
    assert native.decode(str(src_copy / "x.png")) is None


def test_failed_build_names_the_missing_header(lib, src_copy, monkeypatch):
    """zlib.h is the one header the build requires: where g++ lacks it the
    reason names it (a missing jpeglib.h only leaves JPEG out)."""
    monkeypatch.setattr(native, "missing_headers", lambda: ["zlib.h", "jpeglib.h"])
    text = (src_copy / "imgcodec.cpp").read_text()
    assert "#include <zlib.h>" in text
    (src_copy / "imgcodec.cpp").write_text(text.replace("#include <zlib.h>",
                                                        "#include <innfer_absent_zlib.h>"))
    assert native.get_lib() is None
    why = native.unavailable_reason()
    assert why.startswith("missing zlib.h;") and "No such file" in why
    assert "jpeglib.h" not in why.split(";")[0]
    assert not os.listdir(_build.BUILD_DIR)  # nothing left under any name
    assert not native.encode_png(str(src_copy / "x.png"), np.zeros((2, 2), np.uint8))


@pytest.mark.parametrize("shape", [(29, 41, 3), (29, 41, 4), (29, 41)],
                         ids=["bgr", "bgra", "gray"])
def test_save_img_writes_the_jax_packages_bytes(lib, tmp_path, shape):
    # a smooth picture with noise: the filter recipe changes the bytes
    yy, xx = np.indices(shape[:2])
    smooth = 128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    smooth = smooth[..., None] if len(shape) == 3 else smooth
    img = np.clip(smooth + np.random.default_rng(1).normal(0, 8, shape), 0, 255).astype(np.uint8)
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    iio.save_img(img, ours)
    jio.save_img(img, theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(iio.read_img(ours), img)


@pytest.mark.parametrize("scale", [0.5, 2, 1.5, 0.3, 3, 1 / 3])
@pytest.mark.parametrize("shape", [(7, 9, 3), (13, 17)])
def test_save_img_scale_equals_jax(lib, tmp_path, rng, scale, shape):
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    iio.save_img(img, ours, scale=scale)
    jio.save_img(img, theirs, scale=scale)
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def _write(kind, path, rng):
    if kind == "palette":
        from PIL import Image

        img = rng.integers(0, 256, (16, 12, 3), dtype=np.uint8)
        Image.fromarray(img).convert("P", palette=Image.ADAPTIVE).save(path)
        return
    shape, dtype = {"bgr8": ((13, 17, 3), np.uint8), "bgr16": ((13, 17, 3), np.uint16),
                    "gray": ((13, 17), np.uint8), "gray16": ((13, 17), np.uint16),
                    "bgra": ((13, 17, 4), np.uint8), "jpeg": ((24, 40, 3), np.uint8),
                    "tiff": ((9, 11, 3), np.uint8)}[kind]
    cv2.imwrite(path, rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype))


@pytest.mark.parametrize("kind,ext", [("bgr8", "png"), ("bgr16", "png"), ("gray", "png"),
                                      ("gray16", "png"), ("bgra", "png"),
                                      ("palette", "png"), ("jpeg", "jpg"), ("tiff", "tif")])
def test_read_img_equals_jax(lib, tmp_path, rng, kind, ext):
    path = str(tmp_path / f"x.{ext}")
    _write(kind, path, rng)
    ours, theirs = iio.read_img(path), jio.read_img(path)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(iio.read_img(path, use_native=False),
                                  jio.read_img(path, use_native=False))


def test_codec_name_and_the_no_codec_message(lib, tmp_path, monkeypatch):
    assert iio.codec_name() == f"native ({native.version()}) + opencv {cv2.__version__}"
    formats = "PNG, JPEG" if native.has_jpeg() else "PNG"
    assert native.version() == f"zlib {zlib.ZLIB_RUNTIME_VERSION}; {formats}"
    monkeypatch.setattr(iio, "cv2", None)
    path = str(tmp_path / "x.webp")
    with pytest.raises(ValueError, match="reads PNG and JPEG and writes 8-bit PNG"):
        iio.read_img(path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", "switched off by the test")
    with pytest.raises(ValueError, match=r"unavailable \(switched off by the test\).*PNG only"):
        iio.read_img(path)


# ---------------------------------------------------------------------------
# The PNG codec on zlib against libpng (the JAX package's library)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def libpng():
    jlib = jnative.get_lib()
    if jlib is None:
        pytest.skip("the JAX package's libpng codec does not build here")
    return jlib


def _smooth(shape, seed=1):
    """A smooth picture with noise: every row filter has something to win."""
    yy, xx = np.indices(shape[:2])
    smooth = 128 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    smooth = smooth[..., None] if len(shape) == 3 else smooth
    noise = np.random.default_rng(seed).normal(0, 8, shape)
    return np.clip(smooth + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("level", [1, 0, 2, 6, 9])
@pytest.mark.parametrize("shape", [(1, 1, 3), (1, 1), (1, 7, 4), (6, 1, 3), (5, 9, 3), (29, 41),
                                   (29, 41, 4), (31, 47, 3), (200, 99, 3), (3, 11000, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_encode_png_writes_libpngs_bytes(lib, libpng, tmp_path, shape, level):
    """Byte for byte what libpng writes under the JAX package's settings:
    one row or one column (libpng drops the filters that need the missing
    neighbour), odd widths, images small enough that libpng narrows the
    zlib window and rewrites the zlib header, rows over 32 KiB, and levels
    >= 2 (all five filters chosen per row, Z_FILTERED)."""
    img = _smooth(shape)
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert native.encode_png(ours, img, compression_level=level)
    assert jnative.encode_png(theirs, img, compression_level=level)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(native.decode(ours), img)


@pytest.mark.parametrize("level", [1, 2])
def test_encode_1080p_png_writes_libpngs_bytes(lib, libpng, tmp_path, level):
    """A 1080x1920 image: hundreds of 8 KiB IDAT chunks, the last one short."""
    img = _smooth((1080, 1920, 3), seed=2)
    ours, theirs = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    assert native.encode_png(ours, img, compression_level=level)
    assert jnative.encode_png(theirs, img, compression_level=level)
    data = open(ours, "rb").read()
    assert data == open(theirs, "rb").read()
    assert data.count(b"IDAT") > 100
    np.testing.assert_array_equal(native.decode(ours), img)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes, crc_xor: int = 0) -> bytes:
    crc = (zlib.crc32(kind + data) ^ crc_xor) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _filtered(rows, bpp, filters):
    """The rows (bytes) filtered, each behind its filter byte, cycling
    through ``filters``; the previous row of the first is zeros."""
    out, prev = bytearray(), bytes(len(rows[0]))
    for k, row in enumerate(rows):
        f = filters[k % len(filters)]
        line = bytearray(len(row))
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
            line[i] = (x - pred) & 0xFF
        out += bytes([f]) + line
        prev = row
    return bytes(out)


def _png(samples, color, depth, *, filters=(0,), interlace=False, plte=None, trns=None,
         idat_parts=2):
    """PNG bytes of ``samples`` (H x W x samples-per-pixel values at
    ``depth`` bits), written here independently of both codecs."""
    s = np.asarray(samples).reshape(samples.shape[:2] + (-1,))
    h, w, spp = s.shape
    bpp = max(1, depth * spp // 8)

    def pack(sub):
        rows = []
        for r in sub:
            flat = r.reshape(-1).astype(np.int64)
            if depth == 16:
                rows.append(flat.astype(">u2").tobytes())
            elif depth == 8:
                rows.append(flat.astype(np.uint8).tobytes())
            else:
                bits = (flat[:, None] >> np.arange(depth - 1, -1, -1)) & 1
                rows.append(np.packbits(bits.reshape(-1).astype(np.uint8)).tobytes())
        return rows

    raw = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = s[y0::dy, x0::dx]
        if sub.size:
            raw += _filtered(pack(sub), bpp, filters)
    z = zlib.compress(raw, 9)
    cut = [len(z) * k // idat_parts for k in range(idat_parts + 1)]
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                                              0, int(interlace)))
    out += _chunk(b"gAMA", struct.pack(">I", 45455))  # ignored, as libpng here ignores it
    if plte is not None:
        out += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    for a, b in zip(cut, cut[1:]):
        out += _chunk(b"IDAT", z[a:b])
    return out + _chunk(b"IEND", b"")


def _case(kind, rng):
    """(samples, color type, bit depth, PLTE, tRNS) of one kind of file."""
    h, w = 13, 11
    if kind.startswith("gray") and not kind.startswith("graya"):
        depth = int(kind[4:].split("t")[0])
        g = rng.integers(0, 1 << depth, (h, w, 1))
        trns = struct.pack(">H", int(g[0, 0, 0])) if kind.endswith("trns") else None
        return g, 0, depth, None, trns
    if kind.startswith("palette"):
        depth = int(kind[7:].split("t")[0])
        n = min(1 << depth, 200)
        idx = rng.integers(0, n, (h, w, 1))
        trns = bytes(rng.integers(0, 256, n // 2 + 1).astype(np.uint8)) \
            if kind.endswith("trns") else None
        return idx, 3, depth, rng.integers(0, 256, (n, 3)), trns
    color, spp = {"rgb": (2, 3), "graya": (4, 2), "rgba": (6, 4)}[kind.rstrip("0123456789trns")]
    depth = 16 if "16" in kind else 8
    px = rng.integers(0, 1 << depth, (h, w, spp))
    trns = None
    if kind.endswith("trns"):
        px[2, 3] = px[0, 0]
        trns = px[0, 0].astype(">u2").tobytes()
    return px, color, depth, None, trns


_KINDS = ["gray1", "gray2", "gray4", "gray8", "gray16", "gray1trns", "gray2trns", "gray4trns",
          "gray8trns", "gray16trns", "graya8", "graya16", "rgb8", "rgb16", "rgb8trns",
          "rgb16trns", "rgba8", "rgba16", "palette1", "palette2", "palette4", "palette8",
          "palette1trns", "palette4trns", "palette8trns"]


@pytest.mark.parametrize("interlace", [False, True], ids=["", "adam7"])
@pytest.mark.parametrize("kind", _KINDS)
def test_decode_equals_libpng(lib, libpng, tmp_path, rng, kind, interlace):
    """Every colour type at every bit depth, with and without tRNS, plain
    and Adam7-interlaced, the rows cycling through all five filters: the
    arrays (uint8, or uint16 for 16 bits) libpng gives after the JAX
    package's transforms."""
    samples, color, depth, plte, trns = _case(kind, rng)
    path = str(tmp_path / f"{kind}.png")
    with open(path, "wb") as f:
        f.write(_png(samples, color, depth, filters=(0, 1, 2, 3, 4), interlace=interlace,
                     plte=plte, trns=trns))
    ours, theirs = native.decode(path), jnative.decode(path)
    assert theirs is not None and ours is not None
    assert ours.dtype == theirs.dtype == (np.uint16 if depth == 16 else np.uint8)
    np.testing.assert_array_equal(ours, theirs)
    if trns is not None:  # alpha made from tRNS: both values occur
        assert {0, np.iinfo(ours.dtype).max} <= set(np.unique(ours[..., -1])) or color == 3


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "avg", "paeth"])
@pytest.mark.parametrize("kind", ["rgb8", "rgba16", "gray2"])
def test_decode_undoes_each_filter(lib, libpng, tmp_path, rng, kind, filt):
    samples, color, depth, plte, trns = _case(kind, rng)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png(samples, color, depth, filters=(filt,), plte=plte, trns=trns))
    np.testing.assert_array_equal(native.decode(path), jnative.decode(path))


@pytest.mark.parametrize("shape", [(1, 1, 3), (2, 3, 3), (9, 1), (17, 23, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_decode_adam7_with_empty_passes(lib, libpng, tmp_path, rng, shape):
    """Images too small for some of Adam7's passes: an empty pass has no
    rows and no filter bytes."""
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    rgb = img[..., [2, 1, 0, 3][:img.shape[2]]] if img.ndim == 3 else img
    color = {2: 0, 3: 2, 4: 6}[img.ndim if img.ndim == 2 else img.shape[2]]
    path = str(tmp_path / "i.png")
    with open(path, "wb") as f:
        f.write(_png(rgb, color, 8, filters=(4, 3, 1), interlace=True))
    np.testing.assert_array_equal(native.decode(path), img)
    np.testing.assert_array_equal(jnative.decode(path), img)


@pytest.mark.parametrize("writer", ["opencv", "opencv level 9", "jax level 1", "jax level 6",
                                    "pillow palette"])
def test_decode_files_other_encoders_wrote(lib, libpng, tmp_path, writer):
    img = _smooth((45, 67, 3), seed=3)
    path = str(tmp_path / "w.png")
    if writer.startswith("opencv"):
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, 9 if "9" in writer else 1])
    elif writer.startswith("jax"):
        jnative.encode_png(path, img, compression_level=int(writer[-1]))
    else:
        from PIL import Image

        Image.fromarray(img[:, :, ::-1]).convert("P", palette=Image.ADAPTIVE).save(path)
    ours = native.decode(path)
    np.testing.assert_array_equal(ours, jnative.decode(path))
    np.testing.assert_array_equal(ours, cv2.imread(path, cv2.IMREAD_UNCHANGED))


def _corrupt(kind, img_bytes):
    """A valid 8x8 RGB file made invalid in one way."""
    sig, rest = img_bytes[:8], img_bytes[8:]
    px = np.arange(8 * 8 * 3).reshape(8, 8, 3)
    if kind == "bad IHDR crc":
        return sig + rest[:21] + bytes([rest[21] ^ 1]) + rest[22:]
    if kind == "bad IDAT crc":
        at = img_bytes.index(b"IDAT")
        crc = at + 4 + struct.unpack(">I", img_bytes[at - 4:at])[0]
        return img_bytes[:crc] + bytes([img_bytes[crc] ^ 1]) + img_bytes[crc + 1:]
    if kind == "truncated IDAT":
        return img_bytes[: len(img_bytes) // 2]
    if kind == "short image data":  # a valid stream with a row too few
        z = zlib.compress(_filtered([bytes(24)] * 7, 3, (0,)))
        return sig + rest[:25] + _chunk(b"IDAT", z) + _chunk(b"IEND", b"")
    if kind == "IDAT split by another chunk":  # libpng: "Not enough image data"
        z = zlib.compress(_filtered([r.astype(np.uint8).tobytes() for r in px], 3, (0,)))
        return (img_bytes[:33] + _chunk(b"IDAT", z[:10]) + _chunk(b"tEXt", b"k\x00v")
                + _chunk(b"IDAT", z[10:]) + _chunk(b"IEND", b""))
    if kind == "width over the limit":
        ihdr = struct.pack(">IIBBBBB", 1_000_001, 1, 8, 2, 0, 0, 0)
        return sig + _chunk(b"IHDR", ihdr) + rest[25:]
    if kind == "height over the limit":
        ihdr = struct.pack(">IIBBBBB", 1, 1_000_001, 8, 0, 0, 0, 0)
        return sig + _chunk(b"IHDR", ihdr) + rest[25:]
    if kind == "palette without PLTE":
        return _png(np.zeros((4, 4, 1), np.int64), 3, 8)
    if kind == "bad filter byte":
        z = zlib.compress(b"".join(b"\x05" + bytes(24) for _ in range(8)))
        return sig + rest[:25] + _chunk(b"IDAT", z) + _chunk(b"IEND", b"")
    if kind == "not a PNG":
        return b"GIF89a" + rest
    if kind == "bad bit depth":
        ihdr = struct.pack(">IIBBBBB", 8, 8, 4, 2, 0, 0, 0)
        return sig + _chunk(b"IHDR", ihdr) + rest[25:]
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["bad IHDR crc", "bad IDAT crc", "truncated IDAT",
                                  "short image data", "IDAT split by another chunk",
                                  "width over the limit", "height over the limit",
                                  "palette without PLTE", "bad filter byte", "not a PNG",
                                  "bad bit depth"])
def test_corrupt_png_returns_none_as_libpng_refuses_it(lib, libpng, tmp_path, kind):
    good = _png(np.arange(8 * 8 * 3).reshape(8, 8, 3) % 256, 2, 8, idat_parts=1)
    path = str(tmp_path / "bad.png")
    with open(path, "wb") as f:
        f.write(_corrupt(kind, good))
    assert jnative.decode(path) is None  # libpng refuses it too
    assert native.decode(path) is None


@pytest.mark.parametrize("kind", ["bad tRNS crc", "tRNS of the wrong length", "unknown ancillary",
                                  "trailing garbage after IEND", "no IEND"])
def test_damage_libpng_tolerates_is_tolerated(lib, libpng, tmp_path, rng, kind):
    """Ancillary damage libpng drops with a warning, and anything after the
    image data, which it never reads: the same pixels as libpng."""
    px = rng.integers(0, 256, (6, 7, 3))
    trns = {"bad tRNS crc": None, "tRNS of the wrong length": b"\x00\x01"}.get(kind)
    data = _png(px, 2, 8, trns=trns)
    if kind == "bad tRNS crc":
        data = data[:33] + _chunk(b"tRNS", px[0, 0].astype(">u2").tobytes(), crc_xor=1) + data[33:]
    elif kind == "unknown ancillary":
        data = data[:33] + _chunk(b"inNf", b"\x00" * 40) + data[33:]
    elif kind == "trailing garbage after IEND":
        data += b"garbage"
    elif kind == "no IEND":
        data = data[:-12]
    path = str(tmp_path / "t.png")
    with open(path, "wb") as f:
        f.write(data)
    theirs = jnative.decode(path)
    assert theirs is not None and theirs.shape == (6, 7, 3)
    np.testing.assert_array_equal(native.decode(path), theirs)


# ---------------------------------------------------------------------------
# A library built without libjpeg
# ---------------------------------------------------------------------------

@pytest.fixture
def no_jpeg(src_copy, monkeypatch):
    """A library built where g++ reports jpeglib.h missing, with the
    compiler's command recorded."""
    monkeypatch.setattr(native, "missing_headers", lambda: ["jpeglib.h"])
    cmds = []
    real = _build.compile_into

    def spy(cmd, out):
        cmds.append(cmd)
        return real(cmd, out)

    monkeypatch.setattr(_build, "compile_into", spy)
    lib = native.get_lib()
    assert lib is not None, native.unavailable_reason()
    return lib, cmds


def test_library_without_libjpeg_reads_png_and_refuses_jpeg(lib, no_jpeg, tmp_path, rng):
    _, (cmd,) = no_jpeg
    assert "-lz" in cmd and "-ljpeg" not in cmd and "-DINNFER_WITH_JPEG" not in cmd
    assert not native.has_jpeg()
    assert native.version() == f"zlib {zlib.ZLIB_RUNTIME_VERSION}; PNG"
    # the two builds never share a file
    assert native.library_path() != native.library_path(
        native.CXX_FLAGS + native.JPEG_FLAGS + ("-lz",))
    img = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
    png_path, jpg_path = str(tmp_path / "a.png"), str(tmp_path / "b.jpg")
    assert native.encode_png(png_path, img)
    np.testing.assert_array_equal(native.decode(png_path), img)
    cv2.imwrite(jpg_path, img)
    assert native.decode(jpg_path) is None
    np.testing.assert_array_equal(iio.read_img(jpg_path), cv2.imread(jpg_path,
                                                                      cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("listing", ["jpeg only", "mixed", "png only"])
def test_loader_without_libjpeg_keeps_decoding_off_the_main_thread(lib, no_jpeg, tmp_path, rng,
                                                                    listing):
    """A list with a JPEG takes the Python pool (PNGs still decode natively
    in it), in order; a list of PNGs keeps the library's threads."""
    paths, imgs, fell_back = [], [], []
    for i in range(6):
        jpg = listing == "jpeg only" or (listing == "mixed" and i % 2)
        paths.append(str(tmp_path / f"f{i}.{'jpg' if jpg else 'png'}"))
        imgs.append(rng.integers(0, 256, (8 + i, 9, 3), dtype=np.uint8))
        cv2.imwrite(paths[-1], imgs[-1])

    def fallback(p):
        fell_back.append(os.path.basename(p))
        return cv2.imread(p, cv2.IMREAD_UNCHANGED)

    loader = native.PrefetchLoader(paths, capacity=2, threads=2, fallback=fallback)
    try:
        pooled = loader._pool is not None
        got = [(i, p, img) for i, p, img in loader]
    finally:
        loader.close()
    assert pooled == (listing != "png only") and (loader._handle is None)
    assert [(i, p) for i, p, _ in got] == list(enumerate(paths))
    for i, _, img in got:
        if paths[i].endswith(".png"):
            np.testing.assert_array_equal(img, imgs[i])
        else:
            np.testing.assert_array_equal(img, cv2.imread(paths[i], cv2.IMREAD_UNCHANGED))
    assert sorted(fell_back) == sorted(os.path.basename(p) for p in paths if p.endswith(".jpg"))


@pytest.mark.parametrize("kind,interlace", [("rgb8", False), ("rgba16", True), ("palette4trns", False),
                                            ("gray2trns", True)])
def test_mutated_files_decode_as_libpng_decodes_them(lib, libpng, tmp_path, rng, kind, interlace):
    """Seeded damage (bytes flipped, files cut short, bytes overwritten past
    the signature): the port refuses what libpng refuses and reads what it
    reads, pixel for pixel."""
    samples, color, depth, plte, trns = _case(kind, rng)
    good = _png(samples, color, depth, filters=(0, 1, 2, 3, 4), interlace=interlace, plte=plte,
                trns=trns)
    path = str(tmp_path / "m.png")
    refused = read = 0
    for _ in range(120):
        m = bytearray(good)
        how = rng.integers(3)
        if how == 0:
            for _ in range(rng.integers(1, 4)):
                m[rng.integers(len(m))] ^= int(rng.integers(1, 256))
        elif how == 1:
            m = m[:rng.integers(len(m))]
        else:
            m[rng.integers(8, len(m))] = int(rng.integers(256))
        with open(path, "wb") as f:
            f.write(m)
        ours, theirs = native.decode(path), jnative.decode(path)
        assert (ours is None) == (theirs is None)
        if ours is None:
            refused += 1
        else:
            read += 1
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)
    assert refused and read  # both outcomes occur


def test_loader_without_libjpeg_or_a_fallback_still_reads_the_pngs(lib, no_jpeg, tmp_path, rng):
    """No fallback and a JPEG in the list: the PNGs still decode natively,
    in order, and the JPEG, which nothing here can read, is None."""
    paths = [str(tmp_path / name) for name in ("a.png", "b.jpg", "c.png")]
    imgs = [rng.integers(0, 256, (5 + i, 6, 3), dtype=np.uint8) for i in range(3)]
    for p, img in zip(paths, imgs):
        cv2.imwrite(p, img)
    loader = native.PrefetchLoader(paths, capacity=2, threads=2)
    try:
        got = list(loader)
    finally:
        loader.close()
    assert [(i, p) for i, p, _ in got] == list(enumerate(paths))
    np.testing.assert_array_equal(got[0][2], imgs[0])
    np.testing.assert_array_equal(got[2][2], imgs[2])
    assert got[1][2] is None
