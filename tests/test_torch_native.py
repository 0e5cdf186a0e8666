"""The port's native host runtime (innfer_tpu_torch/runtime/) against OpenCV
and the JAX package's runtime, on the CPU.

Each case of tests/test_native_runtime.py has its counterpart here, and the
parity cases hold the port's ``io.images`` to the JAX package's: the same
pixels read, byte-identical PNG files written (the same C sources, the same
UP filter and Z_RLE recipe).  The library builds with g++ at first use; the
cases that need it skip inside a fixture where g++ or a header is missing.
"""
import os
import shutil

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
    monkeypatch.setattr(native, "HEADERS", native.HEADERS + ("innfer_absent.h",))
    text = (src_copy / "imgcodec.cpp").read_text()
    (src_copy / "imgcodec.cpp").write_text("#include <innfer_absent.h>\n" + text)
    assert native.get_lib() is None
    why = native.unavailable_reason()
    assert why.startswith("missing innfer_absent.h;") and "No such file" in why
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
    assert native.version().startswith("libpng 1.")
    monkeypatch.setattr(iio, "cv2", None)
    path = str(tmp_path / "x.webp")
    with pytest.raises(ValueError, match="reads PNG and JPEG and writes 8-bit PNG"):
        iio.read_img(path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", "switched off by the test")
    with pytest.raises(ValueError, match=r"unavailable \(switched off by the test\).*PNG only"):
        iio.read_img(path)
