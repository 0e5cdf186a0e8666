"""The port's pipeline, CLI and image codec against the JAX package's.

Outputs are u8 PNGs from the same synthetic checkpoint and seeded images;
both packages compute in fp32 on the CPU, so a pixel may differ by one
rounding step at most (|delta| <= 1).
"""
import os

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from innfer_tpu.cli import main as jax_cli
from innfer_tpu.pipeline import InferenceSession as JaxSession
from innfer_tpu_torch import cli as torch_cli
from innfer_tpu_torch.io import images as iio
from innfer_tpu_torch.io import png
from innfer_tpu_torch.nn import functional as F
from innfer_tpu_torch.nn import phase as PH
from innfer_tpu_torch.ops.rdb import rdb_reference
from innfer_tpu_torch.pipeline import InferenceSession, _postprocess_u8, np2tensor
from innfer_tpu_torch.runtime import native
from tools import synth_params as SP


@pytest.fixture
def ckpt(tmp_path):
    state = SP.esrgan_state(nb=1, nf=16, gc=8, scale=2, seed=2)
    path = tmp_path / "2x_synth.pth"
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, str(path))
    return str(path)


@pytest.fixture
def in_dir(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    rng = np.random.default_rng(3)
    for name, (h, w) in {"a": (20, 28), "b": (24, 24)}.items():
        cv2.imwrite(str(d / f"{name}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return str(d)


def _assert_same_outputs(dir_a, dir_b, names=("a", "b")):
    for n in names:
        a = cv2.imread(os.path.join(dir_a, f"{n}.png"), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(os.path.join(dir_b, f"{n}.png"), cv2.IMREAD_UNCHANGED)
        assert a is not None and a.shape == b.shape and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


@pytest.mark.parametrize("tile_mode", ["uniform", "auto"])
def test_process_matches_jax_session(ckpt, in_dir, tmp_path, tile_mode):
    kw = dict(tile=16, overlap=8, tile_batch=4, tile_mode=tile_mode)
    JaxSession(ckpt, compute_dtype=jnp.float32, **kw).process(
        in_dir, str(tmp_path / "jax"), verbose=False)
    sess = InferenceSession(ckpt, compute_dtype=torch.float32, device="cpu", **kw)
    written = sess.process(in_dir, str(tmp_path / "port"), verbose=False)
    assert sorted(os.path.basename(p) for p in written) == ["a.png", "b.png"]
    assert cv2.imread(written[0]).shape == (40, 56, 3)
    _assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_cli_matches_jax_cli(ckpt, in_dir, tmp_path):
    common = ["-m", ckpt, "-i", in_dir, "--tile", "16", "--overlap", "8"]
    assert jax_cli(common + ["-o", str(tmp_path / "jax"), "-no_fp16", "-cpu"]) == 0
    assert torch_cli.main(common + ["-o", str(tmp_path / "port"), "-cpu"]) == 0
    _assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_default_device_entry_points_raise_without_a_card(ckpt, in_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceSession(ckpt)
    with pytest.raises(RuntimeError, match="-cpu"):
        torch_cli.main(["-m", ckpt, "-i", in_dir, "-o", str(tmp_path / "o")])


def test_write_error_surfaces(ckpt, in_dir, tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    sess = InferenceSession(ckpt, compute_dtype=torch.float32, device="cpu", tile=16,
                            overlap=8)
    with pytest.raises(OSError):
        sess.process(in_dir, str(blocker / "out"), verbose=False)


@pytest.fixture
def png_jpeg_dir(tmp_path):
    """One PNG and one JPEG: the native codec decodes both."""
    d = tmp_path / "mixed"
    d.mkdir()
    rng = np.random.default_rng(8)
    cv2.imwrite(str(d / "a.png"), rng.integers(0, 256, (20, 28, 3), dtype=np.uint8))
    cv2.imwrite(str(d / "b.jpg"), rng.integers(0, 256, (24, 16, 3), dtype=np.uint8))
    return str(d)


@pytest.mark.parametrize("codec", ["native", "opencv"])
def test_process_png_and_jpeg_matches_jax_process(ckpt, png_jpeg_dir, tmp_path, monkeypatch,
                                                  codec):
    """A directory of a PNG and a JPEG through the port's process (decoded
    by the native prefetch loader, or with no native library by OpenCV on
    the loader's Python threads) against the JAX package's process, fp32
    on the CPU: identical u8 outputs, and with the native codec, whose PNG
    recipe is the JAX package's, byte-identical files."""
    kw = dict(tile=16, overlap=8, tile_batch=4)
    JaxSession(ckpt, compute_dtype=jnp.float32, **kw).process(
        png_jpeg_dir, str(tmp_path / "jax"), verbose=False)
    if codec == "opencv":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        assert iio.codec_name() == f"opencv {cv2.__version__}"
    sess = InferenceSession(ckpt, compute_dtype=torch.float32, device="cpu", **kw)
    written = sess.process(png_jpeg_dir, str(tmp_path / "port"), verbose=False)
    assert [os.path.basename(p) for p in written] == ["a.png", "b.png"]
    for path in written:
        ref = str(tmp_path / "jax" / os.path.basename(path))
        np.testing.assert_array_equal(cv2.imread(path), cv2.imread(ref))
        with open(path, "rb") as f, open(ref, "rb") as g:
            assert (f.read() == g.read()) == (codec == "native")


# the thread-name prefixes of the port's two pools: the loader's decode
# pool (runtime/native.py) and the session's encode pool (pipeline.py).  A
# JAX test in the same worker leaves the JAX package's process-wide
# ``innfer-fetch`` pool behind, which is none of the port's business.
PORT_POOLS = ("innfer-decode", "innfer-encode")


def _port_pool_threads():
    import threading

    return [t.name for t in threading.enumerate() if t.name.startswith(PORT_POOLS)]


def _process_fails_on_the_second_image(ckpt, in_dir, tmp_path, monkeypatch, codec):
    """A forward that raises on the second image: the error reaches the
    caller, the loader is closed and none of the port's decode or encode
    threads is left."""
    from innfer_tpu_torch import pipeline

    if codec != "native":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    loaders = []

    class Recorded(pipeline.PrefetchLoader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            loaders.append((self, self._handle is not None, self._pool is not None))

    monkeypatch.setattr(pipeline, "PrefetchLoader", Recorded)
    sess = InferenceSession(ckpt, compute_dtype=torch.float32, device="cpu", tile=16,
                            overlap=8)
    real, calls = sess.run_image, []

    def failing(img, **kw):
        calls.append(img.shape)
        if len(calls) == 2:
            raise RuntimeError("forward failed")
        return real(img, **kw)

    monkeypatch.setattr(sess, "run_image", failing)
    with pytest.raises(RuntimeError, match="forward failed"):
        sess.process(in_dir, str(tmp_path / "out"), verbose=False)
    ((loader, had_handle, had_pool),) = loaders
    assert (had_handle, had_pool) == ((True, False) if codec == "native" else (False, True))
    assert loader._handle is None and loader._pool is None and len(calls) == 2
    assert not _port_pool_threads()


@pytest.mark.parametrize("codec", ["native", "python threads"])
def test_process_error_closes_the_loader_and_the_pools(ckpt, in_dir, tmp_path, monkeypatch,
                                                       codec):
    _process_fails_on_the_second_image(ckpt, in_dir, tmp_path, monkeypatch, codec)


@pytest.mark.parametrize("codec", ["native", "python threads"])
def test_process_error_check_ignores_a_jax_fetch_pool(ckpt, in_dir, tmp_path, monkeypatch,
                                                      codec):
    """The same failure with a thread named as the JAX package's fetch pool
    alive in the process (what tests/test_pipeline.py leaves in a worker it
    shared with this file): the check counts the port's pools only, and
    still sees a port thread that outlives the call."""
    import threading

    stop = threading.Event()
    jax_like = threading.Thread(target=stop.wait, name="innfer-fetch_0", daemon=True)
    jax_like.start()
    try:
        _process_fails_on_the_second_image(ckpt, in_dir, tmp_path, monkeypatch, codec)
        leak = threading.Thread(target=stop.wait, name="innfer-encode_0", daemon=True)
        leak.start()
        assert _port_pool_threads() == ["innfer-encode_0"]
    finally:
        stop.set()
        jax_like.join()
    leak.join()
    assert not _port_pool_threads()


def test_chains_are_refused(ckpt, in_dir, tmp_path):
    """A chain of two 2x ESRGANs ('+' or '>') runs both stages in turn at
    the scales of their filenames, as the JAX session does; -s does not
    override a chain's scales."""
    kw = dict(tile=16, overlap=8, tile_batch=4)
    JaxSession(f"{ckpt}>{ckpt}", compute_dtype=jnp.float32, **kw).process(
        in_dir, str(tmp_path / "jax"), verbose=False)
    sess = InferenceSession(f"{ckpt}+{ckpt}", compute_dtype=torch.float32, device="cpu",
                            scale=4, **kw)
    assert [st.model.scale for st in sess.stages] == [2, 2]
    written = sess.process(in_dir, str(tmp_path / "port"), verbose=False)
    assert cv2.imread(written[0]).shape == (80, 112, 3)
    _assert_same_outputs(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_fp32_path_requests_no_tf32(monkeypatch):
    seen = []
    real = torch.nn.functional.conv2d

    def spy(*a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return real(*a, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x = torch.rand(1, 8, 8, 8)
    F.conv2d(x, torch.rand(8, 8, 3, 3), torch.rand(8), padding=1)
    ws = [torch.rand(8 if c < 4 else 8, 8 + 8 * c, 3, 3) for c in range(5)]
    rdb_reference(x, ws, [torch.rand(8) for _ in range(5)])
    assert len(seen) == 6 and all(s == (False, False) for s in seen)
    assert torch.backends.cudnn.allow_tf32  # restored after the fp32 op
    seen.clear()
    F.conv2d(x.bfloat16(), torch.rand(8, 8, 3, 3), None, padding=1)
    assert seen == [(True, torch.backends.cuda.matmul.allow_tf32)]
    # evsrgan's conv3d, the phase tail's convs and an asymmetric pad: true fp32
    seen.clear()
    real3d = torch.nn.functional.conv3d

    def spy3d(*a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return real3d(*a, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv3d", spy3d)
    F.conv3d(torch.rand(1, 3, 6, 6, 4), torch.rand(4, 4, 3, 3, 3), torch.rand(4), padding=1)
    p = torch.rand(1, 4, 5, 4 * 8)
    PH.phase_conv3x3(p, torch.rand(8, 8, 3, 3), torch.rand(8))
    PH.phase_conv3x3_dense(p, torch.rand(8, 8, 3, 3), torch.rand(8))
    F.conv2d(x, torch.rand(8, 8, 3, 3), torch.rand(8), padding=[(1, 0), (0, 1)])
    assert len(seen) == 4 and all(s == (False, False) for s in seen)
    assert torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_u8_round_trip_on_device_side(dtype):
    rng = np.random.default_rng(4)
    img = rng.integers(0, np.iinfo(dtype).max, (5, 7, 3), dtype=dtype)
    t = np2tensor(img, device=torch.device("cpu"))
    assert t.shape == (1, 5, 7, 3) and t.dtype == torch.float32
    back = _postprocess_u8(t).numpy()
    want = np.round(img.astype(np.float64) / np.iinfo(dtype).max * 255)
    np.testing.assert_array_equal(back, want.astype(np.uint8))


@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 3), (9, 11, 4)])
def test_stdlib_png_round_trip_and_agrees_with_cv2(shape, tmp_path):
    img = np.random.default_rng(5).integers(0, 256, shape, dtype=np.uint8)
    assert np.array_equal(png.decode(png.encode(img)), img)
    # cv2 reads what the stdlib codec writes ...
    dec = cv2.imdecode(np.frombuffer(png.encode(img), np.uint8), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(dec, img)
    # ... and the stdlib codec reads what cv2 writes (adaptive row filters)
    smooth = (np.indices(shape).sum(0) * 7 % 256).astype(np.uint8)
    for pic in (img, smooth):
        path = str(tmp_path / "cv.png")
        cv2.imwrite(path, pic)
        assert np.array_equal(png.read(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))


def test_images_use_stdlib_png_without_cv2(monkeypatch, tmp_path):
    monkeypatch.setattr(iio, "cv2", None)
    # and without the native codec, which would read and write PNG first
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_reason", "switched off by the test")
    assert iio.codec_name() == "stdlib png"
    img = np.random.default_rng(6).integers(0, 256, (6, 9, 3), dtype=np.uint8)
    iio.save_img(img, str(tmp_path / "x.png"))
    assert np.array_equal(iio.read_img(str(tmp_path / "x.png")), img)
    with pytest.raises(ValueError, match="PNG only"):
        iio.save_img(img, str(tmp_path / "x.jpg"))
