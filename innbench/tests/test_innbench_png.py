"""The benchmark's own PNG codec: its round trip, and the files the program's
encoder writes, with its one filter and with all five."""
import numpy as np
import pytest

from innbench import png


def _img(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 127 + 90 * np.sin(xx / 7.0)[..., None] * np.cos(yy / 5.0)[..., None]
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def test_round_trip(tmp_path):
    img = _img(37, 53)
    n = png.write(str(tmp_path / "a.png"), img)
    assert n == (tmp_path / "a.png").stat().st_size
    assert png.size(str(tmp_path / "a.png")) == (37, 53)
    np.testing.assert_array_equal(png.read(str(tmp_path / "a.png")), img)


@pytest.mark.parametrize("level", [1, 6])
def test_reads_the_program_encoder(tmp_path, level):
    """Level 1 is the program's: the Up filter and Z_RLE; level 6 chooses
    among all five filters row by row."""
    from innfer_tpu_torch.runtime import native

    if not native.available():
        pytest.skip(f"the native codec did not build here: {native.unavailable_reason()}")
    img = _img(24, 31, seed=level)
    path = str(tmp_path / "b.png")
    assert native.encode_png(path, np.ascontiguousarray(img[..., ::-1]), compression_level=level)
    np.testing.assert_array_equal(png.read(path), img)


def test_refuses_a_broken_file(tmp_path):
    path = tmp_path / "c.png"
    png.write(str(path), _img(8, 8))
    data = bytearray(path.read_bytes())
    data[40] ^= 0xFF
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        png.read(str(path))
