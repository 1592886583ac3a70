"""The numpy/zlib PNG codec (utils/png.py) and the images written with it."""

import struct
import zlib

import numpy as np
import pytest

from scrabblegan.utils import png
from scrabblegan.utils.viz import image_grid, make_animation, save_epoch_grid


def _chunks(data):
    pos, out = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        out.append((kind, body))
        pos += 12 + n
    return out


@pytest.mark.parametrize("shape", [(7, 5), (4, 9, 3)])
def test_round_trip(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    png.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "a.png")), img)


def test_filtered_png_goes_to_the_optional_decoders(tmp_path):
    """A PNG with row filters (as other encoders write them) is not decoded
    here; read_grayscale hands it to cv2 / PIL."""
    img = np.random.default_rng(1).integers(0, 256, (5, 6)).astype(np.uint8)
    raw = b"".join(bytes([2]) + bytes(((img[y].astype(int) - (img[y - 1] if y else 0)) % 256)
                                       .astype(np.uint8)) for y in range(5))
    data = (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 6, 5, 8, 0, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(raw)) + png._chunk(b"IEND", b""))
    path = tmp_path / "up.png"
    path.write_bytes(data)
    with pytest.raises(png.UnsupportedPNG, match="filters"):
        png.read_png(str(path))
    from scrabblegan.data import images

    if not (images._HAS_CV2 or images._HAS_PIL):
        assert images.read_grayscale(str(path)) is None
    else:
        np.testing.assert_array_equal(images.read_grayscale(str(path)), img)


def test_unsupported_png_raises(tmp_path):
    data = (b"\x89PNG\r\n\x1a\n" + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 16, 0, 0, 0, 0))
            + png._chunk(b"IEND", b""))
    (tmp_path / "d16.png").write_bytes(data)
    with pytest.raises(png.UnsupportedPNG):
        png.read_png(str(tmp_path / "d16.png"))


def test_epoch_grid_and_animation(tmp_path):
    imgs = np.linspace(-1, 1, 16 * 32 * 48).reshape(16, 32, 48, 1)
    grid = image_grid(imgs)
    assert grid.shape == (4 * 36 + 4, 4 * 52 + 4) and grid.dtype == np.uint8
    assert grid[0].min() == 255  # white gutter
    for epoch in (1, 2, 3):
        save_epoch_grid(imgs[:3], str(tmp_path), epoch)
    anim = make_animation(str(tmp_path), "anim.png")
    chunks = _chunks(open(anim, "rb").read())
    kinds = [k for k, _ in chunks]
    num_frames = struct.unpack(">II", dict(chunks)[b"acTL"])[0]
    assert kinds[0] == b"IHDR" and b"acTL" in kinds and kinds[-1] == b"IEND"
    assert num_frames == kinds.count(b"fcTL") == 1 + kinds.count(b"fdAT")
    seqs = [struct.unpack(">I", b[:4])[0] for k, b in chunks if k in (b"fcTL", b"fdAT")]
    assert seqs == list(range(len(seqs)))
    # the first frame is the plain PNG image a non-animating viewer shows
    np.testing.assert_array_equal(png.read_png(anim), png.read_png(
        str(tmp_path / "image_at_epoch_0001.png")))
