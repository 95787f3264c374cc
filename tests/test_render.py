"""Map PNG rendering without third-party imaging packages."""
import struct
import sys
import zlib

import numpy as np

from vslam_jax.viz import render


def _read_png(path):
    """Minimal decoder for the writer's own output (8-bit RGB, filter 0)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks.setdefault(tag, b"")
        chunks[tag] += body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 2) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_write_png_roundtrips_pixels(tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (7, 5, 3)).astype(np.uint8)
    path = render.write_png(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(_read_png(path), img)


def test_render_png_two_panels(tmp_path):
    rng = np.random.RandomState(1)
    poses = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    poses[:, 2, 3] = np.arange(6)
    snap = {"points": rng.randn(300, 3).astype(np.float32) * 4,
            "colors": rng.rand(300, 3).astype(np.float32),
            "poses": poses}
    img = _read_png(render.render_png(snap, str(tmp_path / "map.png"),
                                      size=120))
    assert img.shape == (120, 2 * 120 + 4, 3)
    assert (img != 255).any(axis=2).sum() > 100          # something drawn
    red = (img[..., 0] > 200) & (img[..., 1] < 60) & (img[..., 2] < 60)
    assert red.sum() >= 10                                # the trajectory
    assert "matplotlib" not in sys.modules
