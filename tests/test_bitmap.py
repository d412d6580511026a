"""Bitmap codecs (`io/bitmap.py`) and the main path without an imaging
library: BMP round trip with row parity, PNG decoded by hand with `zlib`,
a BMP-textured scene load and a CLI render to PNG with Pillow made
unimportable."""

import json
import struct
import sys
import zlib

import numpy as np
import pytest

from raytracer_tpu.io.bitmap import read_bmp, write_bmp, write_image, write_png


def _img(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c)).astype(np.uint8)


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 7])
def test_bmp_round_trip(tmp_path, w):
    img = _img(6, w, seed=w)
    p = str(tmp_path / "a.bmp")
    write_bmp(p, img)
    np.testing.assert_array_equal(read_bmp(p), img)


def test_bmp_rows_stored_bottom_up(tmp_path):
    img = np.zeros((2, 1, 3), np.uint8)
    img[0, 0] = (10, 20, 30)  # top row
    img[1, 0] = (40, 50, 60)  # bottom row
    p = tmp_path / "rows.bmp"
    write_bmp(str(p), img)
    data = p.read_bytes()
    (offset,) = struct.unpack_from("<I", data, 10)
    (height,) = struct.unpack_from("<i", data, 22)
    assert height == 2  # positive height = bottom-up storage
    stride = 4  # 3 bytes padded to a multiple of 4
    first, second = data[offset:offset + 3], data[offset + stride:offset + stride + 3]
    assert first == bytes((60, 50, 40))  # bottom row first, stored BGR
    assert second == bytes((30, 20, 10))
    assert len(data) == offset + 2 * stride


def _bmp32(path, img_rgba, top_down):
    h, w, _ = img_rgba.shape
    rows = img_rgba[:, :, [2, 1, 0, 3]]
    if not top_down:
        rows = rows[::-1]
    pixels = rows.tobytes()
    hdr = struct.pack("<2sIHHI", b"BM", 54 + len(pixels), 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, 32, 0,
                       len(pixels), 0, 0, 0, 0)
    path.write_bytes(hdr + info + pixels)


@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_reads_32_bit(tmp_path, top_down):
    img = _img(3, 5, 4, seed=1)
    p = tmp_path / "b.bmp"
    _bmp32(p, img, top_down)
    np.testing.assert_array_equal(read_bmp(str(p)), img)


def test_bmp_rejects_other_depths(tmp_path):
    p = tmp_path / "c.bmp"
    write_bmp(str(p), _img(2, 2))
    data = bytearray(p.read_bytes())
    struct.pack_into("<H", data, 28, 8)  # claim 8 bits per pixel
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="8-bit"):
        read_bmp(str(p))


def _decode_png(data: bytes):
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        assert crc == zlib.crc32(kind + payload) & 0xFFFFFFFF, kind
        chunks.append((kind, payload))
        pos += 12 + n
    kinds = [k for k, _ in chunks]
    assert kinds[0] == b"IHDR" and kinds[-1] == b"IEND"
    w, h, depth, ctype, comp, filt, inter = struct.unpack(">IIBBBBB", chunks[0][1])
    assert (depth, comp, filt, inter) == (8, 0, 0, 0)
    c = {0: 1, 2: 3, 6: 4}[ctype]
    raw = zlib.decompress(b"".join(p for k, p in chunks if k == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * c)
    assert np.all(rows[:, 0] == 0)  # filter type None on every row
    return rows[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_writer_decodes(tmp_path, c):
    img = _img(5, 7, c, seed=c)
    p = tmp_path / "a.png"
    write_png(str(p), img)
    np.testing.assert_array_equal(_decode_png(p.read_bytes()), img)


def test_write_image_by_extension(tmp_path):
    img = _img(4, 4)
    write_image(str(tmp_path / "x.png"), img)
    write_image(str(tmp_path / "x.bmp"), img)
    np.testing.assert_array_equal(_decode_png((tmp_path / "x.png").read_bytes()), img)
    np.testing.assert_array_equal(read_bmp(str(tmp_path / "x.bmp")), img)
    with pytest.raises(ValueError, match="png or .bmp"):
        write_image(str(tmp_path / "x.jpg"), img)


@pytest.fixture
def no_pillow(monkeypatch):
    """Make `import PIL` fail, as on an installation without Pillow."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


def test_load_bmp_textured_scene_without_pillow(tmp_path, no_pillow):
    import warnings

    from raytracer_tpu.io.scene_loader import _load_bitmap, load_scene

    img = _img(8, 4, seed=5)
    write_bmp(str(tmp_path / "tex.bmp"), img)
    doc = {
        "textures": [{"name": "t", "type": "bitmap", "path": "tex.bmp"}],
        "materials": [{"name": "m", "bsdf": "diffuse", "baseColorTexture": "t"}],
        "objects": [{"type": "rect", "size": [1, 1], "material": "m"}],
        "lights": [{"type": "background", "color": [1, 1, 1]}],
    }
    (tmp_path / "scene.json").write_text(json.dumps(doc))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a missing texture only warns
        scene, meta, cam = load_scene(str(tmp_path / "scene.json"), strict=True)
    assert scene.textures is not None
    lin = _load_bitmap(str(tmp_path), "tex.bmp")
    # rows flipped to the reference's raw bottom-up sampling; sRGB -> linear
    # is monotone, so the brightest texel keeps its (flipped) position
    flat = img.astype(np.int64).sum(-1)
    r, c = np.unravel_index(np.argmax(flat), flat.shape)
    assert np.argmax(lin.sum(-1)) == np.ravel_multi_index((img.shape[0] - 1 - r, c), flat.shape)
    assert lin.shape == (8, 4, 3) and np.all((lin >= 0) & (lin <= 1))


def test_png_texture_without_pillow_names_the_file(tmp_path, no_pillow):
    from raytracer_tpu.io.scene_loader import SceneLoadError, _load_bitmap

    (tmp_path / "tex.png").write_bytes(b"")
    with pytest.raises(SceneLoadError, match="tex.png"):
        _load_bitmap(str(tmp_path), "tex.png")


def test_cli_renders_png_without_pillow(tmp_path, no_pillow, monkeypatch, capsys):
    from raytracer_tpu import cli

    # the entry point's compile-cache helper leaves JAX alone when the
    # variable is set, so this test changes no process-wide setting
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    out = tmp_path / "frame.png"
    rc = cli.main(["--cpu", "--width", "8", "--height", "8", "--passes", "1",
                   "--max-depth", "2", "--output", str(out), "--stats-json"])
    assert rc == 0
    img = _decode_png(out.read_bytes())
    assert img.shape == (8, 8, 3) and img.max() > 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["platform"] == "cpu"
