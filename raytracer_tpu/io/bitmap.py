"""Bitmap codecs in numpy: uncompressed BMP read/write and a PNG writer.

The renderer's own inputs and outputs need no imaging library: generated
scenes ship 24-bit BMP textures (the reference's `BitmapBMP.cpp` format) and
tonemapped frames are written as 8-bit PNG through `zlib`.

Arrays are ``(H, W, C)`` uint8 with row 0 the TOP row (display order), as an
imaging library would return them.  BMP stores rows bottom-up when its
header height is positive; the codec undoes that on read and applies it on
write.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_BI_RGB = 0
_BI_BITFIELDS = 3


def read_bmp(path: str) -> np.ndarray:
    """Decode a 24- or 32-bit uncompressed BMP -> (H, W, 3|4) uint8, top row
    first (channel order RGB[A])."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM" or len(data) < 54:
        raise ValueError(f"{path}: not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    (hdr_size, width, height, planes, bpp, compression) = struct.unpack_from(
        "<IiiHHI", data, 14
    )
    if hdr_size < 40:
        raise ValueError(f"{path}: unsupported BMP header ({hdr_size} bytes)")
    if bpp not in (24, 32):
        raise ValueError(f"{path}: {bpp}-bit BMP unsupported (need 24 or 32)")
    if compression not in (_BI_RGB, _BI_BITFIELDS) or (
        compression == _BI_BITFIELDS and bpp != 32
    ):
        raise ValueError(f"{path}: compressed BMP unsupported ({compression})")
    if compression == _BI_BITFIELDS:
        masks = struct.unpack_from("<III", data, 54)  # right after the info header
        if masks != (0x00FF0000, 0x0000FF00, 0x000000FF):
            raise ValueError(f"{path}: BMP channel masks {masks} unsupported")
    bottom_up = height > 0
    h, w = abs(height), width
    ch = bpp // 8
    stride = (w * ch + 3) & ~3
    rows = np.frombuffer(data, np.uint8, count=h * stride, offset=offset)
    px = rows.reshape(h, stride)[:, : w * ch].reshape(h, w, ch)
    if bottom_up:
        px = px[::-1]
    order = [2, 1, 0, 3] if ch == 4 else [2, 1, 0]  # BGR[A] -> RGB[A]
    return np.ascontiguousarray(px[..., order])


def write_bmp(path: str, img: np.ndarray) -> None:
    """Encode (H, W, 3) uint8 RGB (top row first) as a 24-bit bottom-up BMP."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_bmp needs (H, W, 3) uint8, got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    pixels = rows.tobytes()
    header = struct.pack("<2sIHHI", b"BM", 54 + len(pixels), 0, 0, 54)
    info = struct.pack(
        "<IiiHHIIiiII", 40, w, h, 1, 24, _BI_RGB, len(pixels), 2835, 2835, 0, 0
    )
    with open(path, "wb") as f:
        f.write(header + info + pixels)


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray) -> None:
    """Encode (H, W), (H, W, 3) or (H, W, 4) uint8 (top row first) as an
    8-bit PNG (filter type 0 on every row, one zlib stream)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"write_png needs uint8 gray/RGB/RGBA, got {img.dtype} {img.shape}")
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = np.zeros((h, 1 + w * c), np.uint8)  # leading 0 = filter "None"
    raw[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def write_image(path: str, img: np.ndarray) -> None:
    """Write a tonemapped uint8 frame by extension: ``.png`` or ``.bmp``."""
    ext = path.lower().rsplit(".", 1)[-1]
    if ext == "png":
        write_png(path, img)
    elif ext == "bmp":
        write_bmp(path, img)
    else:
        raise ValueError(f"{path}: output format must be .png or .bmp")
