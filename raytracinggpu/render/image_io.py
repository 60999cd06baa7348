"""Image encode/decode.

The reference writes PNGs through the vendored stb_image_write
(cpu_launcher.cpp:719, optimized.cu:862) after a gamma-2.2 tone map with a
255 clamp and a raw char cast (saveImage, global_launcher.cu:957-968):

    byte = (char) min(pow(radiance, 1/2.2), 255.0)

Radiance is *not* rescaled — the huge light intensity (3e10) makes lit
surfaces land in the hundreds after the 1/2.2 power, and the clamp does the
rest.  ``tonemap`` reproduces this exactly (the C char cast preserves the low
8 bits, i.e. uint8 truncation).

PNG encoding is a dependency-free implementation over stdlib zlib (filter 0);
a paired decoder exists for round-trip tests.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float radiance -> uint8 with the reference's gamma/clamp."""
    img = np.asarray(img, np.float64)
    out = np.minimum(np.power(np.maximum(img, 0.0), 1.0 / 2.2), 255.0)
    return out.astype(np.uint8)


def tonemap_device(img):
    """jnp (on-device) variant of ``tonemap`` for jitted frame loops — same
    formula, uint8 out."""
    import jax.numpy as jnp

    return jnp.minimum(
        jnp.power(jnp.maximum(img, 0.0), 1.0 / 2.2), 255.0
    ).astype(jnp.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str, rgb: np.ndarray, native: bool | None = None) -> None:
    """Write an (H, W, 3) uint8 array as a PNG file (native C++ encoder when
    available, stdlib-zlib fallback)."""
    rgb = np.asarray(rgb, np.uint8)
    h, w, c = rgb.shape
    assert c == 3
    if native is not False:
        from raytracinggpu import native as native_mod

        if native_mod.write_png(path, rgb):
            return
        if native is True:
            raise RuntimeError("native library requested but unavailable")
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Decode PNGs written by write_png (8-bit RGB, filters 0/1/2 only)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            assert depth == 8 and ctype == 2, "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * 3
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    p = 0
    for i in range(h):
        filt = raw[p]
        row = np.frombuffer(raw[p + 1 : p + 1 + stride], np.uint8).astype(np.int32)
        if filt == 1:  # Sub
            row = row.copy()
            for j in range(3, stride):
                row[j] = (row[j] + row[j - 3]) & 0xFF
        elif filt == 2:  # Up
            row = (row + prev) & 0xFF
        elif filt != 0:
            raise NotImplementedError(f"PNG filter {filt}")
        img[i] = row.astype(np.uint8)
        prev = row
        p += 1 + stride
    return img.reshape(h, w, 3)
