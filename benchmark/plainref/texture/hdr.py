"""Radiance .hdr (RGBE) decoder for IBL environment maps.

Port of henjou_tpu/texture/hdr.py: host numpy code, copied. The scanline
decode runs in C (`plainref.native.hdr_decode`); `decode_rgbe_plain`
is its pure-Python version, which the tests hold it to byte for byte.

Replaces stb_image's HDR path used by the reference's HDRTexture
(include/renderer/texture.h:42-169). Supports the common case: 32-bit_rle_rgbe,
-Y H +X W orientation, new-style scanline RLE.
"""

from __future__ import annotations

import numpy as np


def read_hdr(path: str) -> np.ndarray:
    """Decode to [H,W,3] float32 linear radiance."""
    with open(path, "rb") as f:
        data = f.read()

    # header
    pos = 0
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {path}")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    # resolution line
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation: {res}")
    height, width = int(res[1]), int(res[3])

    return decode_rgbe_plain(data[pos:], width, height)


def decode_rgbe_plain(scanlines: bytes, width: int, height: int) -> np.ndarray:
    """The scanlines after the header (new-style RLE or flat) -> [H,W,3]
    f32, in Python (the plain version of `plainref.native.hdr_decode`)."""
    raw = np.frombuffer(scanlines, np.uint8)
    img = np.zeros((height, width, 4), np.uint8)
    offs = 0
    for y in range(height):
        if (
            width >= 8
            and width < 32768
            and raw[offs] == 2
            and raw[offs + 1] == 2
            and ((int(raw[offs + 2]) << 8) | int(raw[offs + 3])) == width
        ):
            offs += 4
            # new-style RLE: 4 separately-encoded channel planes
            for c in range(4):
                x = 0
                while x < width:
                    count = int(raw[offs])
                    offs += 1
                    if count > 128:  # run
                        img[y, x : x + count - 128, c] = raw[offs]
                        offs += 1
                        x += count - 128
                    else:  # literal
                        img[y, x : x + count, c] = raw[offs : offs + count]
                        offs += count
                        x += count
        else:
            # flat scanline
            n = width * 4
            img[y] = raw[offs : offs + n].reshape(width, 4)
            offs += n

    rgbe = img.astype(np.float32)
    exp = np.ldexp(1.0, img[:, :, 3].astype(np.int32) - 136)  # 2^(e-128-8)
    rgb = rgbe[:, :, :3] * exp[:, :, None]
    rgb[img[:, :, 3] == 0] = 0.0
    return rgb.astype(np.float32)
