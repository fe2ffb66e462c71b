"""The C decode loops of the host pipeline (port of henjou_tpu/native).

``fastloader.c`` (a copy of the JAX package's) holds the serial parts of
asset decode: PNG scanline unfiltering and Radiance HDR run-length
decoding with the RGBE to float conversion. It is compiled on first use
with the system C compiler into ``build/henjou_torch/`` at the repository
root, named by a hash of the source and the flags, and loaded through
ctypes:

    cc -O2 -fPIC -shared -o libhenjou_fastloader_<hash>.so fastloader.c -lm

There is no fallback: a failed build raises with the compiler's output.
The pure-Python loops (`henjou_torch.post.png.unfilter_plain`,
`henjou_torch.texture.hdr.decode_rgbe_plain`) are the plain versions the
tests compare these against, byte for byte.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from henjou_torch.csrc import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "fastloader.c"
CFLAGS = ("-O2", "-fPIC", "-shared")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return BUILD_DIR / f"libhenjou_fastloader_{h.hexdigest()[:16]}.so"


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The compiled library; builds it when this source hash has none.
    Raises RuntimeError when the compiler fails."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            tmp = work / "lib.so"
            cmd = [os.environ.get("CC", "cc"), *CFLAGS, "-o", str(tmp), str(SOURCE), "-lm"]
            p = subprocess.run(cmd, capture_output=True, text=True)
            if p.returncode != 0:
                raise RuntimeError(f"cc failed ({p.returncode}): {' '.join(cmd)}\n"
                                   f"{p.stdout}\n{p.stderr}")
            os.replace(tmp, path)  # atomic: concurrent builds race harmlessly
        finally:
            shutil.rmtree(work, ignore_errors=True)
    lib = ctypes.CDLL(str(path))
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int]
    lib.hdr_decode_rle.restype = ctypes.c_int64
    lib.hdr_decode_rle.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_int64]
    lib.rgbe_to_float.restype = None
    lib.rgbe_to_float.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    return lib


def png_unfilter(raw: bytes, h: int, stride: int, bypp: int) -> np.ndarray:
    """PNG scanline reconstruction of the decompressed IDAT stream `raw`
    (one filter byte and `stride` bytes per scanline) -> [h, stride] u8."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"PNG stream holds {len(raw)} bytes, {h} scanlines need "
                         f"{h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    if get_lib().png_unfilter(raw, out.ctypes.data, h, stride, bypp) != 0:
        raise ValueError("bad PNG filter type")
    return out


def hdr_decode(raw: bytes, w: int, h: int) -> np.ndarray:
    """Radiance scanlines (new-style RLE or flat) after the header ->
    [h, w, 3] f32 linear radiance."""
    lib = get_lib()
    rgbe = np.empty((h, w, 4), np.uint8)
    if lib.hdr_decode_rle(raw, len(raw), rgbe.ctypes.data, w, h) < 0:
        raise ValueError("corrupt HDR RLE stream")
    rgb = np.empty((h, w, 3), np.float32)
    lib.rgbe_to_float(rgbe.ctypes.data, rgb.ctypes.data, w * h)
    return rgb
