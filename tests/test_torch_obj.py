"""The port's OBJ loader and its C decode loops.

- `load_obj` field-equal (no tolerance) to the JAX package's on
  scenes/cornelbox.obj and on a generated UV sphere of more than 10k
  triangles (tests/test_misc_parity.py:72);
- scenes/cornelbox_obj_option.json through the port's CLI on the CPU at
  32x32, 4 spp (tests/test_scene_files.py:80);
- the C library builds (a failed build raises), and its PNG unfilter and
  HDR decode are byte-equal to the port's pure-Python loops
  (tests/test_native_and_codecs.py:84, :91, :131).
"""

import dataclasses
import json
import os
import struct
import zlib

import numpy as np
import pytest

from henjou_torch import native, render
from henjou_torch.post.png import read_png, unfilter_plain
from henjou_torch.scene.obj import load_obj as t_load_obj
from henjou_torch.texture.hdr import decode_rgbe_plain, read_hdr
from henjou_tpu.scene.obj import load_obj as j_load_obj

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _big_sphere_obj(path, lat=64, lon=96):
    """A UV-sphere OBJ of 12,096 triangles (tests/test_misc_parity.py's)."""
    lines = ["o bigsphere"]
    for i in range(lat + 1):
        th = np.pi * i / lat
        for j in range(lon):
            ph = 2 * np.pi * j / lon
            lines.append(f"v {np.sin(th)*np.cos(ph):.6f} {np.cos(th):.6f} "
                         f"{np.sin(th)*np.sin(ph):.6f}")

    def vid(i, j):
        return i * lon + (j % lon) + 1

    for i in range(lat):
        for j in range(lon):
            a, b, c, d = vid(i, j), vid(i, j + 1), vid(i + 1, j), vid(i + 1, j + 1)
            if i != 0:
                lines.append(f"f {a} {b} {c}")
            if i != lat - 1:
                lines.append(f"f {b} {d} {c}")
    with open(path, "w") as f:
        f.write("\n".join(lines))


def _obj_paths(tmp_path):
    big = str(tmp_path / "sphere.obj")
    _big_sphere_obj(big)
    return [os.path.join(ROOT, "scenes", "cornelbox.obj"), big]


def test_load_obj_field_equal(tmp_path):
    for path in _obj_paths(tmp_path):
        js, ts = j_load_obj(path), t_load_obj(path)
        for f in ("vertices", "indices", "material_ids", "normals", "texcoords", "colors"):
            a, b = getattr(js, f), getattr(ts, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f"{path}: {f}")
        assert len(js.materials) == len(ts.materials)
        for mj, mt in zip(js.materials, ts.materials):
            assert mj.keys() == mt.keys()
            for k in mj:
                assert np.array_equal(np.asarray(mj[k]), np.asarray(mt[k])), (path, k)
        assert ([dataclasses.astuple(g) for g in js.geometries]
                == [dataclasses.astuple(g) for g in ts.geometries])
        assert ([dataclasses.astuple(i) for i in js.instances]
                == [dataclasses.astuple(i) for i in ts.instances])
        assert (js.textures, js.animations) == (ts.textures, ts.animations) == ([], [])
    assert len(ts.material_ids) > 10000


def test_cli_obj_option(tmp_path, monkeypatch):
    """The checked-in OBJ option file through the CLI at a toy size: a
    32x32 PNG with the light patch bright."""
    monkeypatch.chdir(ROOT)
    out = str(tmp_path / "obj")
    stats = str(tmp_path / "stats.json")
    assert render.main([os.path.join("scenes", "cornelbox_obj_option.json"), "--device", "cpu",
                        "--size", "32x32", "--spp", "4", "--out", out, "--stats", stats]) == 0
    img = read_png(out + "_000.png")
    assert img.shape[:2] == (32, 32)
    assert img.max() > 100  # the light patch
    with open(stats) as f:
        fr = json.load(f)["frames"][0]
    assert fr["spp"] == 4 and fr["film_finite"]


def test_native_library_builds():
    assert native.get_lib().png_unfilter is not None
    assert native.library_path().exists()


def test_failed_native_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CC", "false")
    native.get_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="cc failed"):
            native.get_lib()
    finally:
        native.get_lib.cache_clear()
    assert not list(tmp_path.glob("*.so"))


def _png_with_filters(img, filters):
    """A PNG of `img` with the given per-scanline filter types 0-3
    (tests/test_native_and_codecs.py's encoder)."""
    h, w, c = img.shape
    raw = b""
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        line = img[y].reshape(-1).astype(np.int32)
        f = filters[y % len(filters)]
        a = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        enc = {0: line, 1: line - a, 2: line - prev, 3: line - ((a + prev) // 2)}[f]
        raw += bytes([f]) + (enc & 0xFF).astype(np.uint8).tobytes()
        prev = line

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def test_png_decode_through_native(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(16, 11, 3), dtype=np.uint8)
    p = tmp_path / "f.png"
    p.write_bytes(_png_with_filters(img, [0, 1, 2, 3]))
    np.testing.assert_array_equal(read_png(str(p)), img)


@pytest.mark.parametrize("h,w,bypp", [(9, 7, 3), (13, 31, 4), (5, 64, 1), (3, 5, 2)])
def test_native_unfilter_equals_python(h, w, bypp):
    """Random scanlines with every filter type (0-4, Paeth included):
    the C loop and the Python loop agree byte for byte."""
    rng = np.random.default_rng(h * w)
    stride = w * bypp
    lines = rng.integers(0, 256, size=(h, stride + 1), dtype=np.uint8)
    lines[:, 0] = rng.integers(0, 5, size=h)
    lines[: min(h, 5), 0] = np.arange(min(h, 5))
    raw = lines.tobytes()
    np.testing.assert_array_equal(native.png_unfilter(raw, h, stride, bypp),
                                  unfilter_plain(raw, h, stride, bypp))
    with pytest.raises(ValueError):
        native.png_unfilter(raw[:-1], h, stride, bypp)


def _write_flat_hdr(path, rgb):
    """A flat (non-RLE) Radiance file (tests/test_native_and_codecs.py's
    writer)."""
    h, w, _ = rgb.shape
    maxv = rgb.max(axis=-1)
    nz = maxv > 1e-32
    exp = np.ceil(np.log2(np.where(nz, maxv, 1.0))).astype(np.int32) + 1
    mant = np.clip(rgb * np.where(nz, np.exp2(8.0 - exp), 0.0)[..., None], 0, 255).astype(np.uint8)
    e = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(np.concatenate([mant, e[..., None]], axis=-1).tobytes())


def _scanlines(path):
    """(the bytes after the resolution line, width, height)."""
    data = open(path, "rb").read()
    head = data.index(b"\n\n") + 2
    eol = data.index(b"\n", head)
    _, h, _, w = data[head:eol].split()
    return data[eol + 1:], int(w), int(h)


def test_native_hdr_equals_python(tmp_path):
    """The contest sky (new-style RLE) and a flat file: the C decode and
    the Python decode agree byte for byte, and read_hdr returns them."""
    rng = np.random.default_rng(4)
    base = rng.uniform(0.1, 20.0, size=(6, 16, 1))
    flat = str(tmp_path / "e.hdr")
    _write_flat_hdr(flat, (base * rng.uniform(0.5, 1.0, size=(6, 16, 3))).astype(np.float32))
    for path in (os.path.join(ROOT, "scenes", "rtcamp_sky.hdr"), flat):
        scan, w, h = _scanlines(path)
        got, want = native.hdr_decode(scan, w, h), decode_rgbe_plain(scan, w, h)
        assert got.dtype == want.dtype == np.float32 and got.shape == (h, w, 3)
        assert got.tobytes() == want.tobytes(), path
        assert read_hdr(path).tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        native.hdr_decode(scan[: len(scan) // 2], w, h)
