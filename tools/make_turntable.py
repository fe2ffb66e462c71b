"""Generate `scenes/rtcamp_turntable.gltf`, the contest scene with its
showcase objects keyframed: the scene of the benchmark's `rtcamp720turntable`
configuration and of the tests of the per-frame path (host pack, plan, device
refresh of the pack) at the contest scene's size, made from
`scenes/rtcamp.gltf` and its `rtcamp.bin`. Its motion is this repo's own,
not a published animation, and the objects are tessellated spheres, so the
turn shows in the tessellation only; every triangle still moves every frame.

    python tools/make_turntable.py [--scenes DIR] [--out DIR]

The contest scene is one mesh node of 130 primitives and an animated
camera. Here its 64 showcase objects become 64 keyframed nodes on a
turntable, each turning about the vertical axis through its own centre and
bobbing in place; the floor, the 64 pedestals and the light stay one static
node, and the camera node (last) keeps its rotation channel. Frame 0's
transforms are the identity, so its world triangles are the contest
scene's.

Buffer 0 is `rtcamp.bin` by URI: the geometry is not copied. The keys live
in a second buffer, `rtcamp_turntable.bin`: one shared time accessor, one
rotation accessor per turning direction, one translation accessor per
object. Keys sit at every frame time j / FPS for j = 0..KEY_FRAMES, so the
renderer samples each frame at a key and the pivot holds exactly, and any
two consecutive frames up to KEY_FRAMES differ.

Needs only numpy; the output is the same bytes on every run.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "rtcamp.gltf"
OUT = "rtcamp_turntable.gltf"
OUT_BIN = "rtcamp_turntable.bin"
# materials of the static node's primitives
STATIC_MATERIALS = ("floor", "pedestal", "light")
FPS = 24
KEY_FRAMES = 1440  # keys through 60 s
SPIN_DEG_PER_S = 36.0  # object k turns one way for even k, the other for odd
BOB = 0.2  # scene units: b(t) = BOB sin(pi t)

_DTYPES = {5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


def _accessor(doc: dict, bins: list, idx: int) -> np.ndarray:
    """Accessor `idx` as [count, ncomp] (tightly packed views only)."""
    acc = doc["accessors"][idx]
    bv = doc["bufferViews"][acc["bufferView"]]
    dtype = np.dtype(_DTYPES[acc["componentType"]])
    ncomp = _NCOMP[acc["type"]]
    if bv.get("byteStride", dtype.itemsize * ncomp) != dtype.itemsize * ncomp:
        raise ValueError(f"accessor {idx}: strided views are not read here")
    off = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    return np.frombuffer(bins[bv["buffer"]], dtype, acc["count"] * ncomp, off).reshape(-1, ncomp)


def object_centre(doc: dict, bins: list, prim: dict) -> np.ndarray:
    """The mean of a primitive's triangle vertices (each corner counted
    once per triangle), in float64."""
    pos = _accessor(doc, bins, prim["attributes"]["POSITION"]).astype(np.float64)
    idx = _accessor(doc, bins, prim["indices"]).reshape(-1).astype(np.int64)
    return pos[idx].mean(axis=0)


def key_times() -> np.ndarray:
    return np.arange(KEY_FRAMES + 1, dtype=np.float64) / FPS


def spin(t: np.ndarray, direction: int):
    """(quaternions [n, 4] xyzw, rotation matrices [n, 3, 3]) about +y."""
    theta = direction * np.deg2rad(SPIN_DEG_PER_S) * t
    c, s = np.cos(theta), np.sin(theta)
    q = np.stack([np.zeros_like(t), np.sin(theta / 2), np.zeros_like(t), np.cos(theta / 2)], 1)
    zero, one = np.zeros_like(t), np.ones_like(t)
    rot = np.stack([np.stack([c, zero, s], 1), np.stack([zero, one, zero], 1),
                    np.stack([-s, zero, c], 1)], 1)
    return q, rot


def translations(t: np.ndarray, rot: np.ndarray, centre: np.ndarray) -> np.ndarray:
    """c + b(t) y - R(t) c: the object turns about the vertical through c
    and rises by b(t)."""
    bob = BOB * np.sin(np.pi * t)
    return centre[None] + bob[:, None] * np.array([0.0, 1.0, 0.0]) - rot @ centre


def build(doc: dict, bins: list):
    """(the turntable glTF document, its key buffer's bytes)."""
    mats = doc["materials"]
    (mesh,) = doc["meshes"]
    static = [p for p in mesh["primitives"] if mats[p["material"]]["name"] in STATIC_MATERIALS]
    objects = [p for p in mesh["primitives"] if mats[p["material"]]["name"] not in STATIC_MATERIALS]
    cams = [n for n in doc["nodes"] if "camera" in n]
    if len(objects) != 64 or len(cams) != 1 or len(doc["nodes"]) != 2:
        raise ValueError("expected the contest scene: one mesh node of 64 objects, one camera")
    cam_node = doc["nodes"].index(cams[0])

    out = {k: v for k, v in doc.items() if k not in ("meshes", "nodes", "scenes", "animations")}
    out["asset"] = dict(doc["asset"], generator="tools/make_turntable.py")
    out["bufferViews"] = list(doc["bufferViews"])
    out["accessors"] = list(doc["accessors"])
    blob = bytearray()

    def add(arr: np.ndarray, kind: str, minmax: bool = False) -> int:
        arr = np.ascontiguousarray(arr, np.float32)
        out["bufferViews"].append({"buffer": len(doc["buffers"]), "byteOffset": len(blob),
                                   "byteLength": arr.nbytes})
        blob.extend(arr.tobytes())
        acc = {"bufferView": len(out["bufferViews"]) - 1, "componentType": 5126,
               "count": int(arr.shape[0]), "type": kind}
        if minmax:
            acc["min"] = [float(arr.min())]
            acc["max"] = [float(arr.max())]
        out["accessors"].append(acc)
        return len(out["accessors"]) - 1

    t = key_times()
    t_acc = add(t, "SCALAR", minmax=True)
    rots = {}
    for direction in (1, -1):
        q, rot = spin(t, direction)
        rots[direction] = (add(q, "VEC4"), rot)

    meshes = [{"name": "static", "primitives": static}]
    nodes = [{"mesh": 0, "name": "static"}]
    samplers, channels = [], []
    for k, prim in enumerate(objects):
        direction = 1 if k % 2 == 0 else -1
        q_acc, rot = rots[direction]
        tr_acc = add(translations(t, rot, object_centre(doc, bins, prim)), "VEC3")
        node = len(nodes)
        name = mats[prim["material"]]["name"]
        meshes.append({"name": name, "primitives": [prim]})
        nodes.append({"mesh": len(meshes) - 1, "name": name})
        for path, acc in (("rotation", q_acc), ("translation", tr_acc)):
            samplers.append({"input": t_acc, "output": acc, "interpolation": "LINEAR"})
            channels.append({"sampler": len(samplers) - 1, "target": {"node": node, "path": path}})
    nodes.append(dict(doc["nodes"][cam_node]))
    camera_anims = []
    for anim in doc.get("animations", []):
        anim = json.loads(json.dumps(anim))
        for ch in anim["channels"]:
            if ch["target"]["node"] != cam_node:
                raise ValueError("expected only the camera to be animated")
            ch["target"]["node"] = len(nodes) - 1
        camera_anims.append(anim)

    out["buffers"] = doc["buffers"] + [{"uri": OUT_BIN, "byteLength": len(blob)}]
    out["meshes"] = meshes
    out["nodes"] = nodes
    out["scenes"] = [{"nodes": list(range(len(nodes)))}]
    out["scene"] = 0
    out["animations"] = camera_anims + [{"name": "turntable", "samplers": samplers,
                                         "channels": channels}]
    return out, bytes(blob)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", default=os.path.join(ROOT, "scenes"),
                    help="directory holding rtcamp.gltf and rtcamp.bin")
    ap.add_argument("--out", default=None, help="output directory (default: --scenes)")
    args = ap.parse_args(argv)
    with open(os.path.join(args.scenes, SRC)) as f:
        doc = json.load(f)
    bins = []
    for b in doc["buffers"]:
        with open(os.path.join(args.scenes, b["uri"]), "rb") as f:
            bins.append(f.read())
    out, blob = build(doc, bins)
    dest = args.out or args.scenes
    os.makedirs(dest, exist_ok=True)
    with open(os.path.join(dest, OUT), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    with open(os.path.join(dest, OUT_BIN), "wb") as f:
        f.write(blob)
    print(f"wrote {os.path.join(dest, OUT)} ({len(out['nodes'])} nodes) and "
          f"{os.path.join(dest, OUT_BIN)} ({len(blob)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
