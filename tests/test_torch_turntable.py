"""The animated contest scene and the per-frame path it drives.

- `scenes/rtcamp_turntable.gltf` (made by `tools/make_turntable.py`): 65
  instances over the contest scene's 254,740 triangles; frame 0's world
  triangles are the contest scene's; every object turns and bobs about its
  own vertical, so its vertex mean keeps x and z; consecutive frames'
  transform sets differ through frame 1,440; the generator reproduces the
  files byte for byte.
- The port against the benchmark's plain reference (`benchmark/plainref`)
  on a seeded random animated scene of three instances, more than 256
  triangles, so frame 0 packs on the host, frame 1 plans the cluster order
  and frames 1-3 refresh the pack: films and DenoiseTemporal's finalized
  frames agree pixel for pixel under the benchmark check's rule, counts
  exactly, and the spans show one host pack, one plan and the refreshes.
  A stale pack (frame 1's handed back for frames 2 and 3) disagrees.
- On the card (marked `cuda`, skipped without one): the same comparison
  under the contest cell's limits, for the random scene and for the
  turntable scene at 1280x720, 2 spp, frames 0-3 (the binned kernel over
  each refreshed pack), and the stale pack over those limits. Run there
  without the tests directory's conftest, which imports jax:

      python -m pytest tests/test_torch_turntable.py -m cuda --noconftest -q
"""

import base64
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from henjou_torch.runtime.renderer import Renderer
from henjou_torch.scene.gltf import load_gltf
from henjou_torch.scene.scenedata import build_frame_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
SCENES = os.path.join(ROOT, "scenes")
# the benchmark's check: a value is off by more than ATOL + RTOL |reference|
ATOL, RTOL = 1e-4, 1e-3
FPS = 24
KEY_FRAMES = 1440

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def turntable():
    """(renderer over the turntable scene on the CPU, the scene)."""
    scene = load_gltf(os.path.join(SCENES, "rtcamp_turntable.gltf"))
    r = Renderer(device="cpu").set_scene(scene).build()
    return r, scene


def _world(r, frame: int) -> np.ndarray:
    xf, inv = r._frame_transforms(frame / FPS)
    fs = build_frame_scene(r.device_scene, torch.as_tensor(xf), torch.as_tensor(inv))
    return fs.tri_verts.numpy()


def _ranges(r):
    offs = r.device_scene.prim_offsets.numpy()
    return list(zip(offs, np.diff(np.append(offs, int(r.device_scene.tri_vidx.shape[0])))))


def test_turntable_scene_shape(turntable):
    r, scene = turntable
    assert len(scene.instances) == 65 and len(scene.material_ids) == 254_740
    counts = [int(c) for _, c in _ranges(r)]
    # the static node (floor, 64 pedestals, light), then 64 objects
    assert counts == [788] + [3968] * 64
    assert scene.camera_animation_id == 65


def test_frame0_is_the_contest_scene(turntable):
    r, _ = turntable
    contest = load_gltf(os.path.join(SCENES, "rtcamp.gltf"))
    want = contest.vertices.reshape(-1, 9)
    got = _world(r, 0).reshape(-1, 9)

    def rows(a):
        return a[np.lexsort(a.T[::-1])]

    assert np.array_equal(rows(got), rows(want))


def test_objects_turn_in_place_and_every_frame_moves(turntable):
    r, _ = turntable
    objects = _ranges(r)[1:]

    def means(frame):
        w = _world(r, frame).astype(np.float64)
        return np.stack([w[s:s + c].reshape(-1, 3).mean(axis=0) for s, c in objects])

    rest = means(0)
    for frame in (1, 2, 3):
        m = means(frame)
        np.testing.assert_allclose(m[:, [0, 2]], rest[:, [0, 2]], rtol=0, atol=1e-4)
        # the bob, b(t) = 0.2 sin(pi t)
        np.testing.assert_allclose(m[:, 1] - rest[:, 1], 0.2 * np.sin(np.pi * frame / FPS),
                                   rtol=0, atol=1e-4)
    sets = [r._frame_transforms(f / FPS)[0] for f in (0, 1, 2, 3, KEY_FRAMES - 1, KEY_FRAMES)]
    for a, b in zip(sets, sets[1:]):
        assert a.tobytes() != b.tobytes()


def test_keys_reach_frame_1440(turntable):
    _, scene = turntable
    for inst in scene.instances[1:]:
        anim = scene.animations[inst.animation_id]
        for track in (anim.translation, anim.rotation):
            assert len(track.keys) == 1 + KEY_FRAMES + 1  # the base pose, then the keys
            assert track.keys[-1] == pytest.approx(KEY_FRAMES / FPS)


def test_generator_reproduces_the_files(tmp_path):
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_turntable.py"),
                    "--out", str(tmp_path)], check=True, capture_output=True)
    for name in ("rtcamp_turntable.gltf", "rtcamp_turntable.bin"):
        with open(os.path.join(SCENES, name), "rb") as f, open(tmp_path / name, "rb") as g:
            assert f.read() == g.read(), name


# ---------------- the port against the plain reference ----------------

SPP = 2
WIDTH, HEIGHT = 32, 18
N_FRAMES = 4


def _random_scene_gltf(path, seed=11):
    """Three mesh nodes of random triangles (a floor quad under the first,
    a glass primitive in the second, an emissive one in the third), each
    on random translation, rotation and scale keys."""
    rng = np.random.default_rng(seed)
    blob = bytearray()
    views, accessors = [], []

    def add(arr, kind, comp, minmax=False):
        arr = np.ascontiguousarray(arr)
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": arr.nbytes})
        blob.extend(arr.tobytes())
        acc = {"bufferView": len(views) - 1, "componentType": comp,
               "count": int(arr.shape[0]), "type": kind}
        if minmax:
            acc.update(min=arr.min(axis=0).tolist(), max=arr.max(axis=0).tolist())
        accessors.append(acc)
        return len(accessors) - 1

    def prim(tris, material):
        pos = tris.reshape(-1, 3).astype(np.float32)
        idx = np.arange(len(pos), dtype=np.uint32)
        return {"attributes": {"POSITION": add(pos, "VEC3", 5126, minmax=True)},
                "indices": add(idx, "SCALAR", 5125), "material": material}

    def blob_tris(centre, n, size=0.35):
        c = centre + rng.uniform(-0.5, 0.5, (n, 1, 3))
        return c + rng.normal(scale=size, size=(n, 3, 3))

    floor = np.array([[[-4, -0.8, -3], [4, -0.8, -3], [4, -0.8, 4]],
                      [[-4, -0.8, -3], [4, -0.8, 4], [-4, -0.8, 4]]], np.float64)
    meshes = [
        {"primitives": [prim(floor, 0), prim(blob_tris(np.array([-1.3, 0.3, 0.5]), 110), 1)]},
        {"primitives": [prim(blob_tris(np.array([0.0, 0.4, 0.8]), 100), 2)]},
        {"primitives": [prim(blob_tris(np.array([1.3, 0.3, 0.5]), 90), 1),
                        prim(blob_tris(np.array([0.4, 1.9, 0.6]), 6, 0.2), 3)]},
    ]
    times = np.array([0.0, 0.05, 0.1, 0.15, 0.2], np.float32)
    t_acc = add(times, "SCALAR", 5126, minmax=True)
    samplers, channels = [], []
    for node in range(3):
        q = np.concatenate([rng.normal(scale=0.15, size=(len(times), 3)),
                            np.ones((len(times), 1))], axis=1)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        keys = {"translation": rng.normal(scale=0.2, size=(len(times), 3)),
                "rotation": q, "scale": rng.uniform(0.85, 1.15, (len(times), 3))}
        for p, val in keys.items():
            out = add(val.astype(np.float32), "VEC4" if p == "rotation" else "VEC3", 5126)
            samplers.append({"input": t_acc, "output": out, "interpolation": "LINEAR"})
            channels.append({"sampler": len(samplers) - 1, "target": {"node": node, "path": p}})

    def pbr(color, rough, **ext):
        m = {"pbrMetallicRoughness": {"baseColorFactor": color + [1.0],
                                      "roughnessFactor": rough, "metallicFactor": 0.0}}
        if ext:
            m["extensions"] = ext
        return m

    light = dict(pbr([0.8, 0.8, 0.8], 0.5), emissiveFactor=[1.0, 0.9, 0.8])
    light["extensions"] = {"KHR_materials_emissive_strength": {"emissiveStrength": 12.0}}
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(bytes(blob)).decode(), "byteLength": len(blob)}],
        "bufferViews": views, "accessors": accessors, "meshes": meshes,
        "materials": [pbr([0.7, 0.7, 0.7], 0.8), pbr([0.8, 0.3, 0.2], 0.4),
                      pbr([1.0, 1.0, 1.0], 0.0,
                          KHR_materials_transmission={"transmissionFactor": 1.0},
                          KHR_materials_ior={"ior": 1.5}),
                      light],
        "nodes": [{"mesh": 0}, {"mesh": 1}, {"mesh": 2}],
        "scenes": [{"nodes": [0, 1, 2]}], "scene": 0,
        "animations": [{"samplers": samplers, "channels": channels}],
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def _option(tmp_path):
    _random_scene_gltf(tmp_path / "animated.gltf")
    opt = {
        "Image": {"image_width": WIDTH, "image_height": HEIGHT, "image_name": "animated",
                  "image_directory": str(tmp_path) + "/", "max_spp": SPP},
        "Render_mode": "DenoiseTemporal",
        "GLTF_file": {"gltf_filepath": str(tmp_path) + "/", "gltf_filename": "animated.gltf"},
        "Camera": {"allow_camera_animation": True, "camera_position": [0.0, 1.2, -4.5],
                   "camera_direction": [0.0, -0.15, 1.0], "camera_fov": 45.0},
        "Animation": {"fps": FPS, "start_frame": 0, "end_frame": N_FRAMES,
                      "time_limit": 1e9},
        "Sky": {"IBL_path": "", "IBL_intensity": 1.0, "use_IBL": False,
                "scene_sky_default": [0.2, 0.25, 0.35]},
        "TPU": {"spp_batch": 16, "integrator": "mis", "seed": 12345},
    }
    path = tmp_path / "option.json"
    with open(path, "w") as f:
        json.dump(opt, f)
    return str(path)


def _off(prog, ref):
    prog = np.asarray(prog, np.float64).reshape(ref.shape[0], -1)
    ref = np.asarray(ref, np.float64).reshape(ref.shape[0], -1)
    return (~np.isfinite(prog) | (np.abs(prog - ref) > ATOL + RTOL * np.abs(ref))).any(axis=1)


def _bench(module: str):
    """A module of the benchmark (`plainref`, `hbench`), which imports
    nothing of the program."""
    import importlib

    sys.path.insert(0, BENCH)
    try:
        return importlib.import_module(module)
    finally:
        sys.path.remove(BENCH)


def _render(opt_path, device, profiled=False):
    """The port's frames of the option: (films by frame, finalized images
    by frame, frame_stats)."""
    r = Renderer(device=device)
    films, images = {}, {}
    render, finalize = r.render_frame, r._finalize

    def render_frame(frame, *a, **k):
        films[frame] = render(frame, *a, **k)
        return films[frame]

    def finalize_frame(aovs, frame=None):
        images[frame] = finalize(aovs, frame=frame)
        return images[frame]

    r.render_frame, r._finalize = render_frame, finalize_frame
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            r.initialize_and_render(opt_path)
    else:
        r.initialize_and_render(opt_path)
    return films, images, r.frame_stats


def _stale_pack(monkeypatch):
    """Break the refresh underneath: the pack of the first refresh (frame
    1) is handed back for every later frame, so frames 2 on trace frame
    1's geometry while shading their own."""
    from henjou_torch.accel import pallas_binned

    build = pallas_binned.build_binned_from_order
    first = []

    def stale(*a, **k):
        if not first:
            first.append(build(*a, **k))
        return first[0]

    monkeypatch.setattr(pallas_binned, "build_binned_from_order", stale)
    return first


def _check(opt_path, device, films, images, pick):
    """The benchmark check's numbers (`hbench.check`) of the port's frames
    against `plainref` on `device`: the films at the pixels pick(frame),
    every finalized frame whole."""
    check, reference = _bench("hbench.check"), _bench("hbench.reference")
    ref = _bench("plainref.render").PlainRenderer(opt_path, device)
    spp = int(json.load(open(opt_path))["Image"]["max_spp"])
    samples = {}
    for f, aovs in films.items():
        flat = {k: np.asarray(aovs[k]) for k in ("color", "albedo", "normal", "count")}
        samples[f] = {k: a.reshape(a.shape[0] * a.shape[1], -1)[pick(f)] for k, a in flat.items()}
    want = reference.reference_films(ref, sorted(films), pick, "wavefront", spp)
    finals = reference.reference_finals(ref, {
        f: {k: a.get(k) for k in ("color", "albedo", "normal", "variance", "count")}
        for f, a in films.items()})
    return {**check.film_numbers(samples, want), **check.final_numbers(images, finals)}


@pytest.fixture(scope="module")
def animated_run(tmp_path_factory):
    """The port's frames 0-3 under a CPU profiler: (option path, films by
    frame, finalized images by frame, frame_stats)."""
    opt_path = _option(tmp_path_factory.mktemp("animated"))
    return (opt_path, *_render(opt_path, "cpu", profiled=True))


def test_spans_show_pack_plan_and_refreshes(animated_run):
    *_, stats = animated_run
    assert [s["frame"] for s in stats] == list(range(N_FRAMES))
    names = [[n for n, *_ in s.get("spans", [])] for s in stats]
    assert [n.count("accel.pack") for n in names] == [1, 0, 0, 0]
    assert [n.count("accel.plan") for n in names] == [0, 1, 0, 0]
    assert [n.count("accel.refresh") for n in names] == [0, 1, 1, 1]
    for s in stats:
        spans = s["spans"]
        for name, parent, _, _ in spans:
            if name in ("accel.pack", "accel.plan", "accel.refresh"):
                assert spans[parent][0] in ("frame.scene", "finalize.probe"), name


def test_port_matches_plain_reference(animated_run):
    opt_path, films, images, _ = animated_run
    ref = _bench("plainref.render").PlainRenderer(opt_path, "cpu")
    pix = np.arange(WIDTH * HEIGHT)
    state = {}
    for frame in range(N_FRAMES):
        got = films[frame]
        want = ref.film(frame, pix, SPP, "wavefront")
        for k in ("color", "albedo", "normal"):
            off = _off(got[k].reshape(-1, 3), want[k].reshape(-1, 3))
            assert not off.any(), (frame, k, int(off.sum()))
        np.testing.assert_array_equal(got["count"].reshape(-1), want["count"].reshape(-1))
        film = {k: got.get(k) for k in ("color", "albedo", "normal", "variance", "count")}
        final, state = ref.finalize(frame, film, state)
        off = _off(images[frame].reshape(-1, 3), final.reshape(-1, 3))
        assert not off.any(), (frame, "final", int(off.sum()))


def test_stale_pack_disagrees_with_plain_reference(tmp_path, monkeypatch):
    """The comparison above has teeth: with the stale pack the films of
    frames 0-1 still agree with the reference, those of frames 2-3 do not."""
    opt_path = _option(tmp_path)
    first = _stale_pack(monkeypatch)
    films, _, _ = _render(opt_path, "cpu")
    assert len(first) == 1
    ref = _bench("plainref.render").PlainRenderer(opt_path, "cpu")
    pix = np.arange(WIDTH * HEIGHT)
    for frame in range(N_FRAMES):
        want = ref.film(frame, pix, SPP, "wavefront")
        off = np.zeros(pix.size, bool)
        for k in ("color", "albedo", "normal"):
            off |= _off(films[frame][k].reshape(-1, 3), want[k].reshape(-1, 3))
        if frame < 2:
            assert not off.any(), (frame, int(off.sum()))
        else:
            assert off.mean() > 0.02, (frame, int(off.sum()))


# ---------------- on the card ----------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the binned kernel has no CPU mode)")
    return "cuda"


def _contest_limits():
    with open(os.path.join(BENCH, "workloads", "rtcamp720.contest.json")) as f:
        return json.load(f)["limits"]


def _turntable_option(tmp_path):
    """scenes/rtcamp_turntable_720_option.json at 2 spp, frames 0-3, its
    paths made absolute."""
    with open(os.path.join(SCENES, "rtcamp_turntable_720_option.json")) as f:
        opt = json.load(f)
    opt["Image"].update(max_spp=2, image_directory=str(tmp_path) + "/")
    opt["GLTF_file"]["gltf_filepath"] = SCENES + "/"
    opt["Sky"]["IBL_path"] = os.path.join(SCENES, os.path.basename(opt["Sky"]["IBL_path"]))
    opt["Animation"].update(end_frame=N_FRAMES, time_limit=1e9)
    opt.setdefault("TPU", {})["seed"] = 2**31 + 77
    path = tmp_path / "option.json"
    with open(path, "w") as f:
        json.dump(opt, f)
    return str(path)


def _seeded_pick(n_pixels, count):
    rng = np.random.default_rng(2**31 + 5)
    picks = {f: np.sort(rng.choice(n_pixels, size=min(count, n_pixels), replace=False))
             for f in range(N_FRAMES)}
    return picks.__getitem__


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["random3", "turntable"])
def test_port_matches_plain_reference_on_the_card(cuda, tmp_path, scene):
    """Frames 0-3 on the card, each later pack refreshed on the device and
    traced by the binned kernel, against `plainref` on the card, under the
    contest cell's limits; frame 0 packs on the host, frame 1 plans."""
    if scene == "random3":
        opt_path, pick = _option(tmp_path), _seeded_pick(WIDTH * HEIGHT, WIDTH * HEIGHT)
    else:
        opt_path, pick = _turntable_option(tmp_path), _seeded_pick(1280 * 720, 512)
    films, images, stats = _render(opt_path, cuda, profiled=True)
    names = [[n for n, *_ in s.get("spans", [])] for s in stats]
    assert [(n.count("accel.pack"), n.count("accel.plan"), n.count("accel.refresh"))
            for n in names] == [(1, 0, 0), (0, 1, 1), (0, 0, 1), (0, 0, 1)]
    numbers = _check(opt_path, cuda, films, images, pick)
    for name, limit in _contest_limits().items():
        assert numbers[name] <= limit, (name, numbers)


@pytest.mark.cuda
def test_stale_pack_fails_the_contest_limits_on_the_card(cuda, tmp_path, monkeypatch):
    opt_path = _option(tmp_path)
    first = _stale_pack(monkeypatch)
    films, images, _ = _render(opt_path, cuda)
    assert len(first) == 1
    numbers = _check(opt_path, cuda, films, images, _seeded_pick(WIDTH * HEIGHT, WIDTH * HEIGHT))
    assert numbers["film_mismatch_pct"] > _contest_limits()["film_mismatch_pct"], numbers
