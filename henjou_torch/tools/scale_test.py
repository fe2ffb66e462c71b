"""Scale probe: a ~195k-triangle mesh at 1080p with two-sample MIS.

Port of tools/scale_test.py ("BASELINE config #4"). It renders a UV
sphere of 232 x 420 segments over a ground plane with one area light
(194,044 triangles) at 1920x1080, 2 spp, seed 3, on a 65,536-lane
wavefront pool with two-sample MIS (``mis_single=False``), in two rows:

- ``binned+bitonic``: the binned intersector (``csrc/binned.cu``) inside
  the bitonic sorted wrapper (``csrc/bitonic.cu``), the renderer's path;
- ``hbm sorted``: the two-level intersector (``csrc/cluster_hbm.cu``)
  inside the argsort wrapper `make_sorted_intersector`, with the scene
  box taken from the supercluster AABBs.

Each row renders once untimed, as the JAX script does for its compile,
so the timed render pays no first-use cost (CUDA context, lazy module
loading, the allocator's growth to the 1080p pool), then once timed. Each
row reports seconds, honest traces (radiance, shadow and branch rays) and
Mrays/s, and the run reports the RMSE between the two rows' per-pixel
means.

    python -m henjou_torch.tools.scale_test --device cuda

On CPU tensors the wrappers run the kernels' plain versions, which is
practical only at toy sizes (`run_scale_test`'s keyword arguments).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from henjou_torch.accel import bitonic, pallas_binned, pallas_cluster_hbm
from henjou_torch.accel.pallas_binned import pack_binned_np
from henjou_torch.accel.pallas_cluster_hbm import make_pallas_hbm_intersector, pack_clusters_hbm_np
from henjou_torch.accel.sorting import make_sorted_intersector, sorted_binned_intersector
from henjou_torch.bsdf.dispatch import bsdf_eval, bsdf_pdf, make_bsdf_sampler
from henjou_torch.integrator.payload import Sky
from henjou_torch.integrator.wavefront import wavefront_render
from henjou_torch.runtime.camera import make_camera
from henjou_torch.runtime.renderer import resolve_device
from henjou_torch.scene.scenedata import (
    SceneData,
    build_device_scene,
    build_frame_scene,
    make_material,
)

ROWS = ("binned+bitonic", "hbm sorted")
SEED = 3


def big_scene(lat=232, lon=420):
    """~195k-triangle UV sphere over a ground plane, 3 materials."""
    verts = []
    for i in range(lat + 1):
        th = np.pi * i / lat
        for j in range(lon):
            ph = 2 * np.pi * j / lon
            verts.append(
                [np.sin(th) * np.cos(ph), np.cos(th) + 1.2, np.sin(th) * np.sin(ph)]
            )
    verts = np.asarray(verts, np.float32)

    def vid(i, j):
        return i * lon + (j % lon)

    faces = []
    for i in range(lat):
        for j in range(lon):
            a, b, c, d = vid(i, j), vid(i, j + 1), vid(i + 1, j), vid(i + 1, j + 1)
            if i != 0:
                faces.append((a, b, c))
            if i != lat - 1:
                faces.append((b, d, c))
    faces = np.asarray(faces, np.uint32)

    # ground plane + area light
    base = len(verts)
    plane = np.asarray([[-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8]], np.float32)
    light = np.asarray([[-2, 6, -2], [2, 6, -2], [2, 6, 2], [-2, 6, 2]], np.float32)
    verts = np.concatenate([verts, plane, light])
    extra = np.asarray(
        [
            (base, base + 1, base + 2), (base, base + 2, base + 3),
            (base + 4, base + 6, base + 5), (base + 4, base + 7, base + 6),
        ],
        np.uint32,
    )
    tri = np.concatenate([faces, extra])
    n_mesh = len(faces)

    flat = verts[tri.reshape(-1)]
    e1 = flat.reshape(-1, 3, 3)
    fn = np.cross(e1[:, 1] - e1[:, 0], e1[:, 2] - e1[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    normals = np.repeat(fn[:, None, :], 3, axis=1).reshape(-1, 3)

    mats = [
        make_material("metal", base_color=(0.9, 0.7, 0.4), metallic=1.0, roughness=0.25),
        make_material("floor", base_color=(0.6, 0.6, 0.65), roughness=0.8),
        make_material("light", emission=(12.0, 12.0, 12.0), is_light=True),
    ]
    mat_ids = np.concatenate(
        [np.zeros(n_mesh, np.uint32), np.ones(2, np.uint32), np.full(2, 2, np.uint32)]
    )
    return SceneData(
        vertices=flat,
        indices=np.arange(len(flat), dtype=np.uint32),
        material_ids=mat_ids,
        normals=normals,
        texcoords=None,
        colors=None,
        materials=mats,
    )


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_rows(device, lat=232, lon=420, log=print):
    """The scale scene on `device` and both rows' traces: (scene facts,
    frame scene, {row: ((intersect_fn, occluded_fn), {name: kernel
    module})})."""
    t0 = time.perf_counter()
    scene = big_scene(lat, lon)
    frame = build_frame_scene(build_device_scene(scene, device))
    tv = frame.tri_verts.cpu().numpy()
    hc = pack_clusters_hbm_np(tv, device)
    a2 = hc.aabb2[:, : hc.num_super]
    lo, hi = a2[0:3].amin(dim=1), a2[3:6].amax(dim=1)
    bc = pack_binned_np(tv, device)
    _sync(device)
    info = dict(tris=len(scene.material_ids), clusters=hc.num_clusters, super=hc.num_super,
                binned_group=bc.group, binned_groups=bc.num_groups,
                build_s=time.perf_counter() - t0)
    log(f"[scale] scene: {info['tris']} tris, clusters={hc.num_clusters}, super={hc.num_super}, "
        f"binned group={bc.group} groups={bc.num_groups}, build {info['build_s']:.2f} s")
    rows = {
        "binned+bitonic": (
            sorted_binned_intersector(bc),
            {"bitonic": bitonic, "binned": pallas_binned},
        ),
        "hbm sorted": (
            make_sorted_intersector(*make_pallas_hbm_intersector(hc), lo, hi),
            {"cluster_hbm": pallas_cluster_hbm},
        ),
    }
    return info, frame, rows


def render_row(frame, fns, width=1920, height=1080, spp=2, lanes=1 << 16):
    """One two-sample MIS render of the scale scene through a row's
    (intersect_fn, occluded_fn); returns the film."""
    device = frame.tri_verts.device
    sky = Sky(constant_color=torch.tensor([0.4, 0.5, 0.7], device=device),
              intensity=torch.tensor(1.0, device=device))
    cam = make_camera((0.0, 2.2, -6.5), (0.0, -0.12, 1.0), np.radians(50.0), device)
    bs = make_bsdf_sampler(None, has_specular=False, has_sheen=False, has_clearcoat=False)

    def beval(h, wo, wi):
        return bsdf_eval(h, wo, wi, None, False, False)

    return wavefront_render(
        frame, sky, cam, width, height, spp, bs, bsdf_eval=beval, bsdf_pdf=bsdf_pdf,
        integrator="mis", seed=SEED, lanes=lanes, intersect_fn=fns[0], occluded_fn=fns[1],
        mis_single=False,
    )


def run_scale_test(device="cuda", width=1920, height=1080, spp=2, lanes=1 << 16,
                   lat=232, lon=420, log=print) -> dict:
    """Render the scale scene once untimed and once timed per row; returns
    the scene facts, and per row the timed render's seconds, traces,
    Mrays/s, mean film (a [H*W, 3] tensor of per-pixel means) and the
    launch counts of the row's kernels."""
    device = torch.device(device)
    info, frame, rows = build_rows(device, lat, lon, log)
    out = {"scene": info, "rows": {}}
    for name in ROWS:
        fns, mods = rows[name]
        render_row(frame, fns, width, height, spp, lanes)  # warm-up
        _sync(device)
        before = {k: m.LAUNCHES for k, m in mods.items()}
        t0 = time.perf_counter()
        film = render_row(frame, fns, width, height, spp, lanes)
        _sync(device)
        dt = time.perf_counter() - t0
        traces = int(film.n_traces)
        mean = film.color / film.count.clamp(min=1)[:, None]
        row = dict(seconds=dt, traces=traces, mrays=traces / dt / 1e6,
                   film_finite=bool(torch.isfinite(mean).all()), mean=mean,
                   launches={k: m.LAUNCHES - before[k] for k, m in mods.items()})
        out["rows"][name] = row
        log(f"[scale] {name:14s}: {dt:.3f} s for {spp} spp @{width}x{height}, "
            f"{traces / 1e6:.3f} Mtraces, {row['mrays']:.3f} Mrays/s, projected 256 spp = "
            f"{dt / spp * 256 / 60:.1f} min; film finite {row['film_finite']}, "
            f"launches {row['launches']}")
    a, b = (r["mean"] for r in out["rows"].values())
    out["rmse"] = float(torch.sqrt(((a - b) ** 2).mean()))
    log(f"[scale] RMSE between the rows' films: {out['rmse']:.4g} "
        f"(mean {float(a.mean()):.4f} vs {float(b.mean()):.4f})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="two-sample MIS scale probe (PyTorch/CUDA)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"[scale] device: {torch.cuda.get_device_name(device)}", flush=True)
    out = run_scale_test(device, log=lambda *a: print(*a, flush=True))
    return 0 if all(r["film_finite"] for r in out["rows"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
