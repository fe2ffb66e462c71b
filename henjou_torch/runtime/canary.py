"""Known-answer hardware canary (port of henjou_tpu/runtime/canary.py).

Renders a tiny known-answer frame through the production stack (the
wavefront engine with two-sample MIS, the binned intersector inside the
bitonic sorted wrapper) and holds every pixel against a pinned film, so a
kernel, CUDA runtime or compiler that renders quietly wrong fails at
render start instead of spending the budget on a wrong image.

The pinned film (`canary_film.npy` beside this file) is a byte copy of
the JAX package's pin, `henjou_tpu/runtime/canary_film.npy`: the port's
plain versions render it on the CPU to within CANARY_RMSE_TOL
(tests/test_torch_canary.py). If the pin ever changes, copy that file
again. On CUDA the kernels render it; atomic film sums and a rare
ulp-level hit flip stay far inside the tolerance.

    python -m henjou_torch.runtime.canary --device cuda
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

log = logging.getLogger("henjou_torch")

PIN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "canary_film.npy")
CANARY_RMSE_TOL = 5e-3
SPP = 4


def canary_film(device) -> np.ndarray:
    """16x16, 4-spp two-sample MIS render of the sphere gallery through the
    production stack, seed 11, 1024 lanes, depth 4. Returns the [256, 3]
    mean-colour film."""
    from henjou_torch.accel.pallas_binned import pack_binned_np
    from henjou_torch.accel.sorting import sorted_binned_intersector
    from henjou_torch.bsdf.dispatch import bsdf_eval, bsdf_pdf, make_bsdf_sampler
    from henjou_torch.integrator.payload import Sky
    from henjou_torch.integrator.wavefront import wavefront_render
    from henjou_torch.runtime.camera import make_camera
    from henjou_torch.scene.scenedata import build_device_scene, build_frame_scene
    from henjou_torch.scene.testscenes import sphere_gallery_scene

    dev = torch.device(device)
    frame = build_frame_scene(build_device_scene(sphere_gallery_scene(), dev))
    pc = pack_binned_np(frame.tri_verts.cpu().numpy(), dev)
    ifn, ofn = sorted_binned_intersector(pc)
    sky = Sky(constant_color=torch.tensor([0.3, 0.4, 0.55], device=dev),
              intensity=torch.tensor(1.0, device=dev))
    cam = make_camera((0.0, 1.2, -9.0), (0.0, -0.05, 1.0), np.radians(45.0), dev)
    film = wavefront_render(
        frame, sky, cam, 16, 16, SPP, make_bsdf_sampler(None),
        bsdf_eval=lambda h, wo, wi: bsdf_eval(h, wo, wi, None), bsdf_pdf=bsdf_pdf,
        integrator="mis", seed=11, lanes=1024, max_depth=4, intersect_fn=ifn,
        occluded_fn=ofn, mis_single=False,
    )
    return (film.color / SPP).cpu().numpy()


def canary_check(device="cuda", strict: bool = True) -> dict:
    """Render the canary on `device` and compare it per pixel with the
    pinned film. Returns {'ok', 'rmse', 'mean'}; raises on failure when
    strict."""
    pinned = np.load(PIN_PATH)
    film = canary_film(device)
    rmse = float(np.sqrt(np.mean((film - pinned) ** 2)))
    ok = bool(np.isfinite(rmse) and rmse <= CANARY_RMSE_TOL)
    log.info("canary [%s]: per-pixel rmse %.2e vs pinned film (tol %.0e) -> %s",
             device, rmse, CANARY_RMSE_TOL, "OK" if ok else "FAIL")
    if strict and not ok:
        worst = int(np.argmax(np.sum((film - pinned) ** 2, axis=1)))
        raise RuntimeError(
            f"hardware canary failed on {device}: per-pixel rmse {rmse:.3e} > "
            f"{CANARY_RMSE_TOL} (worst pixel {worst}: {film[worst]} vs pinned "
            f"{pinned[worst]})"
        )
    return {"ok": ok, "rmse": rmse, "mean": film.mean(axis=0)}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="Render the hardware canary")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(canary_check(args.device, strict=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
