"""Quality per second on the contest-class scene.

Port of bench.py `_quality_row`: the 720p `rtcamp_scene` (~255k triangles,
the wavefront engine with one-sample MIS, firefly clamp 64) rendered once
as a warm-up under a 0.5 s deadline, then under a 60 s deadline, then
filtered by `denoise_atrous_var` with demodulation. It prints one JSON
line: `rtcamp720_60s_svgf_rmse`, the RMSE of the filtered frame against
the pinned 512-spp truth `tests/golden/gt_rtcamp720.npz` (linear HDR), the
raw frame's RMSE, the spp reached and the render's seconds. It prints no
`vs_baseline`: bench.py's baseline is a TPU's number.

    python -m henjou_torch.tools.quality --device cuda

On the CPU it is practical only at toy sizes (`quality_row`'s keyword
arguments, with a truth of that size).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

GT_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                       "tests", "golden", "gt_rtcamp720.npz")


def quality_row(device, budget_s: float = 60.0, width: int = 1280, height: int = 720,
                scene_kw=None, truth=None, spp_batch: int = 16) -> dict:
    """Render, filter and score one frame; returns the JSON row. `truth`
    is an [height, width, 3] linear image (default: the pinned 720p
    truth); `scene_kw` goes to `rtcamp_scene` (grid, lat, lon)."""
    from henjou_torch.post.denoise import denoise_atrous_var
    from henjou_torch.runtime.options import RenderOption
    from henjou_torch.runtime.renderer import Renderer
    from henjou_torch.scene.testscenes import rtcamp_scene

    if truth is None:
        with np.load(GT_PATH) as gt:
            truth = gt["color"]
    opt = RenderOption(
        image_width=width, image_height=height, max_spp=100000, spp_batch=spp_batch,
        engine="wavefront", firefly_clamp=64.0,
        scene_sky_default=(0.35, 0.45, 0.62),
        camera_position=(0.0, 6.0, -16.5),
        camera_direction=(0.0, -0.28, 1.0),
        camera_fov=float(np.radians(40.0)),
    )
    r = Renderer(option=opt, device=device)
    r.set_scene(rtcamp_scene(**(scene_kw or {})))
    r.build()

    def denoise(aovs):
        out = denoise_atrous_var(*(torch.as_tensor(aovs[k], device=r.device)
                                   for k in ("color", "albedo", "normal", "variance")),
                                 demodulate=True)
        return out.cpu().numpy()

    # warm-up: the accel pack, first-use costs and the renderer's per-spp
    # cost model, so the budgeted render measures the steady pipeline
    denoise(r.render_frame(0, deadline=0.5))

    t0 = time.perf_counter()
    aovs = r.render_frame(0, deadline=budget_s)
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    den = denoise(aovs)
    denoise_s = time.perf_counter() - t1
    rmse = float(np.sqrt(np.mean((den - truth) ** 2)))
    raw_rmse = float(np.sqrt(np.mean((aovs["color"] - truth) ** 2)))
    return {
        "metric": f"rtcamp{height}_{budget_s:g}s_svgf_rmse",
        "value": rmse,
        "unit": "rmse_linear_hdr",
        "raw_rmse": raw_rmse,
        "spp": int(aovs["spp_done"]),
        "render_s": wall,
        "budget_s": budget_s,
        "denoise_s": denoise_s,
        "size": f"{width}x{height}",
        "device": (torch.cuda.get_device_name(r.device) if r.device.type == "cuda"
                   else "cpu"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="SVGF quality per second on the contest scene")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(quality_row(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
