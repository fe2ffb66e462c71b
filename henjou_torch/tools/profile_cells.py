"""Where the device time goes: one warm render of each cell under
torch.profiler.

    python -m henjou_torch.tools.profile_cells --device cuda

Cells, cut in size so the traces stay small:

- contest frame 0 (``scenes/rtcamp_720_option.json``, Default mode) at
  640x360, 1 spp, with ``mis_mode`` single and ref, through
  `Renderer.render_frame`;
- the scale probe's two rows (`henjou_torch.tools.scale_test`) at
  960x540, 1 spp, on the full 194,044-triangle scene.

Each cell renders once untimed, then once under the profiler. Prints one
JSON line per cell: wall seconds, device busy seconds (summed kernel
time), idle share, kernel launches and the three kernels that took the
most device time (`henjou_torch.render.profiled`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

CONTEST = "scenes/rtcamp_720_option.json"


def _cells(device):
    """(name, render callable) of every cell, built lazily."""
    from henjou_torch.runtime.options import RenderMode
    from henjou_torch.runtime.renderer import Renderer
    from henjou_torch.tools.scale_test import ROWS, build_rows, render_row

    for mis_mode in ("single", "ref"):
        r = Renderer(device=device)
        r.load_render_option(CONTEST)
        r.option = dataclasses.replace(
            r.option, render_mode=RenderMode.DEFAULT, end_frame=1, max_spp=1,
            image_width=640, image_height=360, mis_mode=mis_mode,
        )
        r._load_scene_from_option()
        yield f"contest 640x360 1spp mis_mode={mis_mode}", lambda r=r: r.render_frame(0)
    _, frame, rows = build_rows(device)
    for name in ROWS:
        fns = rows[name][0]
        yield f"scale {name} 960x540 1spp", lambda fns=fns: render_row(frame, fns, 960, 540, 1)


def main(argv=None) -> int:
    from henjou_torch.render import profiled
    from henjou_torch.runtime.renderer import resolve_device

    ap = argparse.ArgumentParser(description="torch.profiler pass over the port's cells")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for name, render in _cells(device):
        render()  # warm-up
        _, _, s = profiled(render, device, top=3)
        print(json.dumps(dict(cell=name, **s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
