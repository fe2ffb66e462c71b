"""The quality row (henjou_torch/tools/quality.py) on the CPU at a toy
size, and the contest-class scene it renders against the JAX package's."""

import numpy as np
import torch

from henjou_torch.scene.testscenes import rtcamp_scene
from henjou_torch.tools import quality
from henjou_tpu.scene.testscenes import rtcamp_scene as jax_rtcamp_scene

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)


def test_rtcamp_scene_matches_jax():
    for kw in (dict(grid=2, lat=8, lon=16), {}):
        got, want = rtcamp_scene(**kw), jax_rtcamp_scene(**kw)
        for field in ("vertices", "normals", "texcoords", "material_ids", "indices"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
        assert repr(got.materials) == repr(want.materials)
    assert len(got.vertices) // 3 == 254740


def test_quality_row_at_toy_size():
    """32x18 pixels, a 2x2 hall: the row's keys, and the SVGF frame closer
    to a 256-spp truth of the same size than the raw frame is."""
    from henjou_torch.runtime.options import RenderOption
    from henjou_torch.runtime.renderer import Renderer

    kw = dict(width=32, height=18, scene_kw=dict(grid=2, lat=8, lon=16))
    r = Renderer(option=RenderOption(image_width=32, image_height=18, max_spp=256,
                                     spp_batch=256, firefly_clamp=64.0,
                                     scene_sky_default=(0.35, 0.45, 0.62),
                                     camera_position=(0.0, 6.0, -16.5),
                                     camera_direction=(0.0, -0.28, 1.0),
                                     camera_fov=float(np.radians(40.0)), seed=5),
                 device="cpu")
    r.set_scene(rtcamp_scene(**kw["scene_kw"]))
    truth = r.build().render_frame(0)["color"]
    row = quality.quality_row("cpu", budget_s=0.1, truth=truth, spp_batch=4, **kw)
    assert row["metric"] == "rtcamp18_0.1s_svgf_rmse" and row["unit"] == "rmse_linear_hdr"
    assert row["spp"] == 4 and row["device"] == "cpu" and row["size"] == "32x18"
    assert np.isfinite(row["value"]) and row["value"] < row["raw_rmse"]
    assert "vs_baseline" not in row
