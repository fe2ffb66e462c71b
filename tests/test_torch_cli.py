"""The port's entry points on the CPU: the CLI, the Renderer's device and
option checks, and the import boundary (henjou_torch never imports jax)."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from henjou_torch import render
from henjou_torch.post.png import read_png
from henjou_torch.runtime.renderer import Renderer

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GALLERY = os.path.join(ROOT, "scenes", "sphere_gallery_option.json")


def test_cli_writes_png(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    out = str(tmp_path / "gal")
    stats = str(tmp_path / "stats.json")
    rc = render.main([GALLERY, "--device", "cpu", "--size", "32x18", "--spp", "2",
                      "--out", out, "--stats", stats])
    assert rc == 0
    img = read_png(out + "_000.png")
    assert img.shape == (18, 32, 3)
    assert img.mean() > 10  # lit, not black
    import json

    with open(stats) as f:
        fr = json.load(f)["frames"][0]
    assert fr["spp"] == 2 and fr["film_finite"] and fr["n_traces"] > 32 * 18 * 2


def test_cli_cornell_without_option(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert render.main(["--device", "cpu", "--size", "16x16", "--spp", "1"]) == 0
    assert read_png(str(tmp_path / "cornell_000.png")).shape == (16, 16, 3)


def test_cli_profile_writes_summary(tmp_path, monkeypatch):
    """--profile on the CPU: the trace, the op table, every frame's spans
    and counters (spans.json), and a summary of the frames whose device
    field says there was no device, so no idle time by span."""
    monkeypatch.chdir(tmp_path)
    prof = tmp_path / "prof"
    assert render.main(["--device", "cpu", "--size", "8x8", "--spp", "1",
                        "--profile", str(prof)]) == 0
    import json

    from henjou_torch.utils.timer import NAMES

    summary = json.loads((prof / "summary.json").read_text())
    assert summary["device"] == "cpu" and summary["idle_s_by_span"] is None
    assert summary["frames"][0]["spp"] == 1 and "spans" not in summary["frames"][0]
    frames = json.loads((prof / "spans.json").read_text())
    assert [f["frame"] for f in frames] == [s["frame"] for s in summary["frames"]]
    names = {s[0] for s in frames[0]["spans"]}
    assert {"frame.render", "engine.bounce", "engine.trace"} <= names <= set(NAMES)
    # each of the 64 samples holds a lane for one iteration at least
    c = frames[0]["counters"]
    assert 64 <= c["engine.lanes_valid"] <= c["engine.lane_slots"]
    assert (prof / "trace.json.gz").stat().st_size > 0 and (prof / "ops.txt").exists()


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        assert Renderer(device="cuda").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Renderer(device="cuda")


@pytest.mark.parametrize(
    "tpu, env",
    [
        (dict(sampler="sobol"), {}),
        (dict(light_ris=8), {}),
        (dict(adaptive=True, spp_batch=1), {}),
        (dict(adaptive=True, light_ris=4, engine="masked"), {}),
        ({}, {"HENJOU_POOL_SORT": "1"}),
    ],
)
def test_cli_renders_opt_in_option(tpu, env, tmp_path, monkeypatch):
    """Each opt-in key of the option file's TPU section (and the pool
    re-sort's environment variable) renders through the CLI on the CPU: a
    finite, lit PNG at the asked spp."""
    import json

    monkeypatch.chdir(ROOT)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with open(GALLERY) as f:
        opt = json.load(f)
    opt["TPU"].update(tpu)
    path = tmp_path / "opt.json"
    path.write_text(json.dumps(opt))
    out, stats = str(tmp_path / "img"), str(tmp_path / "stats.json")
    assert render.main([str(path), "--device", "cpu", "--size", "32x18", "--spp", "2",
                        "--out", out, "--stats", stats]) == 0
    assert read_png(out + "_000.png").mean() > 10
    with open(stats) as f:
        fr = json.load(f)["frames"][0]
    assert fr["film_finite"] and fr["spp"] == 2 and fr["n_traces"] > 0


def test_cli_renders_mis_ref(tmp_path, monkeypatch):
    """TPU.mis_mode "ref" in the option file renders two-sample MIS
    through the CLI: a finite, lit PNG, with more traces than the
    one-sample form (the branch ray of every bounce)."""
    import json

    monkeypatch.chdir(ROOT)
    with open(GALLERY) as f:
        opt = json.load(f)
    traces = {}
    for mode in ("single", "ref"):
        opt["TPU"]["mis_mode"] = mode
        path = tmp_path / f"{mode}.json"
        path.write_text(json.dumps(opt))
        out, stats = str(tmp_path / mode), str(tmp_path / f"{mode}_stats.json")
        assert render.main([str(path), "--device", "cpu", "--size", "32x18", "--spp", "2",
                            "--out", out, "--stats", stats]) == 0
        assert read_png(out + "_000.png").mean() > 10
        with open(stats) as f:
            fr = json.load(f)["frames"][0]
        assert fr["film_finite"] and fr["spp"] == 2
        traces[mode] = fr["n_traces"]
    assert traces["ref"] > traces["single"]


def test_renderer_mis_ref_takes_binned_light_query(monkeypatch):
    """Above BINNED_LIGHT_THRESHOLD emissive triangles the Renderer builds
    the binned light query once per accel and renders through it."""
    monkeypatch.chdir(ROOT)
    r = Renderer(device="cpu")
    r.load_render_option(GALLERY)
    r.option = dataclasses.replace(r.option, mis_mode="ref", image_width=16, image_height=8,
                                   max_spp=1)
    r._load_scene_from_option()
    monkeypatch.setattr(Renderer, "BINNED_LIGHT_THRESHOLD", 0)
    out = r.render_frame(0)
    key, la = r._light_accel_cache
    assert key == r._accel_cache[0] and la.light_prim_ids.numel() == r.device_scene.num_lights
    assert out["spp_done"] == 1 and torch.isfinite(torch.as_tensor(out["color"])).all()
    r.render_frame(0)
    assert r._light_accel_cache[1] is la  # reused while the transforms are unchanged


def test_masked_engine_still_raises(monkeypatch):
    """The masked engine renders the gallery (a film without the variance
    and count AOVs), and with sampler="sobol" renders the Sobol streams
    (it raised before the sampler was ported; JAX's masked engine takes
    the sampler too)."""
    monkeypatch.chdir(ROOT)
    r = Renderer(device="cpu")
    r.load_render_option(GALLERY)
    r.option = dataclasses.replace(r.option, engine="masked", mis_mode="ref", image_width=16,
                                   image_height=8, max_spp=1)
    r._load_scene_from_option()
    out = r.render_frame(0)
    assert out["spp_done"] == 1 and out["n_traces"] > 0 and "variance" not in out
    assert np.isfinite(out["color"]).all() and out["color"].shape == (8, 16, 3)
    r.option = dataclasses.replace(r.option, sampler="sobol")
    sob = r.render_frame(0)
    assert np.isfinite(sob["color"]).all() and not np.array_equal(sob["color"], out["color"])


def test_import_never_pulls_in_jax():
    """Import the whole package in a fresh interpreter: jax stays out."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import henjou_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(henjou_torch.__path__, 'henjou_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) > 30, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'henjou_tpu'))]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 30
