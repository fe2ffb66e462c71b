"""NCCL's sharded film against one process, on four GPUs: the contest
option of `rtcamp720.contest.4gpu` at a reduced size (320x180, 8 spp, one
animated frame) rendered by four ranks that join as the CLI's workers join
(`hbench.group.join`: `torch.cuda.set_device(rank)`, then an NCCL group on
tcp://localhost), each rendering its 2-spp share through
`Renderer.render_frame` and meeting the others in the program's
all-reduce, against the same frame rendered by one process on cuda:0. The
per-pixel sample counts and the trace count must be exact, and color,
albedo and normal within hbench/check.py's rule (1e-4 + 1e-3 |ref|).
Both engines. On the CPU the same test runs two ranks in a gloo group at
the harness tests' toy size.

    python -m pytest benchmark/tests/test_hbench_nccl.py -m cuda -q

on a host with four GPUs; it skips on fewer."""

import json

import numpy as np
import pytest
import torch

from hbench import group, spec
from hbench.check import mismatched

FRAME = 5
SEED = 2**31 + 99
# device type -> (ranks, image size)
SETUPS = {"cuda": (4, (320, 180)), "cpu": (2, (48, 27))}
AOVS = ("color", "albedo", "normal", "count")


def _option(engine, size, tmp_path):
    cell = "rtcamp720.contest.4gpu"
    opt = spec.run_option(spec.load_named("configs", "rtcamp720"),
                          spec.load_named("workloads", cell), SEED, str(tmp_path))
    opt = spec.merge(opt, {"Image": {"image_width": size[0], "image_height": size[1]},
                           "TPU": {"engine": engine}})
    path = tmp_path / "option.json"
    path.write_text(json.dumps(opt))
    return str(path)


def _render(device, opt_path):
    from henjou_torch.runtime.renderer import Renderer

    r = Renderer(device=device)
    r.load_render_option(opt_path)
    r._load_scene_from_option()
    aovs = r.render_frame(FRAME)
    film = {k: np.asarray(aovs[k]) for k in AOVS if k in aovs}
    return dict(film, n_traces=np.int64(aovs["n_traces"]), spp_done=np.int64(aovs["spp_done"]))


def _rank(rank, world, device_type, init_method, opt_path, out):
    import torch.distributed as dist

    if device_type == "cpu":
        torch.set_num_threads(2)
    device = group.join(rank, world, init_method, device_type)
    try:
        film = _render(str(device), opt_path)
        if rank == 0:
            np.savez(out, **film)
    finally:
        dist.destroy_process_group()


def _sharded_against_one(device_type, engine, tmp_path):
    import torch.multiprocessing as mp

    world, size = SETUPS[device_type]
    opt_path = _option(engine, size, tmp_path)
    out = str(tmp_path / "rank0.npz")
    mp.spawn(_rank, args=(world, device_type, f"tcp://localhost:{group.free_port()}",
                          opt_path, out), nprocs=world)
    with np.load(out) as f:
        sharded = dict(f)
    one = _render("cuda:0" if device_type == "cuda" else "cpu", opt_path)
    assert int(sharded["spp_done"]) == int(one["spp_done"]) == 8
    assert int(sharded["n_traces"]) == int(one["n_traces"]) > 0
    assert ("count" in sharded) == ("count" in one) == (engine == "wavefront")
    if engine == "wavefront":
        assert np.array_equal(sharded["count"], one["count"])
    off = {k: int(mismatched(sharded[k].reshape(-1, 3), one[k].reshape(-1, 3)).sum())
           for k in ("color", "albedo", "normal")}
    worst = {k: float(np.abs(sharded[k] - one[k]).max()) for k in off}
    print(f"[sharded] {device_type} x{world} {engine}: traces {int(one['n_traces'])}, "
          f"pixels off {off}, largest difference {worst}")
    assert not any(off.values()), (off, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["wavefront", "masked"])
def test_nccl_film_equals_one_process(cuda_device, tmp_path, engine):
    if torch.cuda.device_count() < SETUPS["cuda"][0]:
        pytest.skip(f"needs {SETUPS['cuda'][0]} GPUs")
    _sharded_against_one("cuda", engine, tmp_path)


@pytest.mark.parametrize("engine", ["wavefront", "masked"])
def test_gloo_film_equals_one_process(tmp_path, engine):
    _sharded_against_one("cpu", engine, tmp_path)
