"""Whole runs of the harness with the look for a chip skipped: each cell's
configuration and traffic at a toy size on the CPU (the program runs its
plain versions there), sound; the control (the reference in bfloat16 in
the program's place) and the timed path broken underneath must both come
out as not correct. A cell has one chip, so there is no exchange between
chips to leave out."""

import json
import subprocess
import sys
import time

import pytest
import torch

from hbench import runner, spec

BENCH = spec.load_benchmark()
TOY = {"Image": {"image_width": 48, "image_height": 27}}


def _run(cell, seed=2**31 + 17, seconds=0.5, control=False, trace=False, device="cpu"):
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    wl = dict(spec.load_named("workloads", cell), check_pixels_per_frame=96)
    cfg = spec.load_named("configs", entry["config"])
    if device == "cpu":
        cfg = spec.merge(cfg, {"option": TOY})
    res, rows = runner.run_cell(BENCH, entry, wl, cfg, seed, seconds, trace, device,
                                time.monotonic(), control=control)
    return res, {n: v for n, v, _ in rows}


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert runner.main(["--workload", "rtcamp720.contest", "--seed", "1",
                        "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_only_benchmark_files_fail(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files
    the program is missing: no result, a non-zero exit."""
    import shutil

    shutil.copy(f"{spec.ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "rtcamp720.contest",
                        "--seed", "1", "--seconds", "1"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res, nums = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    # every end-to-end metric of the cell; the CPU holds no device memory peak
    e2e = {m["name"] for m in spec.cell_metrics(BENCH, cell, "end_to_end")}
    assert set(res["metrics"]) == e2e - {"peak_mem_GiB"} and "setup_s" in e2e
    assert list(res)[-1] == "checks"
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res, nums = _run(cell, control=True)
    assert not res["correct"], res["checks"]


def _wrap_steps(monkeypatch, fault):
    from henjou_torch.runtime.renderer import Renderer

    for name in ("_make_wavefront_step", "_make_masked_step"):
        make = getattr(Renderer, name)

        def broken(self, *a, _make=make, **k):
            step, groups = _make(self, *a, **k)
            return (lambda arg, s0, n, **kw: fault(step, arg, s0, n, **kw)), groups

        monkeypatch.setattr(Renderer, name, broken)


def _unchanged(step, arg, s0, n, **kw):
    """The step returns its state unchanged: no sample reaches the film."""
    out = step(arg, s0, n, **kw)
    return tuple(torch.zeros_like(x) for x in out[:5]) + (out[5],)


def _half(step, arg, s0, n, **kw):
    """Half the batch left out, the mean taken over the rest: half the
    samples of a step; in a one-sample step of the masked engine, every
    other pixel of the tile, each rendered pixel's sums given to the next."""
    if n > 1 or not torch.is_tensor(arg):
        return step(arg, s0, max(1, n // 2), **kw)
    out = step(arg[::2], s0, n, **kw)
    return tuple(x.repeat_interleave(2, 0)[:arg.shape[0]] for x in out[:5]) + (out[5],)


def _altered(step, arg, s0, n, **kw):
    """An answer altered where it is produced: every 4th pixel's colour."""
    out = list(step(arg, s0, n, **kw))
    c = out[0].clone()
    c[::4] *= 1.5
    out[0] = c
    return tuple(out)


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(monkeypatch, cell, fault):
    _wrap_steps(monkeypatch, fault)
    res, nums = _run(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_finalize_is_not_correct(monkeypatch, cell):
    """The finalized image altered on every 3rd row."""
    from henjou_torch.runtime.renderer import Renderer

    fin = Renderer._finalize

    def broken(self, aovs, frame=None):
        img = fin(self, aovs, frame=frame).copy()
        img[::3] *= 1.1
        return img

    monkeypatch.setattr(Renderer, "_finalize", broken)
    res, nums = _run(cell)
    assert not res["correct"] and nums["final_mismatch_pct"] > 10.0, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_history_is_not_correct(monkeypatch, cell):
    """DenoiseTemporal's history altered as the finalize banks it: every
    frame's own image is right, and only the next frame's shows it."""
    from henjou_torch.runtime.renderer import Renderer

    fin = Renderer._finalize_temporal

    def broken(self, dev, frame):
        out = fin(self, dev, frame)
        hist = self._temporal_history
        self._temporal_history = (hist[0] * 1.5,) + tuple(hist[1:])
        if self._temporal_raw is not None:
            raw = self._temporal_raw
            self._temporal_raw = (raw[0] * 1.5,) + tuple(raw[1:])
        return out

    monkeypatch.setattr(Renderer, "_finalize_temporal", broken)
    res, nums = _run(cell)
    assert not res["correct"] and nums["final_mismatch_pct"] > 10.0, res["checks"]


def test_traced_run_reports_its_layers():
    res, _ = _run("rtcamp720.contest", trace=True)
    assert res["correct"]
    assert {"Mrays_per_s", "traces_per_sample", "frame_overhead_ms"} <= set(res["metrics"])
    assert "busy_s" in res["device"] and "breakdown" in res


def test_traced_masked_run_reports_its_split_layers():
    """The masked cell's per-layer metrics split by cell (`<quantity>.masked`)
    read as their quantity does, the hooked rooflines' counts included."""
    res, _ = _run("rtcamp720.masked", trace=True)
    assert res["correct"]
    assert {"spp_per_s.masked", "Mrays_per_s.masked", "traces_per_sample.masked",
            "frame_overhead_ms.masked"} <= set(res["metrics"])
    assert not {"spp_per_s", "Mrays_per_s"} & set(res["metrics"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cuda_device, cell):
    res, _ = _run(cell, seconds=5, device=cuda_device)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
