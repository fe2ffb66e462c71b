"""Whole runs of the harness with the look for a chip skipped: each cell's
configuration and traffic at a toy size on the CPU (the program runs its
plain versions there), sound; the control (the reference in bfloat16 in
the program's place) and the timed path broken underneath (faults.py) must
both come out as not correct.

A cell on one chip runs in this process, and makes no process group and no
collective. A cell on n > 1 chips runs on the CPU as two processes in a
gloo group (toy_rank.py starts rank 0 in a process of its own), where the
exchange between chips left out must come out as not correct too, and a
follower that raises in the window must end the run with no result and a
non-zero exit."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import faults
from hbench import group, runner, spec
from toy_rank import toy_cell

BENCH = spec.load_benchmark()
CHIPS = {w["name"]: int(w["chips"]) for w in BENCH["workloads"]}
TOY_RANK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy_rank.py")
# ranks of a multi-chip cell on the CPU
TOY_CHIPS = 2
# a toy run of two ranks on the CPU takes 30-60 s
TOY_RUN_S = 300


def _rank0(cell, seed, seconds, control=False, trace=False, fault=None):
    """(exit code, the last line of standard output as a dict or None,
    standard error) of toy_rank.py's rank 0 of `cell`."""
    cmd = [sys.executable, TOY_RANK, "lead", "--workload", cell, "--chips", str(TOY_CHIPS),
           "--seed", str(seed), "--seconds", str(seconds)]
    cmd += ["--control"] * control + ["--trace"] * trace + (["--fault", fault] if fault else [])
    p = subprocess.run(cmd, cwd=spec.ROOT, capture_output=True, text=True, timeout=TOY_RUN_S)
    lines = p.stdout.strip().splitlines()
    return p.returncode, json.loads(lines[-1]) if lines else None, p.stderr


def _run(cell, seed=2**31 + 17, seconds=0.5, control=False, trace=False, device="cpu",
         fault=None, set_attr=None):
    """(result, {number compared: value}) of a sound toy run of `cell`, or
    of one with `fault` planted (set with `set_attr` in this process)."""
    if CHIPS[cell] > 1:
        rc, res, err = _rank0(cell, seed, seconds, control, trace, fault)
        assert rc == 0 and res is not None, err[-3000:]
        return res, {n: v["value"] for n, v in res["checks"].items()}
    if fault:
        faults.install(fault, set_attr)
    entry, wl, cfg = toy_cell(BENCH, cell)
    if device != "cpu":
        cfg = spec.load_named("configs", entry["config"])
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
MULTI = [c for c in CELLS if CHIPS[c] > 1]


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


@pytest.mark.parametrize("fault", list(faults.STEP))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_step_is_not_correct(monkeypatch, cell, fault):
    res, nums = _run(cell, fault=fault, set_attr=monkeypatch.setattr)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_finalize_is_not_correct(monkeypatch, cell):
    """The finalized image altered on every 3rd row."""
    res, nums = _run(cell, fault="finalize", set_attr=monkeypatch.setattr)
    assert not res["correct"] and nums["final_mismatch_pct"] > 10.0, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_altered_history_is_not_correct(monkeypatch, cell):
    """DenoiseTemporal's history altered as the finalize banks it: every
    frame's own image is right, and only the next frame's shows it."""
    res, nums = _run(cell, fault="history", set_attr=monkeypatch.setattr)
    assert not res["correct"] and nums["final_mismatch_pct"] > 10.0, res["checks"]


@pytest.mark.parametrize("cell", MULTI)
def test_exchange_left_out_is_not_correct(cell):
    """One follower takes part in every all-reduce of the film with zeros:
    its share of the samples never reaches rank 0's film."""
    res, nums = _run(cell, fault="exchange")
    assert not res["correct"] and nums["count_mismatch"] > 0, res["checks"]


@pytest.mark.parametrize("cell", MULTI)
def test_follower_that_raises_ends_the_run(cell):
    """A follower raises in the window's first frame, while rank 0 waits
    in that frame's all-reduce: rank 0 sees it exit within group.POLL_S
    and ends with no result and FOLLOWER_FAILED; no process is left
    waiting for the group's timeout."""
    t0 = time.monotonic()
    rc, res, err = _rank0(cell, 2**31 + 23, 0.5, fault="raise")
    took = time.monotonic() - t0
    assert rc == group.FOLLOWER_FAILED and res is None, err[-3000:]
    assert "follower rank 1 exited with code 1" in err
    # set-up and two warm-up frames take 20-40 s on the CPU; far under the
    # group's timeout
    assert took < group.GROUP_TIMEOUT_S / 2, took


def test_one_chip_cell_makes_no_group_and_no_collective(monkeypatch):
    import torch.distributed as dist

    calls = []
    for name in ("init_process_group", "broadcast", "all_reduce", "all_gather", "barrier"):
        monkeypatch.setattr(dist, name, lambda *a, _n=name, **k: calls.append(_n))
    monkeypatch.setattr(group, "Leader", lambda *a, **k: calls.append("Leader"))
    res, _ = _run("rtcamp720.contest")
    assert res["correct"] and res["device"]["count"] == 1
    assert calls == [] and not dist.is_initialized()


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
@pytest.mark.parametrize("cell", [c for c in CELLS if c not in MULTI])
def test_cell_on_the_card(cuda_device, cell):
    res, _ = _run(cell, seconds=5, device=cuda_device)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
