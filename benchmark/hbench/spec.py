"""The benchmark's data: BENCHMARK.json at the root of the checkout, one file
per configuration (`configs/<config>.json`), one per cell
(`workloads/<cell>.json`) and one reader per metric (`metrics/<metric>.py`),
each found by its name (see `quantity` for a metric split by cell)."""

from __future__ import annotations

import copy
import importlib.util
import json
import os
import re

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_named(kind: str, name: str) -> dict:
    """configs/<name>.json or workloads/<name>.json under the benchmark."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(os.path.join(BENCH_DIR, kind, f"{name}.json")) as f:
        return json.load(f)


def quantity(name: str) -> str:
    """The name of the reader of metric `name`: `name` itself where
    metrics/<name>.py exists, else the part before its first dot, so that a
    quantity split by the end-to-end metric that it moves in some cells
    (`spp_per_s.masked` beside `spp_per_s`) reads as that part does."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad metric name {name!r}")
    if os.path.exists(os.path.join(BENCH_DIR, "metrics", f"{name}.py")):
        return name
    return name.split(".")[0]


def metric_reader(name: str):
    """The module of metrics/<quantity(name)>.py."""
    q = quantity(name)
    path = os.path.join(BENCH_DIR, "metrics", f"{q}.py")
    spec = importlib.util.spec_from_file_location(f"hbench_metric_{q.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, group: str) -> list:
    """The `group` ("end_to_end" or "per_layer") metrics that `cell` reports:
    those without a workloads key, and those that list it."""
    return [m for m in bench[group] if cell in m.get("workloads", [cell])]


def merge(base: dict, over: dict) -> dict:
    """`base` with `over` merged in, group by group."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def option_seed(seed: int) -> int:
    """The option's TPU.seed for a run's --seed: 31 bits (bit 31 of the
    sampler seed is the program's Sobol tag), mixed from any whole number."""
    return int(np.random.SeedSequence(int(seed)).generate_state(1)[0]) & 0x7FFFFFFF


def run_option(config: dict, workload: dict, seed: int, out_dir: str) -> dict:
    """The option file a run renders: the configuration's option, the cell's
    traffic merged in, the seed and the output directory."""
    opt = merge(config["option"], workload.get("option", {}))
    return merge(opt, {"TPU": {"seed": option_seed(seed)},
                       "Image": {"image_directory": out_dir.rstrip("/") + "/"}})


def check_pixels(seed: int, frame: int, n_pixels: int, count: int) -> np.ndarray:
    """The pixels of `frame` whose film the check compares, drawn from the
    seed: `count` distinct ids, sorted."""
    rng = np.random.default_rng([int(seed), int(frame)])
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels), replace=False))
