"""BENCHMARK.json and the files it names: every configuration, cell and
metric parses, keeps to the allowed names and units, and is found by name."""

import json
import os

import pytest

from hbench import spec

BENCH = spec.load_benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_allowed(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(set(names)) == len(names)
    for n in names:
        assert spec.NAME_RE.match(n), n


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"] == f"benchmark/configs/{cfg['name']}.json"
    data = spec.load_named("configs", cfg["name"])
    assert data["source"] == cfg["source"] and data["reduced"] == cfg["reduced"]
    for k in cfg["reduced"]:
        assert spec.NAME_RE.match(k)
    opt = data["option"]
    scene = os.path.join(spec.ROOT, opt["GLTF_file"]["gltf_filepath"],
                         opt["GLTF_file"]["gltf_filename"])
    assert os.path.exists(scene)
    # a cut changes scale only: every width of the shipped option stays
    for grp in ("Image", "Camera", "Sky", "TPU"):
        for k, v in data["shipped_option"][grp].items():
            if k not in cfg["reduced"]:
                assert opt[grp][k] == v, (grp, k)
    for text in (cfg["source"], cfg["why"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_workload_file(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    data = spec.load_named("workloads", cell["name"])
    for k in ("config", "traffic", "chips", "why"):
        assert data[k] == cell[k]
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    assert spec.NAME_RE.match(cell["traffic"])
    assert data["check_pixels_per_frame"] > 0
    assert set(data["limits"]) >= {"film_mismatch_pct", "final_mismatch_pct"}


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_found_by_name(metric):
    assert spec.UNIT_RE.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    mod = spec.metric_reader(metric["name"])
    assert callable(mod.read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["per_layer"]:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200


def test_a_metric_split_by_cell_reads_as_its_quantity():
    assert spec.quantity("spp_per_s") == "spp_per_s"
    assert spec.quantity("binned_roofline.masked") == "binned_roofline"
    assert spec.metric_reader("Mrays_per_s.masked").read is not None
    with pytest.raises(ValueError):
        spec.quantity("a/b")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_cell_of_a_layer_metric_reports_what_it_moves(metric):
    for cell in metric.get("workloads", [w["name"] for w in BENCH["workloads"]]):
        assert metric["moves"] in {m["name"] for m in spec.cell_metrics(BENCH, cell,
                                                                        "end_to_end")}


def test_every_cell_reports_setup_and_another_end_to_end_and_a_layer():
    for cell in BENCH["workloads"]:
        e2e = {m["name"] for m in spec.cell_metrics(BENCH, cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.cell_metrics(BENCH, cell["name"], "per_layer")


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_run_option_merges_traffic_seed_and_output():
    cfg = spec.load_named("configs", "rtcamp720")
    wl = spec.load_named("workloads", "rtcamp720.masked")
    opt = spec.run_option(cfg, wl, 2**31 + 5, "/x/run")
    assert opt["TPU"]["engine"] == "masked" and opt["Image"]["max_spp"] == 1
    assert opt["Render_mode"] == "DenoiseTemporal" and opt["Image"]["image_width"] == 1280
    assert opt["Image"]["image_directory"] == "/x/run/"
    assert 0 <= opt["TPU"]["seed"] < 2**31
    assert opt["TPU"]["seed"] == spec.option_seed(2**31 + 5) != spec.option_seed(5)
    assert cfg["option"]["TPU"].get("engine") is None  # the config is not written into


def test_check_pixels_from_the_seed():
    a = spec.check_pixels(2**32 + 3, 4, 1000, 64)
    assert (a == spec.check_pixels(2**32 + 3, 4, 1000, 64)).all()
    assert len(set(a.tolist())) == 64 and a.max() < 1000
    assert not (a == spec.check_pixels(2**32 + 3, 5, 1000, 64)).all()
