"""The port's hardware canary (henjou_torch/runtime/canary.py) on the CPU.

The port's plain canary film (the CPU runs every kernel's plain version)
against the JAX package's pinned film, read as data, at the canary's own
tolerance, CANARY_RMSE_TOL = 5e-3; the port ships a byte copy of that film
as its pin. Then the check's failure path, and when `initialize_and_render`
runs it: on CUDA unless HENJOU_SKIP_CANARY=1, before anything else."""

import os

import numpy as np
import pytest
import torch

from henjou_torch.runtime import canary
from henjou_torch.runtime import renderer as rmod

# one intra-op thread: the test lane runs several pytest workers at once
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PIN = os.path.join(ROOT, "henjou_tpu", "runtime", "canary_film.npy")


@pytest.fixture(scope="module")
def cpu_film():
    return canary.canary_film("cpu")


def test_plain_film_matches_the_jax_pin(cpu_film):
    pinned = np.load(JAX_PIN)
    assert cpu_film.shape == pinned.shape == (256, 3)
    rmse = float(np.sqrt(np.mean((cpu_film - pinned) ** 2)))
    assert rmse <= canary.CANARY_RMSE_TOL, rmse
    # the port's arithmetic follows the JAX package's: far inside the limit
    assert rmse < 1e-5, rmse


def test_shipped_pin_is_the_jax_pin():
    with open(canary.PIN_PATH, "rb") as a, open(JAX_PIN, "rb") as b:
        assert a.read() == b.read()


def test_canary_check_passes_on_cpu():
    res = canary.canary_check("cpu", strict=True)
    assert res["ok"] and res["rmse"] < 1e-5 and res["mean"].shape == (3,)


def test_canary_check_raises_on_a_wrong_film(tmp_path, monkeypatch, cpu_film):
    """A film that redistributes radiance (two pixel rows swapped) fails;
    strict=False reports it instead."""
    wrong = cpu_film.reshape(16, 16, 3)[::-1].reshape(256, 3)
    path = tmp_path / "pin.npy"
    np.save(path, wrong.astype(np.float32))
    monkeypatch.setattr(canary, "PIN_PATH", str(path))
    monkeypatch.setattr(canary, "canary_film", lambda device: cpu_film)
    with pytest.raises(RuntimeError, match="hardware canary failed"):
        canary.canary_check("cpu")
    assert not canary.canary_check("cpu", strict=False)["ok"]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("device,skip,runs", [
    ("cuda", None, True), ("cuda", "1", False), ("cpu", None, False)])
def test_initialize_and_render_runs_the_canary_first(monkeypatch, device, skip, runs):
    """The canary runs before the option is loaded, on CUDA only, unless
    HENJOU_SKIP_CANARY=1; the check is stopped right after that point."""
    calls = []
    monkeypatch.setattr(canary, "canary_check",
                        lambda dev, strict: calls.append((dev, strict)) or {"rmse": 0.0})

    def stop(self):
        raise _Stop

    monkeypatch.setattr(rmod.Renderer, "build", stop)
    if skip is None:
        monkeypatch.delenv("HENJOU_SKIP_CANARY", raising=False)
    else:
        monkeypatch.setenv("HENJOU_SKIP_CANARY", skip)
    r = rmod.Renderer(device="cpu")
    r.device = torch.device(device)  # only the device's type is read before the stop
    with pytest.raises(_Stop):
        r.initialize_and_render()
    assert calls == ([(r.device, True)] if runs else [])
    assert ("canary_rmse" in r.setup_stats) == runs


def test_a_failing_canary_stops_the_render(monkeypatch):
    def fail(dev, strict):
        raise RuntimeError("hardware canary failed on cuda")

    monkeypatch.setattr(canary, "canary_check", fail)
    monkeypatch.delenv("HENJOU_SKIP_CANARY", raising=False)
    r = rmod.Renderer(device="cpu")
    r.device = torch.device("cuda")
    with pytest.raises(RuntimeError, match="hardware canary failed"):
        r.initialize_and_render()
    assert r.frame_stats == []
