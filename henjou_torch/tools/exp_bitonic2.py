"""Isolate the per-substage cost of the payload-carrying bitonic network.

Port of tools/exp_bitonic2.py. The state is P = 10 int32 planes of
S x 128 = 65,536 elements below 2^24 from numpy's ``default_rng(0)``;
each row of A-F runs ITERS = 136 iterations (the substage count of a full
sort at this n) of one operation, double-buffered as the JAX kernels are:

- A: one stacked `net_substage` (k, j) = (32, 16), both compiled;
- B: the same at (1024, 512) (a sublane roll on the TPU);
- C: one `net_local` over the list of 136 x (32, 16): the state stays in
  shared memory for every iteration (the JAX kernel's value carry);
- D: the per-plane `net_substage` (32, 16);
- E, F: `roll_pass` (roll 16 + roll 112 along each 128-element row),
  stacked and per plane. The JAX kernels read their output buffer before
  writing it, so their result is undefined on the TPU (zeros in interpret
  mode); these rows start from the input.

A substage is idempotent, so A-D leave one substage's result. With
argument ``g`` the script runs A-F and then G, as the JAX script's two
``__main__`` blocks do: the full network (keys from ``default_rng(0)``,
planes from ``default_rng(1)``), walked on the host with one per-plane
`net_substage` per substage, j compiled, double-buffered. G prints ``ok``
(keys equal numpy's sort). Each row prints the first call's seconds and
the mean ms of 20 calls after it; A-F also per substage.

    python -m henjou_torch.tools.exp_bitonic2 [g] --device cuda
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from henjou_torch.accel import bitonic_net
from henjou_torch.accel.bitonic_net import substages
from henjou_torch.runtime.renderer import resolve_device
from henjou_torch.tools.exp_bitonic import (
    LANES,
    REPS,
    keys_sorted,
    pingpong,
    row_line,
    row_result,
    time_calls,
)

S = 512
P = 10
ITERS = 136
ROWS = (
    ("A stacked refs, static lane j=16", "a"),
    ("B stacked refs, static sublane j=512", "b"),
    ("C stacked value carry, static j=16", "c"),
    ("D per-plane refs, static j=16", "d"),
    ("E rolls only (no masks), 3D refs", "e"),
    ("F rolls only (no masks), per-plane 2D", "f"),
)
G_NAME = "G real schedule unrolled"


def make_input(s=S, p=P) -> np.ndarray:
    """[p, s * 128] int32 below 2^24 from default_rng(0)."""
    return np.random.default_rng(0).integers(0, 1 << 24, (p, s * LANES)).astype(np.int32)


def make_g_input(s=S, p=P) -> np.ndarray:
    """Row G's input: keys below 2^24 from default_rng(0), planes below
    2^30 from default_rng(1) (whose plane 0 the keys replace)."""
    n = s * LANES
    key = np.random.default_rng(0).integers(0, 1 << 24, n).astype(np.int32)
    st = np.random.default_rng(1).integers(0, 1 << 30, (p, n)).astype(np.int32)
    st[0] = key
    return st


def row_fn(row: str, stack: torch.Tensor, ops, iters: int):
    """The operation of row `row` ("a" to "f") as a call returning the
    output state."""
    sub = dict(a=dict(k=32, j=16), b=dict(k=1024, j=512), d=dict(k=32, j=16, per_plane=True))
    if row in sub:
        kw = sub[row]
        return lambda: pingpong(stack, iters, lambda s, src, dst: ops.net_substage(
            src, dst=dst, mode="static", **kw))[0]
    if row == "c":
        return lambda: ops.net_local(stack, [(32, 16)] * iters)
    if row in ("e", "f"):
        per_plane = row == "f"
        return lambda: pingpong(stack, iters, lambda s, src, dst: ops.roll_pass(
            src, dst=dst, per_plane=per_plane))[0]
    raise ValueError(f"unknown row {row!r}")


def run(name, row, device="cuda", *, s=S, p=P, iters=ITERS, state=None, reps=REPS,
        plain=False, log=print) -> dict:
    """One row of A-F on `state` (a [p, s * 128] numpy array; `make_input`
    when None), with the kernels or, with `plain`, their plain versions."""
    device = torch.device(device)
    inp = make_input(s, p) if state is None else np.asarray(state, np.int32)
    stack = torch.from_numpy(inp).to(device)
    first_s, ms, out = time_calls(row_fn(row, stack, bitonic_net.ops(plain), iters), device, reps)
    log(row_line(name, 52, first_s, ms, per_sub=iters))
    return row_result(name, out, first_s, ms)


def sort_per_plane(stack: torch.Tensor, subs, ops) -> torch.Tensor:
    """Row G's network: one per-plane `net_substage` per substage, j
    compiled, double-buffered; the last one written is the result."""
    out, buf = pingpong(stack, len(subs), lambda s, src, dst: ops.net_substage(
        src, *subs[s], dst=dst, per_plane=True, mode="static_j"))
    return buf if len(subs) % 2 == 1 else out


def run_g(device="cuda", *, s=S, p=P, state=None, reps=REPS, plain=False, log=print) -> dict:
    """Row G on `state` (`make_g_input` when None)."""
    device = torch.device(device)
    inp = make_g_input(s, p) if state is None else np.asarray(state, np.int32)
    stack = torch.from_numpy(inp).to(device)
    subs = substages(s * LANES)
    ops = bitonic_net.ops(plain)
    first_s, ms, out = time_calls(lambda: sort_per_plane(stack, subs, ops), device, reps)
    ok = keys_sorted(inp[0], out)
    log(f"{G_NAME} ok={ok} first {first_s:5.2f}s run {ms:8.3f} ms" if ms is not None
        else f"{G_NAME} ok={ok} first {first_s:5.2f}s")
    return row_result(G_NAME, out, first_s, ms, ok)


def run_all(device="cuda", *, g=True, s=S, p=P, iters=ITERS, reps=REPS, plain=False,
            log=print) -> dict:
    """Rows A-F, then G when `g`: {name: row result}."""
    out = {name: run(name, row, device, s=s, p=p, iters=iters, reps=reps, plain=plain, log=log)
           for name, row in ROWS}
    if g:
        out[G_NAME] = run_g(device, s=s, p=p, reps=reps, plain=plain, log=log)
    return out


def main(argv=None, **sizes) -> int:
    ap = argparse.ArgumentParser(description="bitonic substage costs (PyTorch/CUDA)")
    ap.add_argument("which", nargs="?", default="", help="'g' also runs the full schedule (G)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = run_all(device, g=args.which == "g", log=lambda *a: print(*a, flush=True), **sizes)
    return 0 if all(r["ok"] is not False for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
