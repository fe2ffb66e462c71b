"""Isolate bitonic loop costs: guard-chain length, run-time k, run-time j.

Port of tools/exp_bitonic4.py. The state is P = 10 int32 planes of
S x 128 = 65,536 elements below 2^24 from numpy's ``default_rng(0)``;
each row runs ITERS = 136 iterations, double-buffered as the JAX loop is,
with the schedule of a full sort at this n as its (j, k) table:

- X1: one stacked `net_substage` (32, 16), both compiled;
- X2: j = 16 compiled, k the table's k of the iteration, passed at launch
  (as the JAX kernel reads it from SMEM); where that k is 16 both elements
  of a pair may take the same key, as on the TPU;
- X5: the whole table walked by one cooperative `net_walk`, j and k used
  as read (the JAX kernel's dynamic rolls): a full sort;
- X3, X4: X1's body behind a chain of 4 or 16 ``lj == g % 16`` guards
  evaluated on the card, with lj = 0 from a table of zeros, so only g = 0
  passes.

X1, X3 and X4 leave one substage's result (it is idempotent). Each row
prints the first call's seconds, the mean ms of 20 calls after it and the
microseconds per substage.

    python -m henjou_torch.tools.exp_bitonic4 --device cuda
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from henjou_torch.accel import bitonic_net
from henjou_torch.accel.bitonic_net import make_schedule, substages
from henjou_torch.runtime.renderer import resolve_device
from henjou_torch.tools.exp_bitonic import REPS, pingpong, row_line, row_result, time_calls
from henjou_torch.tools.exp_bitonic2 import make_input

S = 512
P = 10
ITERS = 136
ROWS = (
    ("X1 static j,k 2 guards", "x1"),
    ("X2 static j dynamic k", "x2"),
    ("X5 dynamic j,k (dyn rolls)", "x5"),
    ("X3 4-guard chain static body", "x3"),
    ("X4 16-guard chain static body", "x4"),
)


def row_fn(row: str, stack: torch.Tensor, ops, iters: int):
    """The loop of row `row` over the first `iters` substages of the
    sort's schedule, as a call returning the output state (`iters` even,
    so that the last iteration writes the output, as in the JAX rows)."""
    n = stack.shape[1]
    subs = substages(n)[:iters]
    if len(subs) != iters:
        raise ValueError(f"n={n} has {len(substages(n))} substages, fewer than {iters}")
    if row == "x1":
        step = lambda s, src, dst: ops.net_substage(src, 32, 16, dst=dst, mode="static")  # noqa: E731
    elif row == "x2":
        step = lambda s, src, dst: ops.net_substage(  # noqa: E731
            src, subs[s][0], 16, dst=dst, mode="static_j")
    elif row in ("x3", "x4"):
        guards = 4 if row == "x3" else 16
        step = lambda s, src, dst: ops.net_substage(  # noqa: E731
            src, 32, 16, dst=dst, guards=guards, lj=0)
    elif row == "x5":
        sched = make_schedule(subs, n, stack.device)
        return lambda: ops.net_walk(stack, sched)
    else:
        raise ValueError(f"unknown row {row!r}")
    return lambda: pingpong(stack, iters, step)[0]


def run(name, row, device="cuda", *, s=S, p=P, iters=ITERS, state=None, reps=REPS,
        plain=False, log=print) -> dict:
    """One row on `state` (a [p, s * 128] numpy array; exp_bitonic2's
    `make_input` when None), with the kernels or their plain versions."""
    device = torch.device(device)
    inp = make_input(s, p) if state is None else np.asarray(state, np.int32)
    stack = torch.from_numpy(inp).to(device)
    first_s, ms, out = time_calls(row_fn(row, stack, bitonic_net.ops(plain), iters), device, reps)
    log(row_line(name, 56, first_s, ms, per_sub=iters))
    return row_result(name, out, first_s, ms)


def run_all(device="cuda", *, s=S, p=P, iters=ITERS, reps=REPS, plain=False, log=print) -> dict:
    """Every row: {name: row result}."""
    return {name: run(name, row, device, s=s, p=p, iters=iters, reps=reps, plain=plain, log=log)
            for name, row in ROWS}


def main(argv=None, **sizes) -> int:
    ap = argparse.ArgumentParser(description="bitonic loop costs (PyTorch/CUDA)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    run_all(device, log=lambda *a: print(*a, flush=True), **sizes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
