"""The whole payload-carrying bitonic network in place, in one launch.

Port of tools/exp_bitonic3.py, whose fully unrolled in-place kernels
sort P = 10 int32 planes of S x 128 = 65,536 elements (keys below 2^24
from numpy's ``default_rng(0)``, planes below 2^30 from ``default_rng(1)``)
in VMEM. Here each row is one cooperative `net_walk` in place over the
schedule (136 substages in 16 passes of the keyed network engine), the
first j of each global pass run by code compiled for it (the switch form,
the nearest the card has to a static unroll):

- ``G1 inplace full unroll``: copies the input, then sorts the copy in
  place (the JAX kernel's out <- stack, then in-place substages);
- ``G2 inplace + aliased io``: sorts the caller's tensor itself, no copy;
  before each call it restores the input into that tensor, as the JAX
  loop uploads the input again for every call;
- ``G3 inplace + vmem 100MB``: the TPU's VMEM limit has no GPU
  counterpart, so this row runs G1's kernel again under G3's name.

The JAX script catches a failed compile and prints FAIL; here a refused
launch raises. Each row prints ``ok`` (keys equal numpy's sort), the first
call's seconds and the mean ms of 20 calls after it.

    python -m henjou_torch.tools.exp_bitonic3 [a|b|c|all] --device cuda
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from henjou_torch.accel import bitonic_net
from henjou_torch.accel.bitonic_net import make_schedule, substages
from henjou_torch.runtime.renderer import resolve_device
from henjou_torch.tools.exp_bitonic import REPS, keys_sorted, row_line, row_result, time_calls
from henjou_torch.tools.exp_bitonic2 import make_g_input

S = 512
P = 10
ROWS = (
    ("a", "G1 inplace full unroll", "copy"),
    ("b", "G2 inplace + aliased io", "aliased"),
    ("c", "G3 inplace + vmem 100MB", "copy"),
)


def run(name, kind, device="cuda", *, s=S, p=P, state=None, reps=REPS, plain=False,
        log=print) -> dict:
    """One row ("copy" or "aliased") on `state` (a [p, s * 128] numpy
    array; `make_g_input` when None)."""
    device = torch.device(device)
    inp = make_g_input(s, p) if state is None else np.asarray(state, np.int32)
    n = inp.shape[1]
    stack = torch.from_numpy(inp).to(device)
    sched = make_schedule(substages(n), n, device)
    ops = bitonic_net.ops(plain)
    if kind == "copy":
        fn = lambda: ops.net_walk(stack.clone(), sched, inplace=True, switch=True)  # noqa: E731
    elif kind == "aliased":
        work = stack.clone()  # the caller's tensor, sorted where it lies
        fn = lambda: ops.net_walk(work.copy_(stack), sched, inplace=True, switch=True)  # noqa: E731
    else:
        raise ValueError(f"unknown kind {kind!r}")
    first_s, ms, out = time_calls(fn, device, reps)
    ok = keys_sorted(inp[0], out)
    log(row_line(name, 40, first_s, ms, ok=ok))
    return row_result(name, out, first_s, ms, ok)


def run_all(device="cuda", *, which="all", s=S, p=P, reps=REPS, plain=False, log=print) -> dict:
    """The rows `which` selects ("a", "b", "c" or "all"): {name: row result}."""
    return {name: run(name, kind, device, s=s, p=p, reps=reps, plain=plain, log=log)
            for key, name, kind in ROWS if which in ("all", key)}


def main(argv=None, **sizes) -> int:
    ap = argparse.ArgumentParser(description="in-place bitonic network (PyTorch/CUDA)")
    ap.add_argument("which", nargs="?", default="all", choices=("a", "b", "c", "all"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = run_all(device, which=args.which, log=lambda *a: print(*a, flush=True), **sizes)
    return 0 if all(r["ok"] for r in rows.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
