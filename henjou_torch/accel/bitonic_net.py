"""Payload-carrying bitonic network: four CUDA kernels and their plain versions.

Port of the kernels of the bitonic-schedule experiments
(tools/exp_bitonic.py, exp_bitonic2.py, exp_bitonic3.py,
exp_bitonic4.py), which time variants of the network that
henjou_tpu/accel/bitonic.py `_sort_kernel` walks. The state is a [P, n]
int32 tensor: n = 2^m >= 1024 elements, plane 0 the key, the TPU
kernels' [P, n / 128, 128] planes flattened (`to_state` bitcasts other
4-byte dtypes, as `bitonic_sort` does).

One substage (k, j): element i compares its key with that of its partner
i ^ j and, with take_min = ((i & j) == 0) == ((i & k) == 0), takes the
partner's planes where take_min and key > pkey, or not take_min and
key < pkey. Equal keys never move. A full sort (the (k, j) list of
`substages`) is therefore not stable: ties come out in the network's own
order, which is the JAX kernels' order bit for bit. The production sort,
accel/bitonic.py's `bitonic_sort`, is stable and orders ties differently.

Entry points; each launches its kernel (``csrc/bitonic_net.cu``) for CUDA
tensors, runs its plain version (the same name with ``_plain``, built from
`_substage`, a `torch.where` over i ^ j) for CPU tensors, and raises for
anything else, including a launch that CUDA refuses:

- `net_substage`: one (k, j) over the state, stacked or per plane, with
  j and k compile-time, j compile-time and k run-time, or both run-time,
  or behind a chain of guards; each thread owns four pairs and moves them
  in 16-byte accesses;
- `net_local`: a list of substages with j < TILE on tiles sized to the
  list, the keys running the list as (key, source) words in registers
  under the layouts of `plan_local`, the planes gathered once;
- `net_walk`: a `Schedule` in one cooperative launch of the keyed network
  engine that `bitonic.bitonic_sort` shares (``csrc/keyed_network.cuh``):
  (key, source) words run the network in passes, the planes are gathered
  once at the end; in place or into a new state;
- `roll_pass`: roll(x, 16) + roll(x, 112) along each 128-element row.

``LAUNCHES[name]`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import types

import torch

from henjou_torch.accel.bitonic import (
    MAX_FUSED_COLS,
    NETWORK_TILE,
    c_plan,
    plan_passes,
    substages,
)
from henjou_torch.csrc import INT, PTR, bind, check

TILE = 1024  # net_local takes j < TILE
MAX_LIST = 256  # substages per net_local call
# net_local: a thread holds 2^LOCAL_REG_BITS words, a warp's lanes are
# LOCAL_LANE_BITS more element bits, the rest of a tile's are warp bits
LOCAL_REG_BITS = 3
LOCAL_LANE_BITS = 5
LOCAL_MIN_BITS = LOCAL_REG_BITS + LOCAL_LANE_BITS  # a one-warp tile, 256 elements
# plan codes of net_local (csrc/bitonic_net.cu `LocalPlan`)
LOCAL_LK_SHIFT = 5
LOCAL_OP_SHIFT = 10
LOCAL_NEW_LAYOUT = 1 << 13
MAX_N = 1 << 30
ROW = 128  # roll_pass row length
ROLL_SHIFTS = (16, 112)
GUARDS = (4, 16)  # guard chain lengths of net_substage
STATIC_PAIRS = ((32, 16), (1024, 512))  # (k, j) compiled as constants
MAX_STATIC_J = 1 << 16
MODES = ("dynamic", "static_j", "static")
# a schedule for n = 65,536 with k == j substages (both elements of a pair
# may take the same key), repeated and out-of-order j, and global substages
MIXED_SUBS = ((1 << 16, 1 << 15), (8192, 8192), (2048, 2048), (16, 16), (1 << 16, 4096),
              (2, 1), (8192, 4096), (8192, 4096), (64, 8192), (1 << 16, 1 << 15), (32, 16))

LAUNCHES = dict.fromkeys(("net_substage", "net_local", "net_walk", "roll_pass"), 0)


def _pow2(x: int) -> bool:
    return x >= 1 and (x & (x - 1)) == 0


def _check_pair(k: int, j: int, n: int) -> None:
    if not (_pow2(k) and _pow2(j) and j < n and k <= n):
        raise ValueError(f"substage (k={k}, j={j}) is not valid for n={n}")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A substage list for n elements on a device, checked against n once
    when it is made, and its plan for the kernel: the passes
    (`bitonic.plan_passes`) for the network's tile and their codes."""

    subs: tuple[tuple[int, int], ...]
    n: int
    device: torch.device
    passes: tuple
    codes: object  # ctypes array of the plan's codes


def make_schedule(subs, n: int, device) -> Schedule:
    """The Schedule of `subs` [(k, j), ...] for n elements on `device`."""
    subs = tuple((int(k), int(j)) for k, j in subs)
    for k, j in subs:
        _check_pair(k, j, n)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    codes, _ = c_plan(subs)
    return Schedule(subs=subs, n=n, device=device, passes=plan_passes(subs, NETWORK_TILE),
                    codes=codes)


def to_state(key: torch.Tensor, *planes: torch.Tensor) -> torch.Tensor:
    """[1 + len(planes), n] int32 state from [n] tensors of any 4-byte
    dtype (bitcast, not converted)."""
    cols = []
    for x in (key, *planes):
        if x.dim() != 1 or x.element_size() != 4 or x.shape[0] != key.shape[0]:
            raise ValueError("key and planes must be [n] tensors of a 4-byte dtype")
        cols.append(x.contiguous().view(torch.int32))
    return torch.stack(cols)


def _check_state(x: torch.Tensor) -> tuple[int, int]:
    if x.dim() != 2 or x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"the state must be a contiguous [P, n] int32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    p, n = x.shape
    if p < 1 or not _pow2(n) or n < TILE or n > MAX_N:
        raise ValueError(f"the state needs P >= 1 planes of n = 2^m in [{TILE}, {MAX_N}], "
                         f"got {tuple(x.shape)}")
    return p, n


def _out(src: torch.Tensor, dst: torch.Tensor | None) -> torch.Tensor:
    if dst is None:
        return torch.empty_like(src)
    if dst.shape != src.shape or dst.dtype != src.dtype or dst.device != src.device \
            or not dst.is_contiguous():
        raise ValueError("dst must be a contiguous tensor like src")
    return dst


def _device(x: torch.Tensor) -> str:
    """'cpu' or 'cuda'; raises for any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check_aligned(*xs: torch.Tensor) -> None:
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError("the state and dst must be 16-byte aligned (the kernels load and "
                         "store 16 bytes)")


# ---------------- the substage ----------------


def _substage(x: torch.Tensor, k: int, j: int) -> torch.Tensor:
    """One substage (k, j) of the state x: the plain version's core."""
    i = torch.arange(x.shape[1], device=x.device)
    partner = x[:, i ^ j]
    take_min = ((i & j) == 0) == ((i & k) == 0)
    key, pkey = x[0], partner[0]
    swap = torch.where(take_min, key > pkey, key < pkey)
    return torch.where(swap, partner, x)


def _check_substage(src, dst, k, j, per_plane, mode, guards):
    _, n = _check_state(src)
    _check_pair(k, j, n)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "static" and (k, j) not in STATIC_PAIRS:
        raise ValueError(f"mode 'static' compiles only (k, j) in {STATIC_PAIRS}")
    if mode == "static_j" and j > MAX_STATIC_J:
        raise ValueError(f"mode 'static_j' compiles j <= {MAX_STATIC_J}")
    if guards and (guards not in GUARDS or (k, j) != (32, 16) or per_plane):
        raise ValueError(f"a guard chain ({GUARDS}) wraps the stacked (32, 16) body only")
    if per_plane and dst is src:
        raise ValueError("the per-plane substage cannot run in place")
    return _out(src, dst)


def _guard_fires(guards: int, lj: int) -> bool:
    return not guards or any(lj == g % 16 for g in range(guards))


def net_substage_plain(src, k, j, *, dst=None, per_plane=False, mode="dynamic",
                       guards=0, lj=0):
    """Plain version of `net_substage`."""
    out = _check_substage(src, dst, k, j, per_plane, mode, guards)
    if _guard_fires(guards, lj):
        out.copy_(_substage(src, k, j))
    return out


@functools.cache
def _substage_fn():
    return bind("henjou_net_substage", [PTR, PTR, INT, INT, INT, INT, INT, INT, INT, INT, PTR])


def net_substage(src, k, j, *, dst=None, per_plane=False, mode="dynamic", guards=0, lj=0):
    """Substage (k, j) of the [P, n] state `src` into `dst` (a new tensor
    when None; `src` itself runs in place, except per plane). Stacked, one
    thread carries a pair's every plane; `per_plane` gives each (pair,
    plane) its own thread. `mode`: "static" compiles j and k as constants
    (the pairs of STATIC_PAIRS), "static_j" j only, "dynamic" neither.
    `guards` (4 or 16) wraps the static (32, 16) body in that many
    `lj == g % 16` tests; where none passes, dst is left as it was.
    Returns dst."""
    out = _check_substage(src, dst, k, j, per_plane, mode, guards)
    if _device(src) == "cpu":
        return net_substage_plain(src, k, j, dst=out, per_plane=per_plane, mode=mode,
                                  guards=guards, lj=lj)
    _check_aligned(src, out)
    p, n = src.shape
    check(_substage_fn()(src.data_ptr(), out.data_ptr(), p, n, j, k, int(per_plane),
                         MODES.index(mode), guards, lj, _stream(src)), "henjou_net_substage")
    LAUNCHES["net_substage"] += 1
    return out


# ---------------- the local run ----------------


def _check_local(src, dst, subs):
    _, n = _check_state(src)
    subs = [(int(k), int(j)) for k, j in subs]
    if len(subs) > MAX_LIST:
        raise ValueError(f"net_local takes at most {MAX_LIST} substages, got {len(subs)}")
    for k, j in subs:
        _check_pair(k, j, n)
        if j >= TILE:
            raise ValueError(f"net_local takes j < {TILE}, got {j}")
    return _out(src, dst), subs


def net_local_plain(src, subs, *, dst=None):
    """Plain version of `net_local`."""
    out, subs = _check_local(src, dst, subs)
    x = src
    for k, j in subs:
        x = _substage(x, k, j)
    return out.copy_(x)


@dataclasses.dataclass(frozen=True)
class LocalPlan:
    """How `net_local` runs a list on each tile of 2^bits elements. A
    layout is a tuple of element bits: register bits 0-2 of a thread's
    eight words, lane bits 0-4, then the warp bits. `ops[s]` is substage
    s's (layout index, "reg" or "lane", field): its j is that register or
    lane bit of the layout. Layout 0 is loaded; each later one begins with
    a round of the words through shared memory."""

    bits: int
    layouts: tuple[tuple[int, ...], ...]
    ops: tuple[tuple[int, str, int], ...]


def plan_local(subs) -> LocalPlan:
    """The plan of `net_local` for `subs` [(k, j), ...], as the kernel's
    host code makes it (csrc/bitonic_net.cu `plan_local`): the tile is
    2^bits elements, bits = max(LOCAL_MIN_BITS, log2 of twice the largest
    j), with bits - LOCAL_MIN_BITS warp bits. From substage i, a layout
    takes as warp bits those whose next use is furthest ahead (the higher
    bit on a tie) and serves until a warp bit's next use; its register
    bits are the three other bits used most in that run (the lower bit on
    a tie), its lane bits the rest, each group ascending."""
    ljs = [int(j).bit_length() - 1 for _, j in subs]
    bits = max([LOCAL_MIN_BITS] + [lj + 1 for lj in ljs])
    count = len(ljs)
    layouts, ops = [], []
    i = 0
    while True:
        nxt = {b: next((s for s in range(i, count) if ljs[s] == b), count) for b in range(bits)}
        warp = sorted(sorted(range(bits), key=lambda b: (-nxt[b], -b))[:bits - LOCAL_MIN_BITS])
        end = min([nxt[b] for b in warp] + [count])
        uses = {b: ljs[i:end].count(b) for b in range(bits)}
        rest = [b for b in range(bits) if b not in warp]
        regs = sorted(sorted(rest, key=lambda b: (-uses[b], b))[:LOCAL_REG_BITS])
        lanes = [b for b in rest if b not in regs]
        for s in range(i, end):
            b = ljs[s]
            ops.append((len(layouts), "reg", regs.index(b)) if b in regs
                       else (len(layouts), "lane", lanes.index(b)))
        layouts.append(tuple(regs + lanes + warp))
        i = end
        if i >= count:
            return LocalPlan(bits=bits, layouts=tuple(layouts), ops=tuple(ops))


def local_plan_codes(subs, plan: LocalPlan | None = None):
    """(codes, layouts) of `plan` (of `subs` when None) as the kernel
    encodes them: a substage's code holds log2 j, log2 k, the op (0-2
    register bit, 3-7 lane bit 0-4) and LOCAL_NEW_LAYOUT on the first
    substage of each layout; a layout 4 bits per field."""
    plan = plan_local(subs) if plan is None else plan
    codes, last = [], None
    for (k, j), (li, kind, f) in zip(subs, plan.ops):
        op = f if kind == "reg" else LOCAL_REG_BITS + f
        codes.append((int(j).bit_length() - 1) | (int(k).bit_length() - 1) << LOCAL_LK_SHIFT
                     | op << LOCAL_OP_SHIFT | (LOCAL_NEW_LAYOUT if li != last else 0))
        last = li
    layouts = [sum(b << (4 * f) for f, b in enumerate(lay)) for lay in plan.layouts]
    return codes, layouts


@functools.cache
def _local_fn():
    return bind("henjou_net_local", [PTR, PTR, INT, INT, PTR, PTR, INT, PTR])


def kernel_local_plan(subs):
    """(codes, layouts, bits) of the plan that the kernel's host code
    makes for `subs`, read from the library: for the tests on the card."""
    fn = bind("henjou_net_local_plan", [PTR, PTR, INT, PTR, PTR, PTR])
    m = max(1, len(subs))
    js = (ctypes.c_int64 * m)(*[j for _, j in subs])
    ks = (ctypes.c_int64 * m)(*[k for k, _ in subs])
    codes, layouts, info = (ctypes.c_int64 * m)(), (ctypes.c_int64 * m)(), (ctypes.c_int64 * 2)()
    check(fn(js, ks, len(subs), codes, layouts, info), "henjou_net_local_plan")
    return list(codes)[:len(subs)], list(layouts)[:info[1]], info[0]


def net_local(src, subs, *, dst=None):
    """The substages `subs` [(k, j), ...] (each j < TILE, at most
    MAX_LIST) of the state `src`, in order, into `dst` (new when None; may
    be `src`). Each tile of `plan_local` runs the whole list on its keys
    as (key, source) words, eight per thread, then gathers every plane
    once through the sources. Returns dst."""
    out, subs = _check_local(src, dst, subs)
    if _device(src) == "cpu":
        return net_local_plain(src, subs, dst=out)
    _check_aligned(src, out)
    p, n = src.shape
    js = (ctypes.c_int64 * max(1, len(subs)))(*[j for _, j in subs])
    ks = (ctypes.c_int64 * max(1, len(subs)))(*[k for k, _ in subs])
    check(_local_fn()(src.data_ptr(), out.data_ptr(), p, n, js, ks, len(subs), _stream(src)),
          "henjou_net_local")
    LAUNCHES["net_local"] += 1
    return out


# ---------------- the walk ----------------


def _check_walk(state, sched, inplace):
    _, n = _check_state(state)
    if not isinstance(sched, Schedule) or sched.n != n or sched.device != state.device:
        raise ValueError(f"the schedule must be a Schedule for n={n} on {state.device}")
    return state if inplace else torch.empty_like(state)


def net_walk_plain(state, sched, *, inplace=False, switch=False):
    """Plain version of `net_walk`."""
    dst = _check_walk(state, sched, inplace)
    x = state
    for k, j in sched.subs:
        x = _substage(x, k, j)
    return dst.copy_(x)


@functools.cache
def _walk_fn():
    return bind("henjou_net_walk",
                [PTR, PTR, PTR, PTR, PTR, INT, INT, PTR, INT, INT, INT, PTR])


def net_walk(state, sched, *, inplace=False, switch=False):
    """Every substage of the Schedule `sched` over the state, in one
    cooperative launch: (key, source) words run the schedule's passes with
    a grid-wide barrier after each, then the planes are gathered through
    the sources (above 17 planes the rest take further launches).
    `inplace`: the result goes back into `state`, which is returned;
    otherwise to a new tensor. `switch`: the first j of each global pass
    runs code compiled for it, picked by a switch on log2 j; otherwise j
    is used as read. Raises when CUDA refuses the cooperative launch."""
    if _device(state) == "cpu":
        return net_walk_plain(state, sched, inplace=inplace)
    dst = _check_walk(state, sched, inplace)
    p, n = state.shape
    buf = torch.empty_like(state) if inplace else dst
    words = torch.empty(n, dtype=torch.int64, device=state.device)
    idx = torch.empty(n, dtype=torch.int32, device=state.device) if p - 1 > MAX_FUSED_COLS \
        else None
    check(_walk_fn()(state.data_ptr(), dst.data_ptr(), buf.data_ptr(), words.data_ptr(),
                     None if idx is None else idx.data_ptr(), p, n, sched.codes,
                     len(sched.subs), int(inplace), int(switch), _stream(state)),
          "henjou_net_walk")
    LAUNCHES["net_walk"] += 1
    return dst


# ---------------- the roll pass ----------------


def _check_roll(src, dst):
    _check_state(src)
    if dst is src:
        raise ValueError("roll_pass cannot run in place")
    return _out(src, dst)


def roll_pass_plain(src, *, dst=None, per_plane=False):
    """Plain version of `roll_pass`."""
    out = _check_roll(src, dst)
    x = src.view(src.shape[0], -1, ROW)
    a, b = (torch.roll(x, s, dims=2) for s in ROLL_SHIFTS)
    return out.copy_((a + b).view_as(src))  # int32 adds wrap, as the kernel's


@functools.cache
def _roll_fn():
    return bind("henjou_roll_pass", [PTR, PTR, INT, INT, INT, PTR])


def roll_pass(src, *, dst=None, per_plane=False):
    """dst = roll(src, 16) + roll(src, 112) along each 128-element row of
    every plane (np.roll's direction, which is pltpu.roll's), wrapping on
    overflow, into `dst` (new when None; not `src`). `per_plane` gives
    each (element, plane) its own thread. Returns dst."""
    out = _check_roll(src, dst)
    if _device(src) == "cpu":
        return roll_pass_plain(src, dst=out, per_plane=per_plane)
    p, n = src.shape
    check(_roll_fn()(src.data_ptr(), out.data_ptr(), p, n, int(per_plane), _stream(src)),
          "henjou_roll_pass")
    LAUNCHES["roll_pass"] += 1
    return out


def ops(plain: bool = False) -> types.SimpleNamespace:
    """The four entry points, or with `plain` their plain versions (which
    run on any device), under the same names."""
    if plain:
        return types.SimpleNamespace(net_substage=net_substage_plain, net_local=net_local_plain,
                                     net_walk=net_walk_plain, roll_pass=roll_pass_plain)
    return types.SimpleNamespace(net_substage=net_substage, net_local=net_local,
                                 net_walk=net_walk, roll_pass=roll_pass)
