"""Payload-carrying ray sort: the CUDA bitonic kernel and its plain version.

Port of henjou_tpu/accel/bitonic.py. `bitonic_sort(key, *planes)` sorts
non-negative i32 keys ascending and moves every 4-byte payload plane
([n], or [n, c] rows such as ray origins) through the same permutation;
`bitonic_unsort(lid, *planes)` is the inverse used after a trace: it
writes plane[i] to position lid[i].

For CUDA tensors both run the hand-written kernels of
``csrc/bitonic.cu``; for CPU tensors they run the plain PyTorch versions
(`bitonic_sort_plain`, `bitonic_unsort_plain`), which compute the same
results bit for bit. The sort is stable: equal keys keep their input order
(the JAX kernel leaves their order unspecified, so this is a strict
refinement of its contract).

On the card the sort is one cooperative launch of the keyed network
engine (``csrc/keyed_network.cuh``), which `bitonic_net.net_walk` shares:
8-byte (key, source) words run the network and the payload is gathered
once at the end. The host cuts the substage list into passes
(`plan_passes`): runs of substages with j below the tile in shared memory,
and global substages over device memory, each cut into groups of up to
three whose words stay in one thread's registers (`plan_groups`).

``LAUNCHES`` counts the wrapper calls that launched the CUDA kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from henjou_torch.csrc import INT, PTR, bind, check

LAUNCHES = 0

_MIN_N = 1024
MAX_N = 1 << 30
# words per shared-memory tile of the network (csrc/keyed_network.cuh
# NET_TILE) and substages per group, picked on the H100 from CUDA-graph
# times of tiles 512-8192 and groups of 2 and 3 (PERF.md)
NETWORK_TILE = 1024
NETWORK_GROUP = 3
MAX_SUBS = 1024  # substages per plan (csrc/keyed_network.cuh NET_MAX_SUBS)
# a substage's code: log2 j | log2 k << 5, GROUP_START on a group's first
# substage, PASS_START on a pass's, with GLOBAL for a global pass
# (keyed_network.cuh `Plan`)
GROUP_START = 1 << 10
PASS_START = 1 << 11
GLOBAL = 1 << 12
MAX_FUSED_COLS = 16  # payload columns gathered inside the network's launch


def valid_size(n: int) -> bool:
    """The kernel takes n a power of two, 1024 <= n <= 2^30."""
    return _MIN_N <= n <= MAX_N and (n & (n - 1)) == 0


def substages(n: int) -> list[tuple[int, int]]:
    """The bitonic sort's substage list [(k, j), ...] for power-of-two n
    (the port's copy of henjou_tpu/accel/bitonic.py `_substages`)."""
    out = []
    k = 2
    while k <= n:
        j = k >> 1
        while j >= 1:
            out.append((k, j))
            j >>= 1
        k <<= 1
    return out


def plan_groups(subs, first: int, count: int, group: int = NETWORK_GROUP):
    """Substages first .. first + count - 1 of `subs` cut greedily into
    groups [(first, count), ...] of at most `group` consecutive substages
    of distinct j: the words of one group's 2^m elements stay in one
    thread's registers for all of its substages."""
    groups = []
    for s in range(first, first + count):
        if groups and groups[-1][1] < group and all(
                subs[r][1] != subs[s][1] for r in range(groups[-1][0], s)):
            groups[-1][1] += 1
        else:
            groups.append([s, 1])
    return [tuple(g) for g in groups]


def plan_passes(subs, tile: int, group: int = NETWORK_GROUP):
    """The passes of the network over the substage list `subs` [(k, j),
    ...] with `tile`-word tiles: ("local", first, count) for each maximal
    run of substages with j < tile, and ("global", first, count) for each
    group (`plan_groups`) of a run of substages with j >= tile. Together
    they cover every substage once, in order."""
    passes, s = [], 0
    while s < len(subs):
        local = subs[s][1] < tile
        e = s
        while e < len(subs) and (subs[e][1] < tile) == local:
            e += 1
        if local:
            passes.append(("local", s, e - s))
        else:
            passes += [("global", f, c) for f, c in plan_groups(subs, s, e - s, group)]
        s = e
    return tuple(passes)


def plan_codes(subs, passes, group: int = NETWORK_GROUP) -> list[int]:
    """The plan as the kernel takes it: one code per substage (see
    GROUP_START)."""
    codes = [(j.bit_length() - 1) | ((k.bit_length() - 1) << 5) for k, j in subs]
    for kind, first, count in passes:
        codes[first] |= PASS_START | (GLOBAL if kind == "global" else 0)
        for f, _ in plan_groups(subs, first, count, group):
            codes[f] |= GROUP_START
    return codes


def c_plan(subs):
    """(ctypes array of the plan's codes, count) for the kernel, with the
    engine's tile and group size."""
    if len(subs) > MAX_SUBS:
        raise ValueError(f"the network takes at most {MAX_SUBS} substages, got {len(subs)}")
    codes = plan_codes(subs, plan_passes(subs, NETWORK_TILE))
    return (ctypes.c_int64 * max(1, len(codes)))(*codes), len(codes)


@functools.cache
def _sort_plan(n: int):
    return c_plan(substages(n))


def _check_inputs(key: torch.Tensor, planes) -> int:
    if key.dim() != 1 or key.dtype != torch.int32:
        raise TypeError(f"key must be 1-D int32, got {key.dtype} {tuple(key.shape)}")
    n = key.shape[0]
    for p in planes:
        if p.dim() not in (1, 2) or p.shape[0] != n or p.device != key.device:
            raise ValueError("every plane must be [n] or [n, c] on the key's device")
        if p.element_size() != 4:
            raise TypeError(f"payload planes must be 4-byte, got {p.dtype}")
    return n


def _columns(planes):
    """(outputs, descriptor, column count) for the gather/scatter
    kernels: one output per plane, allocated like it, and a host array of
    (src, dst, stride) per 4-byte column, so an [n, c] plane moves as c
    strided columns."""
    outs, desc = [], []
    for p in planes:
        if not p.is_contiguous():
            raise ValueError("payload planes must be contiguous")
        out = torch.empty_like(p)
        cols = 1 if p.dim() == 1 else p.shape[1]
        for c in range(cols):
            desc += [p.data_ptr() + 4 * c, out.data_ptr() + 4 * c, cols]
        outs.append(out)
    return tuple(outs), (ctypes.c_int64 * len(desc))(*desc), len(desc) // 3


@functools.cache
def _fns():
    sort = bind("henjou_bitonic_sort", [PTR, PTR, PTR, PTR, PTR, INT, INT, PTR, INT, PTR])
    scatter = bind("henjou_scatter_columns", [PTR, INT, PTR, INT, PTR])
    return sort, scatter


def bitonic_sort_plain(key: torch.Tensor, *planes: torch.Tensor):
    """Plain version: a stable argsort plus indexing."""
    _check_inputs(key, planes)
    perm = torch.argsort(key, stable=True)
    return (key[perm],) + tuple(p[perm] for p in planes)


def bitonic_unsort_plain(lid: torch.Tensor, *planes: torch.Tensor):
    """Plain version of the inverse: out[lid[i]] = plane[i]."""
    _check_inputs(lid, planes)
    idx = lid.long()
    outs = []
    for p in planes:
        out = torch.empty_like(p)
        out[idx] = p
        outs.append(out)
    return tuple(outs)


def bitonic_sort(key: torch.Tensor, *planes: torch.Tensor):
    """Sort i32 `key` ascending (stable), carrying `planes` (any 4-byte
    dtype, [n] or [n, c]) through the same permutation. `key` is [n]; on CUDA
    n must be a power of two, 1024 <= n <= 2^30, and the sort is one launch
    of the network (one more launch gathers columns beyond 16). Returns
    (sorted_key, *sorted_planes)."""
    global LAUNCHES
    n = _check_inputs(key, planes)
    if key.device.type == "cpu":
        return bitonic_sort_plain(key, *planes)
    if key.device.type != "cuda":
        raise ValueError(f"unsupported device {key.device}")
    if not valid_size(n):
        raise ValueError(f"bitonic_sort needs n = 2^m in [{_MIN_N}, {MAX_N}], got {n}")
    codes, count = _sort_plan(n)
    sort_fn, _ = _fns()
    key = key.contiguous()
    stream = torch.cuda.current_stream(key.device).cuda_stream
    key_out = torch.empty_like(key)
    words = torch.empty(n, dtype=torch.int64, device=key.device)
    outs, desc, n_cols = _columns(planes)
    idx = torch.empty_like(key) if n_cols > MAX_FUSED_COLS else None
    check(sort_fn(key.data_ptr(), key_out.data_ptr(), words.data_ptr(),
                  None if idx is None else idx.data_ptr(), desc, n_cols, n, codes, count,
                  stream), "henjou_bitonic_sort")
    LAUNCHES += 1
    return (key_out,) + outs


def bitonic_unsort(lid: torch.Tensor, *planes: torch.Tensor):
    """Inverse permutation by lane id: returns planes with
    out[lid[i]] = plane[i]. `lid` (i32) must be a permutation of
    0..n-1, as the lane ids carried through `bitonic_sort` are."""
    global LAUNCHES
    n = _check_inputs(lid, planes)
    if lid.device.type == "cpu":
        return bitonic_unsort_plain(lid, *planes)
    if lid.device.type != "cuda":
        raise ValueError(f"unsupported device {lid.device}")
    if not planes:
        return ()
    _, scatter_fn = _fns()
    lid = lid.contiguous()
    stream = torch.cuda.current_stream(lid.device).cuda_stream
    outs, desc, n_cols = _columns(planes)
    check(scatter_fn(desc, n_cols, lid.data_ptr(), n, stream),
          "henjou_scatter_columns")
    LAUNCHES += 1
    return outs
