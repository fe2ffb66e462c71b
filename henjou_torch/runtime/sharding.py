"""Multi-GPU scaling: sample (spp) and pixel (tile) sharding over a
`torch.distributed` process group, one process per GPU.

Port of henjou_tpu/runtime/sharding.py. The JAX package shards inside one
program with `shard_map` over a device mesh; the port's engine is eager
Python with a host read-back every iteration, so one process drives one
card and the processes meet in collectives:

- **spp sharding**: every process renders the same pixels with a disjoint
  slice of the sample indices (the samplers are counter-based, so shifting
  the sample index by the rank is exact sample partitioning), then the
  per-pixel sums are added with one `all_reduce`;
- **tile sharding**: the pixels are split across processes, and the image
  is put together with `all_gather`.

The group must be initialised by the caller (`init_process_group` with an
address, world size and rank; nothing here reads a cluster environment).
NCCL groups reduce CUDA tensors in place on the card; any other backend
(gloo) reduces on the CPU, so a gloo group may also drive CUDA renders.
`world()` is (1, 0) without a group, and every helper then runs the
single-process computation.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def world() -> tuple[int, int]:
    """(world size, rank) of the default process group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _comm_device(t: torch.Tensor) -> torch.device:
    return t.device if dist.get_backend() == "nccl" else torch.device("cpu")


def all_reduce_sum(*tensors: torch.Tensor):
    """Each tensor summed over the group, on its own device."""
    out = []
    for t in tensors:
        x = t.to(_comm_device(t)).clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        out.append(x.to(t.device))
    return tuple(out)


def all_reduce_film(sums):
    """A pixel group's (color, albedo, normal [P,3]; m2, count [P];
    traces 0-d i64) summed over the group: the float sums in one
    all-reduce, the exact trace count in another."""
    c, a, nm, m2, cnt, traces = sums
    flat = torch.cat([c, a, nm, m2[:, None], cnt[:, None]], dim=1)
    flat, traces = all_reduce_sum(flat, traces)
    return flat[:, 0:3], flat[:, 3:6], flat[:, 6:9], flat[:, 9], flat[:, 10], traces


def broadcast_int(value: int, src: int = 0) -> int:
    """Rank `src`'s value of an int, on every process."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=src)
    return int(t.item())


def spp_sharded_step(render_one_spp: Callable):
    """Wrap `render_one_spp(spp_idx: int) -> (color, albedo, normal)`
    ([lanes,3] each) into `run(spp_start)`: process k renders sample index
    spp_start + k, and every process gets the mean over the group."""
    n_dev, rank = world()

    def run(spp_start: int):
        parts = render_one_spp(spp_start + rank)
        if n_dev > 1:
            parts = all_reduce_sum(*parts)
        return tuple(x / n_dev for x in parts)

    return run


def wavefront_sharded_step(wavefront_fn: Callable, spp_per_device: int):
    """Shard the wavefront engine by sample slices: process k runs
    `wavefront_fn(spp_offset)` (a refilling-pool render of
    `spp_per_device` samples per pixel, returning a WavefrontFilm of
    per-pixel sums) at offset spp_start + k * spp_per_device, then the
    films are summed over the group. Returns `run(spp_start)` ->
    (color, albedo, normal, n_traces, m2, count)."""
    n_dev, rank = world()

    def run(spp_start: int):
        film = wavefront_fn(spp_start + spp_per_device * rank)
        sums = (film.color, film.albedo, film.normal, film.m2, film.count, film.n_traces)
        if n_dev > 1:
            sums = all_reduce_film(sums)
        c, a, nm, m2, cnt, traces = sums
        return c, a, nm, traces, m2, cnt

    return run


def tile_sharded_step(render_pixels: Callable):
    """Wrap `render_pixels(pixel_idx[tile], spp_idx) -> ([tile,3],) * 3`
    into `step(pixel_idx[L], spp_idx)`: process k renders the k-th of
    equal slices of the pixels (L divisible by the world size) and every
    process gets the whole [L,3] outputs back by `all_gather`."""
    n_dev, rank = world()

    def step(pixel_idx: torch.Tensor, spp_idx: int):
        if pixel_idx.shape[0] % n_dev:
            raise ValueError(f"{pixel_idx.shape[0]} pixels do not split over {n_dev} processes")
        tile = pixel_idx.shape[0] // n_dev
        parts = render_pixels(pixel_idx[rank * tile:(rank + 1) * tile], spp_idx)
        if n_dev == 1:
            return tuple(parts)
        out = []
        for x in parts:
            y = x.to(_comm_device(x)).contiguous()
            got = [torch.empty_like(y) for _ in range(n_dev)]
            dist.all_gather(got, y)
            out.append(torch.cat(got).to(x.device))
        return tuple(out)

    return step
