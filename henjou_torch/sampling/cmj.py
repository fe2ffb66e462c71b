"""Correlated multi-jittered sampling, bit-equal to the JAX package's.

Port of henjou_tpu/sampling/cmj.py (4x4 CMJ strata, an xxhash32 scramble
keyed on (sample index, pixel index, dimension counter, seed) and Kensler
permutations). The state is threaded functionally: every draw returns
(value, new_state).

torch's uint32 supports few operators, so every u32 value is held in an
int64 tensor and masked with ``& 0xFFFFFFFF`` after each operation. A
product of two u32 values can reach 2^64 and overflow int64, so `_mul`
splits one factor into 16-bit halves and keeps every partial product
below 2^48: the result is exact without relying on signed wraparound.

A state made with ``sobol=True`` draws through the Owen-scrambled Sobol
sampler (`sampling/sobol.py`) on the lanes whose seed carries
SOBOL_SEED_FLAG, and the CMJ values on the others, as the JAX package's
`cmj_2d` does when its process-wide `set_sobol_enabled(True)` gate is on.
Here the choice rides on the state (a static field that every draw keeps),
so two renderers in one process cannot share it. With ``sobol=False``
(the default) the Sobol pair is not computed at all.

On a CUDA state every draw (`cmj_1d` to `cmj_4d`) is one launch of
``csrc/cmj.cu``, which computes the same bits in native u32 arithmetic
(the Sobol pair included) and returns a new `depth` tensor; the state's
fields must be int64 tensors of one shape on one device. Any other state
takes the torch code below, the plain version (`draw_plain`). ``LAUNCHES``
counts the draws that went through the kernel's entry point (a draw of no
lanes launches nothing); under a profiler session the counters
``sampling.draws`` and ``sampling.draws_kernel`` count every draw and
those through the kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from henjou_torch.csrc import INT, PTR, bind, check
from henjou_torch.utils.timer import count, span

CMJ_M = 4
CMJ_N = 4
M32 = 0xFFFFFFFF
# seed tag bit selecting the Sobol sampler for a lane (the low 31 seed
# bits mean the same in both samplers)
SOBOL_SEED_FLAG = 0x80000000

LAUNCHES = 0


def _mul(a, b):
    """(a * b) mod 2^32 for u32 values held in int64 (tensor or int)."""
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & M32


def _rotl(h, r: int):
    return ((h << r) | (h >> (32 - r))) & M32


class CMJState(NamedTuple):
    """Per-lane sampler state; every field a u32 value in an int64 tensor."""

    n_spp: torch.Tensor  # sample index within the pixel
    scramble: torch.Tensor  # global seed
    depth: torch.Tensor  # dimension counter, bumped per draw
    image_idx: torch.Tensor  # pixel index
    # static: tagged lanes draw Sobol values (see the module docstring)
    sobol: bool = False


def _u32(x, device=None):
    return torch.as_tensor(x, device=device).to(torch.int64) & M32


def make_cmj_state(n_spp, image_idx, seed=0, sobol: bool = False) -> CMJState:
    with span("sampling.draw"):
        image_idx = _u32(image_idx)
        n_spp = _u32(n_spp, image_idx.device)
        shape = torch.broadcast_shapes(n_spp.shape, image_idx.shape)
        zero = torch.zeros(shape, dtype=torch.int64, device=image_idx.device)
        return CMJState(
            n_spp=n_spp.expand(shape) + zero,
            scramble=_u32(seed, image_idx.device).expand(shape) + zero,
            depth=zero,
            image_idx=image_idx.expand(shape) + zero,
            sobol=bool(sobol),
        )


def xxhash32(x, y, z, w):
    """xxhash32 of a uint4."""
    PRIME32_2 = 2246822519
    PRIME32_3 = 3266489917
    PRIME32_4 = 668265263
    PRIME32_5 = 374761393
    h = (w + PRIME32_5 + _mul(x, PRIME32_3)) & M32
    h = _mul(_rotl(h, 17), PRIME32_4)
    h = (h + _mul(y, PRIME32_3)) & M32
    h = _mul(_rotl(h, 17), PRIME32_4)
    h = (h + _mul(z, PRIME32_3)) & M32
    h = _mul(_rotl(h, 17), PRIME32_4)
    h = _mul(h ^ (h >> 15), PRIME32_2)
    h = _mul(h ^ (h >> 13), PRIME32_3)
    return h ^ (h >> 16)


def _cmj_permute_small(i, l: int, p):
    """Kensler permutation for power-of-two l <= 32 (one pass of the
    reference do/while is exact there; see the JAX module's note)."""
    w = l - 1
    i = i ^ p
    i = _mul(i, 0xE170893D)
    i = i ^ (p >> 16)
    i = i ^ ((i & w) >> 4)
    i = i ^ (p >> 8)
    i = _mul(i, 0x0929EB3F)
    i = i ^ (p >> 23)
    i = i ^ ((i & w) >> 1)
    i = _mul(i, 1 | (p >> 27))
    i = _mul(i, 0x6935FA69)
    i = i ^ ((i & w) >> 11)
    i = _mul(i, 0x74DCB303)
    i = i ^ ((i & w) >> 2)
    i = _mul(i, 0x9E501CC3)
    i = i ^ ((i & w) >> 2)
    i = _mul(i, 0xC860A3DF)
    i = i & w
    i = i ^ (i >> 5)
    return ((i + p) & M32) % l


def _cmj_randfloat(i, p):
    """Integer-hash float in [0, 1)."""
    i = i ^ p
    i = i ^ (i >> 17)
    i = i ^ (i >> 10)
    i = _mul(i, 0xB36534E5)
    i = i ^ (i >> 12)
    i = i ^ (i >> 21)
    i = _mul(i, 0x93FC4795)
    i = i ^ 0xDF6E307F
    i = i ^ (i >> 17)
    i = _mul(i, 1 | (p >> 18))
    # a Python scalar is cast to the f32 tensor's type, as jnp.float32(...)
    # is in the JAX package (and needs no host-to-device copy)
    return i.to(torch.float32) * (1.0 / 4294967808.0)


def _cmj(index, scramble):
    """One 2D CMJ sample from stratum `index`."""
    index = _cmj_permute_small(index, CMJ_M * CMJ_N, _mul(scramble, 0x51633E2D))
    sx = _cmj_permute_small(index % CMJ_M, CMJ_M, _mul(scramble, 0xA511E9B3))
    sy = _cmj_permute_small(index // CMJ_M, CMJ_N, _mul(scramble, 0x63D83595))
    jx = _cmj_randfloat(index, _mul(scramble, 0xA399D265))
    jy = _cmj_randfloat(index, _mul(scramble, 0x711AD6A5))
    fx = (
        (index % CMJ_M).to(torch.float32) + (sy.to(torch.float32) + jx) / CMJ_N
    ) / CMJ_M
    fy = (
        (index // CMJ_M).to(torch.float32) + (sx.to(torch.float32) + jy) / CMJ_M
    ) / CMJ_N
    return fx, fy


def _draw_2d(state: CMJState):
    """`cmj_2d` without its span: the draw that every form takes."""
    index = state.n_spp % (CMJ_M * CMJ_N)
    scramble = xxhash32(
        state.n_spp // (CMJ_M * CMJ_N),
        state.image_idx,
        state.depth,
        state.scramble,
    )
    fx, fy = _cmj(index, scramble)
    if state.sobol:
        from henjou_torch.sampling.sobol import sobol_pair

        sx, sy = sobol_pair(state.n_spp, state.image_idx, state.depth,
                            state.scramble & (M32 ^ SOBOL_SEED_FLAG))
        tag = (state.scramble & SOBOL_SEED_FLAG) != 0
        fx = torch.where(tag, sx, fx)
        fy = torch.where(tag, sy, fy)
    new_state = state._replace(depth=(state.depth + 1) & M32)
    return torch.stack([fx, fy], dim=-1), new_state


def draw_plain(state: CMJState, width: int):
    """The torch code of a draw of `width` components (1: `cmj_1d`, 2:
    `cmj_2d`, 3: `cmj_3d`, 4: `cmj_4d`) on any device."""
    xi, state = _draw_2d(state)
    if width == 1:
        return xi[..., 0], state
    if width == 2:
        return xi, state
    b, state = _draw_2d(state)
    return torch.cat([xi, b[..., :width - 2]], dim=-1), state


@functools.cache
def _kernel_fn():
    return bind("henjou_cmj_draw", [PTR, PTR, PTR, PTR, INT, INT, INT, PTR, PTR, PTR])


def _draw_cuda(state: CMJState, width: int):
    """One launch of csrc/cmj.cu on the state's device's current stream."""
    global LAUNCHES
    fields = (state.n_spp, state.scramble, state.depth, state.image_idx)
    shape, dev = state.n_spp.shape, state.n_spp.device
    for name, x in zip(CMJState._fields, fields):
        if x.dtype != torch.int64 or x.shape != shape or x.device != dev:
            raise ValueError(f"state.{name} must be int64 of shape {tuple(shape)} on {dev}, "
                             f"got {x.dtype} of shape {tuple(x.shape)} on {x.device}")
    fields = [x.contiguous() for x in fields]
    out = torch.empty((*shape, width) if width > 1 else shape, dtype=torch.float32, device=dev)
    depth = torch.empty(shape, dtype=torch.int64, device=dev)
    err = _kernel_fn()(*(x.data_ptr() for x in fields), fields[0].numel(), width,
                       int(state.sobol), out.data_ptr(), depth.data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream)
    check(err, "henjou_cmj_draw")
    LAUNCHES += 1
    count("sampling.draws_kernel", 1)
    return out, state._replace(depth=depth)


def _draw(state: CMJState, width: int):
    count("sampling.draws", 1)
    if state.n_spp.is_cuda:
        return _draw_cuda(state, width)
    return draw_plain(state, width)


def cmj_2d(state: CMJState):
    """Draw a 2D sample; returns ((x, y) [..., 2], new_state)."""
    with span("sampling.draw"):
        return _draw(state, 2)


def cmj_1d(state: CMJState):
    """A 2D draw's x component."""
    with span("sampling.draw"):
        return _draw(state, 1)


def cmj_3d(state: CMJState):
    """A 2D draw, then a 1D draw; returns ([..., 3], new_state)."""
    with span("sampling.draw"):
        return _draw(state, 3)


def cmj_4d(state: CMJState):
    """Two 2D draws; returns ([..., 4], new_state)."""
    with span("sampling.draw"):
        return _draw(state, 4)
