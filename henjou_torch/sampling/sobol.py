"""Owen-scrambled Sobol sampling (hash-based, Burley 2020), bit-equal to
the JAX package's.

Port of henjou_tpu/sampling/sobol.py. Every 2D draw uses Sobol dimensions
(0, 1): dimension 0 is the van der Corput sequence (the bit-reversed
index), dimension 1 the x+1-polynomial direction matrix (m = 1, 3, 5, 15,
17, 51, ...). Hash keys of (pixel, dimension counter, seed) drive a
hierarchy-preserving shuffle of the sample index and an Owen scramble of
each output, so every power-of-two prefix of a pixel's samples stays
stratified. The draws are counter-based, like the CMJ sampler's.

Values are u32 held in int64 tensors, as in `sampling/cmj.py`. The two
wide steps run as a few whole-tensor operations instead of one per bit:
the dimension-1 value XORs the 32 direction words masked by the index
bits as one [R, 32] tensor folded in halves (5 XORs), and a bit reversal
is a byte-table lookup per byte.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from henjou_torch.sampling.cmj import M32, _mul
from henjou_torch.utils.timer import span


def _gen_dim2_dirs() -> np.ndarray:
    """Direction numbers v_k = m_k << (32 - k) of Sobol dimension 2
    (primitive polynomial x+1: m_k = (m_{k-1} << 1) ^ m_{k-1}, m_1 = 1)."""
    m = [0, 1]
    for k in range(2, 33):
        m.append((m[k - 1] << 1) ^ m[k - 1])
    return np.asarray([(m[k] << (32 - k)) & M32 for k in range(1, 33)], np.int64)


_DIM2_DIRS = _gen_dim2_dirs()
# each byte's bits reversed
_REV8 = np.asarray([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.int64)


@functools.cache
def _tables(device: torch.device):
    """(direction words [32], bit shifts [32], byte reversal [256]) on
    `device`, made once per device. Callers must not write to them."""
    return (torch.from_numpy(_DIM2_DIRS).to(device),
            torch.arange(32, dtype=torch.int64, device=device),
            torch.from_numpy(_REV8).to(device))


def reverse_bits_u32(x):
    """Bit-reverse u32 values (an int64 tensor)."""
    rev = _tables(x.device)[2]
    return ((rev[x & 0xFF] << 24) | (rev[(x >> 8) & 0xFF] << 16)
            | (rev[(x >> 16) & 0xFF] << 8) | rev[x >> 24])


def _laine_karras(x, seed):
    """Laine-Karras-style hash whose bit i depends only on bits <= i of
    its input: an Owen permutation when applied to a bit-reversed value."""
    x = (x + seed) & M32
    x = x ^ _mul(x, 0x6C50B47C)
    x = x ^ _mul(x, 0xB82F1E52)
    x = x ^ _mul(x, 0xC7AFE638)
    x = x ^ _mul(x, 0x8D22F6E6)
    return x


def nested_uniform_scramble(x, seed):
    """Owen scramble of u32 sample values (applied to a sample index, a
    stratification-preserving shuffle of the sequence)."""
    return reverse_bits_u32(_laine_karras(reverse_bits_u32(x), seed))


def _sobol_dim2_u32(index):
    """Sobol dimension-2 value: the XOR of the direction words at the set
    bits of `index`, as one [R, 32] tensor folded in halves."""
    dirs, shifts, _ = _tables(index.device)
    words = torch.where(((index[..., None] >> shifts) & 1) != 0, dirs, 0)
    while words.shape[-1] > 1:
        half = words.shape[-1] // 2
        words = words[..., :half] ^ words[..., half:]
    return words[..., 0]


def _key_base(a, b):
    """The (pixel, dim) part of a scramble key, shared by a draw's three
    keys."""
    return _mul(a, 0x9E3779B1) + _mul(b, 0x85EBCA77)


def _finish_key(base, c):
    """The scramble key of (pixel, dim, seed c): an xxhash32 finalizer over
    a simple combine (the JAX package's `_hash_key`)."""
    h = (base + c) & M32
    h = _mul(h ^ (h >> 15), 0xC2B2AE3D)
    h = _mul(h ^ (h >> 13), 0x27D4EB2F)
    return h ^ (h >> 16)


# (v >> 8) * 2^-24: 24 exact mantissa bits, strictly below 1.0
_INV_2_24 = 1.0 / 16777216.0


def sobol_pair(n_spp, image_idx, dim, seed):
    """One padded Owen-Sobol 2D draw of u32 values (int64 tensors, or an
    int for `seed`): `n_spp` the absolute sample index within the pixel,
    `image_idx` the global pixel id, `dim` the per-lane dimension counter.
    Returns (fx, fy), f32 in [0, 1).

    The bit reversal is an involution, so the x value's scramble of the
    reversed index, reverse(LK(reverse(reverse(idx)))), is computed as
    reverse(LK(idx)): the same bits with two reversals fewer."""
    with span("sampling.draw"):
        base = _key_base(image_idx, dim)
        k_shuffle = _finish_key(base, seed ^ 0x5B1DE5A7)
        k_x = _finish_key(base, seed ^ 0xA341316C)
        k_y = _finish_key(base, seed ^ 0xC8013EA4)
        idx = nested_uniform_scramble(n_spp, k_shuffle)
        ux = reverse_bits_u32(_laine_karras(idx, k_x))
        uy = nested_uniform_scramble(_sobol_dim2_u32(idx), k_y)
        fx = (ux >> 8).to(torch.float32) * _INV_2_24
        fy = (uy >> 8).to(torch.float32) * _INV_2_24
        return fx, fy
