// The CMJ and Owen-Sobol draw of one lane, shared by the draw kernel
// (cmj.cu) and the BSDF kernels (bsdf.cu), so both draw with the same code.
//
// Equal to the plain PyTorch version (`_draw_2d` in sampling/cmj.py,
// `sobol_pair` in sampling/sobol.py) to the bit: the same integer steps in
// native uint32_t (a product mod 2^32 is a plain `*`, a rotate a funnel
// shift, a bit reversal `__brev`), and the same float steps in the same
// order, built with --fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace henjou {
namespace cmj {

constexpr uint32_t kSobolFlag = 0x80000000u;

__device__ __forceinline__ uint32_t rotl(uint32_t h, int r) {
  return __funnelshift_l(h, h, r);
}

// sampling/cmj.py `xxhash32`
__device__ __forceinline__ uint32_t xxhash32(uint32_t x, uint32_t y, uint32_t z,
                                             uint32_t w) {
  constexpr uint32_t P2 = 2246822519u, P3 = 3266489917u, P4 = 668265263u,
                     P5 = 374761393u;
  uint32_t h = w + P5 + x * P3;
  h = rotl(h, 17) * P4;
  h = h + y * P3;
  h = rotl(h, 17) * P4;
  h = h + z * P3;
  h = rotl(h, 17) * P4;
  h = (h ^ (h >> 15)) * P2;
  h = (h ^ (h >> 13)) * P3;
  return h ^ (h >> 16);
}

// sampling/cmj.py `_cmj_permute_small`: power-of-two l <= 32
__device__ __forceinline__ uint32_t permute_small(uint32_t i, uint32_t l, uint32_t p) {
  const uint32_t w = l - 1;
  i ^= p;
  i *= 0xE170893Du;
  i ^= p >> 16;
  i ^= (i & w) >> 4;
  i ^= p >> 8;
  i *= 0x0929EB3Fu;
  i ^= p >> 23;
  i ^= (i & w) >> 1;
  i *= 1u | (p >> 27);
  i *= 0x6935FA69u;
  i ^= (i & w) >> 11;
  i *= 0x74DCB303u;
  i ^= (i & w) >> 2;
  i *= 0x9E501CC3u;
  i ^= (i & w) >> 2;
  i *= 0xC860A3DFu;
  i &= w;
  i ^= i >> 5;
  return (i + p) & w;
}

// sampling/cmj.py `_cmj_randfloat`
__device__ __forceinline__ float randfloat(uint32_t i, uint32_t p) {
  i ^= p;
  i ^= i >> 17;
  i ^= i >> 10;
  i *= 0xB36534E5u;
  i ^= i >> 12;
  i ^= i >> 21;
  i *= 0x93FC4795u;
  i ^= 0xDF6E307Fu;
  i ^= i >> 17;
  i *= 1u | (p >> 18);
  // the Python double 1/4294967808 cast to f32, as torch casts the scalar
  return __uint2float_rn(i) * (float)(1.0 / 4294967808.0);
}

// sampling/cmj.py `_draw_2d` without the Sobol choice
__device__ __forceinline__ void cmj_2d(uint32_t n_spp, uint32_t image_idx,
                                       uint32_t depth, uint32_t seed, float& fx,
                                       float& fy) {
  const uint32_t s = xxhash32(n_spp >> 4, image_idx, depth, seed);
  const uint32_t index = permute_small(n_spp & 15u, 16, s * 0x51633E2Du);
  const uint32_t sx = permute_small(index & 3u, 4, s * 0xA511E9B3u);
  const uint32_t sy = permute_small(index >> 2, 4, s * 0x63D83595u);
  const float jx = randfloat(index, s * 0xA399D265u);
  const float jy = randfloat(index, s * 0x711AD6A5u);
  fx = (__uint2float_rn(index & 3u) + (__uint2float_rn(sy) + jx) / 4.0f) / 4.0f;
  fy = (__uint2float_rn(index >> 2) + (__uint2float_rn(sx) + jy) / 4.0f) / 4.0f;
}

// sampling/sobol.py `_laine_karras`
__device__ __forceinline__ uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

// sampling/sobol.py `nested_uniform_scramble`
__device__ __forceinline__ uint32_t nested_uniform_scramble(uint32_t x, uint32_t seed) {
  return __brev(laine_karras(__brev(x), seed));
}

// sampling/sobol.py `_sobol_dim2_u32`: the XOR of the direction words
// v_k = m_k << (32 - k) at the set bits of index (m_1 = 1,
// m_k = (m_{k-1} << 1) ^ m_{k-1}, so m_k has k bits)
__device__ __forceinline__ uint32_t sobol_dim2(uint32_t index) {
  uint32_t v = 0, m = 1;
#pragma unroll
  for (int k = 1; k <= 32; ++k) {
    if ((index >> (k - 1)) & 1u) v ^= m << (32 - k);
    m = (m << 1) ^ m;
  }
  return v;
}

// sampling/sobol.py `_finish_key` over `_key_base`'s base
__device__ __forceinline__ uint32_t finish_key(uint32_t base, uint32_t c) {
  uint32_t h = base + c;
  h = (h ^ (h >> 15)) * 0xC2B2AE3Du;
  h = (h ^ (h >> 13)) * 0x27D4EB2Fu;
  return h ^ (h >> 16);
}

// sampling/sobol.py `sobol_pair`
__device__ __forceinline__ void sobol_pair(uint32_t n_spp, uint32_t image_idx,
                                           uint32_t dim, uint32_t seed, float& fx,
                                           float& fy) {
  const uint32_t base = image_idx * 0x9E3779B1u + dim * 0x85EBCA77u;
  const uint32_t k_shuffle = finish_key(base, seed ^ 0x5B1DE5A7u);
  const uint32_t k_x = finish_key(base, seed ^ 0xA341316Cu);
  const uint32_t k_y = finish_key(base, seed ^ 0xC8013EA4u);
  const uint32_t idx = nested_uniform_scramble(n_spp, k_shuffle);
  const uint32_t ux = __brev(laine_karras(idx, k_x));
  const uint32_t uy = nested_uniform_scramble(sobol_dim2(idx), k_y);
  fx = __uint2float_rn(ux >> 8) * (1.0f / 16777216.0f);
  fy = __uint2float_rn(uy >> 8) * (1.0f / 16777216.0f);
}

// One 2D draw from dimension counter `dim` of the lane (n_spp, image_idx,
// scramble): the Owen-Sobol pair when `sobol` is set and the scramble
// carries kSobolFlag (seeded by its other 31 bits), else the CMJ pair
// (sampling/cmj.py `_draw_2d`).
__device__ __forceinline__ void draw_2d(uint32_t n_spp, uint32_t image_idx, uint32_t dim,
                                        uint32_t scramble, bool sobol, float& fx, float& fy) {
  if (sobol && (scramble & kSobolFlag) != 0)
    sobol_pair(n_spp, image_idx, dim, scramble & ~kSobolFlag, fx, fy);
  else
    cmj_2d(n_spp, image_idx, dim, scramble, fx, fy);
}

}  // namespace cmj
}  // namespace henjou
