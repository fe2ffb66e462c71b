// One CMJ (or Owen-Sobol) draw per launch, for Hopper (sm_90a).
//
// Replaces no Pallas TPU kernel: the JAX package's CMJ and Sobol samplers
// (henjou_tpu/sampling/cmj.py, sobol.py) are plain jnp code that XLA fuses.
// Their torch port (sampling/cmj.py, sobol.py) keeps every u32 in an int64
// tensor and masks it after each op, so one 2D draw is some 400 tensor ops,
// each a launch; on the card the host's cost of those launches was most of
// a frame's time. This kernel is the whole draw in one launch: one thread
// per lane, native uint32_t arithmetic (a product mod 2^32 is a plain `*`,
// a rotate a funnel shift, a bit reversal `__brev`).
//
// A lane reads the state's four int64 fields (n_spp, scramble, depth,
// image_idx), draws `width <= 2 ? 1 : 2` consecutive 2D samples from
// dimension counters depth and depth + 1, writes the first `width` of their
// components (x0, y0, x1, y1) as f32 to out[lane * width + j], and writes
// the new counter (depth + draws) mod 2^32 to depth_out; the input state is
// not written. With `sobol` set, a lane whose scramble carries the tag bit
// 0x80000000 draws the Owen-Sobol pair instead, seeded by the other 31 bits.
//
// Equal to the plain PyTorch version (`_draw_2d` in sampling/cmj.py) to the
// bit: the same integer steps, and the same float steps in the same order
// (u32 -> f32 round to nearest, times f32(1/4294967808); (sy + jx) / 4,
// then (index % 4 + that) / 4), built with --fmad=false.
//
// What bounds it: 48 bytes a lane for a 2D draw (32 in, 8 + 8 out), 56 for
// a 4D one; 131,072 lanes move 6.3 MB, about 2 us at 3.35 TB/s, and the
// arithmetic (some 200 integer ops a draw) is smaller still. So the launch
// itself bounds it; the design's point is one launch where there were 400.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cmj.cuh"
#include "common.cuh"

namespace {

// One lane's draw: W components, 1 or 2 from one 2D draw, 3 or 4 from two
template <int W>
__device__ __forceinline__ void draw_lane(long long lane, const int64_t* __restrict__ n_spp,
                                          const int64_t* __restrict__ scramble,
                                          const int64_t* __restrict__ depth,
                                          const int64_t* __restrict__ image_idx, bool sobol,
                                          float* __restrict__ out,
                                          int64_t* __restrict__ depth_out) {
  constexpr int kDraws = W <= 2 ? 1 : 2;
  // the fields hold u32 values: the low 32 bits are the value
  const uint32_t spp = (uint32_t)n_spp[lane];
  const uint32_t scr = (uint32_t)scramble[lane];
  const uint32_t dep = (uint32_t)depth[lane];
  const uint32_t pix = (uint32_t)image_idx[lane];
  float v[2 * kDraws];
#pragma unroll
  for (int d = 0; d < kDraws; ++d)
    henjou::cmj::draw_2d(spp, pix, dep + d, scr, sobol, v[2 * d], v[2 * d + 1]);
#pragma unroll
  for (int j = 0; j < W; ++j) out[lane * W + j] = v[j];
  depth_out[lane] = (int64_t)(uint32_t)(dep + kDraws);
}

template <int W>
__global__ void cmj_draw(const int64_t* __restrict__ n_spp,
                         const int64_t* __restrict__ scramble,
                         const int64_t* __restrict__ depth,
                         const int64_t* __restrict__ image_idx, long long n, bool sobol,
                         float* __restrict__ out, int64_t* __restrict__ depth_out) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < n) draw_lane<W>(lane, n_spp, scramble, depth, image_idx, sobol, out, depth_out);
}

template <int W>
cudaError_t launch(const int64_t* n_spp, const int64_t* scramble, const int64_t* depth,
                   const int64_t* image_idx, long long n, bool sobol, float* out,
                   int64_t* depth_out, cudaStream_t stream) {
  constexpr int kThreads = 256;
  cmj_draw<W><<<henjou::blocks_for(n, kThreads), kThreads, 0, stream>>>(
      n_spp, scramble, depth, image_idx, n, sobol, out, depth_out);
  return cudaGetLastError();
}

}  // namespace

// Draws of `n` lanes (width 1 = cmj_1d, 2 = cmj_2d, 3 = cmj_3d,
// 4 = cmj_4d); every pointer is device memory of n elements (out: n *
// width). n = 0 launches nothing.
extern "C" int henjou_cmj_draw(const int64_t* n_spp, const int64_t* scramble,
                               const int64_t* depth, const int64_t* image_idx,
                               long long n, long long width, long long sobol,
                               float* out, int64_t* depth_out, void* stream) {
  if (width < 1 || width > 4) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (width) {
    case 1: return (int)launch<1>(n_spp, scramble, depth, image_idx, n, sobol, out, depth_out, st);
    case 2: return (int)launch<2>(n_spp, scramble, depth, image_idx, n, sobol, out, depth_out, st);
    case 3: return (int)launch<3>(n_spp, scramble, depth, image_idx, n, sobol, out, depth_out, st);
    default: return (int)launch<4>(n_spp, scramble, depth, image_idx, n, sobol, out, depth_out, st);
  }
}
