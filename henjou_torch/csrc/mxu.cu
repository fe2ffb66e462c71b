// Matrix-form Moller-Trumbore intersector for Hopper (sm_90a): closest or
// any hit.
//
// Replaces the Pallas TPU kernel `_kernel` in henjou_tpu/accel/pallas_mxu.py
// (launched by `intersect_pallas_mxu`). The data layout is the JAX
// package's `MxuClusters`, unchanged:
//   g_rows  [C2*SC*NF, 4K] f32: cluster c's block is rows c*NF .. c*NF+15,
//           columns [det(K) | u(K) | v(K) | t(K)]; rows 0-9 are the
//           per-triangle coefficient vectors, 10-15 zero;
//   order   [C2*SC, K] i32 original triangle ids (-1 for padding);
//   aabb    [8, Cp] per cluster, aabb2 [8, C2p] per supercluster;
//   centers [4, C2p] the point each supercluster's G was recentred on.
//
// For a ray, F = [d, d x o', o', 1] with o' = o - centers[:, c2], and
// F . G[:, col] is the numerator of det, u*det, v*det or t*det of a
// triangle. The TPU kernel ran one [256, 16] x [16, 512] matmul per taken
// cluster on the MXU at Precision.HIGHEST (f32). Here one thread per ray
// walks the superclusters and their clusters in index order with the slab
// culls of cluster_hbm.cu, builds F once per supercluster it keeps, and
// forms the four numerators of each triangle as ten-term dot products
// summed in feature order 0..9, then runs the kernel's epilogue
// (pallas_mxu.py:266-292): inv_det, u, v, t and the accept test. The plain
// PyTorch version (`_intersect_plain` in accel/pallas_mxu.py) sums the
// same terms in the same order, and the file is built with --fmad=false,
// so the two agree to the ulp.
//
// What bounds it: 40 loads and 80 flops per triangle of every cluster kept
// (the G block is 32 KB per cluster, four times the rows of
// cluster_hbm.cu), so this kernel moves more bytes than the two-level
// kernel for the same work. Tensor cores are not used: the TPU ran f32
// products, and a `wgmma` design (3xTF32 or split bf16 to keep f32
// accuracy, with a 64-ray tile per warpgroup) is a later redesign.

#include "common.cuh"

namespace {

using henjou::K;

constexpr int SC = 16;  // clusters per supercluster
constexpr int NF = 16;  // feature rows per cluster block (10 used)
constexpr int NU = 10;  // features used

__global__ void mxu_kernel(const float* __restrict__ g_rows,
                           const int32_t* __restrict__ order,
                           const float* __restrict__ aabb, long long cp,
                           const float* __restrict__ aabb2, long long c2p,
                           const float* __restrict__ centers, int num_super,
                           const float* __restrict__ ray_o,
                           const float* __restrict__ ray_d,
                           const float* __restrict__ tmin_in,
                           const float* __restrict__ tmax_in, long long n,
                           int any_hit, float* __restrict__ t_out,
                           int32_t* __restrict__ prim_out,
                           float* __restrict__ u_out,
                           float* __restrict__ v_out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float ox = ray_o[3 * r], oy = ray_o[3 * r + 1], oz = ray_o[3 * r + 2];
  const float dx = ray_d[3 * r], dy = ray_d[3 * r + 1], dz = ray_d[3 * r + 2];
  const float ix = henjou::safe_inv(dx), iy = henjou::safe_inv(dy),
              iz = henjou::safe_inv(dz);
  const float tmin = tmin_in[r];
  float best_t = tmax_in[r];
  int32_t best_p = -1;
  float best_u = 0.0f, best_v = 0.0f;

  for (int c2 = 0; c2 < num_super; ++c2) {
    if (!henjou::slab(aabb2, c2p, c2, ox, oy, oz, ix, iy, iz, tmin, best_t))
      continue;
    const float opx = ox - centers[0 * c2p + c2];
    const float opy = oy - centers[1 * c2p + c2];
    const float opz = oz - centers[2 * c2p + c2];
    const float f[NU] = {dx,
                         dy,
                         dz,
                         dy * opz - dz * opy,
                         dz * opx - dx * opz,
                         dx * opy - dy * opx,
                         opx,
                         opy,
                         opz,
                         1.0f};
    for (int j = 0; j < SC; ++j) {
      const int c = c2 * SC + j;
      if (!henjou::slab(aabb, cp, c, ox, oy, oz, ix, iy, iz, tmin, best_t))
        continue;
      const float* __restrict__ g = g_rows + (long long)c * NF * 4 * K;
      const int32_t* __restrict__ ord = order + (long long)c * K;
      for (int k = 0; k < K; ++k) {
        const int32_t prim = ord[k];
        if (prim < 0) continue;
        float det = f[0] * g[k];
        float u_num = f[0] * g[K + k];
        float v_num = f[0] * g[2 * K + k];
        float t_num = f[0] * g[3 * K + k];
#pragma unroll
        for (int q = 1; q < NU; ++q) {
          const float* __restrict__ gq = g + (long long)q * 4 * K;
          det = det + f[q] * gq[k];
          u_num = u_num + f[q] * gq[K + k];
          v_num = v_num + f[q] * gq[2 * K + k];
          t_num = t_num + f[q] * gq[3 * K + k];
        }
        if (!(fabsf(det) > 1e-12f)) continue;
        const float inv_det = 1.0f / det;
        const float uu = u_num * inv_det;
        const float vv = v_num * inv_det;
        const float tt = t_num * inv_det;
        if (!(uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > tmin &&
              tt < best_t))
          continue;
        best_t = tt;
        best_p = prim;
        best_u = uu;
        best_v = vv;
        if (any_hit) goto done;
      }
    }
  }
done:
  t_out[r] = best_t;
  prim_out[r] = best_p;
  u_out[r] = best_u;
  v_out[r] = best_v;
}

}  // namespace

extern "C" int henjou_mxu_intersect(
    const float* g_rows, const int32_t* order, const float* aabb,
    long long cp, const float* aabb2, long long c2p, const float* centers,
    long long num_super, const float* ray_o, const float* ray_d,
    const float* tmin, const float* tmax, long long n, long long any_hit,
    float* t_out, int32_t* prim_out, float* u_out, float* v_out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const unsigned blocks = henjou::blocks_for(n, threads);
  if (blocks > 0) {
    mxu_kernel<<<blocks, threads, 0, s>>>(
        g_rows, order, aabb, cp, aabb2, c2p, centers, (int)num_super, ray_o,
        ray_d, tmin, tmax, n, (int)any_hit, t_out, prim_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}
