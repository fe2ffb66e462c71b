// Helpers shared by the intersector kernels (binned.cu, cluster.cu,
// cluster_hbm.cu and mxu.cu, through cluster_walk.cuh). Every function keeps the arithmetic, and its
// order, of the matching plain PyTorch helper, so that a kernel built
// with --fmad=false agrees with its plain version to the ulp.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace henjou {

constexpr int K = 128;  // triangles per leaf cluster

// 1 / d with |d| < 1e-12 replaced by +-1e-12 (accel/pallas_cluster.py
// `_safe_inv`).
__device__ __forceinline__ float safe_inv(float d) {
  const float tiny = d >= 0.0f ? 1e-12f : -1e-12f;
  return 1.0f / (fabsf(d) < 1e-12f ? tiny : d);
}

// Slab test of box `col` of an [8, stride] AABB table (rows 0-2 min,
// 3-5 max) against [t_lo, t_hi] (accel/pallas_cluster.py `_slab`).
__device__ __forceinline__ bool slab(const float* __restrict__ box,
                                     long long stride, long long col, float ox,
                                     float oy, float oz, float ix, float iy,
                                     float iz, float t_lo, float t_hi) {
  float te = t_lo, tx = t_hi;
  const float o[3] = {ox, oy, oz};
  const float iv[3] = {ix, iy, iz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t1 = (box[a * stride + col] - o[a]) * iv[a];
    const float t2 = (box[(3 + a) * stride + col] - o[a]) * iv[a];
    te = fmaxf(te, fminf(t1, t2));
    tx = fminf(tx, fmaxf(t1, t2));
  }
  return te <= tx;
}

// Moller-Trumbore of one ray against the triangle (v0, e1, e2), in the
// operation order of the TPU kernel (henjou_tpu/accel/pallas_cluster.py
// :185-207) and of `_mt` in accel/pallas_cluster.py. True when the
// hit is accepted: |det| > 1e-12, u >= 0, v >= 0, u + v <= 1 and
// tmin < t < best_t; then t, u and v are written.
__device__ __forceinline__ bool mt(float ox, float oy, float oz, float dx,
                                   float dy, float dz, float v0x, float v0y,
                                   float v0z, float e1x, float e1y, float e1z,
                                   float e2x, float e2y, float e2z, float tmin,
                                   float best_t, float& t, float& u,
                                   float& v) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  if (!(fabsf(det) > 1e-12f)) return false;
  const float inv_det = 1.0f / det;
  const float tvx = ox - v0x;
  const float tvy = oy - v0y;
  const float tvz = oz - v0z;
  const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  if (!(uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > tmin &&
        tt < best_t))
    return false;
  t = tt;
  u = uu;
  v = vv;
  return true;
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace henjou
