// Flat cluster-scan intersector for Hopper (sm_90a): closest or any hit.
//
// Replaces the Pallas TPU kernel `_kernel` in
// henjou_tpu/accel/pallas_cluster.py (launched by `intersect_pallas`). The
// data layout is the JAX package's `PackedClusters`, unchanged: nine
// component planes v0.xyz | e1.xyz | e2.xyz, each [C, K] f32 with K = 128
// triangles per cluster, the original triangle ids `order` [C, K] i32 (-1
// for padding), and the cluster AABBs [8, Cp] (rows 0-2 min, 3-5 max).
//
// One thread per ray. The thread walks all C clusters in index order,
// slab-tests each cluster box against [tmin, best_t], and runs Moller-
// Trumbore against the 128 triangles of every cluster that passes. The
// TPU kernel made the same skip per 512-ray tile ("some lane still needs
// the cluster") because its lanes run in lockstep; per ray it is the same
// cull, made finer. The triangle test keeps the TPU kernel's operation
// order (pallas_cluster.py:185-207) and the file is built with
// --fmad=false, so t, u and v equal the plain PyTorch version
// (`_intersect_plain` in accel/pallas_cluster.py) to the ulp. Within a
// cluster a strict `<` in ascending k keeps the lowest k on a tie in t
// (the TPU kernel's argmin); across clusters the earlier cluster wins a
// tie. Any hit returns at the first accepted triangle, with its t, prim,
// u and v.
//
// What bounds it: every ray slab-tests every cluster box (C boxes, 6
// loads and 12 flops each), so the cost grows linearly in C even where
// the boxes cull; then about 40 flops and 10 loads per triangle of every
// cluster kept. The loads of one warp go to the same cluster's rows, so
// they are broadcasts served from L1; divergence is the cost when the 32
// rays of a warp keep different clusters. The design answers only the
// correctness half: it is the TPU kernel's walk, per ray. The two-level
// walk of cluster_hbm.cu is the answer to the O(C) box scan.

#include "common.cuh"

namespace {

using henjou::K;

struct Planes {
  const float* p[9];  // v0x v0y v0z e1x e1y e1z e2x e2y e2z, each [C, K]
};

__global__ void cluster_kernel(Planes pl, const int32_t* __restrict__ order,
                               const float* __restrict__ aabb, long long cp,
                               int num_clusters,
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

  for (int c = 0; c < num_clusters; ++c) {
    if (!henjou::slab(aabb, cp, c, ox, oy, oz, ix, iy, iz, tmin, best_t))
      continue;
    const long long base = (long long)c * K;
    for (int k = 0; k < K; ++k) {
      const long long i = base + k;
      const int32_t prim = order[i];
      if (prim < 0) continue;
      float tt, uu, vv;
      if (!henjou::mt(ox, oy, oz, dx, dy, dz, pl.p[0][i], pl.p[1][i],
                      pl.p[2][i], pl.p[3][i], pl.p[4][i], pl.p[5][i],
                      pl.p[6][i], pl.p[7][i], pl.p[8][i], tmin, best_t, tt,
                      uu, vv))
        continue;
      best_t = tt;
      best_p = prim;
      best_u = uu;
      best_v = vv;
      if (any_hit) goto done;
    }
  }
done:
  t_out[r] = best_t;
  prim_out[r] = best_p;
  u_out[r] = best_u;
  v_out[r] = best_v;
}

}  // namespace

extern "C" int henjou_cluster_intersect(
    const float* v0x, const float* v0y, const float* v0z, const float* e1x,
    const float* e1y, const float* e1z, const float* e2x, const float* e2y,
    const float* e2z, const int32_t* order, const float* aabb, long long cp,
    long long num_clusters, const float* ray_o, const float* ray_d,
    const float* tmin, const float* tmax, long long n, long long any_hit,
    float* t_out, int32_t* prim_out, float* u_out, float* v_out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Planes pl = {{v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z}};
  const int threads = 128;
  const unsigned blocks = henjou::blocks_for(n, threads);
  if (blocks > 0) {
    cluster_kernel<<<blocks, threads, 0, s>>>(
        pl, order, aabb, cp, (int)num_clusters, ray_o, ray_d, tmin, tmax, n,
        (int)any_hit, t_out, prim_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}
