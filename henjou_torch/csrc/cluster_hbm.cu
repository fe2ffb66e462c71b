// Two-level cluster intersector for Hopper (sm_90a): closest or any hit.
//
// Replaces the Pallas TPU kernel `_kernel` in
// henjou_tpu/accel/pallas_cluster_hbm.py (launched by
// `intersect_pallas_hbm`). The data layout is the JAX package's
// `HbmClusters`, unchanged:
//   rows  [C2*SC*16, K] f32: cluster c's plane p is row c*16 + p, planes
//         0-8 v0.xyz | e1.xyz | e2.xyz, planes 9-15 zero;
//   order [C2*SC, K] i32 original triangle ids (-1 for padding);
//   aabb  [8, Cp] per cluster, aabb2 [8, C2p] per supercluster of SC = 16
//         consecutive clusters (rows 0-2 min, 3-5 max).
//
// One thread per ray. The thread walks the superclusters in index order,
// slab-tests each supercluster box and then each of its 16 cluster boxes
// against [tmin, best_t], and runs Moller-Trumbore (common.cuh `mt`, the
// TPU kernel's operation order) against the 128 triangles of every
// cluster kept. Built with --fmad=false, t, u and v equal the plain
// PyTorch version (`_intersect_plain` in accel/pallas_cluster_hbm.py) to
// the ulp; ties in t go to the lowest k of a cluster and to the earlier
// cluster, as there. Any hit returns at the first accepted triangle.
//
// What the TPU design needed and this one drops:
// - the scalar frustum pre-pass (`frustum_need`, :147-186) is a
//   conservative bundle test of a 256-ray tile, and `bt_max` that tile's
//   far plane; for a single ray the slab test against its own best t
//   subsumes both;
// - the per-supercluster DMA into VMEM becomes plain global loads, which
//   the rays of one warp share through L1 when they keep the same
//   clusters. Staging a supercluster (16 clusters x 9 planes x 128 x 4 B =
//   72 KB) in shared memory for a block of rays is a later design.
//
// What bounds it: about 40 flops and 10 loads per triangle of every
// cluster a ray keeps, and warp divergence when the rays of a warp keep
// different clusters. The box scan is O(C2 + 16 * kept superclusters) per
// ray instead of the flat kernel's O(C). The sorted wrapper around every
// trace (accel/sorting.py) groups rays by direction octant and origin, so
// the rays of a warp mostly keep the same clusters.

#include "common.cuh"

namespace {

using henjou::K;

constexpr int SC = 16;      // clusters per supercluster
constexpr int PLANES = 16;  // rows per cluster in `rows`

__global__ void cluster_hbm_kernel(
    const float* __restrict__ rows, const int32_t* __restrict__ order,
    const float* __restrict__ aabb, long long cp,
    const float* __restrict__ aabb2, long long c2p, int num_super,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ tmin_in, const float* __restrict__ tmax_in,
    long long n, int any_hit, float* __restrict__ t_out,
    int32_t* __restrict__ prim_out, float* __restrict__ u_out,
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
    for (int j = 0; j < SC; ++j) {
      const int c = c2 * SC + j;
      if (!henjou::slab(aabb, cp, c, ox, oy, oz, ix, iy, iz, tmin, best_t))
        continue;
      const float* __restrict__ cl = rows + (long long)c * PLANES * K;
      const int32_t* __restrict__ ord = order + (long long)c * K;
      for (int k = 0; k < K; ++k) {
        const int32_t prim = ord[k];
        if (prim < 0) continue;
        float tt, uu, vv;
        if (!henjou::mt(ox, oy, oz, dx, dy, dz, cl[0 * K + k], cl[1 * K + k],
                        cl[2 * K + k], cl[3 * K + k], cl[4 * K + k],
                        cl[5 * K + k], cl[6 * K + k], cl[7 * K + k],
                        cl[8 * K + k], tmin, best_t, tt, uu, vv))
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

extern "C" int henjou_cluster_hbm_intersect(
    const float* rows, const int32_t* order, const float* aabb, long long cp,
    const float* aabb2, long long c2p, long long num_super,
    const float* ray_o, const float* ray_d, const float* tmin,
    const float* tmax, long long n, long long any_hit, float* t_out,
    int32_t* prim_out, float* u_out, float* v_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const unsigned blocks = henjou::blocks_for(n, threads);
  if (blocks > 0) {
    cluster_hbm_kernel<<<blocks, threads, 0, s>>>(
        rows, order, aabb, cp, aabb2, c2p, (int)num_super, ray_o, ray_d,
        tmin, tmax, n, (int)any_hit, t_out, prim_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}
