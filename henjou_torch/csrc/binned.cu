// Binned cluster intersector for Hopper (sm_90a): closest hit or any hit.
//
// Replaces the Pallas TPU kernel `_kernel` in
// henjou_tpu/accel/pallas_binned.py (launched by `intersect_binned`). The
// data layout is the JAX package's `BinnedClusters`, unchanged:
//   rows  [Ctot*16, K] f32, K = 128 triangles per leaf cluster; plane p of
//         cluster c is row c*16 + p: planes 0-11 the Baldwin-Weber form
//         n.xyz | d | g1.xyz | h1 | g2.xyz | h2, plane 12 the original
//         triangle id bitcast to f32 (-1 for padding);
//   aabb  [8, Cp]: rows 0-2 the cluster min, rows 3-5 the max;
//   gaabb [8, Gp]: the same per group of `group` consecutive clusters.
//
// One thread per ray. The thread walks the groups in index order, slab-
// tests each group box and then each of its cluster boxes against
// [tmin, best_t], and tests the 128 triangles of every cluster that
// passes. The TPU kernel's tile worklists, SMEM prefetch and nibble bits
// exist because a TPU core cannot diverge per lane; a GPU thread can, so
// they are not ported. The triangle test keeps the TPU kernel's operation
// order (nd, no, inv_nd, tt, the hit point, uu, vv), and the file is
// built with --fmad=false, so t, u and v equal the plain PyTorch version
// (`_intersect_plain` in accel/pallas_binned.py) to the ulp. Within a
// cluster a strict `<` in ascending k keeps the lowest k on a tie in t;
// across clusters the earlier cluster in index order wins a tie, as in the
// plain version. Any hit returns at the first accepted triangle with
// t = tmin and prim = 1 (only `hit` is consumed).
//
// Padding triangles have all-zero rows and give tt == 0, which `tt > tmin`
// culls because the wrapper clamps tmin >= 0.
//
// What bounds it: the cluster and triangle tests per ray (about 30 flops
// and 13 loads per triangle of every cluster a ray's slab test keeps), and
// warp divergence when the 32 rays of a warp keep different clusters. The
// sorted wrapper around every trace (accel/sorting.py) orders rays by
// direction octant and origin Morton code before the launch, so the rays
// of one warp mostly keep the same clusters and read the same rows, and
// dead rays (tmax <= tmin) sort to the end, where whole warps exit at once.

#include "common.cuh"

namespace {

using henjou::K;
using henjou::safe_inv;
using henjou::slab;

constexpr int PLANES = 16;  // rows per cluster

__global__ void binned_kernel(const float* __restrict__ rows,
                              const float* __restrict__ aabb, long long cp,
                              const float* __restrict__ gaabb, long long gp,
                              int num_clusters, int group, int num_groups,
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
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float tmin = tmin_in[r];
  float best_t = tmax_in[r];
  int32_t best_p = -1;
  float best_u = 0.0f, best_v = 0.0f;

  for (int g = 0; g < num_groups; ++g) {
    if (!slab(gaabb, gp, g, ox, oy, oz, ix, iy, iz, tmin, best_t)) continue;
    for (int j = 0; j < group; ++j) {
      const int c = g * group + j;
      if (c >= num_clusters) break;
      if (!slab(aabb, cp, c, ox, oy, oz, ix, iy, iz, tmin, best_t)) continue;
      const float* __restrict__ cl = rows + (long long)c * PLANES * K;
      for (int k = 0; k < K; ++k) {
        const float nx = cl[0 * K + k], ny = cl[1 * K + k], nz = cl[2 * K + k];
        const float dpl = cl[3 * K + k];
        const float nd = dx * nx + dy * ny + dz * nz;
        const float no = ox * nx + oy * ny + oz * nz;
        const float inv_nd = fabsf(nd) > 1e-12f ? 1.0f / nd : 0.0f;
        const float tt = (dpl - no) * inv_nd;
        if (!(tt > tmin && tt < best_t)) continue;
        const float px = ox + tt * dx;
        const float py = oy + tt * dy;
        const float pz = oz + tt * dz;
        const float uu = cl[7 * K + k] + cl[4 * K + k] * px +
                         cl[5 * K + k] * py + cl[6 * K + k] * pz;
        const float vv = cl[11 * K + k] + cl[8 * K + k] * px +
                         cl[9 * K + k] * py + cl[10 * K + k] * pz;
        if (!(uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f)) continue;
        if (any_hit) {
          best_t = tmin;
          best_p = 1;
          goto done;
        }
        best_t = tt;
        best_p = __float_as_int(cl[12 * K + k]);
        best_u = uu;
        best_v = vv;
      }
    }
  }
done:
  t_out[r] = best_p >= 0 ? best_t : __int_as_float(0x7f800000);  // +inf
  prim_out[r] = best_p;
  u_out[r] = best_u;
  v_out[r] = best_v;
}

}  // namespace

extern "C" int henjou_binned_intersect(
    const float* rows, const float* aabb, long long cp, const float* gaabb,
    long long gp, long long num_clusters, long long group,
    long long num_groups, const float* ray_o, const float* ray_d,
    const float* tmin, const float* tmax, long long n, long long any_hit,
    float* t_out, int32_t* prim_out, float* u_out, float* v_out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (blocks > 0) {
    binned_kernel<<<blocks, threads, 0, s>>>(
        rows, aabb, cp, gaabb, gp, (int)num_clusters, (int)group,
        (int)num_groups, ray_o, ray_d, tmin, tmax, n, (int)any_hit, t_out,
        prim_out, u_out, v_out);
  }
  return (int)cudaGetLastError();
}
