// Binned cluster intersector for Hopper (sm_90a): closest hit or any hit.
//
// Replaces the Pallas TPU kernel `_kernel` in
// henjou_tpu/accel/pallas_binned.py (:482, launched by `intersect_binned`
// :781). The data layout is the JAX package's `BinnedClusters`, unchanged:
//   rows  [Ctot*16, K] f32, K = 128 triangles per leaf cluster; plane p of
//         cluster c is row c*16 + p: planes 0-11 the Baldwin-Weber form
//         n.xyz | d | g1.xyz | h1 | g2.xyz | h2, plane 12 the original
//         triangle id bitcast to f32 (-1 for padding);
//   aabb  [8, Cp]: rows 0-2 the cluster min, rows 3-5 the max;
//   gaabb [8, Gp]: the same per group of `group` consecutive clusters.
//
// The kernel is the cluster walk of cluster_walk.cuh with `BinnedTest`: a
// warp per ray, the groups and then a kept group's clusters slab-tested
// 32 at a time, one box per lane, and each kept cluster's 128 triangles
// across the lanes, four per lane. The TPU kernel already evaluated a ray
// tile against one cluster's 128 triangles across its 128 lanes, loading
// the rows once per cluster (`load_rows`); here the triangles lie across a
// warp's lanes and the rows arrive as one 16-byte load per lane and plane.
// Its tile worklists, SMEM prefetch and nibble bits served a core that
// cannot diverge per lane and are not ported.
//
// What bounds it on this card: not the arithmetic (about 32 flops per
// ray and triangle; a contest-scale trace is ~1.1 GFLOP, 0.016 ms at the
// f32 peak) but the latency of the row loads and of the box scan, each
// ray a chain of dependent steps. One thread per ray, as before,
// serialised 13 dependent loads per triangle and kept ~16 warps on an SM;
// a warp per ray issues a cluster's planes as independent 512-byte warp
// loads, gives 32x the warps to hide their latency, and turns a warp's
// divergence over its rays' different clusters into one ray's walk. The
// rays of a block, next to each other after the sort (accel/sorting.py),
// share the SM's L1 for the rows they keep. The box scan is a large share
// of a contest-scale trace (PERF.md).
//
// Equal to the plain PyTorch version (`_intersect_plain` in
// accel/pallas_binned.py) to the bit: the same Baldwin-Weber arithmetic
// in the same order (built with --fmad=false), the same (ray, cluster)
// pairs in the same order, torch.min's tie rule. Any hit returns t = tmin
// and prim = 1 (only `hit` is consumed).

#include "cluster_walk.cuh"

extern "C" int henjou_binned_intersect(
    const float* rows, const float* aabb, long long cp, const float* gaabb,
    long long gp, long long num_clusters, long long group,
    long long num_groups, const float* ray_o, const float* ray_d,
    const float* tmin, const float* tmax, long long n, long long any_hit,
    float* t_out, int32_t* prim_out, float* u_out, float* v_out,
    void* stream) {
  const henjou::walk::Levels lv{gaabb, gp, (int)num_groups, (int)group,
                                (int)num_clusters, aabb, cp};
  return henjou::walk::launch(henjou::walk::BinnedTest{rows}, lv, ray_o,
                              ray_d, tmin, tmax, n, any_hit, t_out, prim_out,
                              u_out, v_out, stream);
}
