// Flat cluster-scan intersector for Hopper (sm_90a): closest or any hit.
//
// Replaces the Pallas TPU kernel `_kernel` in
// henjou_tpu/accel/pallas_cluster.py (:115, launched by `intersect_pallas`
// :243). The data layout is the JAX package's `PackedClusters`, unchanged:
// nine component planes v0.xyz | e1.xyz | e2.xyz, each [C, K] f32 with
// K = 128 triangles per cluster, the original triangle ids `order` [C, K]
// i32 (-1 for padding), and the cluster AABBs [8, Cp] (rows 0-2 min, 3-5
// max).
//
// The kernel is the cluster walk of cluster_walk.cuh with
// `MtTest<SplitPlanes>` (Moller-Trumbore, common.cuh `mt`, the TPU kernel's
// operation order; plane p of cluster c at planes[p] + c*K): a warp per ray, the C cluster
// boxes as the walk's top level, 32 at a time, one box per lane, and each
// kept cluster's 128 triangles across the lanes, four per lane. The pack
// has one box level, so each top box stands for one cluster (per_top = 1)
// and the walk's one-level form visits a taken box's cluster at once, its
// retest against the current best t being the cluster's test (the
// two-level form's one-lane cluster ballot cost 12% more on the contest
// scene, PERF.md). The padding columns c >= C of `aabb`
// hold inverted boxes, which pass every slab test, so the walk stops at C
// as the plain version does. The TPU kernel skipped a cluster for a
// 512-ray tile only when no lane needed it, because its lanes run in
// lockstep; per ray it is the same cull, made finer.
//
// What bounds it on this card: not the arithmetic (about 46 flops per ray
// and triangle) but the box scan and load latency. Every ray slab-tests
// all C boxes (1,991 on the contest scene: 63 ballots of 32), where the
// two-level walk scans a box per supercluster; one thread per ray, as
// before, ran that scan and 10 dependent loads per triangle serially, and
// a warp per ray runs 32 boxes per step and issues a cluster's 9 planes
// and its ids as independent 512-byte warp loads.
//
// Equal to the plain PyTorch version (`_intersect_plain` in
// accel/pallas_cluster.py) to the bit: the same arithmetic in the same
// order (--fmad=false), the same (ray, cluster) pairs in the same order,
// torch.min's tie rule; an any hit returns its first accepted triangle.

#include "cluster_walk.cuh"

extern "C" int henjou_cluster_intersect(
    const float* v0x, const float* v0y, const float* v0z, const float* e1x,
    const float* e1y, const float* e1z, const float* e2x, const float* e2y,
    const float* e2z, const int32_t* order, const float* aabb, long long cp,
    long long num_clusters, const float* ray_o, const float* ray_d,
    const float* tmin, const float* tmax, long long n, long long any_hit,
    float* t_out, int32_t* prim_out, float* u_out, float* v_out,
    void* stream) {
  const int c = (int)num_clusters;
  const henjou::walk::Levels lv{aabb, cp, c, 1, c, aabb, cp};
  using Test = henjou::walk::MtTest<henjou::walk::SplitPlanes>;
  const Test test{{{v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z}}, order};
  return henjou::walk::launch<Test, true>(test, lv, ray_o, ray_d, tmin, tmax,
                                          n, any_hit, t_out, prim_out, u_out,
                                          v_out, stream);
}
