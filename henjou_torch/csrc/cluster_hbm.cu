// Two-level cluster intersector for Hopper (sm_90a): closest or any hit.
//
// Replaces the Pallas TPU kernel `_kernel` in
// henjou_tpu/accel/pallas_cluster_hbm.py (:111, launched by
// `intersect_pallas_hbm` :314). The data layout is the JAX package's
// `HbmClusters`, unchanged:
//   rows  [C2*SC*16, K] f32: cluster c's plane p is row c*16 + p, planes
//         0-8 v0.xyz | e1.xyz | e2.xyz, planes 9-15 zero;
//   order [C2*SC, K] i32 original triangle ids (-1 for padding);
//   aabb  [8, Cp] per cluster, aabb2 [8, C2p] per supercluster of SC = 16
//         consecutive clusters (rows 0-2 min, 3-5 max).
//
// The kernel is the cluster walk of cluster_walk.cuh with
// `MtTest<RowPlanes>` (Moller-Trumbore, common.cuh `mt`, the TPU kernel's
// operation order): a
// warp per ray, the superclusters 32 at a time and a kept supercluster's
// 16 cluster boxes at once, one box per lane, then each kept cluster's 128
// triangles across the lanes, four per lane, with their ids as one int4
// per lane. Every supercluster slot is walked, padding clusters included
// (their inverted boxes pass; their ids are -1), as in the plain version.
//
// What the TPU design needed and this one drops:
// - the scalar frustum pre-pass (`frustum_need`, :162) is a conservative
//   bundle test of a 256-ray tile, and `bt_max` that tile's far plane; for
//   a single ray the slab test against its own best t subsumes both;
// - the per-supercluster DMA into VMEM becomes 16-byte global loads that
//   the rays of a block, next to each other after the sort, share
//   through L1.
//
// What bounds it on this card: not the arithmetic (about 46 flops per ray
// and triangle) but load latency and the box scan. One thread per ray, as
// before, ran 10 dependent loads per triangle with few warps per SM; a
// warp per ray issues a cluster's 9 planes and its ids as independent
// 512-byte warp loads and has 32x the warps to hide them, and the box
// scan's top level runs 32 boxes at once.
//
// Equal to the plain PyTorch version (`_intersect_plain` in
// accel/pallas_cluster_hbm.py) to the bit: the same arithmetic in the same
// order (--fmad=false), the same (ray, cluster) pairs in the same order,
// torch.min's tie rule; an any hit returns its first accepted triangle.

#include "cluster_walk.cuh"

namespace {
constexpr int SC = 16;  // clusters per supercluster
}  // namespace

extern "C" int henjou_cluster_hbm_intersect(
    const float* rows, const int32_t* order, const float* aabb, long long cp,
    const float* aabb2, long long c2p, long long num_super,
    const float* ray_o, const float* ray_d, const float* tmin,
    const float* tmax, long long n, long long any_hit, float* t_out,
    int32_t* prim_out, float* u_out, float* v_out, void* stream) {
  const henjou::walk::Levels lv{aabb2, c2p, (int)num_super, SC,
                                (int)(num_super * SC), aabb, cp};
  const henjou::walk::MtTest<henjou::walk::RowPlanes> test{{rows}, order};
  return henjou::walk::launch(test, lv, ray_o, ray_d, tmin, tmax, n, any_hit,
                              t_out, prim_out, u_out, v_out, stream);
}
