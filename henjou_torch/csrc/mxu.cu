// Matrix-form Moller-Trumbore intersector for Hopper (sm_90a): closest or
// any hit.
//
// Replaces the Pallas TPU kernel `_kernel` in henjou_tpu/accel/pallas_mxu.py
// (:156, launched by `intersect_pallas_mxu` :305). The data layout is the
// JAX package's `MxuClusters`, unchanged:
//   g_rows  [C2*SC*NF, 4K] f32: cluster c's block is rows c*NF .. c*NF+15,
//           columns [det(K) | u(K) | v(K) | t(K)]; rows 0-9 are the
//           per-triangle coefficient vectors, 10-15 zero;
//   order   [C2*SC, K] i32 original triangle ids (-1 for padding);
//   aabb    [8, Cp] per cluster, aabb2 [8, C2p] per supercluster of SC = 16;
//   centers [4, C2p] the point each supercluster's G was recentred on.
//
// For a ray, F = [d, d x o', o', 1] with o' = o - centers[:, c2], and
// F . G[:, col] is the numerator of det, u*det, v*det or t*det of a
// triangle. The TPU kernel ran one [256, 16] x [16, 512] matmul per taken
// cluster on the MXU at Precision.HIGHEST (f32). Here the kernel is the
// cluster walk of cluster_walk.cuh, the two-level walk of cluster_hbm.cu
// (every supercluster slot, padding clusters included, as in the plain
// version), with `MxuTest`: lane l owns triangles 4l..4l+3 and, per feature
// row, loads each column group as one float4 (a warp reads 512 contiguous
// bytes per row and group), forms the four numerators as ten-term sums in
// feature order 0..9 and runs the TPU kernel's epilogue (pallas_mxu.py
// :266-292): inv_det, u, v, t and the accept test. The u and v groups are
// loaded only where det and t can accept a triangle.
//
// What bounds it on this card: a visit reads 10 rows x 2-4 groups x 512 B
// (10-20 KB, against the two-level pack's 5 KB of planes and ids), from
// L1 and L2, and runs the walk's chain of box tests; not the f32
// arithmetic (about 81 flops per ray and triangle). Tensor cores are not
// used: the TPU ran f32 products, and a `wgmma` design (3xTF32 or split
// bf16 to keep f32 accuracy, with a 64-ray tile per warpgroup) would give
// up bit-equality with the plain version.
//
// Equal to the plain PyTorch version (`_intersect_plain` in
// accel/pallas_mxu.py) to the bit: the same terms summed in the same order
// (--fmad=false), the same (ray, cluster) pairs in the same order,
// torch.min's tie rule; an any hit returns its first accepted triangle.

#include "cluster_walk.cuh"

extern "C" int henjou_mxu_intersect(
    const float* g_rows, const int32_t* order, const float* aabb,
    long long cp, const float* aabb2, long long c2p, const float* centers,
    long long num_super, const float* ray_o, const float* ray_d,
    const float* tmin, const float* tmax, long long n, long long any_hit,
    float* t_out, int32_t* prim_out, float* u_out, float* v_out,
    void* stream) {
  using henjou::walk::MxuTest;
  const henjou::walk::Levels lv{aabb2, c2p, (int)num_super, MxuTest::SC,
                                (int)(num_super * MxuTest::SC), aabb, cp};
  return henjou::walk::launch(MxuTest{g_rows, order, centers, c2p}, lv, ray_o,
                              ray_d, tmin, tmax, n, any_hit, t_out, prim_out,
                              u_out, v_out, stream);
}
