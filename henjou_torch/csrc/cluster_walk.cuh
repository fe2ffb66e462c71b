// The cluster walk shared by the four cluster intersectors: binned
// (binned.cu), flat (cluster.cu), two-level (cluster_hbm.cu) and matrix
// form (mxu.cu). A warp per ray, the 128 triangles of a cluster across its
// 32 lanes.
//
// The three pack layouts, each K = 128 triangles per cluster under two box
// levels, a top level over runs of `per_top` consecutive clusters and the
// cluster boxes (`aabb`); boxes are [8, stride] tables, rows 0-2 min and
// 3-5 max:
// - binned and two-level: 16 planes of K floats per cluster, planes-major
//   (`rows [C*16, K]`); the top boxes are binned `gaabb` over groups and
//   two-level `aabb2` over superclusters of 16;
// - flat: nine separate [C, K] planes v0 | e1 | e2 and one box level,
//   walked as a top level of the cluster boxes themselves (per_top = 1,
//   `kOneLevel`);
// - matrix form: per cluster 16 feature rows of 4K floats, columns det | u
//   | v | t (`g_rows [C*16, 4K]`), under `aabb2` over superclusters of 16.
//
// The walk, for one ray on RAY_LANES lanes:
// - the top boxes in chunks of RAY_LANES, one box per lane, slab-tested
//   against [tmin, best_t]; a ballot gives the chunk's mask and the walk
//   takes its set bits in index order;
// - a taken box is tested again against the current best_t (it only
//   shrinks, so a box the chunk's test dropped stays dropped), then its
//   clusters the same way: one cluster box per lane, a ballot, the set bits
//   in order, each re-tested against the current best_t before the visit
//   (the flat pack's one-level form visits the taken box's cluster at
//   once: its retest is the cluster's test).
//   So the walk visits exactly the (ray, cluster) pairs of a sequential walk
//   in index order, which is what the plain versions do;
// - a visit loads each plane (each feature row's column group in the
//   matrix form) as one 16-byte vector per lane (lane l owns triangles
//   TRIS_PER_LANE*l ..; a warp reads 512 contiguous bytes per plane, the
//   loads issued together) and runs the pack's triangle test (`BinnedTest`,
//   `MtTest<RowPlanes>`, `MtTest<SplitPlanes>`, `MxuTest`) on the lane's triangles against best_t as it stood
//   at the start of the cluster;
// - closest hit: each lane keeps its smallest accepted t, the lowest k on a
//   tie (a strict `<` in ascending k), and a butterfly of shuffles on
//   (t, k) takes the smallest t and on equal t the lower k: torch.min's
//   first minimum over the cluster, as the plain versions' `_take`. A tie
//   with an earlier cluster stays with it, since a new candidate must be
//   strictly below best_t. u, v and the prim come from the winning lane;
// - any hit: the first accepted k of the first cluster with a hit, that is
//   the lowest lane of a ballot and that lane's first accepted triangle;
//   the ray then retires.
// A dead ray (tmax <= tmin) retires before the walk, its whole warp at
// once. Every branch above depends only on values all lanes of a ray hold
// alike, so the ray's lanes stay converged.
//
// The per-triangle arithmetic is that of the plain versions, in their
// order; with --fmad=false the result equals theirs to the bit.

#pragma once

#include "common.cuh"

namespace henjou {
namespace walk {
// Unnamed: each source that includes this header gets its own kernels and
// policies, so no kernel is instantiated in two sources.
namespace {

// The layout and launch shape were timed on an H100 against 8 and 16
// lanes per ray, 256 threads and 64-98 registers (PERF.md): a warp
// per ray, blocks of 4 warps and at most 80 registers (6 blocks, 24 warps
// an SM) were the fastest on both packs and both ray orders.
constexpr int RAY_LANES = 32;  // lanes that walk one ray
constexpr int TRIS_PER_LANE = K / RAY_LANES;
constexpr int VECS = TRIS_PER_LANE / 4;  // float4 loads per plane and lane
constexpr int THREADS = 128;             // 4 rays per block
constexpr int MIN_BLOCKS = 6;            // resident blocks an SM
constexpr int PLANES = 16;               // rows per cluster in `rows`
static_assert(K % (4 * RAY_LANES) == 0 && 32 % RAY_LANES == 0, "lane layout");

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

// the two box levels of a pack
struct Levels {
  const float* __restrict__ top;  // [8, top_stride]
  long long top_stride;
  int num_top;
  int per_top;       // clusters per top box
  int num_clusters;  // clusters at and past this index are not visited
  const float* __restrict__ aabb;  // [8, stride]
  long long stride;
};

// The lane's TRIS_PER_LANE consecutive values of plane `p` of the
// cluster whose rows start at `cl` (16-byte aligned: the wrappers check
// the base pointers, and a plane is 512 bytes).
template <class T, class V>
__device__ __forceinline__ void load_plane(const T* __restrict__ cl, int p,
                                           int lane,
                                           T (&out)[TRIS_PER_LANE]) {
  const V* src = reinterpret_cast<const V*>(cl + (long long)p * K +
                                            lane * TRIS_PER_LANE);
#pragma unroll
  for (int q = 0; q < VECS; ++q) {
    const V x = __ldg(src + q);
    out[4 * q] = x.x;
    out[4 * q + 1] = x.y;
    out[4 * q + 2] = x.z;
    out[4 * q + 3] = x.w;
  }
}

// Baldwin-Weber on planes 0-11 (n.xyz | d | g1.xyz | h1 | g2.xyz | h2), the
// prim id bitcast on plane 12; the operation order of `_baldwin` in
// accel/pallas_binned.py. Planes 0-3 give t; a lane loads the barycentric
// planes 4-11 only when one of its triangles' t lies in (tmin, best_t),
// the only case they can decide (measured faster on the contest scene on
// an H100).
// All-zero padding gives tt == 0, culled by `tt > tmin` (the wrapper
// clamps tmin >= 0). An any hit reports t = tmin and prim 1.
struct BinnedTest {
  const float* __restrict__ rows;
  static constexpr bool kAnyHitFlag = true;

  __device__ __forceinline__ void eval(int c, int lane, const Ray& r,
                                       float best_t,
                                       float (&t)[TRIS_PER_LANE],
                                       float (&u)[TRIS_PER_LANE],
                                       float (&v)[TRIS_PER_LANE],
                                       bool (&ok)[TRIS_PER_LANE]) const {
    const float* __restrict__ cl = rows + (long long)c * PLANES * K;
    float pl[12][TRIS_PER_LANE];
#pragma unroll
    for (int p = 0; p < 4; ++p) load_plane<float, float4>(cl, p, lane, pl[p]);
    bool any_in = false;  // a plane crossed inside (tmin, best_t)
#pragma unroll
    for (int i = 0; i < TRIS_PER_LANE; ++i) {
      const float nd = r.dx * pl[0][i] + r.dy * pl[1][i] + r.dz * pl[2][i];
      const float no = r.ox * pl[0][i] + r.oy * pl[1][i] + r.oz * pl[2][i];
      const float inv_nd = fabsf(nd) > 1e-12f ? 1.0f / nd : 0.0f;
      t[i] = (pl[3][i] - no) * inv_nd;
      ok[i] = t[i] > r.tmin && t[i] < best_t;
      any_in |= ok[i];
      u[i] = v[i] = 0.0f;
    }
    if (!any_in) return;
#pragma unroll
    for (int p = 4; p < 12; ++p) load_plane<float, float4>(cl, p, lane, pl[p]);
#pragma unroll
    for (int i = 0; i < TRIS_PER_LANE; ++i) {
      const float tt = t[i];
      const float px = r.ox + tt * r.dx;
      const float py = r.oy + tt * r.dy;
      const float pz = r.oz + tt * r.dz;
      u[i] = pl[7][i] + pl[4][i] * px + pl[5][i] * py + pl[6][i] * pz;
      v[i] = pl[11][i] + pl[8][i] * px + pl[9][i] * py + pl[10][i] * pz;
      ok[i] = ok[i] && u[i] >= 0.0f && v[i] >= 0.0f && u[i] + v[i] <= 1.0f;
    }
  }

  __device__ __forceinline__ int32_t prim(int c, int k) const {
    return __float_as_int(rows[(long long)c * PLANES * K + 12 * K + k]);
  }
};

// Plane p of cluster c in the two-level pack, rows [C*16, K].
struct RowPlanes {
  const float* __restrict__ rows;
  __device__ __forceinline__ const float* at(int c, int p) const {
    return rows + (long long)c * PLANES * K + p * K;
  }
};

// Plane p of cluster c in the flat pack, nine [C, K] tensors.
struct SplitPlanes {
  const float* __restrict__ planes[9];
  __device__ __forceinline__ const float* at(int c, int p) const {
    return planes[p] + (long long)c * K;
  }
};

// Moller-Trumbore (common.cuh `mt`) on the nine planes v0 | e1 | e2 of
// either layout, the prim ids in `order` [C, K]; padding (prim < 0) is
// never accepted. An any hit reports the accepted triangle itself. The
// layout is a type, not nine pointers and a stride for both: the two-level
// walk keeps one base address and the planes' constant offsets (nine
// pointers cost it 4% on an H100, PERF.md).
template <class Planes>
struct MtTest {
  Planes planes;
  const int32_t* __restrict__ order;
  static constexpr bool kAnyHitFlag = false;

  __device__ __forceinline__ void eval(int c, int lane, const Ray& r,
                                       float best_t,
                                       float (&t)[TRIS_PER_LANE],
                                       float (&u)[TRIS_PER_LANE],
                                       float (&v)[TRIS_PER_LANE],
                                       bool (&ok)[TRIS_PER_LANE]) const {
    float pl[9][TRIS_PER_LANE];
    int32_t ids[TRIS_PER_LANE];
#pragma unroll
    for (int p = 0; p < 9; ++p)
      load_plane<float, float4>(planes.at(c, p), 0, lane, pl[p]);
    load_plane<int32_t, int4>(order + (long long)c * K, 0, lane, ids);
#pragma unroll
    for (int i = 0; i < TRIS_PER_LANE; ++i) {
      t[i] = u[i] = v[i] = 0.0f;
      ok[i] = ids[i] >= 0 &&
              mt(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, pl[0][i], pl[1][i],
                 pl[2][i], pl[3][i], pl[4][i], pl[5][i], pl[6][i], pl[7][i],
                 pl[8][i], r.tmin, best_t, t[i], u[i], v[i]);
    }
  }

  __device__ __forceinline__ int32_t prim(int c, int k) const {
    return order[(long long)c * K + k];
  }
};

// The matrix form of Moller-Trumbore (the TPU kernel's [rays, 16] x
// [16, 4K] product per cluster, pallas_mxu.py): cluster c's block is the
// feature rows c*NF .. c*NF + 9 of `g_rows` [C*NF, 4K], each row's columns
// det | u | v | t, K each. The ray's features F = [d, d x o', o', 1], with
// o' = o - centers[:, c / SC] ([4, centers_stride]), are alike on every
// lane. Each lane sums F_q * G_q for its triangles in feature order 0..9,
// starting from F_0 * G_0, as `_numerators` does, then divides as the TPU
// kernel's epilogue. The det and t columns come first; a lane loads u and v
// only when one of its triangles has |det| > 1e-12 and t in (tmin, best_t),
// the only case they can decide. The prim ids are in `order` [C, K];
// padding (prim < 0, G zero) is never accepted. An any hit reports the
// accepted triangle itself.
struct MxuTest {
  static constexpr int SC = 16;  // clusters per supercluster
  static constexpr int NF = 16;  // feature rows per cluster block
  static constexpr int NU = 10;  // feature rows used
  const float* __restrict__ g_rows;
  const int32_t* __restrict__ order;
  const float* __restrict__ centers;
  long long centers_stride;
  static constexpr bool kAnyHitFlag = false;

  // acc[i] (+)= F_q * G_q over q = 0..NU-1 for column group `col`
  __device__ __forceinline__ void column(const float* __restrict__ g,
                                         const float (&f)[NU], int col,
                                         int lane,
                                         float (&acc)[TRIS_PER_LANE]) const {
#pragma unroll
    for (int q = 0; q < NU; ++q) {
      float x[TRIS_PER_LANE];
      load_plane<float, float4>(g + (long long)q * 4 * K, col, lane, x);
#pragma unroll
      for (int i = 0; i < TRIS_PER_LANE; ++i)
        acc[i] = q == 0 ? f[0] * x[i] : acc[i] + f[q] * x[i];
    }
  }

  __device__ __forceinline__ void eval(int c, int lane, const Ray& r,
                                       float best_t,
                                       float (&t)[TRIS_PER_LANE],
                                       float (&u)[TRIS_PER_LANE],
                                       float (&v)[TRIS_PER_LANE],
                                       bool (&ok)[TRIS_PER_LANE]) const {
    const int c2 = c / SC;
    const float opx = r.ox - centers[c2];
    const float opy = r.oy - centers[centers_stride + c2];
    const float opz = r.oz - centers[2 * centers_stride + c2];
    const float f[NU] = {r.dx,
                         r.dy,
                         r.dz,
                         r.dy * opz - r.dz * opy,
                         r.dz * opx - r.dx * opz,
                         r.dx * opy - r.dy * opx,
                         opx,
                         opy,
                         opz,
                         1.0f};
    const float* __restrict__ g = g_rows + (long long)c * NF * 4 * K;
    float det[TRIS_PER_LANE], inv_det[TRIS_PER_LANE];
    column(g, f, 0, lane, det);
    column(g, f, 3, lane, t);
    bool any_in = false;  // a triangle with det and t in range
#pragma unroll
    for (int i = 0; i < TRIS_PER_LANE; ++i) {
      const bool det_ok = fabsf(det[i]) > 1e-12f;
      inv_det[i] = det_ok ? 1.0f / det[i] : 0.0f;
      t[i] = t[i] * inv_det[i];
      ok[i] = det_ok && t[i] > r.tmin && t[i] < best_t;
      any_in |= ok[i];
      u[i] = v[i] = 0.0f;
    }
    if (!any_in) return;
    int32_t ids[TRIS_PER_LANE];
    column(g, f, 1, lane, u);
    column(g, f, 2, lane, v);
    load_plane<int32_t, int4>(order + (long long)c * K, 0, lane, ids);
#pragma unroll
    for (int i = 0; i < TRIS_PER_LANE; ++i) {
      u[i] = u[i] * inv_det[i];
      v[i] = v[i] * inv_det[i];
      ok[i] = ok[i] && ids[i] >= 0 && u[i] >= 0.0f && v[i] >= 0.0f &&
              u[i] + v[i] <= 1.0f;
    }
  }

  __device__ __forceinline__ int32_t prim(int c, int k) const {
    return order[(long long)c * K + k];
  }
};

// The best hit of a ray so far; every lane of the ray holds the same.
struct Best {
  float t, u, v;
  int32_t prim;
};

// Visit cluster `c`: fold its triangles into `best`. True when the cluster
// gave a hit (an any-hit ray then stops).
template <class Test>
__device__ __forceinline__ bool visit(const Test& test, int c, int lane,
                                      unsigned mask, int shift, const Ray& r,
                                      bool any_hit, Best& best) {
  float t[TRIS_PER_LANE], u[TRIS_PER_LANE], v[TRIS_PER_LANE];
  bool ok[TRIS_PER_LANE];
  test.eval(c, lane, r, best.t, t, u, v, ok);
  // the lane's pick: its first accepted triangle (any hit) or its smallest
  // accepted t, the lowest k on a tie (closest hit)
  float lt = __int_as_float(0x7f800000);  // +inf
  float lu = 0.0f, lv = 0.0f;
  int lk = K;  // K: none
#pragma unroll
  for (int i = 0; i < TRIS_PER_LANE; ++i) {
    const bool take = any_hit ? ok[i] && lk == K : ok[i] && t[i] < lt;
    if (take) {
      lt = t[i];
      lu = u[i];
      lv = v[i];
      lk = lane * TRIS_PER_LANE + i;
    }
  }
  const unsigned hits = (__ballot_sync(mask, lk < K) & mask) >> shift;
  if (hits == 0) return false;
  if (any_hit && Test::kAnyHitFlag) {
    best.t = r.tmin;
    best.prim = 1;
    return true;
  }
  int src;
  if (any_hit) {
    src = __ffs(hits) - 1;
    lt = __shfl_sync(mask, lt, src, RAY_LANES);
    lk = __shfl_sync(mask, lk, src, RAY_LANES);
  } else {
#pragma unroll
    for (int off = RAY_LANES / 2; off > 0; off >>= 1) {
      const float ot = __shfl_xor_sync(mask, lt, off, RAY_LANES);
      const int ok_k = __shfl_xor_sync(mask, lk, off, RAY_LANES);
      if (ot < lt || (ot == lt && ok_k < lk)) {
        lt = ot;
        lk = ok_k;
      }
    }
    src = lk / TRIS_PER_LANE;
  }
  best.t = lt;
  best.u = __shfl_sync(mask, lu, src, RAY_LANES);
  best.v = __shfl_sync(mask, lv, src, RAY_LANES);
  best.prim = test.prim(c, lk);
  return true;
}

// kOneLevel: a taken top box is itself the cluster to visit (the flat
// pack, per_top = 1); the retest against the current best_t is then the
// cluster's test, and the cluster ballot is skipped.
template <class Test, bool kOneLevel>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    walk_kernel(Test test, Levels lv, const float* __restrict__ ray_o,
                const float* __restrict__ ray_d,
                const float* __restrict__ tmin_in,
                const float* __restrict__ tmax_in, long long n, int any_hit,
                float* __restrict__ t_out, int32_t* __restrict__ prim_out,
                float* __restrict__ u_out, float* __restrict__ v_out) {
  const long long ray =
      ((long long)blockIdx.x * THREADS + threadIdx.x) / RAY_LANES;
  if (ray >= n) return;  // the ray's lanes alike
  const int lane = threadIdx.x % RAY_LANES;
  const int shift = threadIdx.x % 32 / RAY_LANES * RAY_LANES;
  const unsigned mask =
      RAY_LANES == 32 ? 0xffffffffu : ((1u << RAY_LANES) - 1u) << shift;

  Ray r;
  r.ox = ray_o[3 * ray];
  r.oy = ray_o[3 * ray + 1];
  r.oz = ray_o[3 * ray + 2];
  r.dx = ray_d[3 * ray];
  r.dy = ray_d[3 * ray + 1];
  r.dz = ray_d[3 * ray + 2];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  r.tmin = tmin_in[ray];
  Best best{tmax_in[ray], 0.0f, 0.0f, -1};
  const bool hit_mode = any_hit != 0;

  if (!(best.t <= r.tmin)) {
    for (int g0 = 0; g0 < lv.num_top; g0 += RAY_LANES) {
      const int g = g0 + lane;
      const float chunk_t = best.t;
      unsigned tops =
          (__ballot_sync(mask, g < lv.num_top &&
                                   slab(lv.top, lv.top_stride, g, r.ox, r.oy,
                                        r.oz, r.ix, r.iy, r.iz, r.tmin,
                                        best.t)) &
           mask) >>
          shift;
      while (tops) {
        const int gt = g0 + __ffs(tops) - 1;
        tops &= tops - 1;
        if (best.t != chunk_t &&
            !slab(lv.top, lv.top_stride, gt, r.ox, r.oy, r.oz, r.ix, r.iy,
                  r.iz, r.tmin, best.t))
          continue;
        if constexpr (kOneLevel) {
          if (visit(test, gt, lane, mask, shift, r, hit_mode, best) &&
              hit_mode)
            goto done;
          continue;
        }
        for (int j0 = 0; j0 < lv.per_top; j0 += RAY_LANES) {
          const int j = j0 + lane;
          const int c = gt * lv.per_top + j;
          const float sub_t = best.t;
          unsigned cls =
              (__ballot_sync(mask, j < lv.per_top && c < lv.num_clusters &&
                                       slab(lv.aabb, lv.stride, c, r.ox, r.oy,
                                            r.oz, r.ix, r.iy, r.iz, r.tmin,
                                            best.t)) &
               mask) >>
              shift;
          while (cls) {
            const int cv = gt * lv.per_top + j0 + __ffs(cls) - 1;
            cls &= cls - 1;
            if (best.t != sub_t &&
                !slab(lv.aabb, lv.stride, cv, r.ox, r.oy, r.oz, r.ix, r.iy,
                      r.iz, r.tmin, best.t))
              continue;
            if (visit(test, cv, lane, mask, shift, r, hit_mode, best) &&
                hit_mode)
              goto done;
          }
        }
      }
    }
  }
done:
  if (lane == 0) {
    t_out[ray] = best.t;
    prim_out[ray] = best.prim;
    u_out[ray] = best.u;
    v_out[ray] = best.v;
  }
}

// Launch the walk over `n` rays on `stream`; returns cudaGetLastError().
template <class Test, bool kOneLevel = false>
inline int launch(const Test& test, const Levels& lv, const float* ray_o,
                  const float* ray_d, const float* tmin, const float* tmax,
                  long long n, long long any_hit, float* t_out,
                  int32_t* prim_out, float* u_out, float* v_out,
                  void* stream) {
  const unsigned blocks = blocks_for(n * RAY_LANES, THREADS);
  if (blocks > 0) {
    walk_kernel<Test, kOneLevel><<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        test, lv, ray_o, ray_d, tmin, tmax, n, (int)any_hit, t_out, prim_out,
        u_out, v_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace walk
}  // namespace henjou
