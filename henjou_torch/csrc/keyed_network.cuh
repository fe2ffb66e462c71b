// The keyed network engine of bitonic.cu (`bitonic_sort`) and
// bitonic_net.cu (`net_walk`): a substage list of the bitonic network over
// 8-byte (key, source) words, walked in one cooperative launch, with the
// payload moved once at the end.
//
// Word: w = ((uint32)key ^ 0x80000000) << 32 | src, src the element's
// source index. The flipped sign bit makes an unsigned compare order int32
// keys as a signed compare does, negatives included. The payload never
// rides the network: after the last substage each output column is
// out[c][i] = in[c][src(w_i)], a map from sources, which is exact for any
// substage list (also where a k == j substage duplicates a word).
//
// Substage (k, j): element i keeps its word w or takes its partner's
// word p = w[i ^ j]: with take_min = ((i & j) == 0) == ((i & k) == 0) it
// takes p where take_min && w > p or !take_min && w < p. WHOLE compares
// whole words, which are distinct, so a sort's schedule (k > j
// throughout) gives the stable ascending order (ties in the key fall to
// src). Otherwise only the key
// halves are compared, and equal keys never move: the per-element rule
// and tie order of the JAX experiment kernels.
//
// The host cuts the list into passes and the passes into groups
// (accel/bitonic.py `plan_passes`, `plan_groups`). A group is up to 3
// consecutive substages of distinct j: the thread that runs it holds the
// 2^m words b ^ S, S over the subsets of the group's j, a set closed under
// all m exchanges, so the group costs one read and one write of the words.
//   local   a maximal run of substages with j < T: each block loads a
//           T-word tile into shared memory once, runs the run's groups
//           with a __syncthreads() after each, and writes it back once;
//   global  one group of substages with j >= T, over device memory.
// One cooperative launch runs the passes with grid.sync() after each;
// words that other blocks wrote are read through L2 (__ldcg). Then every
// thread of the grid emits the key, the source index and the payload
// columns of its elements. In place, the emit goes to a scratch copy and
// one more barrier copies it back.
//
// What bounds it: not bytes. A pass over the words moves 16 B per element
// (1 MB at n = 65,536, 0.3 us at 3.35 TB/s) and the gather moves each
// column once (1.565 us for 10 columns). At n = 65,536 and T = NET_TILE =
// 1024 the sort is 115 shared-memory substages in 7 local passes (43
// groups) and 21 global ones in 9 passes: 16 grid barriers. (The tile and
// the group size of 3 were picked on the H100 from CUDA-graph times of
// tiles 512 to 8192 and groups of 2 and 3; PERF.md keeps the sweep.)
// Latency sets the pace: a group's round through shared memory (~0.5 us),
// a barrier (~1.2 us) and a global pass are each mostly waiting, so the
// launch takes some 40x the bound.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace henjou {
namespace {

namespace cg = cooperative_groups;

typedef unsigned long long word_t;

constexpr int NET_THREADS = 256;    // threads per block of the network
constexpr int NET_TILE = 1024;      // words per shared-memory tile (T)
constexpr int NET_MAX_SUBS = 1024;  // substages per plan
constexpr int MAX_COLS = 16;        // payload columns per launch
constexpr uint32_t SIGN = 0x80000000u;

// A substage's code: log2 j in bits 0-4, log2 k in bits 5-9; GROUP_START
// on the first substage of each group (up to 3 consecutive substages of
// distinct j that one thread runs on the 2^m words b ^ S), PASS_START on
// the first of each pass, and GLOBAL on that of a global pass
// (accel/bitonic.py `plan_codes`).
constexpr int CODE_LK = 5;
constexpr int GROUP_START = 1 << 10;
constexpr int PASS_START = 1 << 11;
constexpr int GLOBAL = 1 << 12;

struct Plan {
  uint16_t code[NET_MAX_SUBS];
  int count;
};

// Up to MAX_COLS 4-byte columns; column c is an element every stride[c]
// elements from src[c] / dst[c], so a [n, 3] tensor travels as three
// strided columns. src is written only by the in-place copy-back.
struct Columns {
  int32_t* src[MAX_COLS];
  int32_t* dst[MAX_COLS];
  long long stride[MAX_COLS];
  int count;
};

// What the network writes for element i holding word w: key[i] = the key
// of w, idx[i] = src(w) (unless idx is null) and cols.dst[c][i] =
// cols.src[c][src(w)]. With back set (in place), a barrier later copies
// key into back and each cols.dst[c] into cols.src[c].
struct Emit {
  int32_t* key;
  int32_t* idx;
  Columns cols;
  int32_t* back;
};

__device__ __forceinline__ int code_lj(int code) { return code & 31; }
__device__ __forceinline__ int code_lk(int code) { return (code >> CODE_LK) & 31; }

__device__ __forceinline__ word_t make_word(int32_t key, uint32_t src) {
  return (word_t)((uint32_t)key ^ SIGN) << 32 | src;
}

// Substage (k, j) on the pair (lo, lo | j) holding words x and y, by the
// per-element rule: lo takes the min where lo & k is 0, else the max; hi
// the other, except where k == j, where it takes the min too. WHOLE (a
// sort's schedule, k > j, distinct words): the pair swaps where x > y
// agrees with the direction. Otherwise the key halves decide, and equal
// keys never move.
template <bool WHOLE>
__device__ __forceinline__ void settle_pair(uint32_t lo, uint32_t j, uint32_t k, word_t& x,
                                            word_t& y) {
  const bool up = (lo & k) == 0;
  bool swap_lo, swap_hi;
  if (WHOLE) {
    swap_lo = swap_hi = (x > y) == up;
  } else {
    const uint32_t kx = (uint32_t)(x >> 32), ky = (uint32_t)(y >> 32);
    swap_lo = up ? kx > ky : ky > kx;
    swap_hi = k == j ? ky > kx : swap_lo;
  }
  const word_t nx = swap_lo ? y : x;
  const word_t ny = swap_hi ? x : y;
  x = nx;
  y = ny;
}

// The M substages of a group from s0 (distinct j). J0, where not 0, is
// the first substage's j compiled as a constant. The thread running group
// g holds the words at spread(g) | offset(a), a < 2^M: spread inserts a
// zero bit at each of the group's j, offset(a) sets those of a's bits.
template <int M>
struct Group {
  uint32_t J[M], K[M];
  int pos[M];  // log2 of the J, ascending

  __device__ __forceinline__ Group(const uint16_t* codes, int s0, uint32_t j0) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int code = codes[s0 + m];
      pos[m] = (m == 0 && j0) ? __ffs(j0) - 1 : code_lj(code);
      J[m] = 1u << pos[m];
      K[m] = 1u << code_lk(code);
    }
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
      for (int c = a + 1; c < M; ++c)
        if (pos[c] < pos[a]) {
          const int t = pos[a];
          pos[a] = pos[c];
          pos[c] = t;
        }
  }
  __device__ __forceinline__ uint32_t spread(uint32_t g) const {
#pragma unroll
    for (int m = 0; m < M; ++m)  // lowest first
      g = ((g >> pos[m]) << (pos[m] + 1)) | (g & ((1u << pos[m]) - 1));
    return g;
  }
  __device__ __forceinline__ uint32_t offset(int a) const {
    uint32_t o = 0;
#pragma unroll
    for (int m = 0; m < M; ++m)
      if ((a >> m) & 1) o |= J[m];
    return o;
  }
  // The substages in order on the words w[a] of the elements b | offset(a).
  template <bool WHOLE>
  __device__ __forceinline__ void run(word_t (&w)[1 << M], uint32_t b) const {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int a = 0; a < (1 << M); ++a)
        if (!((a >> m) & 1))
          settle_pair<WHOLE>(b | offset(a), J[m], K[m], w[a], w[a | (1 << m)]);
  }
};

// Word i at the start of a pass: built from the key in the first pass,
// else read through L2 (another block may have written it before the
// last barrier).
__device__ __forceinline__ word_t load_word(const int32_t* key_in, const word_t* words,
                                            uint32_t i, bool first) {
  return first ? make_word(key_in[i], i) : __ldcg(words + i);
}

__device__ __forceinline__ void emit(const Emit& e, uint32_t i, word_t w) {
  const uint32_t src = (uint32_t)w;
  e.key[i] = (int32_t)((uint32_t)(w >> 32) ^ SIGN);
  if (e.idx) e.idx[i] = (int32_t)src;
#pragma unroll
  for (int c = 0; c < MAX_COLS; ++c) {  // unrolled: each column's fields at a fixed offset
    if (c >= e.cols.count) break;
    e.cols.dst[c][i * e.cols.stride[c]] = e.cols.src[c][src * e.cols.stride[c]];
  }
}

// Shared-memory slot of tile word u: one pad word per 16 keeps the 8-byte
// accesses of a group's words on distinct banks, also where the group's j
// are 1, 2 and 4 and each thread's words are contiguous.
__device__ __forceinline__ uint32_t slot(uint32_t u) { return u + (u >> 4); }

template <bool WHOLE, int M>
__device__ __forceinline__ void local_group(word_t* tile, uint32_t base, uint32_t tl,
                                            const uint16_t* codes, int s0) {
  const Group<M> grp(codes, s0, 0);
  for (uint32_t g = threadIdx.x; g < (tl >> M); g += NET_THREADS) {
    const uint32_t b = grp.spread(g);
    word_t w[1 << M];
#pragma unroll
    for (int a = 0; a < (1 << M); ++a) w[a] = tile[slot(b | grp.offset(a))];
    grp.template run<WHOLE>(w, base | b);
#pragma unroll
    for (int a = 0; a < (1 << M); ++a) tile[slot(b | grp.offset(a))] = w[a];
  }
}

// Substages s0 .. s1-1 (all j < tl) on every tl-word tile: the tile is
// loaded once, each group is one round through shared memory, and the
// tile is written back once.
template <bool WHOLE>
__device__ __forceinline__ void local_pass(const int32_t* key_in, word_t* words, word_t* tile,
                                           uint32_t n, uint32_t tl, const uint16_t* codes,
                                           int s0, int s1, bool first) {
  for (long long bb = (long long)blockIdx.x * tl; bb < n; bb += (long long)gridDim.x * tl) {
    const uint32_t base = (uint32_t)bb;
    for (uint32_t u = threadIdx.x; u < tl; u += NET_THREADS)
      tile[slot(u)] = load_word(key_in, words, base + u, first);
    __syncthreads();
    for (int g0 = s0; g0 < s1;) {
      int g1 = g0 + 1;
      while (g1 < s1 && !(codes[g1] & GROUP_START)) ++g1;
      if (g1 - g0 == 1)
        local_group<WHOLE, 1>(tile, base, tl, codes, g0);
      else if (g1 - g0 == 2)
        local_group<WHOLE, 2>(tile, base, tl, codes, g0);
      else
        local_group<WHOLE, 3>(tile, base, tl, codes, g0);
      __syncthreads();
      g0 = g1;
    }
    for (uint32_t u = threadIdx.x; u < tl; u += NET_THREADS) words[base + u] = tile[slot(u)];
    __syncthreads();  // the next tile's load overwrites this one
  }
}

// One group of M global substages (j >= tl) from s0: one read and one
// write of the words.
template <bool WHOLE, int M, uint32_t J0>
__device__ __forceinline__ void global_pass(const int32_t* key_in, word_t* words, uint32_t n,
                                            const uint16_t* codes, int s0, bool first) {
  const Group<M> grp(codes, s0, J0);
  const long long groups = (long long)(n >> M);
  for (long long g = (long long)blockIdx.x * NET_THREADS + threadIdx.x; g < groups;
       g += (long long)gridDim.x * NET_THREADS) {
    const uint32_t b = grp.spread((uint32_t)g);
    word_t w[1 << M];
#pragma unroll
    for (int a = 0; a < (1 << M); ++a) w[a] = load_word(key_in, words, b | grp.offset(a), first);
    grp.template run<WHOLE>(w, b);
#pragma unroll
    for (int a = 0; a < (1 << M); ++a) words[b | grp.offset(a)] = w[a];
  }
}

template <bool WHOLE, uint32_t J0>
__device__ __forceinline__ void global_group(int m, const int32_t* key_in, word_t* words,
                                             uint32_t n, const uint16_t* codes, int s0,
                                             bool first) {
  if (m == 1)
    global_pass<WHOLE, 1, J0>(key_in, words, n, codes, s0, first);
  else if (m == 2)
    global_pass<WHOLE, 2, J0>(key_in, words, n, codes, s0, first);
  else
    global_pass<WHOLE, 3, J0>(key_in, words, n, codes, s0, first);
}

// log2 j of the global passes compiled as constants (j >= NET_TILE, up
// to 2^16); a larger j runs with j as read.
#define HJ_GLOBAL_LOG2_CASES(X) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// The plan over the n words of key_in, in one cooperative launch (tiles
// of min(n, NET_TILE) words, 8.7 KB of shared memory per block), then the
// emit of every element after one more barrier. SWITCH: each global pass
// runs code compiled for its first j, picked by a switch on log2 j.
template <bool WHOLE, bool SWITCH>
__global__ void __launch_bounds__(NET_THREADS)
    network(const int32_t* key_in, word_t* words, uint32_t n,
            const __grid_constant__ Plan plan, const __grid_constant__ Emit e) {
  __shared__ word_t tile[NET_TILE + NET_TILE / 16];  // slot(NET_TILE)
  __shared__ uint16_t codes[NET_MAX_SUBS];            // the plan, read on every group
  cg::grid_group grid = cg::this_grid();
  const uint32_t tl = n < (uint32_t)NET_TILE ? n : (uint32_t)NET_TILE;
  for (int s = threadIdx.x; s < plan.count; s += NET_THREADS) codes[s] = plan.code[s];
  __syncthreads();
  for (int s0 = 0; s0 < plan.count;) {
    int s1 = s0 + 1;
    while (s1 < plan.count && !(codes[s1] & PASS_START)) ++s1;
    const bool first = s0 == 0;
    if (!(codes[s0] & GLOBAL)) {
      local_pass<WHOLE>(key_in, words, tile, n, tl, codes, s0, s1, first);
    } else if (SWITCH) {
      switch (code_lj(codes[s0])) {
#define HJ_GLOBAL_CASE(L)                                                    \
  case L:                                                                    \
    global_group<WHOLE, (1u << L)>(s1 - s0, key_in, words, n, codes, s0, first); \
    break;
        HJ_GLOBAL_LOG2_CASES(HJ_GLOBAL_CASE)
#undef HJ_GLOBAL_CASE
        default:
          global_group<WHOLE, 0>(s1 - s0, key_in, words, n, codes, s0, first);
      }
    } else {
      global_group<WHOLE, 0>(s1 - s0, key_in, words, n, codes, s0, first);
    }
    grid.sync();
    s0 = s1;
  }
  const long long i0 = (long long)blockIdx.x * NET_THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * NET_THREADS;
  for (long long i = i0; i < n; i += stride)
    emit(e, (uint32_t)i, load_word(key_in, words, (uint32_t)i, plan.count == 0));
  if (e.back) {
    grid.sync();
    for (long long i = i0; i < n; i += stride) {
      e.back[i] = __ldcg(e.key + i);
#pragma unroll
      for (int c = 0; c < MAX_COLS; ++c) {
        if (c >= e.cols.count) break;
        e.cols.src[c][i * e.cols.stride[c]] = __ldcg(e.cols.dst[c] + i * e.cols.stride[c]);
      }
    }
  }
}

// codes[count] (see Plan) into *plan, checked against the tile: a pass
// is a run of groups, each of 1-3 substages of distinct j; a local pass
// holds only j < tl, a global one is one group of j >= tl.
inline cudaError_t make_plan(const long long* codes, long long count, uint32_t tl, Plan* plan) {
  const long long starts = GROUP_START | PASS_START;
  if (count < 0 || count > NET_MAX_SUBS || (count > 0 && (codes[0] & starts) != starts))
    return cudaErrorInvalidValue;
  plan->count = (int)count;
  long long pass = 0, group = 0;
  for (long long s = 0; s < count; ++s) {
    const long long code = codes[s];
    if (code < 0 || code >= (GLOBAL << 1)) return cudaErrorInvalidValue;
    if (code & PASS_START) {
      if (!(code & GROUP_START)) return cudaErrorInvalidValue;
      pass = s;
    }
    if (code & GROUP_START) group = s;
    const bool global = (codes[pass] & GLOBAL) != 0;
    const uint32_t j = 1u << (code & 31);
    if ((global ? j < tl || group != pass : j >= tl) || s - group >= 3)
      return cudaErrorInvalidValue;
    for (long long r = group; r < s; ++r)
      if ((codes[r] & 31) == (code & 31)) return cudaErrorInvalidValue;
    plan->code[s] = (uint16_t)code;
  }
  return cudaSuccess;
}

// The plan over key_in[n] (n = 2^m <= 2^30), emitting through e; one
// cooperative launch.
template <bool WHOLE, bool SWITCH>
cudaError_t launch_network(const int32_t* key_in, word_t* words, long long n,
                           const long long* codes, long long count, const Emit& e,
                           cudaStream_t s) {
  if (n < 2 || (n & (n - 1)) != 0 || n > (1LL << 30)) return cudaErrorInvalidValue;
  const uint32_t n32 = (uint32_t)n;
  const uint32_t tl = n32 < (uint32_t)NET_TILE ? n32 : (uint32_t)NET_TILE;
  Plan plan;
  cudaError_t err = make_plan(codes, count, tl, &plan);
  if (err != cudaSuccess) return err;
  auto kernel = network<WHOLE, SWITCH>;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NET_THREADS, 0);
  if (err != cudaSuccess) return err;
  // a block per tile, and a thread per pair of a one-substage global
  // pass; a cooperative grid holds no more blocks than can be resident at
  // once, and every phase is grid-strided
  const long long tiles = n / tl;
  const long long pairs = (n / 2 + NET_THREADS - 1) / NET_THREADS;
  const long long want = tiles > pairs ? tiles : pairs;
  const long long most = (long long)per_sm * sms;
  if (most == 0) return cudaErrorCooperativeLaunchTooLarge;
  const unsigned grid = (unsigned)(want < most ? want : most);
  void* args[] = {(void*)&key_in, (void*)&words, (void*)&n32, (void*)&plan, (void*)&e};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(NET_THREADS), args, 0,
                                    s);
  if (err != cudaSuccess) cudaGetLastError();  // a refused launch is returned, not left pending
  return err;
}

// dst[c][i] = src[c][idx[i]] for every column c.
__global__ void gather_columns(Columns cols, const int32_t* __restrict__ idx, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long s = idx[i];
  for (int c = 0; c < cols.count; ++c)
    cols.dst[c][i * cols.stride[c]] = cols.src[c][s * cols.stride[c]];
}

// Columns c0 .. c0 + count - 1 of the host descriptor desc, which holds
// (src pointer, dst pointer, stride) per column; count <= MAX_COLS.
inline Columns columns_of(const long long* desc, long long c0, long long count) {
  Columns cols;
  cols.count = (int)count;
  for (int c = 0; c < cols.count; ++c) {
    const long long* d = desc + 3 * (c0 + c);
    cols.src[c] = reinterpret_cast<int32_t*>(d[0]);
    cols.dst[c] = reinterpret_cast<int32_t*>(d[1]);
    cols.stride[c] = d[2];
  }
  return cols;
}

// Launches `kernel` over n elements for columns c0 .. n_cols - 1 of desc,
// at most MAX_COLS per launch.
template <typename Kernel>
cudaError_t launch_columns(Kernel kernel, const long long* desc, long long c0,
                           long long n_cols, const int32_t* perm, long long n,
                           cudaStream_t s) {
  for (; c0 < n_cols; c0 += MAX_COLS) {
    const long long count = n_cols - c0 < MAX_COLS ? n_cols - c0 : MAX_COLS;
    kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(columns_of(desc, c0, count), perm, n);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace henjou
