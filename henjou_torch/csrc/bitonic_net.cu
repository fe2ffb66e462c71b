// Payload-carrying bitonic network for Hopper (sm_90a): the kernels of the
// bitonic-schedule experiments.
//
// Replaces the Pallas TPU kernels of tools/exp_bitonic.py (kern_switch :53,
// kern_unroll :82), tools/exp_bitonic2.py (kern_a :73, kern_b :91, kern_c
// :109, kern_d :120, kern_e :156, kern_f :173, kern_g :201),
// tools/exp_bitonic3.py (kern_inplace :59, kern_inplace_aliased :66) and
// tools/exp_bitonic4.py (the make_loop :105 kernels over x1, x2, x5 and the
// guard chains :144). Each runs the network of `_sort_kernel`
// (henjou_tpu/accel/bitonic.py :54), one substage of it, or its rolls
// alone, over [P, S, 128] VMEM planes, every payload plane riding each
// exchange.
//
// State: P int32 planes of n = 2^m elements, [P][n], plane 0 the key.
// Substage (k, j): element i compares its key with that of i ^ j, and with
// take_min = ((i & j) == 0) == ((i & k) == 0) takes its partner's planes
// where take_min && key > pkey or !take_min && key < pkey. Each element
// decides for itself, as the TPU kernels' where(swap, partner, self) does,
// so equal keys never move and the network's own tie order is reproduced
// bit for bit. (This is not bitonic.cu's stable (key, index) sort.) The
// rule also covers k == j, which exp_bitonic4.py's x2 row reaches: there
// both elements of a pair may take the same key, as on the TPU.
//
// Kernels:
//   net_substage  one (k, j) over device memory, "stacked" (a thread per
//                 pair carrying every plane; may run in place) or
//                 "per-plane" (a thread per (pair, plane) that re-reads
//                 both keys; src -> dst only: in place, the plane-0 thread
//                 could overwrite a key that another plane's thread has
//                 still to read). j and k are template constants, or j is
//                 one (the host switches on log2 j) and k an argument, or
//                 both are arguments. The guarded form wraps the static
//                 (32, 16) body in a chain of `if (lj == g % 16)` tests, as
//                 exp_bitonic4.py's guard_chain does.
//   net_local     a list of substages with j < TILE on each TILE-element
//                 tile, every plane in shared memory (P * 4 KB).
//   net_walk      a whole substage list in one cooperative launch of the
//                 keyed network engine (keyed_network.cuh): 8-byte (key,
//                 source) words, key halves compared by the rule above,
//                 runs of j below the tile in shared memory and up to
//                 three global substages per pass, a grid barrier after
//                 each pass,
//                 the planes gathered once through the sources; in place
//                 or into a new state, with each global pass's first j
//                 either dispatched by a switch to static-j code or used
//                 as read: the counterpart of one pallas_call whose
//                 fori_loop walks an SMEM schedule.
//   roll_pass     out = roll(x, 16) + roll(x, 112) along each 128-element
//                 row of every plane, in unsigned arithmetic (wraps).
//
// What bounds them: bytes. A substage does two integer compares per pair
// and moves every plane in and out once: 2 * P * n * 4 bytes, 5.2 MB at
// 65,536 x 10, 1.56 us at 3.35 TB/s. That fits the 50 MB L2 cache, so in a
// chain of passes each one is bound by L2 bandwidth and, at this size, by
// its launch. A full sort is 136 substages at n = 65,536. net_local folds
// a run of substages with j < TILE into one pass over memory; the
// host-walked sorts of the tools combine it with net_substage for
// j >= TILE (28 launches at n = 65,536 instead of 136). net_walk leaves
// the planes out of the network altogether and pays one launch and 16 grid
// barriers for the whole sort; its note is in keyed_network.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keyed_network.cuh"

namespace {

constexpr int TILE = 1024;     // elements per net_local block
constexpr int THREADS = 256;   // threads per block of the other kernels
constexpr int MAX_LIST = 256;  // substages per net_local launch
constexpr int ROW = 128;       // roll_pass row length
constexpr int ROLL_A = 16;
constexpr int ROLL_B = 112;

// j and k of a substage: the template constant where it is not 0, else the
// run-time value.
template <long long J, long long K>
struct JK {
  long long j_rt, k_rt;
  __device__ __forceinline__ long long j() const { return J ? J : j_rt; }
  __device__ __forceinline__ long long k() const { return K ? K : k_rt; }
};

// Whether element i takes its partner's planes.
__device__ __forceinline__ bool takes(long long i, long long j, long long k,
                                      int32_t key, int32_t pkey) {
  const bool take_min = ((i & j) == 0) == ((i & k) == 0);
  return take_min ? key > pkey : key < pkey;
}

// The lower element of pair t (0 <= t < n / 2) at distance j.
__device__ __forceinline__ long long pair_lo(long long t, long long j) {
  return 2 * t - (t & (j - 1));
}

// Pair t of substage `jk`, every plane, src -> dst. dst may be src: the
// pair's elements are read before they are written, and no other pair
// touches them.
template <class S>
__device__ __forceinline__ void exchange(const int32_t* src, int32_t* dst,
                                         long long n, int planes, long long t,
                                         S jk) {
  const long long j = jk.j(), k = jk.k();
  const long long lo = pair_lo(t, j), hi = lo + j;
  const int32_t a = src[lo], b = src[hi];
  const bool s_lo = takes(lo, j, k, a, b);
  const bool s_hi = takes(hi, j, k, b, a);
  for (int p = 0; p < planes; ++p) {
    const long long off = p * n;
    const int32_t x = src[off + lo];
    const int32_t y = src[off + hi];
    dst[off + lo] = s_lo ? y : x;
    dst[off + hi] = s_hi ? x : y;
  }
}

template <long long J, long long K>
__global__ void substage_stacked(const int32_t* src, int32_t* dst, long long n,
                                 int planes, long long j, long long k) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n / 2) exchange(src, dst, n, planes, t, JK<J, K>{j, k});
}

// blockIdx.y is the plane.
template <long long J, long long K>
__global__ void substage_per_plane(const int32_t* __restrict__ src,
                                   int32_t* __restrict__ dst, long long n,
                                   long long j_rt, long long k_rt) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n / 2) return;
  const JK<J, K> jk{j_rt, k_rt};
  const long long j = jk.j(), k = jk.k();
  const long long lo = pair_lo(t, j), hi = lo + j;
  const int32_t a = src[lo], b = src[hi];
  const long long off = (long long)blockIdx.y * n;
  const int32_t x = src[off + lo], y = src[off + hi];
  dst[off + lo] = takes(lo, j, k, a, b) ? y : x;
  dst[off + hi] = takes(hi, j, k, b, a) ? x : y;
}

// The static (32, 16) body behind NG guards `lj == g % 16`.
template <int NG>
__global__ void substage_guarded(const int32_t* src, int32_t* dst, long long n,
                                 int planes, long long lj) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n / 2) return;
#pragma unroll
  for (int g = 0; g < NG; ++g)
    if (lj == g % 16) exchange(src, dst, n, planes, t, JK<16, 32>{0, 0});
}

// A substage list by value (kernel parameters live in constant memory).
struct SubList {
  int32_t j[MAX_LIST];
  int32_t k[MAX_LIST];
  int count;
};

// blockDim.x == TILE / 2: one thread per pair of the tile.
__global__ void local_list(const int32_t* src, int32_t* dst, long long n,
                           int planes, SubList list) {
  extern __shared__ int32_t sm[];  // [planes][TILE]
  const long long base = (long long)blockIdx.x * TILE;
  for (int p = 0; p < planes; ++p)
    for (int u = threadIdx.x; u < TILE; u += blockDim.x)
      sm[p * TILE + u] = src[p * n + base + u];
  __syncthreads();
  const int t = threadIdx.x;
  for (int s = 0; s < list.count; ++s) {
    const int j = list.j[s];
    const long long k = list.k[s];
    const int lo = 2 * t - (t & (j - 1)), hi = lo + j;
    const int32_t a = sm[lo], b = sm[hi];
    const bool s_lo = takes(base + lo, j, k, a, b);
    const bool s_hi = takes(base + hi, j, k, b, a);
    if (s_lo || s_hi) {
      for (int p = 0; p < planes; ++p) {
        const int32_t x = sm[p * TILE + lo], y = sm[p * TILE + hi];
        sm[p * TILE + lo] = s_lo ? y : x;
        sm[p * TILE + hi] = s_hi ? x : y;
      }
    }
    __syncthreads();
  }
  for (int p = 0; p < planes; ++p)
    for (int u = threadIdx.x; u < TILE; u += blockDim.x)
      dst[p * n + base + u] = sm[p * TILE + u];
}

#define HJ_LOG2_CASES(X)                                                    \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
      X(14) X(15) X(16)

__device__ __forceinline__ int32_t roll_sum(const int32_t* row, int l) {
  return (int32_t)((uint32_t)row[(l - ROLL_A) & (ROW - 1)] +
                   (uint32_t)row[(l - ROLL_B) & (ROW - 1)]);
}

__global__ void roll_stacked(const int32_t* __restrict__ src,
                             int32_t* __restrict__ dst, long long n,
                             int planes) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long row = i & ~(long long)(ROW - 1);
  const int l = (int)(i & (ROW - 1));
  for (int p = 0; p < planes; ++p) dst[p * n + i] = roll_sum(src + p * n + row, l);
}

// blockIdx.y is the plane.
__global__ void roll_per_plane(const int32_t* __restrict__ src,
                               int32_t* __restrict__ dst, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long off = (long long)blockIdx.y * n;
  const long long row = i & ~(long long)(ROW - 1);
  dst[off + i] = roll_sum(src + off + row, (int)(i & (ROW - 1)));
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

inline int log2_of(long long x) {
  int l = 0;
  while ((1LL << l) < x) ++l;
  return l;
}

typedef void (*StackedFn)(const int32_t*, int32_t*, long long, int, long long,
                          long long);
typedef void (*PlaneFn)(const int32_t*, int32_t*, long long, long long,
                        long long);

}  // namespace

extern "C" {

// One substage (k, j) of a [planes][n] int32 state, src -> dst (dst may be
// src unless per_plane). mode 0: j and k run-time; 1: j a template constant
// (j <= 2^16), k run-time; 2: both constants ((k, j) = (32, 16) or
// (1024, 512)). guards 4 or 16: the guarded static (32, 16) body, stacked,
// with lj the value the guards test. Returns a cudaError_t.
int henjou_net_substage(const int32_t* src, int32_t* dst, long long planes,
                        long long n, long long j, long long k,
                        long long per_plane, long long mode, long long guards,
                        long long lj, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n / 2, THREADS);
  if (guards != 0) {
    if (guards == 4)
      substage_guarded<4><<<blocks, THREADS, 0, s>>>(src, dst, n, (int)planes, lj);
    else if (guards == 16)
      substage_guarded<16><<<blocks, THREADS, 0, s>>>(src, dst, n, (int)planes, lj);
    else
      return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  StackedFn fs = nullptr;
  PlaneFn fp = nullptr;
  if (mode == 0) {
    fs = substage_stacked<0, 0>;
    fp = substage_per_plane<0, 0>;
  } else if (mode == 1) {
    switch (log2_of(j)) {
#define HJ_STATIC_J_CASE(L)                    \
  case L:                                      \
    fs = substage_stacked<(1LL << L), 0>;      \
    fp = substage_per_plane<(1LL << L), 0>;    \
    break;
      HJ_LOG2_CASES(HJ_STATIC_J_CASE)
#undef HJ_STATIC_J_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else if (mode == 2 && j == 16 && k == 32) {
    fs = substage_stacked<16, 32>;
    fp = substage_per_plane<16, 32>;
  } else if (mode == 2 && j == 512 && k == 1024) {
    fs = substage_stacked<512, 1024>;
    fp = substage_per_plane<512, 1024>;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (per_plane)
    fp<<<dim3(blocks, (unsigned)planes), THREADS, 0, s>>>(src, dst, n, j, k);
  else
    fs<<<blocks, THREADS, 0, s>>>(src, dst, n, (int)planes, j, k);
  return (int)cudaGetLastError();
}

// The substages (ks[i], js[i]), i < count <= MAX_LIST, all with j < TILE,
// on each TILE-element tile; n a multiple of TILE; dst may be src.
int henjou_net_local(const int32_t* src, int32_t* dst, long long planes,
                     long long n, const long long* js, const long long* ks,
                     long long count, void* stream) {
  if (count > MAX_LIST) return (int)cudaErrorInvalidValue;
  SubList list;
  list.count = (int)count;
  for (long long i = 0; i < count; ++i) {
    list.j[i] = (int32_t)js[i];
    list.k[i] = (int32_t)ks[i];
  }
  const size_t smem = (size_t)planes * TILE * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        local_list, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  local_list<<<(unsigned)(n / TILE), TILE / 2, smem,
               static_cast<cudaStream_t>(stream)>>>(src, dst, n, (int)planes, list);
  return (int)cudaGetLastError();
}

// The substage list `codes` (the plan of accel/bitonic.py `plan_codes`)
// over the [planes][n] state `in`, in one cooperative launch of the keyed
// network engine, the key halves of the words compared. inplace: in and out are the same state, the planes are
// gathered into the scratch state buf and copied back after a barrier;
// else into out (buf unused). words: n 8-byte words of scratch; idx: n
// int32 of scratch, needed only above 17 planes, whose extra planes take
// gather launches (and in place a copy) after the network. use_switch:
// each global pass's first j dispatched to static-j code by a switch on
// log2 j.
int henjou_net_walk(const int32_t* in, int32_t* out, int32_t* buf, henjou::word_t* words,
                    int32_t* idx, long long planes, long long n, const long long* codes,
                    long long count, long long inplace, long long use_switch, void* stream) {
  using namespace henjou;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cols = planes - 1;
  if (planes < 1 || (cols > MAX_COLS && idx == nullptr)) return (int)cudaErrorInvalidValue;
  int32_t* state = const_cast<int32_t*>(in);
  int32_t* dst = inplace ? buf : out;
  Emit e{};
  e.key = dst;
  e.idx = cols > MAX_COLS ? idx : nullptr;
  e.back = inplace ? state : nullptr;
  e.cols.count = (int)(cols < MAX_COLS ? cols : MAX_COLS);
  for (int c = 0; c < e.cols.count; ++c) {
    e.cols.src[c] = state + (c + 1) * n;
    e.cols.dst[c] = dst + (c + 1) * n;
    e.cols.stride[c] = 1;
  }
  cudaError_t err = use_switch
      ? launch_network<false, true>(in, words, n, codes, count, e, s)
      : launch_network<false, false>(in, words, n, codes, count, e, s);
  for (long long c0 = MAX_COLS; err == cudaSuccess && c0 < cols; c0 += MAX_COLS) {
    Columns more;
    more.count = (int)(cols - c0 < MAX_COLS ? cols - c0 : MAX_COLS);
    for (int c = 0; c < more.count; ++c) {
      more.src[c] = state + (c0 + c + 1) * n;
      more.dst[c] = dst + (c0 + c + 1) * n;
      more.stride[c] = 1;
    }
    gather_columns<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(more, idx, n);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && inplace && cols > MAX_COLS)
    err = cudaMemcpyAsync(state + (MAX_COLS + 1) * n, buf + (MAX_COLS + 1) * n,
                          (size_t)(cols - MAX_COLS) * n * sizeof(int32_t),
                          cudaMemcpyDeviceToDevice, s);
  return (int)err;
}

// dst = roll(src, 16) + roll(src, 112) along each 128-element row of every
// plane; dst must not be src.
int henjou_roll_pass(const int32_t* src, int32_t* dst, long long planes,
                     long long n, long long per_plane, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(n, THREADS);
  if (per_plane)
    roll_per_plane<<<dim3(blocks, (unsigned)planes), THREADS, 0, s>>>(src, dst, n);
  else
    roll_stacked<<<blocks, THREADS, 0, s>>>(src, dst, n, (int)planes);
  return (int)cudaGetLastError();
}

}  // extern "C"
