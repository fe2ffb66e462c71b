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
//   net_substage  one (k, j) over device memory. A thread owns four pairs:
//                 for j >= 4 the two aligned runs of four at pair_lo and
//                 pair_lo + j, for j in {1, 2} the aligned chunk of eight
//                 that holds both members of each pair (exchanged in
//                 registers); every access is 16 bytes. It reads the keys,
//                 then issues every load of a chunk of CHUNK planes before
//                 any of its stores. "Stacked": one thread carries every
//                 plane of its pairs; where dst is not src the planes are
//                 split in CHUNK-plane groups over blockIdx.y, in place
//                 not (another group's block could overwrite a key this
//                 one has still to read). "Per-plane": blockIdx.y is the
//                 plane, src -> dst only. j and k are template constants,
//                 or j is one (the host switches on log2 j) and k an
//                 argument, or both are arguments. The guarded form wraps
//                 the static (32, 16) stacked body in a chain of
//                 `if (lj == g % 16)` tests, as exp_bitonic4.py's
//                 guard_chain does.
//   net_local     a list of substages with j < TILE on each tile of
//                 2^bits elements, bits = max(8, log2 of twice the list's
//                 largest j): the tile's keys ride the network as 8-byte
//                 (key, source) words (keyed_network.cuh `make_word`,
//                 `settle_pair<false>`), eight per thread. A layout maps
//                 each element bit of the tile to a register bit of the
//                 thread's words, a lane bit or a warp bit; a substage
//                 whose j is a register bit costs no communication, one on
//                 a lane bit a __shfl_xor_sync per word. The host plan
//                 (`plan_local`, mirrored by accel/bitonic_net.py
//                 `plan_local`) picks for each run of substages the warp
//                 bits used furthest ahead and the three bits used most in
//                 the run as register bits; a j that falls on a warp bit
//                 starts the next layout, one round of the words through
//                 shared memory and one barrier. Then each plane of the
//                 tile is read once, coalesced, into shared memory and
//                 written once in the order of the sources.
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
// What bounds them: bytes, and at the tools' size latency. A substage does
// two integer compares per pair and moves every plane in and out once:
// 2 * P * n * 4 bytes, 5.2 MB at 65,536 x 10, 1.565 us at 3.35 TB/s. That
// fits the 50 MB L2 cache, so in a chain of launches each one is bound by
// L2 and by how many loads are in flight: net_substage keeps a chunk of
// planes' 16-byte loads in flight per thread and, split over blockIdx.y,
// puts some 9 warps on every SM at n = 65,536. net_local reads the keys
// and every plane once and writes them once for the whole list; its
// substages cost registers, shuffles and a few shared-memory rounds, not
// bytes, and its tile sized to the list fills all 132 SMs where the
// list's j are small (256 tiles for row C). The host-walked sorts of the
// tools combine it with net_substage for j >= TILE (28 launches at
// n = 65,536 instead of 136). net_walk leaves the planes out of the
// network altogether and pays one launch and 16 grid barriers for the
// whole sort; its note is in keyed_network.cuh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keyed_network.cuh"

namespace {

using henjou::word_t;

constexpr int THREADS = 256;      // threads per block of roll_pass
constexpr int SUB_THREADS = 64;   // threads per block of net_substage
constexpr int OWN = 8;            // elements a net_substage thread owns (4 pairs)
constexpr int CHUNK = 4;          // planes whose loads a net_substage thread has in flight
constexpr int TILE = 1024;        // net_local takes j < TILE
constexpr int MAX_LIST = 256;     // substages per net_local launch
constexpr int REG_BITS = 3;       // a net_local thread holds 2^3 words
constexpr int WORDS = 1 << REG_BITS;
static_assert(WORDS == 8, "local_list's ops and gather are written for eight words");
constexpr int LANE_BITS = 5;
constexpr int MIN_TILE_BITS = REG_BITS + LANE_BITS;  // a one-warp tile, 256 elements
constexpr int MAX_TILE_BITS = 10;                    // TILE
constexpr int GATHER_PLANES = 4;  // payload planes per gather round of net_local
constexpr int ROW = 128;          // roll_pass row length
constexpr int ROLL_A = 16;
constexpr int ROLL_B = 112;

// ---------------- net_substage ----------------

// j and k of a substage: the template constant where it is not 0, else the
// run-time value.
template <uint32_t J, uint32_t K>
struct JK {
  uint32_t j_rt, k_rt;
  __device__ __forceinline__ uint32_t j() const { return J ? J : j_rt; }
  __device__ __forceinline__ uint32_t k() const { return K ? K : k_rt; }
};

// Whether element i takes its partner's planes.
__device__ __forceinline__ bool takes(uint32_t i, uint32_t j, uint32_t k, int32_t key,
                                      int32_t pkey) {
  const bool take_min = ((i & j) == 0) == ((i & k) == 0);
  return take_min ? key > pkey : key < pkey;
}

// The eight elements thread q owns in substage j: slots 0-3 the aligned run
// of four at b0, slots 4-7 the one at b1 = b0 + max(j, 4). For j >= 4 they
// are the lower and upper elements of pairs 4q .. 4q + 3 (the lower
// element of pair t is 2t - (t & (j - 1))); for j in {1, 2} the chunk
// 8q .. 8q + 7, which holds both members of its four pairs. Slot m pairs
// with slot m ^ pm.
struct Owned {
  uint32_t b0, b1, pm;
  __device__ __forceinline__ Owned(uint32_t q, uint32_t j) {
    const uint32_t jj = j < 4 ? 4 : j;
    b0 = 8 * q - ((4 * q) & (jj - 1));
    b1 = b0 + jj;
    pm = j < 4 ? j : 4;
  }
  __device__ __forceinline__ uint32_t index(int m) const { return (m < 4 ? b0 : b1) + (m & 3); }
};

// v[m ^ pm], with m a constant after unrolling.
__device__ __forceinline__ int32_t partner(const int32_t (&v)[OWN], int m, uint32_t pm) {
  return pm == 1 ? v[m ^ 1] : pm == 2 ? v[m ^ 2] : v[m ^ 4];
}

__device__ __forceinline__ void load8(const int32_t* plane, const Owned& o, int32_t (&v)[OWN]) {
  const int4 a = *reinterpret_cast<const int4*>(plane + o.b0);
  const int4 b = *reinterpret_cast<const int4*>(plane + o.b1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(int32_t* plane, const Owned& o, const int32_t (&v)[OWN]) {
  *reinterpret_cast<int4*>(plane + o.b0) = make_int4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<int4*>(plane + o.b1) = make_int4(v[4], v[5], v[6], v[7]);
}

// Planes p0 .. min(p0 + CHUNK, p_end) - 1 of thread q's elements.
__device__ __forceinline__ void load_chunk(const int32_t* src, uint32_t n, int p0, int p_end,
                                           const Owned& o, int32_t (&v)[CHUNK][OWN]) {
#pragma unroll
  for (int c = 0; c < CHUNK; ++c)
    if (p0 + c < p_end) load8(src + (size_t)(p0 + c) * n, o, v[c]);
}

// Planes [p_begin, p_end) of thread q's eight elements in substage `jk`,
// src -> dst. The keys and the first CHUNK planes are loaded together, and
// each later chunk is loaded before the one ahead of it is stored, so a
// thread waits on about one round trip to L2. dst may be src: a thread
// reads its elements of a plane before it writes them, and no other
// thread touches them.
template <class S>
__device__ __forceinline__ void exchange(const int32_t* src, int32_t* dst, uint32_t n,
                                         int p_begin, int p_end, uint32_t q, S jk) {
  const uint32_t j = jk.j(), k = jk.k();
  const Owned o(q, j);
  int32_t key[OWN], v[CHUNK][OWN], next[CHUNK][OWN];
  load8(src, o, key);
  load_chunk(src, n, p_begin, p_end, o, v);
  uint32_t swap = 0;
#pragma unroll
  for (int m = 0; m < OWN; ++m)
    if (takes(o.index(m), j, k, key[m], partner(key, m, o.pm))) swap |= 1u << m;
  for (int p0 = p_begin; p0 < p_end; p0 += CHUNK) {
    const bool more = p0 + CHUNK < p_end;
    if (more) load_chunk(src, n, p0 + CHUNK, p_end, o, next);
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      if (p0 + c >= p_end) continue;
      int32_t out[OWN];
#pragma unroll
      for (int m = 0; m < OWN; ++m) out[m] = (swap >> m) & 1 ? partner(v[c], m, o.pm) : v[c][m];
      store8(dst + (size_t)(p0 + c) * n, o, out);
    }
    if (!more) break;
#pragma unroll
    for (int c = 0; c < CHUNK; ++c)
#pragma unroll
      for (int m = 0; m < OWN; ++m) v[c][m] = next[c][m];
  }
}

// blockIdx.y is a group of `span` planes.
template <uint32_t J, uint32_t K>
__global__ void __launch_bounds__(SUB_THREADS)
    substage_stacked(const int32_t* src, int32_t* dst, uint32_t n, int planes, int span,
                     uint32_t j, uint32_t k) {
  const uint32_t q = blockIdx.x * SUB_THREADS + threadIdx.x;
  if (q >= n / OWN) return;
  const int p_begin = (int)blockIdx.y * span;
  exchange(src, dst, n, p_begin, min(planes, p_begin + span), q, JK<J, K>{j, k});
}

// blockIdx.y is the plane.
template <uint32_t J, uint32_t K>
__global__ void __launch_bounds__(SUB_THREADS)
    substage_per_plane(const int32_t* __restrict__ src, int32_t* __restrict__ dst, uint32_t n,
                       uint32_t j, uint32_t k) {
  const uint32_t q = blockIdx.x * SUB_THREADS + threadIdx.x;
  if (q >= n / OWN) return;
  exchange(src, dst, n, (int)blockIdx.y, (int)blockIdx.y + 1, q, JK<J, K>{j, k});
}

// The static (32, 16) stacked body behind NG guards `lj == g % 16`.
template <int NG>
__global__ void __launch_bounds__(SUB_THREADS)
    substage_guarded(const int32_t* src, int32_t* dst, uint32_t n, int planes, int span,
                     long long lj) {
  const uint32_t q = blockIdx.x * SUB_THREADS + threadIdx.x;
  if (q >= n / OWN) return;
  const int p_begin = (int)blockIdx.y * span;
  const int p_end = min(planes, p_begin + span);
#pragma unroll
  for (int g = 0; g < NG; ++g)
    if (lj == g % 16) exchange(src, dst, n, p_begin, p_end, q, JK<16, 32>{0, 0});
}

// ---------------- net_local ----------------

// A substage's code in a LocalPlan: log2 j in bits 0-4, log2 k in bits
// 5-9, the op in bits 10-12 (below LANE_OP: j is register bit op of the
// words; else lane bit op - LANE_OP), NEW_LAYOUT on the first substage of
// each layout.
constexpr int LK_SHIFT = 5;
constexpr int OP_SHIFT = 10;
constexpr int LANE_OP = REG_BITS;
constexpr int NEW_LAYOUT = 1 << 13;

// A layout: 4 bits per field, the element bit of register bit 0-2, then
// of lane bit 0-4, then of warp bit 0-1.
__host__ __device__ __forceinline__ int field(uint64_t layout, int f) {
  return (int)((layout >> (4 * f)) & 15);
}

struct LocalPlan {
  uint16_t code[MAX_LIST];
  uint16_t run[MAX_LIST];     // at the first of a run of equal codes, its length
  uint64_t layout[MAX_LIST];  // the layouts in order; the first is loaded, each later
                              // one starts at a NEW_LAYOUT code
  int count;
  int bits;                   // log2 of the tile
};

// The tile offset of each of a thread's words under a layout.
struct Offsets {
  uint32_t e[WORDS];
  __device__ __forceinline__ void set(uint64_t layout, int bits, uint32_t lane, uint32_t warp) {
    uint32_t fixed = 0;
#pragma unroll
    for (int b = 0; b < LANE_BITS; ++b)
      fixed |= ((lane >> b) & 1u) << field(layout, REG_BITS + b);
    for (int b = 0; b < bits - MIN_TILE_BITS; ++b)
      fixed |= ((warp >> b) & 1u) << field(layout, MIN_TILE_BITS + b);
#pragma unroll
    for (int s = 0; s < WORDS; ++s) {
      uint32_t o = fixed;
#pragma unroll
      for (int r = 0; r < REG_BITS; ++r) o |= (uint32_t)((s >> r) & 1) << field(layout, r);
      e[s] = o;
    }
  }
};

// Shared-memory slot of tile word u: bits 4-11 folded into bits 0-3, so
// that the 16 lanes of a half-warp hit 16 distinct 8-byte slots for every
// layout the plan makes (its lane bits lie among bits 0-9).
__device__ __forceinline__ uint32_t swz(uint32_t u) { return u ^ ((u >> 4) & 15) ^ ((u >> 8) & 15); }

// `reps` substages (k, j), j on register bit R: each time the pairs of
// words (s, s | 2^R) settle in place.
template <int R>
__device__ __forceinline__ void reg_substages(word_t (&w)[WORDS], const Offsets& at,
                                              uint32_t base, uint32_t j, uint32_t k, int reps) {
  for (int r = 0; r < reps; ++r)
#pragma unroll
    for (int s = 0; s < WORDS; ++s)
      if (!((s >> R) & 1))
        henjou::settle_pair<false>(base + at.e[s], j, k, w[s], w[s | (1 << R)]);
}

// `reps` substages (k, j), j on lane bit l: each time every word meets its
// partner's by one shuffle, and each lane keeps its own element's side of
// the pair.
__device__ __forceinline__ void lane_substages(word_t (&w)[WORDS], const Offsets& at,
                                               uint32_t base, uint32_t j, uint32_t k, int l,
                                               uint32_t lane, int reps) {
  const bool hi = (lane >> l) & 1;
  for (int r = 0; r < reps; ++r)
#pragma unroll
    for (int s = 0; s < WORDS; ++s) {
      const word_t p = __shfl_xor_sync(0xffffffffu, w[s], 1u << l);
      word_t x = hi ? p : w[s], y = hi ? w[s] : p;
      henjou::settle_pair<false>(base + (at.e[s] & ~j), j, k, x, y);
      w[s] = hi ? y : x;
    }
}

// blockDim.x == tile / WORDS. Shared memory: two tiles of words, used in
// turns by the layout changes, then GATHER_PLANES tiles of one plane each.
// The plan's codes are read from shared memory, a run of equal codes
// decoded once, and the next run's code read before this one runs.
__global__ void __launch_bounds__(TILE / WORDS)
    local_list(const int32_t* src, int32_t* dst, uint32_t n, int planes,
               const __grid_constant__ LocalPlan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint16_t codes[MAX_LIST];
  __shared__ uint16_t runs[MAX_LIST];
  const uint32_t tile = 1u << plan.bits;
  word_t* words = reinterpret_cast<word_t*>(smem);
  int32_t* cols = reinterpret_cast<int32_t*>(words + 2 * tile);
  const uint32_t base = blockIdx.x * tile;
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < plan.count; i += blockDim.x) {
    codes[i] = plan.code[i];
    runs[i] = plan.run[i];
  }
  Offsets at;
  int li = 0;
  at.set(plan.layout[0], plan.bits, lane, warp);
  word_t w[WORDS];
#pragma unroll
  for (int s = 0; s < WORDS; ++s) w[s] = henjou::make_word(src[base + at.e[s]], at.e[s]);
  __syncthreads();
  int turn = 0;
  int code = plan.count ? codes[0] : 0, reps = plan.count ? runs[0] : 0;
  for (int i = 0; i < plan.count;) {
    const int next = i + reps;
    const int next_code = next < plan.count ? codes[next] : 0;
    const int next_reps = next < plan.count ? runs[next] : 0;
    if ((code & NEW_LAYOUT) && i > 0) {
      word_t* buf = words + turn * tile;
#pragma unroll
      for (int s = 0; s < WORDS; ++s) buf[swz(at.e[s])] = w[s];
      __syncthreads();
      at.set(plan.layout[++li], plan.bits, lane, warp);
#pragma unroll
      for (int s = 0; s < WORDS; ++s) w[s] = buf[swz(at.e[s])];
      turn ^= 1;  // the next change writes the other tile, so no second barrier
    }
    const uint32_t j = 1u << (code & 31), k = 1u << ((code >> LK_SHIFT) & 31);
    const int op = (code >> OP_SHIFT) & 7;
    if (op == 0)
      reg_substages<0>(w, at, base, j, k, reps);
    else if (op == 1)
      reg_substages<1>(w, at, base, j, k, reps);
    else if (op == 2)
      reg_substages<2>(w, at, base, j, k, reps);
    else
      lane_substages(w, at, base, j, k, op - LANE_OP, lane, reps);
    i = next;
    code = next_code;
    reps = next_reps;
  }
  // the words in tile order, then each thread's eight consecutive elements
  word_t* buf = words + turn * tile;
#pragma unroll
  for (int s = 0; s < WORDS; ++s) buf[swz(at.e[s])] = w[s];
  __syncthreads();
  const uint32_t u0 = threadIdx.x * WORDS;
  uint32_t from[WORDS];
  int32_t out[WORDS];
#pragma unroll
  for (int m = 0; m < WORDS; ++m) {
    const word_t x = buf[swz(u0 + m)];
    from[m] = (uint32_t)x;
    out[m] = (int32_t)((uint32_t)(x >> 32) ^ henjou::SIGN);
  }
  // plane 0 from the words; the tile's keys were all read at the start
  int4* o4 = reinterpret_cast<int4*>(dst + base + u0);
  o4[0] = make_int4(out[0], out[1], out[2], out[3]);
  o4[1] = make_int4(out[4], out[5], out[6], out[7]);
  for (int p0 = 1; p0 < planes; p0 += GATHER_PLANES) {
    int4 a[GATHER_PLANES], b[GATHER_PLANES];
#pragma unroll
    for (int c = 0; c < GATHER_PLANES; ++c) {
      if (p0 + c >= planes) continue;
      const int4* s4 = reinterpret_cast<const int4*>(src + (size_t)(p0 + c) * n + base + u0);
      a[c] = s4[0];
      b[c] = s4[1];
    }
#pragma unroll
    for (int c = 0; c < GATHER_PLANES; ++c) {
      if (p0 + c >= planes) continue;
      int4* c4 = reinterpret_cast<int4*>(cols + c * tile + u0);
      c4[0] = a[c];
      c4[1] = b[c];
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < GATHER_PLANES; ++c) {
      if (p0 + c >= planes) continue;
#pragma unroll
      for (int m = 0; m < WORDS; ++m) out[m] = cols[c * tile + from[m]];
      int4* d4 = reinterpret_cast<int4*>(dst + (size_t)(p0 + c) * n + base + u0);
      d4[0] = make_int4(out[0], out[1], out[2], out[3]);
      d4[1] = make_int4(out[4], out[5], out[6], out[7]);
    }
    __syncthreads();  // the next round overwrites cols
  }
}

inline int log2_of(long long x) {
  int l = 0;
  while ((1LL << l) < x) ++l;
  return l;
}

inline bool pow2(long long x) { return x >= 1 && (x & (x - 1)) == 0; }

// The plan of net_local for the substages (ks[i], js[i]), i < count
// (accel/bitonic_net.py `plan_local` makes the same one): the tile is
// 2^bits elements, bits = max(MIN_TILE_BITS, log2 of twice the largest
// j), with bits - MIN_TILE_BITS warp bits. From substage i, a layout takes
// as warp bits those whose next use is furthest ahead (the higher bit on a
// tie); it serves until a warp bit's next use. Its register bits are the
// three other bits used most in that run (the lower bit on a tie), its
// lane bits the rest; each group in ascending order.
inline cudaError_t plan_local(const long long* js, const long long* ks, long long count,
                              LocalPlan* plan) {
  if (count < 0 || count > MAX_LIST) return cudaErrorInvalidValue;
  int lj[MAX_LIST];
  int bits = MIN_TILE_BITS;
  for (long long i = 0; i < count; ++i) {
    if (!pow2(js[i]) || js[i] >= TILE || !pow2(ks[i]) || ks[i] > (1LL << 30))
      return cudaErrorInvalidValue;
    lj[i] = log2_of(js[i]);
    if (lj[i] + 1 > bits) bits = lj[i] + 1;
  }
  plan->count = (int)count;
  plan->bits = bits;
  const int n_warp = bits - MIN_TILE_BITS;
  int layouts = 0;
  int i = 0;
  do {
    int next[MAX_TILE_BITS];
    for (int b = 0; b < bits; ++b) next[b] = (int)count;
    for (int s = (int)count - 1; s >= i; --s) next[lj[s]] = s;
    bool warp[MAX_TILE_BITS] = {}, reg[MAX_TILE_BITS] = {};
    int end = (int)count;
    for (int w = 0; w < n_warp; ++w) {
      int pick = -1;
      for (int b = bits - 1; b >= 0; --b)
        if (!warp[b] && (pick < 0 || next[b] > next[pick])) pick = b;
      warp[pick] = true;
      if (next[pick] < end) end = next[pick];
    }
    int uses[MAX_TILE_BITS] = {};
    for (int s = i; s < end; ++s) ++uses[lj[s]];
    for (int r = 0; r < REG_BITS; ++r) {
      int pick = -1;
      for (int b = 0; b < bits; ++b)
        if (!warp[b] && !reg[b] && (pick < 0 || uses[b] > uses[pick])) pick = b;
      reg[pick] = true;
    }
    uint64_t layout = 0;
    int op_of[MAX_TILE_BITS], f = 0, lane_f = 0;
    for (int b = 0; b < bits; ++b)
      if (reg[b]) op_of[b] = f, layout |= (uint64_t)b << (4 * f++);
    for (int b = 0; b < bits; ++b)
      if (!reg[b] && !warp[b]) op_of[b] = LANE_OP + lane_f++, layout |= (uint64_t)b << (4 * f++);
    for (int b = 0; b < bits; ++b)
      if (warp[b]) layout |= (uint64_t)b << (4 * f++);
    plan->layout[layouts++] = layout;
    for (int s = i; s < end; ++s)
      plan->code[s] = (uint16_t)(lj[s] | log2_of(ks[s]) << LK_SHIFT | op_of[lj[s]] << OP_SHIFT |
                                 (s == i ? NEW_LAYOUT : 0));
    i = end;
  } while (i < count);
  for (int s = 0; s < count;) {  // runs of equal codes (a NEW_LAYOUT code starts one)
    int e = s + 1;
    while (e < count && plan->code[e] == plan->code[s]) ++e;
    plan->run[s] = (uint16_t)(e - s);
    s = e;
  }
  return cudaSuccess;
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

typedef void (*StackedFn)(const int32_t*, int32_t*, uint32_t, int, int, uint32_t, uint32_t);
typedef void (*PlaneFn)(const int32_t*, int32_t*, uint32_t, uint32_t, uint32_t);

// A [planes][n] state that the 16-byte accesses take: n = 2^m in
// [TILE, 2^30] and both bases 16-byte aligned.
inline bool state_ok(const int32_t* src, const int32_t* dst, long long planes, long long n) {
  return planes >= 1 && pow2(n) && n >= TILE && n <= (1LL << 30) &&
         ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
}

}  // namespace

extern "C" {

// One substage (k, j) of a [planes][n] int32 state, src -> dst (dst may be
// src unless per_plane; both 16-byte aligned). mode 0: j and k run-time;
// 1: j a template constant (j <= 2^16), k run-time; 2: both constants
// ((k, j) = (32, 16) or (1024, 512)). guards 4 or 16: the guarded static
// (32, 16) body, stacked, with lj the value the guards test. Returns a
// cudaError_t.
int henjou_net_substage(const int32_t* src, int32_t* dst, long long planes,
                        long long n, long long j, long long k,
                        long long per_plane, long long mode, long long guards,
                        long long lj, void* stream) {
  if (!state_ok(src, dst, planes, n) || !pow2(j) || j >= n || !pow2(k) || k > n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t n32 = (uint32_t)n;
  const unsigned blocks = blocks_for(n / OWN, SUB_THREADS);
  // stacked: CHUNK-plane groups over blockIdx.y where dst is not src
  const int span = src == dst ? (int)((planes + CHUNK - 1) / CHUNK * CHUNK) : CHUNK;
  const dim3 grid(blocks, (unsigned)((planes + span - 1) / span));
  if (guards != 0) {
    if (guards == 4)
      substage_guarded<4><<<grid, SUB_THREADS, 0, s>>>(src, dst, n32, (int)planes, span, lj);
    else if (guards == 16)
      substage_guarded<16><<<grid, SUB_THREADS, 0, s>>>(src, dst, n32, (int)planes, span, lj);
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
#define HJ_STATIC_J_CASE(L)                  \
  case L:                                    \
    fs = substage_stacked<(1u << L), 0>;     \
    fp = substage_per_plane<(1u << L), 0>;   \
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
  if (per_plane) {
    if (src == dst || planes > 65535) return (int)cudaErrorInvalidValue;
    fp<<<dim3(blocks, (unsigned)planes), SUB_THREADS, 0, s>>>(src, dst, n32, (uint32_t)j,
                                                               (uint32_t)k);
  } else {
    fs<<<grid, SUB_THREADS, 0, s>>>(src, dst, n32, (int)planes, span, (uint32_t)j, (uint32_t)k);
  }
  return (int)cudaGetLastError();
}

// The substages (ks[i], js[i]), i < count <= MAX_LIST, all with j < TILE,
// on each tile of the plan (`plan_local`); dst may be src (tiles are
// disjoint, and a block reads its whole tile before it writes).
int henjou_net_local(const int32_t* src, int32_t* dst, long long planes,
                     long long n, const long long* js, const long long* ks,
                     long long count, void* stream) {
  if (!state_ok(src, dst, planes, n)) return (int)cudaErrorInvalidValue;
  LocalPlan plan;
  const cudaError_t err = plan_local(js, ks, count, &plan);
  if (err != cudaSuccess) return (int)err;
  for (long long i = 0; i < count; ++i)
    if (ks[i] > n) return (int)cudaErrorInvalidValue;
  const uint32_t tile = 1u << plan.bits;
  const size_t smem = (size_t)tile * (2 * sizeof(word_t) + GATHER_PLANES * sizeof(int32_t));
  local_list<<<(unsigned)(n / tile), tile / WORDS, smem, static_cast<cudaStream_t>(stream)>>>(
      src, dst, (uint32_t)n, (int)planes, plan);
  return (int)cudaGetLastError();
}

// The plan `henjou_net_local` makes for (js, ks): codes[count] (see
// LocalPlan), layouts[max(count, 1)], info[0] the tile's log2 and info[1]
// the number of layouts. For the tests, which hold it to the Python plan.
int henjou_net_local_plan(const long long* js, const long long* ks, long long count,
                          long long* codes, long long* layouts, long long* info) {
  LocalPlan plan;
  const cudaError_t err = plan_local(js, ks, count, &plan);
  if (err != cudaSuccess) return (int)err;
  int n_layouts = 0;
  for (long long i = 0; i < count; ++i) {
    codes[i] = plan.code[i];
    if (plan.code[i] & NEW_LAYOUT) ++n_layouts;
  }
  if (count == 0) n_layouts = 1;
  for (int l = 0; l < n_layouts; ++l) layouts[l] = (long long)plan.layout[l];
  info[0] = plan.bits;
  info[1] = n_layouts;
  return 0;
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
