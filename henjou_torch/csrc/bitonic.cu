// Payload-carrying ray sort for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_sort_kernel` in
// henjou_tpu/accel/bitonic.py (launched by `bitonic_sort`), which walks a
// bitonic network over [planes, n/128, 128] VMEM tiles with lane/sublane
// rolls, carrying every payload plane through each exchange.
//
// Here the sort is one cooperative launch of the keyed network engine
// (keyed_network.cuh) over 8-byte (key, source) words compared whole:
// the words are distinct, so equal keys keep their input order and the
// result is the stable ascending sort that the plain PyTorch version
// (torch.argsort(stable=True) plus indexing) computes, bit for bit. The
// network ends by gathering up to 16 payload columns through the sources,
// so the planes move once and never ride the network; more columns take
// one more gather launch. At the renderer's 65,536 rays and the engine's
// 1024-word tile the launch holds 16 passes: 7 in shared memory (115
// substages in 43 register groups) and 9 global ones (21 substages), with
// a grid barrier after each. Bytes do not bound it (1 MB of words per
// global pass, each column moved once): the latency of the groups and
// barriers does. The schedule of a sort has k > j throughout, so each pair
// swaps as one (keyed_network.cuh `settle_pair`).
//
// The inverse sort (restoring lane order after a trace) needs no network:
// the lane ids are a permutation of 0..n-1, so one scatter kernel writes
// dst[lid[i]] = src[i] for every column.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keyed_network.cuh"

namespace {

// dst[c][lid[i]] = src[c][i]; lid must be a permutation of 0..n-1.
__global__ void scatter_columns(henjou::Columns cols, const int32_t* __restrict__ lid, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long d = lid[i];
  for (int c = 0; c < cols.count; ++c)
    cols.dst[c][d * cols.stride[c]] = cols.src[c][i * cols.stride[c]];
}

}  // namespace

extern "C" {

// Stable ascending sort of key_in[n] (n = 2^m, 1024 <= n <= 2^30) into
// key_out, carrying the payload columns of desc (n_cols triples of src
// pointer, dst pointer and stride) through the same permutation. codes:
// the substage list's plan (keyed_network.cuh `Plan`). words: n 8-byte words of scratch; idx: n int32 of scratch, needed
// only for more than 16 columns. Returns a cudaError_t.
int henjou_bitonic_sort(const int32_t* key_in, int32_t* key_out, henjou::word_t* words,
                        int32_t* idx, const long long* desc, long long n_cols, long long n,
                        const long long* codes, long long count, void* stream) {
  using namespace henjou;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_cols > MAX_COLS && idx == nullptr) return (int)cudaErrorInvalidValue;
  Emit e{};
  e.key = key_out;
  e.idx = n_cols > MAX_COLS ? idx : nullptr;
  e.cols = columns_of(desc, 0, n_cols < MAX_COLS ? n_cols : MAX_COLS);
  const cudaError_t err = launch_network<true, false>(key_in, words, n, codes, count, e, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_columns(gather_columns, desc, MAX_COLS, n_cols, idx, n, s);
}

int henjou_scatter_columns(const long long* desc, long long n_cols, const int32_t* lid,
                           long long n, void* stream) {
  return (int)henjou::launch_columns(scatter_columns, desc, 0, n_cols, lid, n,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
