// The BSDF dispatch in one launch per call, for Hopper (sm_90a):
// `bsdf_sample`, `bsdf_eval` and `bsdf_pdf` of bsdf/dispatch.py.
//
// Replaces no Pallas TPU kernel: the JAX package's BSDFs
// (henjou_tpu/bsdf/) are plain jnp code that XLA fuses. Their torch port
// computes every lobe on every lane and then selects by material, so one
// `bsdf_sample` ran the six-step multiple-scattering GGX walk for every
// lane, metal or not: some 1,500 tensor ops a call, each a launch, which
// the host issued one by one while the card idled (the shade stage held
// most of a bounce's launches). Here one thread takes one lane and runs
// only its own lobe (meta-glass when `is_specular`, else the walk when
// `metallic > 0.5`, else Disney), with the lane's CMJ or Sobol draws
// inside (cmj.cuh), so each lane's dimension counter advances by exactly
// the draws its lobe takes, as the torch code's per-lane selection of the
// advanced state gives.
//
// Inputs are the hit's fields as contiguous tensors of one lane shape:
// basecolor [n, 3], roughness, metallic, sheen, clearcoat, ior [n] f32,
// is_thinfilm, is_specular [n] bool (one byte), the shading-space
// directions [n, 3] f32, and the CMJ state's four int64 fields. `flags`
// holds the dispatch's scene facts (bsdf.cuh kHas*) and the state's Sobol
// choice; `lut` is the [h, w, 3] thin-film table or null. The sample writes bsdf, wi [n, 3], pdf [n] and
// the new dimension counter (depth + draws) mod 2^32; the state is not
// written.
//
// Equal to the plain PyTorch version (`sample_plain`, `eval_plain`,
// `pdf_plain` in bsdf/dispatch.py) on the same CUDA inputs to the bit: the
// same operations in the same order (bsdf.cuh), built with --fmad=false.
//
// What bounds it: neither bytes nor operations. A sample moves 114 bytes
// a lane (78 in, 36 out): 131,072 lanes move 15 MB, 4.5 us at 3.35 TB/s;
// the walk's six steps are a few thousand flops a lane at most. The launch
// and the host's wrapper bound a call, so the design is one launch where
// there were some 1,500, in blocks of 128 threads so that the lobes'
// register demand (the walk, Disney and the draw's hashes in one body)
// needs no spill.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bsdf.cuh"
#include "common.cuh"

namespace {

using henjou::bsdf::Lut;
using henjou::bsdf::Material;
using henjou::bsdf::Sample;
using henjou::bsdf::Sampler;
using henjou::bsdf::V3;

constexpr int kThreads = 128;

struct Hit {
  const float* basecolor;
  const float* roughness;
  const float* metallic;
  const float* sheen;
  const float* clearcoat;
  const uint8_t* is_thinfilm;
  const uint8_t* is_specular;
  const float* ior;  // the sample's only
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, long long lane) {
  return {p[lane * 3], p[lane * 3 + 1], p[lane * 3 + 2]};
}

__device__ __forceinline__ void store3(float* __restrict__ p, long long lane, V3 v) {
  p[lane * 3] = v.x;
  p[lane * 3 + 1] = v.y;
  p[lane * 3 + 2] = v.z;
}

__device__ __forceinline__ Material load_material(const Hit& h, long long lane) {
  Material m;
  m.basecolor = load3(h.basecolor, lane);
  m.roughness = h.roughness[lane];
  m.metallic = h.metallic[lane];
  m.sheen = h.sheen[lane];
  m.clearcoat = h.clearcoat[lane];
  m.ior = h.ior != nullptr ? h.ior[lane] : 0.0f;
  m.thinfilm = h.is_thinfilm[lane] != 0;
  m.specular = h.is_specular[lane] != 0;
  return m;
}

__global__ void __launch_bounds__(kThreads)
    bsdf_sample_kernel(Hit hit, const float* __restrict__ wo,
                       const int64_t* __restrict__ n_spp, const int64_t* __restrict__ scramble,
                       const int64_t* __restrict__ depth, const int64_t* __restrict__ image_idx,
                       long long n, long long flags, Lut lut, float* __restrict__ bsdf,
                       float* __restrict__ wi, float* __restrict__ pdf,
                       int64_t* __restrict__ depth_out) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  // the state's fields hold u32 values: the low 32 bits are the value
  Sampler s{(uint32_t)n_spp[lane], (uint32_t)image_idx[lane], (uint32_t)depth[lane],
            (uint32_t)scramble[lane], (flags & henjou::bsdf::kSobol) != 0};
  const Material m = load_material(hit, lane);
  const Sample out = henjou::bsdf::bsdf_sample(m, load3(wo, lane), s, lut, flags);
  store3(bsdf, lane, out.bsdf);
  store3(wi, lane, out.wi);
  pdf[lane] = out.pdf;
  depth_out[lane] = (int64_t)s.depth;
}

__global__ void __launch_bounds__(kThreads)
    bsdf_eval_kernel(Hit hit, const float* __restrict__ wo, const float* __restrict__ wi,
                     long long n, long long flags, Lut lut, float* __restrict__ out) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const Material m = load_material(hit, lane);
  store3(out, lane, henjou::bsdf::bsdf_eval(m, load3(wo, lane), load3(wi, lane), lut, flags));
}

__global__ void __launch_bounds__(kThreads)
    bsdf_pdf_kernel(const float* __restrict__ roughness, const float* __restrict__ metallic,
                    const uint8_t* __restrict__ is_specular, const float* __restrict__ wo,
                    const float* __restrict__ wi, long long n, float* __restrict__ out) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  out[lane] = henjou::bsdf::bsdf_pdf(roughness[lane], metallic[lane], is_specular[lane] != 0,
                                     load3(wo, lane), load3(wi, lane));
}

}  // namespace

// `bsdf_sample` of `n` lanes; n = 0 launches nothing.
extern "C" int henjou_bsdf_sample(const float* basecolor, const float* roughness,
                                  const float* metallic, const float* sheen,
                                  const float* clearcoat, const uint8_t* is_thinfilm,
                                  const uint8_t* is_specular, const float* ior,
                                  const float* wo, const int64_t* n_spp,
                                  const int64_t* scramble, const int64_t* depth,
                                  const int64_t* image_idx, long long n, long long flags,
                                  const float* lut, long long lut_h, long long lut_w,
                                  float* bsdf, float* wi, float* pdf, int64_t* depth_out,
                                  void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const Hit hit{basecolor, roughness, metallic, sheen, clearcoat, is_thinfilm, is_specular, ior};
  bsdf_sample_kernel<<<henjou::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      hit, wo, n_spp, scramble, depth, image_idx, n, flags, Lut{lut, lut_h, lut_w}, bsdf,
      wi, pdf, depth_out);
  return (int)cudaGetLastError();
}

// `bsdf_eval` of `n` lanes into out [n, 3]; n = 0 launches nothing.
extern "C" int henjou_bsdf_eval(const float* basecolor, const float* roughness,
                                const float* metallic, const float* sheen,
                                const float* clearcoat, const uint8_t* is_thinfilm,
                                const uint8_t* is_specular, const float* wo, const float* wi,
                                long long n, long long flags, const float* lut,
                                long long lut_h, long long lut_w, float* out, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  const Hit hit{basecolor, roughness, metallic, sheen, clearcoat, is_thinfilm, is_specular,
                nullptr};
  bsdf_eval_kernel<<<henjou::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      hit, wo, wi, n, flags, Lut{lut, lut_h, lut_w}, out);
  return (int)cudaGetLastError();
}

// `bsdf_pdf` of `n` lanes into out [n]; n = 0 launches nothing.
extern "C" int henjou_bsdf_pdf(const float* roughness, const float* metallic,
                               const uint8_t* is_specular, const float* wo, const float* wi,
                               long long n, float* out, void* stream) {
  if (n == 0) return (int)cudaSuccess;
  bsdf_pdf_kernel<<<henjou::blocks_for(n, kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      roughness, metallic, is_specular, wo, wi, n, out);
  return (int)cudaGetLastError();
}
