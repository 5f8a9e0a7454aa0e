// Fused plane-sweep variance cost volume, CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel of satmvs_tpu/ops/pallas/sweep_variance.py:
// `_sweep_variance_impl_hcw` (:130, its pallas_call at :161) and
// `_sweep_variance_kernel` (:35), public `sweep_variance` (:199).
//
// For ref (H, W, C), srcs (S, H, W, C) and sample coordinates xs, ys
// (S, D, H, W) it writes, with V = S + 1,
//
//   out[d, y, x, :] = (Σ_s w_s² + ref²)/V − ((Σ_s w_s + ref)/V)²   (D, H, W, C)
//   w_s = bilinear sample of srcs[s] at (xs[s, d, y, x], ys[s, d, y, x])
//
// with the zero-padding, per-corner-validity contract of
// ops/sampling.bilinear_sample.  The per-view warped volumes are never
// stored.
//
// What bounds it: memory.  It does ~10 flops per gathered float, far below
// the H100's ~20 flops/byte fp32 balance point.  The least traffic is the
// output volume written once, the coordinates read once and the features
// read once: at the cascade's stage shapes (S = 2) 177, 203 and 142 MB,
// i.e. ~53, ~60 and ~42 µs at 3.35 TB/s.
//
// Design (simple first): the TPU kernel's stencil of shifted windows, tile
// bases, padding and D-chunking exist because the TPU has no fast gather;
// Hopper does, so this is a direct gather and equals bilinear_sample
// everywhere.  One thread owns one output pixel (d, y, x) and a run of VEC
// contiguous channels (VEC = 4 when C and the pointers allow float4), loops
// over the S views and writes its channels once.  Threads of one pixel sit
// side by side, so a warp writes contiguous output and each gathered corner
// is one contiguous read of C floats (features are channels-last).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"

namespace {

using bilinear::load_vec;
using bilinear::store_vec;

template <int VEC>
__global__ void __launch_bounds__(256) sweep_variance_kernel(
    const float* __restrict__ ref, const float* __restrict__ srcs,
    const float* __restrict__ xs, const float* __restrict__ ys,
    float* __restrict__ out, int S, int D, int H, int W, int C) {
  const int groups = C / VEC;
  const int64_t hw = (int64_t)H * W;
  const int64_t total = (int64_t)D * hw * groups;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c0 = (int)(t % groups) * VEC;
  const int64_t pix = t / groups;  // d·H·W + y·W + x
  const int64_t p = pix % hw;      // y·W + x
  const int64_t d = pix / hw;

  float sum[VEC], sq[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) { sum[i] = 0.f; sq[i] = 0.f; }

  for (int s = 0; s < S; ++s) {
    const int64_t ci = ((int64_t)s * D + d) * hw + p;
    const bilinear::Taps taps(__ldg(xs + ci), __ldg(ys + ci), H, W);
    float w[VEC];
    bilinear::sample<VEC>(srcs + (int64_t)s * hw * C + c0, taps, H, W, C, w);
#pragma unroll
    for (int i = 0; i < VEC; ++i) { sum[i] += w[i]; sq[i] += w[i] * w[i]; }
  }

  float r[VEC];
  load_vec<VEC>(ref + p * C + c0, r);
  const float v = (float)(S + 1);
  float o[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float mean = (sum[i] + r[i]) / v;
    o[i] = (sq[i] + r[i] * r[i]) / v - mean * mean;
  }
  store_vec<VEC>(out + pix * C + c0, o);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// vec must be 4 (C % 4 == 0, all pointers 16-byte aligned) or 1.
extern "C" int sweep_variance_f32(const float* ref, const float* srcs, const float* xs,
                                  const float* ys, float* out, int S, int D, int H, int W,
                                  int C, int vec, void* stream) {
  if ((vec != 1 && vec != 4) || C % vec != 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)D * H * W * (C / vec);
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    sweep_variance_kernel<4><<<(unsigned)blocks, threads, 0, st>>>(ref, srcs, xs, ys, out,
                                                                   S, D, H, W, C);
  } else {
    sweep_variance_kernel<1><<<(unsigned)blocks, threads, 0, st>>>(ref, srcs, xs, ys, out,
                                                                   S, D, H, W, C);
  }
  return (int)cudaGetLastError();
}
