// Per-view plane-sweep bilinear gather and its exact transpose, CUDA for
// Hopper (sm_90a).
//
// Replaces the two TPU kernels of satmvs_tpu/ops/pallas/sweep_gather.py:
//   sweep_gather_kernel   `_sweep_gather_kernel` (:315; `_sweep_gather_impl_hcw`
//                         :400, pallas_call :436), the training sweep of
//                         ops/warp.rpc_warp;
//   sweep_scatter_kernel  `_sweep_scatter_kernel` (:475; `_sweep_scatter_impl_hcw`
//                         :558, pallas_call :576), its adjoint in the custom
//                         VJP of `sweep_gather` (:636-681).
//
// For src (H, W, C) and sample coordinates xs, ys (D, H, W):
//
//   gather   out[d, i, j, :] = bilinear sample of src at (xs[d, i, j], ys[d, i, j])
//   scatter  dsrc[y, x, :]   = Σ over (d, i, j) and the corners (y, x) of that
//                              sample of (corner weight) · g[d, i, j, :]
//
// with the taps of bilinear.cuh (ops/sampling.bilinear_sample's zero-padding
// contract), so the scatter is the exact transpose of the gather:
// <g, gather(src)> = <scatter(g), src>.  The TPU kernels warp with a stencil
// of shifts inside a DMA'd row window and drop taps outside it (their
// `count_misses` contract); Hopper has a fast gather, so these equal
// bilinear_sample and its transpose everywhere, misses included.
//
// What bounds them: memory.  Each gathered float costs ~8 flops, far below
// the H100's ~20 flops/byte fp32 balance point.  The least traffic of a
// gather is the output written once and the coordinates and the source read
// once; of a scatter, g and the coordinates read once and dsrc written once.
// At the full-width training patch (384×768, ndepths 64/32/8, C 32/16/8) that
// is 162.8, 174.6 and 103.8 MB per view and stage, ~0.26 ms per step for two
// views at 3.35 TB/s, and about the same for the scatter.
//
// Design (simple first).  One thread owns one output pixel (d, i, j) and a
// run of VEC contiguous channels (VEC = 4 when C and the pointers allow
// float4), so a warp reads or writes contiguous channels-last rows.
//   gather:  it loads the two coordinates once, computes the four corners and
//            weights, and writes its channels once.
//   scatter: it reads its channels of g once and adds the four tap-weighted
//            values into dsrc with atomicAdd (dsrc zeroed by the caller; the
//            atomics resolve in L2, and dsrc, ≤ 9.4 MB here, stays there).
// The order of the atomic additions changes from run to run, so the scatter
// is not bitwise reproducible: each dsrc element is a sum of at most 4·D
// products, and two summation orders differ by at most 2·(4·D − 1)·2⁻²⁴ times
// the sum of the magnitudes of its terms; the callers' tolerances follow
// from that bound.  A deterministic form (per-plane partials reduced in
// order) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"

namespace {

template <int VEC>
__global__ void __launch_bounds__(256) sweep_gather_kernel(
    const float* __restrict__ src, const float* __restrict__ xs,
    const float* __restrict__ ys, float* __restrict__ out, int D, int H, int W, int C) {
  const int groups = C / VEC;
  const int64_t total = (int64_t)D * H * W * groups;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c0 = (int)(t % groups) * VEC;
  const int64_t pix = t / groups;  // d·H·W + i·W + j
  const bilinear::Taps taps(__ldg(xs + pix), __ldg(ys + pix), H, W);
  float o[VEC];
  bilinear::sample<VEC>(src + c0, taps, H, W, C, o);
  bilinear::store_vec<VEC>(out + pix * C + c0, o);
}

template <int VEC>
__global__ void __launch_bounds__(256) sweep_scatter_kernel(
    const float* __restrict__ g, const float* __restrict__ xs,
    const float* __restrict__ ys, float* __restrict__ dsrc, int D, int H, int W, int C) {
  const int groups = C / VEC;
  const int64_t total = (int64_t)D * H * W * groups;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int c0 = (int)(t % groups) * VEC;
  const int64_t pix = t / groups;
  const bilinear::Taps taps(__ldg(xs + pix), __ldg(ys + pix), H, W);
  float v[VEC];
  bilinear::load_vec<VEC>(g + pix * C + c0, v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t q = taps.pixel(k, H, W);
    if (q < 0) continue;
    float* dst = dsrc + q * C + c0;
#pragma unroll
    for (int i = 0; i < VEC; ++i) atomicAdd(dst + i, taps.w[k] * v[i]);
  }
}

constexpr int kThreads = 256;

// Blocks of kThreads for one thread per (pixel, vec channels): 0 when there
// is no work, −1 when the arguments are invalid.
int64_t grid_blocks(int D, int H, int W, int C, int vec) {
  if ((vec != 1 && vec != 4) || C % vec != 0) return -1;
  const int64_t blocks = ((int64_t)D * H * W * (C / vec) + kThreads - 1) / kThreads;
  return blocks > 0x7fffffff ? -1 : blocks;
}

}  // namespace

// out (D, H, W, C) = bilinear samples of src (H, W, C) at xs, ys (D, H, W).
// Launches on `stream`; vec is 4 (C % 4 == 0, all pointers 16-byte aligned)
// or 1.  Returns cudaGetLastError() (0 = launched).
extern "C" int sweep_gather_f32(const float* src, const float* xs, const float* ys, float* out,
                                int D, int H, int W, int C, int vec, void* stream) {
  const int64_t blocks = grid_blocks(D, H, W, C, vec);
  if (blocks <= 0) return blocks < 0 ? (int)cudaErrorInvalidValue : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    sweep_gather_kernel<4><<<(unsigned)blocks, kThreads, 0, st>>>(src, xs, ys, out, D, H, W, C);
  } else {
    sweep_gather_kernel<1><<<(unsigned)blocks, kThreads, 0, st>>>(src, xs, ys, out, D, H, W, C);
  }
  return (int)cudaGetLastError();
}

// dsrc (H, W, C) += the transpose of the gather applied to g (D, H, W, C);
// the caller zeroes dsrc.  Same launch contract.
extern "C" int sweep_scatter_f32(const float* g, const float* xs, const float* ys, float* dsrc,
                                 int D, int H, int W, int C, int vec, void* stream) {
  const int64_t blocks = grid_blocks(D, H, W, C, vec);
  if (blocks <= 0) return blocks < 0 ? (int)cudaErrorInvalidValue : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    sweep_scatter_kernel<4><<<(unsigned)blocks, kThreads, 0, st>>>(g, xs, ys, dsrc, D, H, W, C);
  } else {
    sweep_scatter_kernel<1><<<(unsigned)blocks, kThreads, 0, st>>>(g, xs, ys, dsrc, D, H, W, C);
  }
  return (int)cudaGetLastError();
}
