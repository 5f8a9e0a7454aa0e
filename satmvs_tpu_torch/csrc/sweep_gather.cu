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
// For src (Hs, W, C) and sample coordinates xs, ys (D, H, W) (H = Hs, or a
// band of reference rows under height sharding):
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
// Design.  Both kernels take the pixel from the grid (x: j and the channel
// group, y: i, z: a chunk of P consecutive planes), so there is no int64
// division, and give a thread one (i, j, group of VEC contiguous channels)
// (VEC = 4 when C and the pointers allow float4), the threads of one pixel
// side by side, so a warp reads and writes contiguous channels-last rows;
// each thread walks its chunk of planes.  The gather takes them two at a
// time: both planes' coordinates, both taps, then both samples' corner loads
// before either store, so eight loads are in flight instead of four.  Its
// output is written once and never read here, so it goes out with streaming
// stores (__stcs, evict-first) and the source (≤ 9.4 MB here) keeps its
// place in L2 for the corners.  Neighbouring planes of a sweep often share
// their floor corner, so the scatter sums each corner's tap-weighted values
// in registers while the corner stays and adds them into dsrc (zeroed by the
// caller) when it moves: one float4 atomic per corner (sm_90's vector
// atomicAdd) instead of four scalar ones, and one per run of planes instead
// of one per plane.  The atomics resolve in L2, and dsrc (≤ 9.4 MB here)
// stays there.  The order of the atomic additions changes from run to
// run, so the scatter is not bitwise reproducible: each dsrc element is a
// sum of at most 4·D products (each rounded as the plain version rounds
// it, `__fmul_rn`, then summed in some order), and two summation orders
// differ by at most 2·(4·D − 1)·2⁻²⁴ times the sum of the magnitudes of its
// terms; the callers' tolerances follow from that bound.  The build gives
// the scatter 34 (scalar) and 48 (float4) registers, no spills.
//
// bfloat16 volume transport (JAX's `sweep_gather(..., out_dtype=bfloat16)`,
// the same pallas_call :436 traced with a bf16 output, and its VJP's read of
// bf16 cotangents, :666-681): each kernel is templated on the volume's
// type.  sweep_gather_bf16 sums the taps in float and rounds each value
// once, at the store, to nearest even (Tensor.to(torch.bfloat16));
// sweep_scatter_bf16 widens each bf16 cotangent exactly at the read and
// sums in float into a float dsrc.  The volume's bytes halve: at the train
// shapes the gather's least traffic falls from 162.8, 174.6 and 103.8 MB a
// view and stage to 87.3, 99.1 and 66.0 MB.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"

namespace {

using bilinear::store_streaming;

// Thread (i, j, channel group) of grid (W·groups / 256, H, plane chunks)
// samples planes [z·P, z·P + P) of its pixel, two at a time.  The pixel and
// channel come from the grid, one 32-bit division per thread.
template <int VEC, typename Out>
__global__ void __launch_bounds__(256) sweep_gather_kernel(
    const float* __restrict__ src, const float* __restrict__ xs,
    const float* __restrict__ ys, Out* __restrict__ out, int D, int H, int W, int C, int P,
    int Hs) {
  const int groups = C / VEC;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W * groups) return;
  const int j = t / groups;
  const int c0 = (t - j * groups) * VEC;
  const int d0 = blockIdx.z * P;
  const int d1 = d0 + P < D ? d0 + P : D;
  const int64_t plane = (int64_t)H * W;
  int64_t pix = d0 * plane + (int64_t)blockIdx.y * W + j;
  int d = d0;
  for (; d + 1 < d1; d += 2, pix += 2 * plane) {
    const bilinear::Taps t0(__ldg(xs + pix), __ldg(ys + pix), Hs, W);
    const bilinear::Taps t1(__ldg(xs + pix + plane), __ldg(ys + pix + plane), Hs, W);
    float o0[VEC], o1[VEC];
    bilinear::sample<VEC>(src + c0, t0, Hs, W, C, o0);
    bilinear::sample<VEC>(src + c0, t1, Hs, W, C, o1);
    store_streaming<VEC>(out + pix * C + c0, o0);
    store_streaming<VEC>(out + (pix + plane) * C + c0, o1);
  }
  if (d < d1) {
    const bilinear::Taps t0(__ldg(xs + pix), __ldg(ys + pix), Hs, W);
    float o0[VEC];
    bilinear::sample<VEC>(src + c0, t0, Hs, W, C, o0);
    store_streaming<VEC>(out + pix * C + c0, o0);
  }
}

// Adds acc[k] into the dsrc pixel of corner k of the taps at (cx, cy) when
// it lies in the image, then zeroes acc: one float4 atomic (sm_90's
// red.global.add.v4.f32) per corner with VEC = 4, else VEC scalar ones.
template <int VEC>
__device__ __forceinline__ void flush_corners(float* __restrict__ dsrc, int cx, int cy, int H,
                                              int W, int C, int c0, float (&acc)[4][VEC]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = cx + (k & 1), y = cy + (k >> 1);
    if (x >= 0 && x < W && y >= 0 && y < H) {
      float* dst = dsrc + ((int64_t)y * W + x) * C + c0;
      if constexpr (VEC == 4) {
        atomicAdd(reinterpret_cast<float4*>(dst), make_float4(acc[k][0], acc[k][1], acc[k][2],
                                                              acc[k][3]));
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) atomicAdd(dst + i, acc[k][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[k][i] = 0.f;
  }
}

// Thread (i, j, channel group) of grid (W·groups / 256, H, plane chunks)
// walks planes [z·P, z·P + P) of its pixel in order.  While consecutive
// planes share their floor corner (x0, y0), it sums the tap-weighted
// values of each corner in registers; when the corner moves, and at the
// end, it adds the four sums into dsrc.  The pixel and channel come from
// the grid, one 32-bit division per thread.
template <int VEC, typename In>
__global__ void __launch_bounds__(256) sweep_scatter_kernel(
    const In* __restrict__ g, const float* __restrict__ xs,
    const float* __restrict__ ys, float* __restrict__ dsrc, int D, int H, int W, int C, int P,
    int Hs) {
  const int groups = C / VEC;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W * groups) return;
  const int j = t / groups;
  const int c0 = (t - j * groups) * VEC;
  const int d0 = blockIdx.z * P;
  const int d1 = d0 + P < D ? d0 + P : D;
  const int64_t plane = (int64_t)H * W;
  int64_t pix = d0 * plane + (int64_t)blockIdx.y * W + j;
  float acc[4][VEC];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[k][i] = 0.f;
  int cx = 0, cy = 0;
  bool open = false;
  for (int d = d0; d < d1; ++d, pix += plane) {
    const bilinear::Taps taps(__ldg(xs + pix), __ldg(ys + pix), Hs, W);
    if (open && (taps.x0 != cx || taps.y0 != cy))
      flush_corners<VEC>(dsrc, cx, cy, Hs, W, C, c0, acc);
    cx = taps.x0;
    cy = taps.y0;
    open = true;
    float v[VEC];
    bilinear::load_vec<VEC>(g + pix * C + c0, v);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[k][i] += __fmul_rn(taps.w[k], v[i]);
  }
  if (open) flush_corners<VEC>(dsrc, cx, cy, Hs, W, C, c0, acc);
}

constexpr int kThreads = 256;

// The grid of both kernels, (W·groups / kThreads, H, chunks of `planes`
// planes); false when the arguments are invalid.  A grid without blocks
// means there is no work.
bool sweep_grid(int D, int H, int W, int C, int vec, int planes, int Hs, dim3& grid) {
  if ((vec != 1 && vec != 4) || C % vec != 0 || planes < 1 || D < 0 || H < 0 || W < 0 ||
      H > 65535 || Hs < 0)
    return false;
  const int64_t row_threads = (int64_t)W * (C / vec);
  const int64_t chunks = ((int64_t)D + planes - 1) / planes;
  if (row_threads > 0x7fffffff || chunks > 65535) return false;
  grid = dim3((unsigned)((row_threads + kThreads - 1) / kThreads), (unsigned)H, (unsigned)chunks);
  return true;
}

template <typename Out>
int gather(const float* src, const float* xs, const float* ys, Out* out, int D, int H, int W,
           int C, int vec, int planes, int Hs, void* stream) {
  dim3 grid;
  if (!sweep_grid(D, H, W, C, vec, planes, Hs, grid)) return (int)cudaErrorInvalidValue;
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    sweep_gather_kernel<4, Out><<<grid, kThreads, 0, st>>>(src, xs, ys, out, D, H, W, C, planes,
                                                           Hs);
  } else {
    sweep_gather_kernel<1, Out><<<grid, kThreads, 0, st>>>(src, xs, ys, out, D, H, W, C, planes,
                                                           Hs);
  }
  return (int)cudaGetLastError();
}

template <typename In>
int scatter(const In* g, const float* xs, const float* ys, float* dsrc, int D, int H, int W,
            int C, int vec, int planes, int Hs, void* stream) {
  dim3 grid;
  if (!sweep_grid(D, H, W, C, vec, planes, Hs, grid)) return (int)cudaErrorInvalidValue;
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    sweep_scatter_kernel<4, In><<<grid, kThreads, 0, st>>>(g, xs, ys, dsrc, D, H, W, C, planes,
                                                           Hs);
  } else {
    sweep_scatter_kernel<1, In><<<grid, kThreads, 0, st>>>(g, xs, ys, dsrc, D, H, W, C, planes,
                                                           Hs);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out (D, H, W, C) = bilinear samples of src (Hs, W, C) at xs, ys (D, H, W):
// the sample grid may be a band of H of the source's Hs rows (a rank's
// rows under height sharding; Hs = H otherwise), the coordinates are the
// source's own.  Each thread walks `planes` consecutive planes (≥ 1).
// Launches on `stream`; vec is 4 (C % 4 == 0, all pointers 16-byte
// aligned) or 1.  Returns cudaGetLastError() (0 = launched).
extern "C" int sweep_gather_f32(const float* src, const float* xs, const float* ys, float* out,
                                int D, int H, int W, int C, int vec, int planes, int Hs,
                                void* stream) {
  return gather(src, xs, ys, out, D, H, W, C, vec, planes, Hs, stream);
}

// The same with a bfloat16 out (its 16 bits): the taps summed in float,
// rounded once at the store to nearest even.
extern "C" int sweep_gather_bf16(const float* src, const float* xs, const float* ys,
                                 unsigned short* out, int D, int H, int W, int C, int vec,
                                 int planes, int Hs, void* stream) {
  return gather(src, xs, ys, out, D, H, W, C, vec, planes, Hs, stream);
}

// dsrc (Hs, W, C) += the transpose of the gather applied to g (D, H, W, C);
// the caller zeroes dsrc.  Same launch contract.
extern "C" int sweep_scatter_f32(const float* g, const float* xs, const float* ys, float* dsrc,
                                 int D, int H, int W, int C, int vec, int planes, int Hs,
                                 void* stream) {
  return scatter(g, xs, ys, dsrc, D, H, W, C, vec, planes, Hs, stream);
}

// The same with a bfloat16 g (its 16 bits), widened exactly at the read;
// the sums and dsrc stay float.
extern "C" int sweep_scatter_bf16(const unsigned short* g, const float* xs, const float* ys,
                                  float* dsrc, int D, int H, int W, int C, int vec, int planes,
                                  int Hs, void* stream) {
  return scatter(g, xs, ys, dsrc, D, H, W, C, vec, planes, Hs, stream);
}
