// Fused plane-sweep variance cost volume, CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernel of satmvs_tpu/ops/pallas/sweep_variance.py:
// `_sweep_variance_impl_hcw` (:130, its pallas_call at :161) and
// `_sweep_variance_kernel` (:35), public `sweep_variance` (:199).
//
// For B samples, each with a reference feature map ref (H, W, C), S source
// maps srcs (S, H, W, C) and sample coordinates xs, ys (S, D, H, W), it
// writes, with V = S + 1,
//
//   out[b, d, y, x, :] = (Σ_s w_s² + ref²)/V − ((Σ_s w_s + ref)/V)²   (B, D, H, W, C)
//   w_s = bilinear sample of srcs[s] at (xs[s, d, y, x], ys[s, d, y, x])
//
// with the taps of bilinear.cuh (the zero-padding, per-corner-validity
// contract of ops/sampling.bilinear_sample, the same corners and weights as
// the training gather and its scatter).  The per-view warped volumes are
// never stored.  The TPU kernel's stencil of shifted windows, tile bases,
// D-chunking and (H, C, W) layout exist because the TPU has no fast gather;
// Hopper does, so this is a direct gather and equals bilinear_sample
// everywhere.
//
// What bounds it: memory.  It does ~10 flops per gathered float, far below
// the H100's ~20 flops/byte fp32 balance point.  The least traffic is the
// output volume written once, the coordinates read once and the features
// read once: at the cascade's stage shapes (S = 2) 177, 203 and 142 MB,
// ~0.156 ms at 3.35 TB/s.  The corners it gathers are ~6× that (4 corners
// of C floats per view and output pixel), so it lives on its L1 and L2 hit
// rates, and its instruction count (coordinates, taps, corner addresses)
// is of the same order as the bound.
//
// Design.  The card measured the first redesign latency-bound: a thread
// that loads its coordinates, then its corners, view by view, waits on
// four dependent memory round trips, and more planes or channels a thread
// only cut the threads in flight.  So a thread owns one output pixel
// (b, y, x), G groups of VEC contiguous channels (c0 + g·step, step =
// lanes·VEC, so the `lanes` threads of a pixel sit side by side and each
// load or store of a warp is contiguous channels-last memory) and a run of
// K consecutive planes, which it walks in order with all S views unrolled
// (S a template parameter, as the Pallas kernel is traced for its n_src):
// the next plane's coordinates are loaded (__ldcs, read once) while this
// plane's corners are gathered, so a plane waits on one round trip, for
// the corners of all its views together.  The taps of a (view, plane) are
// computed once for the thread's G·VEC channels, and while consecutive
// planes keep a view's floor corner (x0, y0) — the planes of a stage-2/3
// window move by a fraction of a pixel — its four corners stay in
// registers and are not loaded again.  The
// reference vector is read once for the K planes.  Blocks cover 2-D pixel
// tiles (tx pixels × ty rows), so a block's corners fall on few source
// rows and neighbouring rows share them in L1.  The volume is written once
// with streaming stores (__stcs), so it does not push the features out of
// L2.  The launch plan (tile, G, K; ops/kernels/sweep_variance.py
// `sweep_variance_plan`) changes which thread computes an output, never
// how: every output is Σ over the views in order of Σ over the corners in
// Taps order, with the rounding spelled out below, so every plan, and a
// sample of a batch against the same sample alone, gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"

namespace {

constexpr int kMaxThreads = 256;  // the plan's threads a block, at most

// The four corners of taps t for a thread's G groups of VEC channels
// (src already offset by the thread's first channel), zero where a corner
// lies off the image.  Offsets inside a map are 32-bit ((H + 2)·(W + 2)·C
// < 2³¹, so a clamped off-image corner's offset does not overflow either).
template <int VEC, int G>
__device__ __forceinline__ void load_corners(const float* __restrict__ src,
                                             const bilinear::Taps& t, int H, int W, int C,
                                             int step, float (&cv)[4][VEC * G]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int xi = t.xi(k), yi = t.yi(k);
    const bool ok = xi >= 0 && xi < W && yi >= 0 && yi < H;
    const float* p = src + (yi * W + xi) * C;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float v[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
      if (ok) bilinear::load_vec<VEC>(p + g * step, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) cv[k][g * VEC + i] = v[i];
    }
  }
}

// Block: a tile of ty rows × tx pixels, `lanes` threads a pixel (fastest),
// then the pixels of a row, then the rows; grid (tiles, runs of K planes,
// B).  Threads a block: lanes·tx·ty (the plan's, ≤ kMaxThreads).
template <int VEC, int G, int S>
__global__ void __launch_bounds__(kMaxThreads, 2) sweep_variance_kernel(
    const float* __restrict__ ref, const float* __restrict__ srcs, int64_t feat_bstride,
    const float* __restrict__ xs, const float* __restrict__ ys, float* __restrict__ out, int D,
    int H, int W, int C, int K, int tx, int ty) {
  constexpr int N = VEC * G;  // channels a thread owns
  const int lanes = C / N;
  const int q = threadIdx.x / lanes;  // pixel of the tile
  const int lane = threadIdx.x - q * lanes;
  const int row = q / tx;
  const int ntx = (W + tx - 1) / tx;
  const int tile_row = blockIdx.x / ntx;
  const int y = tile_row * ty + row;
  const int x = (blockIdx.x - tile_row * ntx) * tx + (q - row * tx);
  if (y >= H || x >= W) return;
  const int b = blockIdx.z;
  const int d0 = blockIdx.y * K;
  const int d1 = d0 + K < D ? d0 + K : D;
  const int step = lanes * VEC;
  const int64_t hw = (int64_t)H * W;
  const int64_t p = (int64_t)y * W + x;
  const int64_t view = (int64_t)D * hw;  // coordinates of one view to the next
  const int64_t coord0 = ((int64_t)b * S * D + d0) * hw + p;  // view 0, plane d0
  const float* src = srcs + b * feat_bstride + lane * VEC;
  const int map = H * W * C;  // floats of one view's map

  float r[N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float v[VEC];
    bilinear::load_vec<VEC>(ref + b * feat_bstride + p * C + lane * VEC + g * step, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) r[g * VEC + i] = v[i];
  }
  float nx[S], ny[S];  // the coordinates of the next plane
#pragma unroll
  for (int s = 0; s < S; ++s) {
    nx[s] = __ldcs(xs + coord0 + s * view);
    ny[s] = __ldcs(ys + coord0 + s * view);
  }
  float cv[S][4][N] = {};
  int cx[S], cy[S];
#pragma unroll
  for (int s = 0; s < S; ++s) cx[s] = cy[s] = -3;  // no corner yet: Taps clamps to ≥ −2
  const float inv = __frcp_rn((float)(S + 1));
  float* o = out + (((int64_t)b * D + d0) * hw + p) * C + lane * VEC;
  int64_t ci = coord0;
  for (int d = d0; d < d1; ++d, ci += hw, o += hw * C) {
    bilinear::Taps t[S];
#pragma unroll
    for (int s = 0; s < S; ++s) t[s] = bilinear::Taps(nx[s], ny[s], H, W);
    if (d + 1 < d1) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        nx[s] = __ldcs(xs + ci + hw + s * view);
        ny[s] = __ldcs(ys + ci + hw + s * view);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (t[s].x0 != cx[s] || t[s].y0 != cy[s])
        load_corners<VEC, G>(src + (int64_t)s * map, t[s], H, W, C, step, cv[s]);
      cx[s] = t[s].x0;
      cy[s] = t[s].y0;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float v[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int j = g * VEC + i;
        float sum = 0.f, sq = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          // bilinear.cuh's sample: corners in Taps order, each an fma onto
          // the sum (an off-image corner adds 0)
          float w = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) w = __fmaf_rn(cv[s][c][j], t[s].w[c], w);
          sum = __fadd_rn(sum, w);
          sq = __fmaf_rn(w, w, sq);
        }
        const float mean = __fmul_rn(__fadd_rn(sum, r[j]), inv);
        v[i] = __fmaf_rn(-mean, mean, __fmul_rn(__fmaf_rn(r[j], r[j], sq), inv));
      }
      bilinear::store_streaming<VEC>(o + g * step, v);
    }
  }
}

template <int VEC, int G, int S>
void launch(dim3 grid, int threads, cudaStream_t st, const float* ref, const float* srcs,
            int64_t feat_bstride, const float* xs, const float* ys, float* out, int D, int H,
            int W, int C, int K, int tx, int ty) {
  sweep_variance_kernel<VEC, G, S><<<grid, threads, 0, st>>>(ref, srcs, feat_bstride, xs, ys,
                                                            out, D, H, W, C, K, tx, ty);
}

// The instance for S source views; two groups a thread only up to two
// views (more spill at 128 registers).
template <int VEC, int G>
bool launch_views(int S, dim3 grid, int threads, cudaStream_t st, const float* ref,
                  const float* srcs, int64_t feat_bstride, const float* xs, const float* ys,
                  float* out, int D, int H, int W, int C, int K, int tx, int ty) {
#define SWEEP_LAUNCH(NS)                                                                     \
  launch<VEC, G, NS>(grid, threads, st, ref, srcs, feat_bstride, xs, ys, out, D, H, W, C, K, \
                     tx, ty)
  if (S == 1) { SWEEP_LAUNCH(1); return true; }
  if (S == 2) { SWEEP_LAUNCH(2); return true; }
  if constexpr (G == 1) {
    if (S == 3) { SWEEP_LAUNCH(3); return true; }
    if (S == 4) { SWEEP_LAUNCH(4); return true; }
  }
#undef SWEEP_LAUNCH
  return false;
}

}  // namespace

// out (B, D, H, W, C) from sample b's reference map ref + b·feat_bstride
// (H, W, C), its S source maps srcs + b·feat_bstride (S, H, W, C) and xs,
// ys (B, S, D, H, W), under the plan (vec, groups G, planes K, tile tx ×
// ty) of `sweep_variance_plan`.  Launches on `stream`; vec is 4 (C % 4 ==
// 0, ref, srcs, out and feat_bstride 16-byte aligned) or 1; (vec, G) one of
// (4, 1), (4, 2) (S ≤ 2), (1, 1); S from 1 to 4.  Returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int sweep_variance_f32(const float* ref, const float* srcs, long long feat_bstride,
                                  const float* xs, const float* ys, float* out, int B, int S,
                                  int D, int H, int W, int C, int vec, int groups, int planes,
                                  int tx, int ty, void* stream) {
  if ((vec != 1 && vec != 4) || (groups != 1 && (vec != 4 || groups != 2)) || C < 1 ||
      C % (vec * groups) != 0 || planes < 1 || tx < 1 || ty < 1 || B < 0 || S < 1 || S > 4 ||
      D < 0 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t threads = (int64_t)(C / (vec * groups)) * tx * ty;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  if ((int64_t)(H + 2) * (W + 2) * C > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * D * H * W == 0) return 0;
  const int64_t tiles = (int64_t)((H + ty - 1) / ty) * ((W + tx - 1) / tx);
  const int64_t chunks = ((int64_t)D + planes - 1) / planes;
  if (tiles > 0x7fffffff || chunks > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)chunks, (unsigned)B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = (int)threads;
  const bool ok =
      vec == 1   ? launch_views<1, 1>(S, grid, n, st, ref, srcs, feat_bstride, xs, ys, out, D, H,
                                      W, C, planes, tx, ty)
      : groups == 1 ? launch_views<4, 1>(S, grid, n, st, ref, srcs, feat_bstride, xs, ys, out, D,
                                         H, W, C, planes, tx, ty)
                    : launch_views<4, 2>(S, grid, n, st, ref, srcs, feat_bstride, xs, ys, out, D,
                                         H, W, C, planes, tx, ty);
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}
