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
// The output grid may also be a band of H of the source maps' Hs rows (a
// rank's reference rows under height sharding): ref then points at the
// band's first row, the coordinates are the sources' own and their taps
// are bounded by Hs (Hs = H otherwise).
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
// (S a template parameter up to 4, as the Pallas kernel is traced for its
// n_src; beyond four, groups of up to four unrolled views a plane, below):
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

// Where a thread of the plan's grid writes.  Block: a tile of ty rows × tx
// pixels, `lanes` = C / N threads a pixel (fastest), then the pixels of a
// row, then the rows; grid (tiles, runs of K planes, B).  The thread owns
// sample b, pixel (y, x), channels from lane·VEC on and planes d0 .. d1 − 1;
// ok is false past the plane's edge.
struct Site {
  int lanes, lane, y, x, b, d0, d1;
  bool ok;

  __device__ __forceinline__ Site(int N, int D, int H, int W, int C, int K, int tx, int ty) {
    lanes = C / N;
    const int q = threadIdx.x / lanes;  // pixel of the tile
    lane = threadIdx.x - q * lanes;
    const int row = q / tx;
    const int ntx = (W + tx - 1) / tx;
    const int tile_row = blockIdx.x / ntx;
    y = tile_row * ty + row;
    x = (blockIdx.x - tile_row * ntx) * tx + (q - row * tx);
    ok = y < H && x < W;
    b = blockIdx.z;
    d0 = blockIdx.y * K;
    d1 = d0 + K < D ? d0 + K : D;
  }
};

// The kernel for S ≤ 4 source views, all unrolled.  Grid and thread map:
// Site; threads a block: lanes·tx·ty (the plan's, ≤ kMaxThreads).
template <int VEC, int G, int S>
__global__ void __launch_bounds__(kMaxThreads, 2) sweep_variance_kernel(
    const float* __restrict__ ref, const float* __restrict__ srcs, int64_t feat_bstride,
    const float* __restrict__ xs, const float* __restrict__ ys, float* __restrict__ out, int D,
    int H, int W, int C, int K, int tx, int ty, int Hs) {
  constexpr int N = VEC * G;  // channels a thread owns
  const Site at(N, D, H, W, C, K, tx, ty);
  if (!at.ok) return;
  const int lanes = at.lanes, lane = at.lane, y = at.y, x = at.x, b = at.b, d0 = at.d0,
            d1 = at.d1;
  const int step = lanes * VEC;
  const int64_t hw = (int64_t)H * W;
  const int64_t p = (int64_t)y * W + x;
  const int64_t view = (int64_t)D * hw;  // coordinates of one view to the next
  const int64_t coord0 = ((int64_t)b * S * D + d0) * hw + p;  // view 0, plane d0
  const float* src = srcs + b * feat_bstride + lane * VEC;
  const int map = Hs * W * C;  // floats of one source view's map

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
    for (int s = 0; s < S; ++s) t[s] = bilinear::Taps(nx[s], ny[s], Hs, W);
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
        load_corners<VEC, G>(src + (int64_t)s * map, t[s], Hs, W, C, step, cv[s]);
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

// The samples w[s] of views s0 .. s0 + NS − 1 at one output pixel and plane
// (xs, ys at ci for view s0, srcs at src for view s0), each an fma chain
// over its corners in Taps order onto 0, as sweep_variance_kernel's.  The
// group's coordinates are loaded together, then its corners together: two
// memory round trips a group.
template <int VEC, int NS>
__device__ __forceinline__ void sample_views(const float* __restrict__ src,
                                             const float* __restrict__ xs,
                                             const float* __restrict__ ys, int64_t ci,
                                             int64_t view, int map, int H, int W, int C, int step,
                                             float (&w)[NS][VEC]) {
  float cx[NS], cy[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    cx[s] = __ldcs(xs + ci + s * view);
    cy[s] = __ldcs(ys + ci + s * view);
  }
  bilinear::Taps t[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) t[s] = bilinear::Taps(cx[s], cy[s], H, W);
  float cv[NS][4][VEC];
#pragma unroll
  for (int s = 0; s < NS; ++s) load_corners<VEC, 1>(src + (int64_t)s * map, t[s], H, W, C, step, cv[s]);
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      w[s][j] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) w[s][j] = __fmaf_rn(cv[s][c][j], t[s].w[c], w[s][j]);
    }
}

// sample_views, each sample added in view order onto the thread's sums:
// onto sum, its square onto sq, the chain of sweep_variance_kernel.
template <int VEC, int NS>
__device__ __forceinline__ void add_views(const float* __restrict__ src,
                                          const float* __restrict__ xs,
                                          const float* __restrict__ ys, int64_t ci, int64_t view,
                                          int map, int H, int W, int C, int step,
                                          float (&sum)[VEC], float (&sq)[VEC]) {
  float w[NS][VEC];
  sample_views<VEC, NS>(src, xs, ys, ci, view, map, H, W, C, step, w);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      sum[j] = __fadd_rn(sum[j], w[s][j]);
      sq[j] = __fmaf_rn(w[s][j], w[s][j], sq[j]);
    }
  }
}

// sweep_variance_kernel for any S ≥ 1 (run for S > 4, one group of VEC
// channels a thread): each plane walks the views in groups of up to four
// unrolled views (add_views), so every output is the same chain of
// roundings as sweep_variance_kernel's, in view order.  The corners are
// not kept from plane to plane (S views of them would not fit in
// registers), nor the next plane's coordinates loaded ahead.  The same
// grid and thread map as sweep_variance_kernel (Site).
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads, 2) sweep_variance_groups_kernel(
    const float* __restrict__ ref, const float* __restrict__ srcs, int64_t feat_bstride,
    const float* __restrict__ xs, const float* __restrict__ ys, float* __restrict__ out, int S,
    int D, int H, int W, int C, int K, int tx, int ty, int Hs) {
  const Site at(VEC, D, H, W, C, K, tx, ty);
  if (!at.ok) return;
  const int step = at.lanes * VEC;
  const int64_t hw = (int64_t)H * W;
  const int64_t p = (int64_t)at.y * W + at.x;
  const int64_t view = (int64_t)D * hw;
  const float* src = srcs + at.b * feat_bstride + at.lane * VEC;
  const int map = Hs * W * C;
  float r[VEC];
  bilinear::load_vec<VEC>(ref + at.b * feat_bstride + p * C + at.lane * VEC, r);
  const float inv = __frcp_rn((float)(S + 1));
  float* o = out + (((int64_t)at.b * D + at.d0) * hw + p) * C + at.lane * VEC;
  int64_t ci = ((int64_t)at.b * S * D + at.d0) * hw + p;  // view 0, plane d0
  for (int d = at.d0; d < at.d1; ++d, ci += hw, o += hw * C) {
    float sum[VEC], sq[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) sum[j] = sq[j] = 0.f;
    for (int s0 = 0; s0 < S; s0 += 4) {
      const float* g = src + (int64_t)s0 * map;
      const int64_t gi = ci + s0 * view;
      switch (S - s0) {
        case 1: add_views<VEC, 1>(g, xs, ys, gi, view, map, Hs, W, C, step, sum, sq); break;
        case 2: add_views<VEC, 2>(g, xs, ys, gi, view, map, Hs, W, C, step, sum, sq); break;
        case 3: add_views<VEC, 3>(g, xs, ys, gi, view, map, Hs, W, C, step, sum, sq); break;
        default: add_views<VEC, 4>(g, xs, ys, gi, view, map, Hs, W, C, step, sum, sq);
      }
    }
    float v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float mean = __fmul_rn(__fadd_rn(sum[j], r[j]), inv);
      v[j] = __fmaf_rn(-mean, mean, __fmul_rn(__fmaf_rn(r[j], r[j], sq[j]), inv));
    }
    bilinear::store_streaming<VEC>(o, v);
  }
}

// ---- The backward ----
//
// Replaces the fused sweep's custom VJP, `_sweep_variance_bwd`
// (satmvs_tpu/ops/pallas/sweep_variance.py:226), which re-gathers the
// source views with the gather kernel (sweep_gather.py:436), forms each
// view's cotangent volume elementwise and transposes it with the scatter
// kernel (:576).  With V = S + 1 views, the samples w_s of the forward, the
// mean m = (ref + Σ_s w_s) / V (summed in view order after the reference)
// and the volume's cotangent g (B, D, H, W, C), sweep_variance_backward_kernel
// computes the whole VJP in one launch:
//
//   dref[b, y, x, :]  = Σ_d g · ((2/V)·(ref − m))                  (B, H, W, C)
//   dsrcs[b, s]      += Σ over (d, y, x) and the four corners of the sample
//                       w_s of (corner weight) · g · ((2/V)·(w_s − m))
//                                                               (B, S, Hs, W, C)
//
// into dsrcs zeroed by the caller; no cotangent volume is stored.
//
// What bounds it: memory.  The least traffic is g, the coordinates and the
// features read once and dref and dsrcs written once: at the cascade's
// train shapes (S = 2) 184.0, 217.1 and 169.9 MB, ~0.170 ms at 3.35 TB/s.
// Composed as JAX composes it, the S cotangent volumes (755 MB a step
// there) were written by one kernel and read back by S scatters.
//
// Design.  A thread owns one pixel and group of VEC channels of one sample
// (the forward's tiles, Site) and walks all D planes in order, so dref is
// summed over the planes in a fixed order, with no atomics, and every run
// gives the same bits.  Per plane it loads the next plane's coordinates
// and g while this plane is sampled (evict-first: both are read once),
// samples each view from its four corners, kept in registers while the
// view's floor corner (x0, y0) stays (the forward's rule), forms the mean,
// the reference's term and each view's cotangent, and adds each corner's
// tap-weighted cotangent into a register sum of that corner.  The sums go
// into dsrcs (≤ 19 MB at the train shapes, so it stays in L2 while g
// streams past) with sm_90's float4 atomicAdd
// (red.global.add.v4.f32) only when the floor corner moves: along an
// epipolar line it mostly stays or moves one column with the same row, and
// then only the column that leaves is added and the shared column's sums
// and corner values shift into place; on any other move all four are
// added, and at the end what is left.  A corner off the image is skipped.
// Each term is rounded as the composed pair rounds it: the cotangent
// g · ((2/V)·(w_s − m)) as each product of JAX's composition, then
// __fmul_rn(weight, cotangent) as sweep_gather.cu's scatter_runs, summed
// in some order: only the order of each dsrcs element's additions changes,
// within the summation bound of sweep_gather.cu (2·(n − 1)·2⁻²⁴ times the
// sum of the magnitudes of its n terms), and from run to run.
//
// Views.  Up to kKeptViews = 2 source views are unrolled with their
// corners kept; three and four are unrolled with their corners loaded
// again each plane (from L1: kept corners beside four views' sums would
// not fit in registers).  Beyond four, sweep_variance_backward_groups_kernel walks
// the D planes once for each pair of views, carrying that pair's sums and
// corners, the mean recomputed each walk from all S views (the others
// sampled one at a time), dref summed on the first walk.
//
// Registers.  At S = 2 and VEC = 4 a thread carries 64 floats of corner
// values and sums, and more beside them than the forward kernel (g loaded
// ahead, the samples, dref's sum).  Under __launch_bounds__(256, 1) ptxas
// may give a thread up to 255 registers (an SM then holds one block of 256
// threads), under (256, 2) up to 128.  Both were built and timed on an
// H100 (PERF.md, row "1, backward"); the backward kernels take the one
// that spilled nothing and ran faster, (256, 1).

constexpr int kKeptViews = 2;     // views whose corners a thread keeps
constexpr int kUnrolledViews = 4;  // views sweep_variance_backward_kernel unrolls

template <int VEC>
__device__ __forceinline__ void load_streaming(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldcs(p + i);
  }
}

// What a thread carries for one source view: the floor corner (x0, y0) of
// its last sample (−3: none yet; Taps clamps to ≥ −2), the scatter sums of
// that sample's four corners in Taps order, and with KEEP their values.
template <int VEC, bool KEEP>
struct Carried {
  int x0, y0;
  float sums[4][VEC];
  float cv[KEEP ? 4 : 1][VEC];
};

// Adds sums[k] into the dsrc pixel of corner k of (x0, y0), for each corner
// k in MASK that lies in the image (dsrc offset by the thread's channels),
// and zeroes the sums of MASK: one float4 atomic a corner at VEC = 4, else
// VEC scalar ones.
template <int VEC, int MASK>
__device__ __forceinline__ void add_corners(float* __restrict__ dsrc, int x0, int y0, int H,
                                            int W, int C, float (&sums)[4][VEC]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!((MASK >> k) & 1)) continue;
    const int x = x0 + (k & 1), y = y0 + (k >> 1);
    if (x >= 0 && x < W && y >= 0 && y < H) {
      float* dst = dsrc + (y * W + x) * C;
      if constexpr (VEC == 4) {
        atomicAdd(reinterpret_cast<float4*>(dst),
                  make_float4(sums[k][0], sums[k][1], sums[k][2], sums[k][3]));
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) atomicAdd(dst + i, sums[k][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sums[k][i] = 0.f;
  }
}

// The values of pixel (x, y) for a thread's VEC channels, zero off the image.
template <int VEC>
__device__ __forceinline__ void load_corner(const float* __restrict__ src, int x, int y, int H,
                                            int W, int C, float (&v)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = 0.f;
  if (x >= 0 && x < W && y >= 0 && y < H) bilinear::load_vec<VEC>(src + (y * W + x) * C, v);
}

// Corner `from`'s column of the carried sums (and values) moves to column
// `to` (0 or 1); the sums of column `from` start again from 0.
template <int VEC, bool KEEP>
__device__ __forceinline__ void shift_column(Carried<VEC, KEEP>& v, int from, int to) {
#pragma unroll
  for (int r = 0; r < 4; r += 2)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      v.sums[r + to][i] = v.sums[r + from][i];
      v.sums[r + from][i] = 0.f;
      if constexpr (KEEP) v.cv[r + to][i] = v.cv[r + from][i];
    }
}

// The carried view moves to the sample with taps t (src and dsrc: the
// view's map and cotangent, offset by the thread's channels): nothing when
// the floor corner stays; one column over with the same row, the column
// that leaves is added into dsrc and the other shifts into place (with
// KEEP the new column's values are loaded); otherwise all four are added
// (and with KEEP loaded anew).
template <int VEC, bool KEEP>
__device__ __forceinline__ void move_to(Carried<VEC, KEEP>& v, const bilinear::Taps& t,
                                        const float* __restrict__ src, float* __restrict__ dsrc,
                                        int H, int W, int C) {
  if (t.x0 == v.x0 && t.y0 == v.y0) return;
  if (t.y0 == v.y0 && t.x0 == v.x0 + 1) {
    add_corners<VEC, 0b0101>(dsrc, v.x0, v.y0, H, W, C, v.sums);
    shift_column<VEC, KEEP>(v, 1, 0);
    if constexpr (KEEP) {
      load_corner<VEC>(src, t.x0 + 1, t.y0, H, W, C, v.cv[1]);
      load_corner<VEC>(src, t.x0 + 1, t.y0 + 1, H, W, C, v.cv[3]);
    }
  } else if (t.y0 == v.y0 && t.x0 == v.x0 - 1) {
    add_corners<VEC, 0b1010>(dsrc, v.x0, v.y0, H, W, C, v.sums);
    shift_column<VEC, KEEP>(v, 0, 1);
    if constexpr (KEEP) {
      load_corner<VEC>(src, t.x0, t.y0, H, W, C, v.cv[0]);
      load_corner<VEC>(src, t.x0, t.y0 + 1, H, W, C, v.cv[2]);
    }
  } else {
    add_corners<VEC, 0b1111>(dsrc, v.x0, v.y0, H, W, C, v.sums);
    if constexpr (KEEP) load_corners<VEC, 1>(src, t, H, W, C, 0, v.cv);
  }
  v.x0 = t.x0;
  v.y0 = t.y0;
}

// The sample of corner values cv at taps t: an fma chain over the corners
// in Taps order onto 0, as sweep_variance_kernel's.
template <int VEC>
__device__ __forceinline__ void sample_corners(const float (&cv)[4][VEC], const bilinear::Taps& t,
                                               float (&w)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    w[j] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) w[j] = __fmaf_rn(cv[c][j], t.w[c], w[j]);
  }
}

// Views s0 .. s0 + NS − 1 added in view order onto sum (sample_views).
template <int VEC, int NS>
__device__ __forceinline__ void sum_views(const float* __restrict__ src,
                                          const float* __restrict__ xs,
                                          const float* __restrict__ ys, int64_t ci, int64_t view,
                                          int map, int H, int W, int C, int step,
                                          float (&sum)[VEC]) {
  float w[NS][VEC];
  sample_views<VEC, NS>(src, xs, ys, ci, view, map, H, W, C, step, w);
#pragma unroll
  for (int j = 0; j < VEC; ++j)
#pragma unroll
    for (int s = 0; s < NS; ++s) sum[j] = __fadd_rn(sum[j], w[s][j]);
}

// One thread's operands of the backward (B = 1 of them: pointers offset by
// its sample, pixel and channels).
struct Walk {
  const float* src;   // view 0's map of the sample, at the thread's channels
  float* dsrc;        // view 0's cotangent of the sample, at the thread's channels
  const float* xs;
  const float* ys;
  const float* g;     // the volume's cotangent at plane 0, pixel and channels
  int64_t ci;         // coordinates of view 0, plane 0, the thread's pixel
  int64_t hw, view;   // a plane's and a view's coordinates
  int map;            // floats of one source view's map
  int S, D, Hs, W, C, step;
};

// Walks the D planes of a thread, carrying views s0 .. s0 + NS − 1 (KEEP:
// their corner values kept), the mean over all S views (with OTHERS the
// views outside s0 .. s0 + NS − 1 sampled one at a time; without, NS = S),
// and adds their cotangents into dsrc; with ref_term, the reference's term
// onto dref.
template <int VEC, int NS, bool KEEP, bool OTHERS>
__device__ __forceinline__ void backward_walk(const Walk& k, int s0, const float (&r)[VEC],
                                              bool ref_term, float (&dref)[VEC]) {
  const float nv = (float)(k.S + 1), scale = __fdiv_rn(2.f, nv);
  const float* src = k.src + (int64_t)s0 * k.map;
  float* dsrc = k.dsrc + (int64_t)s0 * k.map;
  Carried<VEC, KEEP> v[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    v[s].x0 = v[s].y0 = -3;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[s].sums[c][i] = 0.f;
  }
  float nx[NS], ny[NS], ng[VEC];  // the next plane's coordinates and g
  if (k.D > 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      nx[s] = __ldcs(k.xs + k.ci + (s0 + s) * k.view);
      ny[s] = __ldcs(k.ys + k.ci + (s0 + s) * k.view);
    }
    load_streaming<VEC>(k.g, ng);
  }
  int64_t ci = k.ci;
  const float* gp = k.g;
  const int64_t gplane = k.hw * k.C;
  for (int d = 0; d < k.D; ++d, ci += k.hw, gp += gplane) {
    bilinear::Taps t[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) t[s] = bilinear::Taps(nx[s], ny[s], k.Hs, k.W);
    float gv[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) gv[j] = ng[j];
    if (d + 1 < k.D) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        nx[s] = __ldcs(k.xs + ci + k.hw + (s0 + s) * k.view);
        ny[s] = __ldcs(k.ys + ci + k.hw + (s0 + s) * k.view);
      }
      load_streaming<VEC>(gp + gplane, ng);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s)
      move_to<VEC, KEEP>(v[s], t[s], src + (int64_t)s * k.map, dsrc + (int64_t)s * k.map, k.Hs,
                         k.W, k.C);
    float w[NS][VEC];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if constexpr (KEEP) {
        sample_corners<VEC>(v[s].cv, t[s], w[s]);
      } else {
        float cv[4][VEC];
        load_corners<VEC, 1>(src + (int64_t)s * k.map, t[s], k.Hs, k.W, k.C, 0, cv);
        sample_corners<VEC>(cv, t[s], w[s]);
      }
    }
    float sum[VEC], m[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) sum[j] = r[j];
    if constexpr (OTHERS) {
      for (int s = 0; s < s0; ++s)
        sum_views<VEC, 1>(k.src + (int64_t)s * k.map, k.xs, k.ys, ci + s * k.view, k.view,
                          k.map, k.Hs, k.W, k.C, k.step, sum);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j)
#pragma unroll
      for (int s = 0; s < NS; ++s) sum[j] = __fadd_rn(sum[j], w[s][j]);
    if constexpr (OTHERS) {
      for (int s = s0 + NS; s < k.S; ++s)
        sum_views<VEC, 1>(k.src + (int64_t)s * k.map, k.xs, k.ys, ci + s * k.view, k.view,
                          k.map, k.Hs, k.W, k.C, k.step, sum);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      m[j] = __fdiv_rn(sum[j], nv);
      if (ref_term)
        dref[j] = __fadd_rn(dref[j], __fmul_rn(gv[j], __fmul_rn(scale, __fsub_rn(r[j], m[j]))));
    }
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float cot = __fmul_rn(gv[j], __fmul_rn(scale, __fsub_rn(w[s][j], m[j])));
#pragma unroll
        for (int c = 0; c < 4; ++c) v[s].sums[c][j] += __fmul_rn(t[s].w[c], cot);
      }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
    add_corners<VEC, 0b1111>(dsrc + (int64_t)s * k.map, v[s].x0, v[s].y0, k.Hs, k.W, k.C,
                             v[s].sums);
}

// The thread's Walk, its reference vector r, and where its dref goes
// (Site with K = D: one group of VEC channels a thread, all D planes).
template <int VEC>
__device__ __forceinline__ Walk walk_of(const Site& at, const float* __restrict__ srcs,
                                        int64_t feat_bstride, const float* __restrict__ xs,
                                        const float* __restrict__ ys,
                                        const float* __restrict__ g, float* __restrict__ dsrcs,
                                        int S, int D, int H, int W, int C, int Hs) {
  Walk k;
  k.hw = (int64_t)H * W;
  const int64_t p = (int64_t)at.y * W + at.x;
  k.view = (int64_t)D * k.hw;
  k.map = Hs * W * C;
  k.src = srcs + at.b * feat_bstride + at.lane * VEC;
  k.dsrc = dsrcs + (int64_t)at.b * S * k.map + at.lane * VEC;
  k.xs = xs;
  k.ys = ys;
  k.g = g + ((int64_t)at.b * D * k.hw + p) * C + at.lane * VEC;
  k.ci = (int64_t)at.b * S * k.view + p;
  k.S = S;
  k.D = D;
  k.Hs = Hs;
  k.W = W;
  k.C = C;
  k.step = at.lanes * VEC;
  return k;
}

// The kernel for S ≤ kUnrolledViews source views, all unrolled in one walk
// (corners kept up to kKeptViews views).  Grid (tiles, 1, B) and thread
// map: Site with K = D (one group of VEC channels a thread).
template <int VEC, int S>
__global__ void __launch_bounds__(kMaxThreads, 1) sweep_variance_backward_kernel(
    const float* __restrict__ ref, const float* __restrict__ srcs, int64_t feat_bstride,
    const float* __restrict__ xs, const float* __restrict__ ys, const float* __restrict__ g,
    float* __restrict__ dsrcs, float* __restrict__ dref, int D, int H, int W, int C, int tx,
    int ty, int Hs) {
  const Site at(VEC, D, H, W, C, D, tx, ty);
  if (!at.ok) return;
  const Walk k = walk_of<VEC>(at, srcs, feat_bstride, xs, ys, g, dsrcs, S, D, H, W, C, Hs);
  const int64_t pc = ((int64_t)at.y * W + at.x) * C + at.lane * VEC;
  float r[VEC], acc[VEC];
  bilinear::load_vec<VEC>(ref + at.b * feat_bstride + pc, r);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  backward_walk<VEC, S, (S <= kKeptViews), false>(k, 0, r, true, acc);
  bilinear::store_streaming<VEC>(dref + (int64_t)at.b * k.hw * C + pc, acc);
}

// The kernel for any S ≥ 1 (run for S > kUnrolledViews): one walk over the
// D planes for each pair of views (a single view last when S is odd), its
// corners kept, the mean from all S views each walk; dref on the first
// walk, summed in the order of the unrolled kernel.  The same grid and
// thread map.
template <int VEC>
__global__ void __launch_bounds__(kMaxThreads, 1) sweep_variance_backward_groups_kernel(
    const float* __restrict__ ref, const float* __restrict__ srcs, int64_t feat_bstride,
    const float* __restrict__ xs, const float* __restrict__ ys, const float* __restrict__ g,
    float* __restrict__ dsrcs, float* __restrict__ dref, int S, int D, int H, int W, int C,
    int tx, int ty, int Hs) {
  const Site at(VEC, D, H, W, C, D, tx, ty);
  if (!at.ok) return;
  const Walk k = walk_of<VEC>(at, srcs, feat_bstride, xs, ys, g, dsrcs, S, D, H, W, C, Hs);
  const int64_t pc = ((int64_t)at.y * W + at.x) * C + at.lane * VEC;
  float r[VEC], acc[VEC];
  bilinear::load_vec<VEC>(ref + at.b * feat_bstride + pc, r);
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int s0 = 0; s0 < S; s0 += 2) {
    if (S - s0 >= 2)
      backward_walk<VEC, 2, true, true>(k, s0, r, s0 == 0, acc);
    else
      backward_walk<VEC, 1, true, true>(k, s0, r, s0 == 0, acc);
  }
  bilinear::store_streaming<VEC>(dref + (int64_t)at.b * k.hw * C + pc, acc);
}

template <int VEC>
void launch_backward(int S, dim3 grid, int threads, cudaStream_t st, const float* ref,
                     const float* srcs, int64_t feat_bstride, const float* xs, const float* ys,
                     const float* g, float* dsrcs, float* dref, int D, int H, int W, int C,
                     int tx, int ty, int Hs) {
#define SWEEP_BWD(NS)                                                                    \
  sweep_variance_backward_kernel<VEC, NS><<<grid, threads, 0, st>>>(                     \
      ref, srcs, feat_bstride, xs, ys, g, dsrcs, dref, D, H, W, C, tx, ty, Hs)
  static_assert(kUnrolledViews == 4, "the switch below unrolls up to four views");
  switch (S) {
    case 1: SWEEP_BWD(1); break;
    case 2: SWEEP_BWD(2); break;
    case 3: SWEEP_BWD(3); break;
    case 4: SWEEP_BWD(4); break;
    default:
      sweep_variance_backward_groups_kernel<VEC><<<grid, threads, 0, st>>>(
          ref, srcs, feat_bstride, xs, ys, g, dsrcs, dref, S, D, H, W, C, tx, ty, Hs);
  }
#undef SWEEP_BWD
}

template <int VEC, int G, int S>
void launch(dim3 grid, int threads, cudaStream_t st, const float* ref, const float* srcs,
            int64_t feat_bstride, const float* xs, const float* ys, float* out, int D, int H,
            int W, int C, int K, int tx, int ty, int Hs) {
  sweep_variance_kernel<VEC, G, S><<<grid, threads, 0, st>>>(ref, srcs, feat_bstride, xs, ys,
                                                            out, D, H, W, C, K, tx, ty, Hs);
}

// The instance for S source views: sweep_variance_kernel up to four
// views, two groups a thread only up to two (more spill at 128 registers);
// sweep_variance_groups_kernel beyond four, one group a thread.
template <int VEC, int G>
bool launch_views(int S, dim3 grid, int threads, cudaStream_t st, const float* ref,
                  const float* srcs, int64_t feat_bstride, const float* xs, const float* ys,
                  float* out, int D, int H, int W, int C, int K, int tx, int ty, int Hs) {
#define SWEEP_LAUNCH(NS)                                                                     \
  launch<VEC, G, NS>(grid, threads, st, ref, srcs, feat_bstride, xs, ys, out, D, H, W, C, K, \
                     tx, ty, Hs)
  if (S == 1) { SWEEP_LAUNCH(1); return true; }
  if (S == 2) { SWEEP_LAUNCH(2); return true; }
  if constexpr (G == 1) {
    if (S == 3) { SWEEP_LAUNCH(3); return true; }
    if (S == 4) { SWEEP_LAUNCH(4); return true; }
    sweep_variance_groups_kernel<VEC><<<grid, threads, 0, st>>>(ref, srcs, feat_bstride, xs, ys,
                                                                out, S, D, H, W, C, K, tx, ty,
                                                                Hs);
    return true;
  }
#undef SWEEP_LAUNCH
  return false;
}

}  // namespace

// out (B, D, H, W, C) from sample b's reference map ref + b·feat_bstride
// (H, W, C, rows W·C floats apart), its S source maps srcs + b·feat_bstride
// (S, Hs, W, C) and xs, ys (B, S, D, H, W), under the plan (vec, groups G, planes K, tile tx ×
// ty) of `sweep_variance_plan`.  Launches on `stream`; vec is 4 (C % 4 ==
// 0, ref, srcs, out and feat_bstride 16-byte aligned) or 1; (vec, G) one of
// (4, 1), (4, 2) (S ≤ 2), (1, 1); S ≥ 1.  Returns cudaGetLastError()
// (0 = launched), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int sweep_variance_f32(const float* ref, const float* srcs, long long feat_bstride,
                                  const float* xs, const float* ys, float* out, int B, int S,
                                  int D, int H, int W, int C, int vec, int groups, int planes,
                                  int tx, int ty, int Hs, void* stream) {
  if ((vec != 1 && vec != 4) || (groups != 1 && (vec != 4 || groups != 2)) || C < 1 ||
      C % (vec * groups) != 0 || planes < 1 || tx < 1 || ty < 1 || B < 0 || S < 1 ||
      D < 0 || H < 0 || W < 0 || Hs < H)
    return (int)cudaErrorInvalidValue;
  const int64_t threads = (int64_t)(C / (vec * groups)) * tx * ty;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  if ((int64_t)(Hs + 2) * (W + 2) * C > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * D * H * W == 0) return 0;
  const int64_t tiles = (int64_t)((H + ty - 1) / ty) * ((W + tx - 1) / tx);
  const int64_t chunks = ((int64_t)D + planes - 1) / planes;
  if (tiles > 0x7fffffff || chunks > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)chunks, (unsigned)B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = (int)threads;
  const bool ok =
      vec == 1   ? launch_views<1, 1>(S, grid, n, st, ref, srcs, feat_bstride, xs, ys, out, D, H,
                                      W, C, planes, tx, ty, Hs)
      : groups == 1 ? launch_views<4, 1>(S, grid, n, st, ref, srcs, feat_bstride, xs, ys, out, D,
                                         H, W, C, planes, tx, ty, Hs)
                    : launch_views<4, 2>(S, grid, n, st, ref, srcs, feat_bstride, xs, ys, out, D,
                                         H, W, C, planes, tx, ty, Hs);
  return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// The fused sweep's VJP from the forward's operands (ref, srcs,
// feat_bstride, xs, ys as sweep_variance_f32 takes them) and the volume's
// cotangent g (B, D, H, W, C) (Hs the source maps' rows, as there): dref
// (B, H, W, C), the reference's cotangent, written, and dsrcs (B, S, Hs, W,
// C), each source view's cotangent, added into (the caller zeroes it),
// under the tile (vec, tx × ty) of `sweep_variance_backward_plan` (one
// group of vec channels a thread, all D planes).  Launches on `stream`; vec
// is 4 (C % 4 == 0, ref, srcs, g, dsrcs, dref and feat_bstride 16-byte
// aligned) or 1; S ≥ 1.  Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int sweep_variance_backward_f32(const float* ref, const float* srcs,
                                           long long feat_bstride, const float* xs,
                                           const float* ys, const float* g, float* dsrcs,
                                           float* dref, int B, int S, int D, int H, int W, int C,
                                           int vec, int tx, int ty, int Hs, void* stream) {
  if ((vec != 1 && vec != 4) || C < 1 || C % vec != 0 || tx < 1 || ty < 1 || B < 0 || S < 1 ||
      D < 0 || H < 0 || W < 0 || Hs < H)
    return (int)cudaErrorInvalidValue;
  const int64_t threads = (int64_t)(C / vec) * tx * ty;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  if ((int64_t)(Hs + 2) * (W + 2) * C > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * H * W == 0) return 0;
  const int64_t tiles = (int64_t)((H + ty - 1) / ty) * ((W + tx - 1) / tx);
  if (tiles > 0x7fffffff || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1u, (unsigned)B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    launch_backward<4>(S, grid, (int)threads, st, ref, srcs, feat_bstride, xs, ys, g, dsrcs,
                       dref, D, H, W, C, tx, ty, Hs);
  } else {
    launch_backward<1>(S, grid, (int)threads, st, ref, srcs, feat_bstride, xs, ys, g, dsrcs,
                       dref, D, H, W, C, tx, ty, Hs);
  }
  return (int)cudaGetLastError();
}
