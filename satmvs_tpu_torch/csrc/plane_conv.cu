// Plane convolutions of the RED regularizer and their backwards, CUDA for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of satmvs_tpu/ops/pallas/plane_conv.py:
//   conv_dn   `_conv_dn_impl` (:382, pallas_call :394, kernel :295): stride-2 3×3
//             conv, pad 1, no bias, ReLU (the RED encoder);
//   deconv_up `_deconv_up_impl` (:569, pallas_call :582, kernel :480): stride-2 3×3
//             transposed conv exactly as torch's ConvTranspose2d(k=3, s=2, p=1,
//             op=1), no bias, ReLU (the RED decoder), here with the decoder's
//             skip add fused after the ReLU;
//   conv_head `_conv_head_impl` (:730, pallas_call :738, kernel :663): stride-1 3×3
//             conv + bias, no activation (the RED logit head);
// and their backwards:
//   conv_dn   `_conv_dn_bwd` (:424, pallas_call :442, kernel :320): dx, the
//             transposed stride-2 conv of dz = g·[y > 0], and dW;
//   deconv_up `_deconv_up_bwd` (:610, pallas_call :626, kernel :498): dx, the
//             stride-2 conv of dz = g·relu′(z), and dW (the skip's cotangent is g);
//   conv_head `_conv_head_bwd` (:768, pallas_call :780, kernel :685): dx, the
//             stride-1 conv of g with the flipped, channel-transposed kernel, dW, db.
// conv_dn, conv_head and the dx of deconv_up and conv_head are one kernel,
// `conv3x3_kernel`, with the stride, the bias, the ReLU and an input gate as
// arguments; deconv_up and the dx of conv_dn are `deconv3x3_s2_kernel`; every
// weight and bias cotangent is `wgrad_partial_kernel` + `wgrad_reduce_kernel`
// (`wgrad3x3_f32`).
//
// Layout: activations are channels-last (N, H, W, C) float32 planes; weights
// arrive as (3, 3, Cin, Cout), output channels fastest.  The TPU kernels'
// row-packed layout, even/odd column splits and phase matrices are Mosaic
// workarounds and are not carried over.
//
// What bounds them on this card: memory, at the main path's shapes.  A 3×3
// conv at these channel counts does 9·Cin FMAs per output value, so
// 2·9·Cin·Cout flops per pixel against 4·(Cin + Cout) bytes per pixel; at the
// largest shape (Cin 32, Cout 64, stride 2) that is ~18 flops a byte, under the
// H100's ~20 flops/byte fp32 balance, and the other shapes are far under it.
// The backwards move the same bytes plus the gate (y or relu(z)) and do twice
// the forward's operations (dx and dW), still at or under the balance point.
//
// Design (simple first, fp32 FMA on the CUDA cores, no tensor cores): a direct
// convolution.  One thread owns one output pixel and a run of CO_T = 4 output
// channels; threads of one pixel sit side by side, so their input reads are
// one broadcast and their output writes are contiguous.  Each block stages the
// whole weight tensor, zero-padded to a multiple of CO_T output channels, in
// shared memory (up to 3·3·64·32·4 B = 73.7 KB at these shapes, so dynamic
// shared memory past the 48 KB default) and reads it as float4.  Inputs are
// read 16 bytes at a time where Cin % 4 == 0.  The grid is capped at the
// blocks that can be resident at once and walks the outputs in a grid-stride
// loop, so the weights are staged once per resident block.  The transposed
// conv is a gather over the four output phases (no atomics): out[2i+a, 2j+b]
// reads 1, 2, 2 or 4 taps, and the output padding of 1 falls out of the
// index map.
//
// Backward.  Every dx is a gather of the same two kinds, so it runs through
// the forward kernels with rearranged weights (the wrapper permutes and flips
// them) and a gate: the ReLU's mask is applied as the cotangent is loaded
// (value · [gate > 0]), so dz is never written.  conv_dn's gate is its saved
// output y (y > 0 is exactly relu′).  deconv_up's output is relu(z) + skip,
// from which the mask cannot be read (a tiny positive z that the skip add
// rounds away would read as 0), so when a gradient is wanted the forward
// also writes relu(z) to a second buffer, and that is the gate: one more
// output-sized write in the forward and that buffer kept until the backward
// (the alternative, recomputing z in the backward, costs the whole forward
// conv again).  dx of conv_dn is torch's conv_transpose2d(p=1, op=1)
// geometry, which is the transpose of the stride-2 conv only for even H and
// W; the wrapper raises on odd sizes.
//
// Weight cotangents are reductions over N·H·W pixels (2.4 M at the largest
// shape) into 9·CA·CB values (at most 9·128·128 for the ConvGRU's concat
// convs of satmvs_tpu_torch/csrc/red_recur.cu, which take their weight
// cotangents from this kernel too): a GEMM im2col(A)ᵀ·B with a huge depth
// (the pixels) and a small M × N.  Its arithmetic intensity, 9·CA·CB·2 /
// (4·(CA + CB)) flops a byte, is 18-72 at the main path's shapes, so tiled
// it is bound by the CUDA cores' fp32 FMA rate, not by memory: the 45
// reductions of a 384×768 train step do ~200 GFLOP over ~4.7 GB, ~3.5 ms of
// operations against ~1.4 ms of bytes.  Pass 1 (`wgrad_partial_kernel`)
// stages a pixel tile's B strip and the A window it reads in shared memory
// and runs register-tile outer products (48 fp32 FMAs per four 16-byte
// shared reads), each staged A value used by every cb and each B value by
// 9·ca_t outputs; the pixel is found once per tile, not per FMA.  No tensor
// cores: plain TF32 would miss the gate's fp32 accuracy, and the kernel is
// first held to the CUDA-core bound.  Deterministic: each thread's fp32 sums
// run over ~10³ pixels, then go into its own float64 partial row in a fixed
// order; pass 2 (`wgrad_reduce_kernel`) adds the rows in order, in float64.
// No atomics.  The bias cotangent is the same reduction with an A row of
// ones, in the same launch.  The wrapper (plane_conv.py `wgrad3x3_plan`)
// picks the tiles, lanes and grid: 120-192 threads a block, 7.2-32.8 KB of
// shared memory at the main path's shapes; the build (-Xptxas -v) gives
// pass 1 139-145 registers and no spills, so two or three blocks an SM, at
// most one wave of them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CO_T = 4;
constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <int VEC>
__device__ __forceinline__ void load_in(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// Copies w (rows, cout) into shared memory as (rows, cop), zero past cout.
__device__ void stage_weights(const float* __restrict__ w, float* sw, int rows, int cout,
                              int cop) {
  for (int i = threadIdx.x; i < rows * cop; i += blockDim.x) {
    const int r = i / cop;
    const int co = i - r * cop;
    sw[i] = co < cout ? __ldg(w + (int64_t)r * cout + co) : 0.f;
  }
  __syncthreads();
}

// acc += Σ_ci in[ci] · sw[ci, co0 : co0 + CO_T] over one tap; sw points at
// (tap, 0, co0) of the staged (taps, Cin, cop) weights.  With GATE, in[ci]
// counts only where gate[ci] > 0 (the ReLU mask of a cotangent).
template <int VEC, bool GATE>
__device__ __forceinline__ void tap_fma(const float* __restrict__ in,
                                        const float* __restrict__ gate, const float* sw,
                                        int cin, int cop, float (&acc)[CO_T]) {
  for (int ci = 0; ci < cin; ci += VEC) {
    float v[VEC];
    load_in<VEC>(in + ci, v);
    if constexpr (GATE) {
      float m[VEC];
      load_in<VEC>(gate + ci, m);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = m[j] > 0.f ? v[j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float4 w4 = *reinterpret_cast<const float4*>(sw + (ci + j) * cop);
      acc[0] = fmaf(v[j], w4.x, acc[0]);
      acc[1] = fmaf(v[j], w4.y, acc[1]);
      acc[2] = fmaf(v[j], w4.z, acc[2]);
      acc[3] = fmaf(v[j], w4.w, acc[3]);
    }
  }
}

__device__ __forceinline__ void store_out(float* __restrict__ out, const float* skip, int co0,
                                          int cout, const float (&acc)[CO_T]) {
  if (co0 + CO_T <= cout && (cout % 4) == 0) {
    float4 o = make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (skip != nullptr) {
      const float4 s = __ldg(reinterpret_cast<const float4*>(skip));
      o.x += s.x; o.y += s.y; o.z += s.z; o.w += s.w;
    }
    *reinterpret_cast<float4*>(out) = o;
  } else {
    for (int k = 0; k < CO_T && co0 + k < cout; ++k)
      out[k] = acc[k] + (skip != nullptr ? __ldg(skip + k) : 0.f);
  }
}

// out[n, oy, ox, co] = act(bias[co] + Σ_{dy, dx, ci} in'[n, S·oy + dy − 1, S·ox + dx − 1, ci]
//                                                    · w[dy, dx, ci, co]),
// in' = in, or in · [gate > 0] with GATE (gate shaped as in)
template <int STRIDE, int VEC, bool GATE>
__global__ void __launch_bounds__(THREADS) conv3x3_kernel(
    const float* __restrict__ in, const float* __restrict__ gate, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int N, int H, int W, int Cin, int Ho,
    int Wo, int Cout, int relu) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  const int cop = round_up(Cout, CO_T);
  stage_weights(w, sw, 9 * Cin, Cout, cop);
  const int groups = cop / CO_T;
  const int64_t total = (int64_t)N * Ho * Wo * groups;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int co0 = (int)(t % groups) * CO_T;
    const int64_t pix = t / groups;  // (n·Ho + oy)·Wo + ox
    const int ox = (int)(pix % Wo);
    const int oy = (int)((pix / Wo) % Ho);
    const int64_t n = pix / ((int64_t)Wo * Ho);
    float acc[CO_T];
#pragma unroll
    for (int k = 0; k < CO_T; ++k)
      acc[k] = (bias != nullptr && co0 + k < Cout) ? __ldg(bias + co0 + k) : 0.f;
    for (int dy = 0; dy < 3; ++dy) {
      const int iy = oy * STRIDE + dy - 1;
      if (iy < 0 || iy >= H) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int ix = ox * STRIDE + dx - 1;
        if (ix < 0 || ix >= W) continue;
        const int64_t off = ((n * H + iy) * W + ix) * Cin;
        tap_fma<VEC, GATE>(in + off, gate + off, sw + (dy * 3 + dx) * Cin * cop + co0, Cin, cop,
                           acc);
      }
    }
    if (relu) {
#pragma unroll
      for (int k = 0; k < CO_T; ++k) acc[k] = fmaxf(acc[k], 0.f);
    }
    store_out(out + pix * Cout + co0, nullptr, co0, Cout, acc);
  }
}

// torch ConvTranspose2d(k=3, s=2, p=1, op=1), output (N, 2H, 2W, Cout):
//   out[oy] gathers in[iy] with ky = oy + 1 − 2·iy ∈ {0, 1, 2}, i.e.
//   oy = 2i: (iy = i, ky = 1);  oy = 2i + 1: (iy = i, ky = 2) and (iy = i + 1, ky = 0),
//   the latter only while i + 1 < H; the same for columns.  Then ReLU when
//   relu != 0 (written to act too when act is given), then + skip[n, oy, ox, co]
//   when skip is given.  w is (ky, kx, Cin, Cout); with GATE the input counts
//   only where gate > 0.
template <int VEC, bool GATE>
__global__ void __launch_bounds__(THREADS) deconv3x3_s2_kernel(
    const float* __restrict__ in, const float* __restrict__ gate, const float* __restrict__ w,
    const float* __restrict__ skip, float* __restrict__ out, float* __restrict__ act, int N,
    int H, int W, int Cin, int Cout, int relu) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);
  const int cop = round_up(Cout, CO_T);
  stage_weights(w, sw, 9 * Cin, Cout, cop);
  const int groups = cop / CO_T;
  const int Ho = 2 * H, Wo = 2 * W;
  const int64_t total = (int64_t)N * Ho * Wo * groups;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    const int co0 = (int)(t % groups) * CO_T;
    const int64_t pix = t / groups;
    const int ox = (int)(pix % Wo);
    const int oy = (int)((pix / Wo) % Ho);
    const int64_t n = pix / ((int64_t)Wo * Ho);
    float acc[CO_T] = {0.f, 0.f, 0.f, 0.f};
    const int ny = (oy & 1) ? 2 : 1;
    const int nx = (ox & 1) ? 2 : 1;
    for (int a = 0; a < ny; ++a) {
      const int iy = (oy >> 1) + a;
      const int ky = (oy & 1) ? (a ? 0 : 2) : 1;
      if (iy >= H) continue;
      for (int b = 0; b < nx; ++b) {
        const int ix = (ox >> 1) + b;
        const int kx = (ox & 1) ? (b ? 0 : 2) : 1;
        if (ix >= W) continue;
        const int64_t off = ((n * H + iy) * W + ix) * Cin;
        tap_fma<VEC, GATE>(in + off, gate + off, sw + (ky * 3 + kx) * Cin * cop + co0, Cin, cop,
                           acc);
      }
    }
    if (relu) {
#pragma unroll
      for (int k = 0; k < CO_T; ++k) acc[k] = fmaxf(acc[k], 0.f);
    }
    if (act != nullptr) store_out(act + pix * Cout + co0, nullptr, co0, Cout, acc);
    store_out(out + pix * Cout + co0, skip != nullptr ? skip + pix * Cout + co0 : nullptr, co0,
              Cout, acc);
  }
}

// Pass 1 of a 3×3 weight cotangent, a GEMM im2col(A')ᵀ·B' over the pixels.
// A = [a1 (ca1) | a2 (ca2)] (N, Ha, Wa, CA) images, B (N, Hb, Wb, CB)
// cotangents, stride S:
//   dw[dy, dx, ca, cb] = Σ_{n, y, x} A'[n, S·y + dy − 1, S·x + dx − 1, ca] · B'[n, y, x, cb]
// (taps outside A count 0), then with bias db[cb] = Σ B'[n, y, x, cb];
// A' = a1 · [amask > 0] with amask (only without a2), B' = B · [bmask > 0]
// with bmask.  Outputs o = (tap·CA + ca)·CB + cb, then the CB bias values.
//
// A pixel tile is tp consecutive pixels (n, y, x0 … x0 + tp − 1) of one row
// of B; tile t is (row, xt) = (t / nxt, t % nxt), row = n·Hb + y.  Block
// (x, y) owns the output tile of every tap × ca ∈ [ca0, ca0 + ca_t) × cb ∈
// [cb0, cb0 + cb_t) (blockIdx.y = ca tile · n_cb_tiles + cb tile) and walks
// pixel tiles [x·tpb, (x + 1)·tpb) in order.  Per tile it stages into shared
// memory the B strip (tp × cb_t, bmask applied, zero past the row's end) and
// the A window those pixels read (3 rows × (S·tp + 2) columns × ca_t, zero
// outside the image, amask and the concat resolved as it is staged).  Thread
// (lane, dy, ca4, cb4) holds a 3 × 4 × 4 register tile (dx, 4 ca, 4 cb) and
// runs outer products over pixels lane, lane + lanes, … of the tile: per
// pixel three float4 reads of A and one of B for 48 FMAs.  The thread with
// dy = 1, ca4 = 0 of a block of the first ca tile also sums B' (the bias, an
// A row of ones).  Each thread's fp32 sums run over at most `run` tiles
// (~10³ pixels), then are added into its own float64 row of `part` (row
// x·lanes + lane; written at the first flush, so no zeroing): fixed order,
// no atomics.
template <bool VA>
__device__ __forceinline__ float4 load_a4(const float* __restrict__ a1,
                                          const float* __restrict__ a2,
                                          const float* __restrict__ amask, int64_t n, int ay,
                                          int ax, int Ha, int Wa, int ca1, int ca2, int ca) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ay < 0 || ay >= Ha || ax < 0 || ax >= Wa) return v;
  const int64_t apix = (n * Ha + ay) * Wa + ax;
  if constexpr (VA) {  // ca1 % 4 == ca2 % 4 == 0: the group lies in a1, in a2 or past CA
    if (ca < ca1) {
      v = __ldg(reinterpret_cast<const float4*>(a1 + apix * ca1 + ca));
      if (amask != nullptr) {
        const float4 m = __ldg(reinterpret_cast<const float4*>(amask + apix * ca1 + ca));
        v.x = m.x > 0.f ? v.x : 0.f;
        v.y = m.y > 0.f ? v.y : 0.f;
        v.z = m.z > 0.f ? v.z : 0.f;
        v.w = m.w > 0.f ? v.w : 0.f;
      }
    } else if (ca < ca1 + ca2) {
      v = __ldg(reinterpret_cast<const float4*>(a2 + apix * ca2 + (ca - ca1)));
    }
  } else {
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = ca + k;
      t[k] = 0.f;
      if (c < ca1) {
        t[k] = __ldg(a1 + apix * ca1 + c);
        if (amask != nullptr && !(__ldg(amask + apix * ca1 + c) > 0.f)) t[k] = 0.f;
      } else if (c < ca1 + ca2) {
        t[k] = __ldg(a2 + apix * ca2 + (c - ca1));
      }
    }
    v = make_float4(t[0], t[1], t[2], t[3]);
  }
  return v;
}

template <bool VB>
__device__ __forceinline__ float4 load_b4(const float* __restrict__ b,
                                          const float* __restrict__ bmask, int64_t p, int CB,
                                          int cb) {
  float t[4];
  if constexpr (VB) {  // CB % 4 == 0
    const float4 v = __ldg(reinterpret_cast<const float4*>(b + p * CB + cb));
    t[0] = v.x; t[1] = v.y; t[2] = v.z; t[3] = v.w;
    if (bmask != nullptr) {
      const float4 m = __ldg(reinterpret_cast<const float4*>(bmask + p * CB + cb));
      t[0] = m.x > 0.f ? t[0] : 0.f;
      t[1] = m.y > 0.f ? t[1] : 0.f;
      t[2] = m.z > 0.f ? t[2] : 0.f;
      t[3] = m.w > 0.f ? t[3] : 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = cb + k;
      t[k] = 0.f;
      if (c < CB) {
        t[k] = __ldg(b + p * CB + c);
        if (bmask != nullptr && !(__ldg(bmask + p * CB + c) > 0.f)) t[k] = 0.f;
      }
    }
  }
  return make_float4(t[0], t[1], t[2], t[3]);
}

__device__ __forceinline__ void fma4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
    acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
    acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
    acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
  }
}

__device__ __forceinline__ void zero_tile(float (&acc)[3][4][4], float (&bacc)[4]) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[dx][i][j] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) bacc[j] = 0.f;
}

// Adds a thread's fp32 run sums (taps (dy, 0..2) × ca0..+3 × cb0..+3, and
// the bias cb0..+3 for the bias thread) into its float64 row of part (sets
// them at the first flush), then zeroes the run.
__device__ __forceinline__ void flush_tile(double* __restrict__ prow, float (&acc)[3][4][4],
                                           float (&bacc)[4], bool first, bool bias_thread,
                                           int dy, int ca0, int cb0, int CA, int CB) {
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (ca0 + i < CA && cb0 + j < CB) {
          const int o = ((dy * 3 + dx) * CA + ca0 + i) * CB + cb0 + j;
          prow[o] = first ? (double)acc[dx][i][j] : prow[o] + (double)acc[dx][i][j];
        }
      }
  if (bias_thread) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (cb0 + j < CB) {
        const int o = 9 * CA * CB + cb0 + j;
        prow[o] = first ? (double)bacc[j] : prow[o] + (double)bacc[j];
      }
    }
  }
  zero_tile(acc, bacc);
}

constexpr int WG_THREADS = 256;  // most threads of a block; the wrapper's plan stays under it

template <int S, bool VA, bool VB>
__global__ void __launch_bounds__(WG_THREADS) wgrad_partial_kernel(
    const float* __restrict__ a1, const float* __restrict__ a2, const float* __restrict__ amask,
    const float* __restrict__ b, const float* __restrict__ bmask, double* __restrict__ part,
    int Ha, int Wa, int ca1, int ca2, int Hb, int Wb, int CB, int bias, int tp, int ca_t,
    int cb_t, int lanes, int64_t n_tiles, int64_t tpb, int run, int n_out) {
  extern __shared__ float4 smem4[];
  const int CA = ca1 + ca2;
  const int nca4 = ca_t / 4, ncb4 = cb_t / 4;
  const int wcol = S * tp + 2;
  float4* As = smem4;                   // (3, wcol, nca4)
  float4* Bs = smem4 + 3 * wcol * nca4;  // (tp, ncb4)
  const int n_cb_tiles = (CB + cb_t - 1) / cb_t;
  const int ca0 = (int)(blockIdx.y / n_cb_tiles) * ca_t;
  const int cb0 = (int)(blockIdx.y % n_cb_tiles) * cb_t;
  int r = threadIdx.x;
  const int cb4 = r % ncb4;
  r /= ncb4;
  const int ca4 = r % nca4;
  r /= nca4;
  const int dy = r % 3;
  const int lane = r / 3;
  const bool bias_thread = bias && ca0 == 0 && dy == 1 && ca4 == 0;
  const int nxt = (Wb + tp - 1) / tp;
  const int n_a = 3 * wcol * nca4, n_b = tp * ncb4;
  double* prow = part + ((int64_t)blockIdx.x * lanes + lane) * n_out;

  float acc[3][4][4], bacc[4];
  bool first = true;
  zero_tile(acc, bacc);
  const int64_t t_begin = (int64_t)blockIdx.x * tpb;
  const int64_t t_end = t_begin + tpb < n_tiles ? t_begin + tpb : n_tiles;
  int in_run = 0;
  for (int64_t t = t_begin; t < t_end; ++t) {
    // the tile's pixels, found once per tile
    const int64_t row = t / nxt;  // n·Hb + y
    const int x0 = (int)(t - row * nxt) * tp;
    const int y = (int)(row % Hb);
    const int64_t n = row / Hb;
    const int tv = Wb - x0 < tp ? Wb - x0 : tp;
    __syncthreads();  // the previous tile's reads are done
    for (int i = threadIdx.x; i < n_a; i += blockDim.x) {
      const int g = i % nca4, rc = i / nca4;
      const int c = rc % wcol, rr = rc / wcol;
      As[i] = load_a4<VA>(a1, a2, amask, n, S * y + rr - 1, S * x0 + c - 1, Ha, Wa, ca1, ca2,
                          ca0 + 4 * g);
    }
    for (int i = threadIdx.x; i < n_b; i += blockDim.x) {
      const int g = i % ncb4, px = i / ncb4;
      Bs[i] = px < tv ? load_b4<VB>(b, bmask, row * Wb + x0 + px, CB, cb0 + 4 * g)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const float4* ap = As + dy * wcol * nca4 + ca4;
    for (int px = lane; px < tv; px += lanes) {
      const float4 bv = Bs[px * ncb4 + cb4];
      const float4* apx = ap + S * px * nca4;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) fma4(acc[dx], apx[dx * nca4], bv);
      if (bias_thread) {
        bacc[0] += bv.x; bacc[1] += bv.y; bacc[2] += bv.z; bacc[3] += bv.w;
      }
    }
    if (++in_run == run) {
      flush_tile(prow, acc, bacc, first, bias_thread, dy, ca0 + 4 * ca4, cb0 + 4 * cb4, CA, CB);
      first = false;
      in_run = 0;
    }
  }
  // every thread writes its row at least once
  if (in_run > 0 || first)
    flush_tile(prow, acc, bacc, first, bias_thread, dy, ca0 + 4 * ca4, cb0 + 4 * cb4, CA, CB);
}

// Pass 2: out[o] = Σ_r part[r, o], r in order, in float64.
__global__ void __launch_bounds__(THREADS) wgrad_reduce_kernel(const double* __restrict__ part,
                                                               float* __restrict__ out,
                                                               int rows, int n_out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  double s = 0.0;
  for (int r = 0; r < rows; ++r) s += part[(int64_t)r * n_out + o];
  out[o] = (float)s;
}

// Blocks for a grid-stride launch: the outputs' blocks, capped at what can be
// resident at once.  Returns 0 with *err set when the launch cannot be made.
template <typename K>
int64_t grid_blocks(K kernel, int smem, int64_t total, cudaError_t* err) {
  *err = cudaSuccess;
  if (smem > MAX_SMEM) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  if ((*err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if ((*err = cudaGetDevice(&dev))) return 0;
  if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return 0;
  if ((*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)))
    return 0;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  const int64_t want = (total + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)per_sm * sms;
  return want < cap ? want : cap;
}

template <int STRIDE, int VEC, bool GATE>
int launch_conv(const float* in, const float* gate, const float* w, const float* bias, float* out,
                int N, int H, int W, int Cin, int Cout, int relu, cudaStream_t st) {
  const int Ho = (H - 1) / STRIDE + 1, Wo = (W - 1) / STRIDE + 1;
  const int smem = 9 * Cin * round_up(Cout, CO_T) * (int)sizeof(float);
  const int64_t total = (int64_t)N * Ho * Wo * (round_up(Cout, CO_T) / CO_T);
  if (total == 0) return 0;
  cudaError_t err;
  const int64_t blocks = grid_blocks(conv3x3_kernel<STRIDE, VEC, GATE>, smem, total, &err);
  if (blocks == 0) return (int)err;
  conv3x3_kernel<STRIDE, VEC, GATE><<<(unsigned)blocks, THREADS, smem, st>>>(
      in, gate, w, bias, out, N, H, W, Cin, Ho, Wo, Cout, relu);
  return (int)cudaGetLastError();
}

template <int STRIDE, bool GATE>
int launch_conv_vec(bool vec, const float* in, const float* gate, const float* w,
                    const float* bias, float* out, int N, int H, int W, int Cin, int Cout,
                    int relu, cudaStream_t st) {
  return vec ? launch_conv<STRIDE, 4, GATE>(in, gate, w, bias, out, N, H, W, Cin, Cout, relu, st)
             : launch_conv<STRIDE, 1, GATE>(in, gate, w, bias, out, N, H, W, Cin, Cout, relu, st);
}

template <int VEC, bool GATE>
int launch_deconv(const float* in, const float* gate, const float* w, const float* skip,
                  float* out, float* act, int N, int H, int W, int Cin, int Cout, int relu,
                  cudaStream_t st) {
  const int smem = 9 * Cin * round_up(Cout, CO_T) * (int)sizeof(float);
  const int64_t total = (int64_t)N * 4 * H * W * (round_up(Cout, CO_T) / CO_T);
  if (total == 0) return 0;
  cudaError_t err;
  const int64_t blocks = grid_blocks(deconv3x3_s2_kernel<VEC, GATE>, smem, total, &err);
  if (blocks == 0) return (int)err;
  deconv3x3_s2_kernel<VEC, GATE><<<(unsigned)blocks, THREADS, smem, st>>>(
      in, gate, w, skip, out, act, N, H, W, Cin, Cout, relu);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// 3×3 conv, pad 1, stride 1 or 2: in (N, H, W, Cin), gate (shaped as in) or
// null, w (3, 3, Cin, Cout), bias (Cout) or null, out (N, ceil(H/stride),
// ceil(W/stride), Cout), ReLU when relu != 0.  With a gate, in counts only
// where gate > 0.  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
extern "C" int conv3x3_f32(const float* in, const float* gate, const float* w, const float* bias,
                           float* out, int N, int H, int W, int Cin, int Cout, int stride,
                           int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = Cin % 4 == 0 && aligned16(in) && (gate == nullptr || aligned16(gate));
  if (!aligned16(out)) return (int)cudaErrorMisalignedAddress;
  if (stride == 1)
    return gate ? launch_conv_vec<1, true>(vec, in, gate, w, bias, out, N, H, W, Cin, Cout, relu, st)
                : launch_conv_vec<1, false>(vec, in, gate, w, bias, out, N, H, W, Cin, Cout, relu,
                                            st);
  if (stride == 2)
    return gate ? launch_conv_vec<2, true>(vec, in, gate, w, bias, out, N, H, W, Cin, Cout, relu, st)
                : launch_conv_vec<2, false>(vec, in, gate, w, bias, out, N, H, W, Cin, Cout, relu,
                                            st);
  return (int)cudaErrorInvalidValue;
}

// ConvTranspose2d(k=3, s=2, p=1, op=1), then ReLU when relu != 0 (also
// written to act when act is not null), then + skip: in (N, H, W, Cin), gate
// (shaped as in) or null, w (3, 3, Cin, Cout), skip (N, 2H, 2W, Cout) or null,
// out and act (N, 2H, 2W, Cout).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int deconv3x3_s2_f32(const float* in, const float* gate, const float* w,
                                const float* skip, float* out, float* act, int N, int H, int W,
                                int Cin, int Cout, int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!aligned16(out) || (skip != nullptr && !aligned16(skip)) ||
      (act != nullptr && !aligned16(act)))
    return (int)cudaErrorMisalignedAddress;
  const bool vec = Cin % 4 == 0 && aligned16(in) && (gate == nullptr || aligned16(gate));
  if (gate != nullptr)
    return vec ? launch_deconv<4, true>(in, gate, w, skip, out, act, N, H, W, Cin, Cout, relu, st)
               : launch_deconv<1, true>(in, gate, w, skip, out, act, N, H, W, Cin, Cout, relu, st);
  return vec ? launch_deconv<4, false>(in, gate, w, skip, out, act, N, H, W, Cin, Cout, relu, st)
             : launch_deconv<1, false>(in, gate, w, skip, out, act, N, H, W, Cin, Cout, relu, st);
}

// 3×3 weight cotangent (see wgrad_partial_kernel): a1 (N, Ha, Wa, ca1), a2
// (N, Ha, Wa, ca2) or null (ca2 = 0), amask (shaped as a1; only without a2)
// or null, b (N, Hb, Wb, CB), bmask (shaped as b) or null, stride S ∈ {1, 2};
// out (9·(ca1 + ca2)·CB [+ CB when bias != 0]) = dw (3, 3, ca1 + ca2, CB)
// then db (CB).  The launch is the wrapper's plan (plane_conv.py
// `wgrad3x3_plan`): tiles of tp pixels, output tiles of ca_t × cb_t
// channels (multiples of 4), `lanes` pixel lanes, gx pixel ranges, fp32 runs
// of `run` tiles; part is float64 scratch of gx·lanes·len(out).  Two
// launches on `stream`, no atomics: the result is the same in every run.
// Returns cudaGetLastError() (0 = launched).
extern "C" int wgrad3x3_f32(const float* a1, const float* a2, const float* amask, const float* b,
                            const float* bmask, double* part, float* out, int N, int Ha, int Wa,
                            int ca1, int ca2, int Hb, int Wb, int CB, int S, int bias, int tp,
                            int ca_t, int cb_t, int lanes, int gx, int run, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int CA = ca1 + ca2;
  if (gx < 1 || CB < 1 || CA < 1 || (a2 == nullptr) != (ca2 == 0) ||
      (amask != nullptr && a2 != nullptr) || (S != 1 && S != 2) || tp < 1 || ca_t < 4 ||
      ca_t % 4 || cb_t < 4 || cb_t % 4 || lanes < 1 || run < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = lanes * 3 * (ca_t / 4) * (cb_t / 4);
  if (threads > WG_THREADS) return (int)cudaErrorInvalidConfiguration;
  const int smem = 16 * (3 * (S * tp + 2) * (ca_t / 4) + tp * (cb_t / 4));
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const int n_out = 9 * CA * CB + (bias ? CB : 0);
  const int64_t n_tiles = (int64_t)N * Hb * ((Wb + tp - 1) / tp);
  if (n_tiles == 0) return (int)cudaMemsetAsync(out, 0, sizeof(float) * n_out, st);
  const int64_t tpb = (n_tiles + gx - 1) / gx;
  const int gy = ((CA + ca_t - 1) / ca_t) * ((CB + cb_t - 1) / cb_t);
  const bool va = ca1 % 4 == 0 && ca2 % 4 == 0 && aligned16(a1) &&
                  (a2 == nullptr || aligned16(a2)) && (amask == nullptr || aligned16(amask));
  const bool vb = CB % 4 == 0 && aligned16(b) && (bmask == nullptr || aligned16(bmask));
  auto launch = [&](auto kernel) -> cudaError_t {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((unsigned)gx, (unsigned)gy), threads, smem, st>>>(
        a1, a2, amask, b, bmask, part, Ha, Wa, ca1, ca2, Hb, Wb, CB, bias, tp, ca_t, cb_t, lanes,
        n_tiles, tpb, run, n_out);
    return cudaGetLastError();
  };
  cudaError_t err;
  if (S == 1)
    err = va ? (vb ? launch(wgrad_partial_kernel<1, true, true>)
                   : launch(wgrad_partial_kernel<1, true, false>))
             : (vb ? launch(wgrad_partial_kernel<1, false, true>)
                   : launch(wgrad_partial_kernel<1, false, false>));
  else
    err = va ? (vb ? launch(wgrad_partial_kernel<2, true, true>)
                   : launch(wgrad_partial_kernel<2, true, false>))
             : (vb ? launch(wgrad_partial_kernel<2, false, true>)
                   : launch(wgrad_partial_kernel<2, false, false>));
  if (err != cudaSuccess) return (int)err;
  wgrad_reduce_kernel<<<(n_out + THREADS - 1) / THREADS, THREADS, 0, st>>>(part, out, gx * lanes,
                                                                           n_out);
  return (int)cudaGetLastError();
}
