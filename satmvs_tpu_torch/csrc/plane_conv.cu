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
// What bounds them on this card.  A 3×3 conv does 9·Cin multiply-adds per
// output value against 4·(Cin + Cout) bytes per pixel.  Of the 42 calls of a
// 384×768 train step (21 forwards, 21 dx), 27 are bound by bytes (the wide
// planes at 1-16 channels: the encoder's first conv, the decoder's last, the
// head) and 15 by the fp32 FMA rate (16 → 32 and 32 → 64 down the encoder,
// 64 → 32 up the decoder, and those shapes' dx); each call's bound is
// 10-68 µs.
//
// Design: direct convolution on the CUDA cores in fp32 (no tensor cores:
// plain TF32 would miss the gates' fp32 accuracy), one plain grid of
// (tile, slab, image) blocks, the launch plan chosen in Python
// (ops/kernels/plane_conv.py `plane_conv_plan`).
//   * A block owns a tile of output pixels (conv: tile_rows × tx outputs;
//     transposed: tile_rows × tx input pixels, each the quad of outputs
//     (2i + a, 2j + b) it feeds) and a slab of co_s ≤ 64 output channels.
//   * It stages in shared memory, by cp.async with zeros outside the plane
//     (a zero source size), the input window its tile reads, ck input
//     channels at a time, as planes of VEC channels (VEC = 4: 16-byte copies
//     where Cin % 4 == 0 and the pointers are aligned), columns of a stride-2
//     window split into even and odd halves so neighbouring lanes read
//     neighbouring words; and only its slab's weights, (ci, tap, co) with
//     the two float4 of a thread's 8 channels a lane apart.  The inner loop
//     has no bounds branch.
//   * A dx's ReLU mask is applied once per element as it is staged: the
//     cotangent and the gate are each copied once, then each thread masks
//     the words it copied, so dz = g·[gate > 0] is formed once.
//   * Register tiles: a conv thread owns CONV_P = 4 output rows of one column
//     × CO_T = 8 channels (one weight float4 feeds 4 pixels, one staged input
//     float4 8 channels: 128 FMAs per 12 shared reads); a transposed-conv
//     thread owns QUAD_Q = 2 input pixels of one column and all four output
//     phases of each × CO_T channels, and reads the staged 3 × 2
//     neighbourhood once per channel group: the nine taps' products come
//     from it, 16 FMAs per weight float4 pair, and no warp diverges on
//     parity.  torch's index map falls out of the window: the last row and
//     column have no i + 1 tap because the window holds zeros there.
//   * Cout = 1 (the head) takes CO_T = 1, so nothing is padded; Cin = 1 (the
//     head's dx) stages single channels (VEC = 1).
//   * Deterministic: each output's sum runs over (channel group, tap,
//     channel) in one fixed order, the same for every plan; no atomics.
//
// Backward.  Every dx is a gather of the same two kinds, so it runs through
// the forward kernels with rearranged weights (the wrapper permutes and flips
// them) and a gate.  conv_dn's gate is its saved output y (y > 0 is exactly
// relu′).  deconv_up's output is relu(z) + skip, from which the mask cannot
// be read (a tiny positive z that the skip add rounds away would read as 0),
// so when a gradient is wanted the forward also writes relu(z) to a second
// buffer, and that is the gate: one more output-sized write in the forward
// and that buffer kept until the backward (the alternative, recomputing z in
// the backward, costs the whole forward conv again).  dx of conv_dn is
// torch's conv_transpose2d(p=1, op=1) geometry, which is the transpose of the
// stride-2 conv only for even H and W; the wrapper raises on odd sizes.
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

constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90
constexpr int CONV_P = 4;         // output rows a conv thread owns
constexpr int QUAD_Q = 2;         // input rows (rows of output quads) a transposed-conv thread owns
constexpr int MAX_SLAB = 64;      // output channels a block owns at most

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// An asynchronous copy of 16 or 4 bytes from global to shared memory (zeros
// when !valid; src must still be a valid address), completed by
// cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Words of shared memory a launch stages: the input window (twice with a
// gate: the cotangent and its mask), rounded up to whole float4, then the
// slab's weights of one chunk.  The window is (S·(rows − 1) + 3) ×
// (S·(tx − 1) + 3) for a conv of `rows` output rows, (rows + 1) × (tx + 1)
// for a transposed conv of `rows` input rows.  plane_conv.py
// `plane_conv_smem` is the same formula.
__host__ __device__ inline int window_rows(bool transposed, int stride, int rows) {
  return transposed ? rows + 1 : stride * (rows - 1) + 3;
}
__host__ __device__ inline int window_cols(bool transposed, int stride, int tx) {
  return transposed ? tx + 1 : stride * (tx - 1) + 3;
}
__host__ __device__ inline int window_words(bool transposed, int stride, int rows, int tx, int ck) {
  return round_up(ck * window_rows(transposed, stride, rows) * window_cols(transposed, stride, tx),
                  4);
}
__host__ __device__ inline int smem_bytes(bool transposed, int stride, bool gate, int rows, int tx,
                                          int ck, int co_s) {
  return 4 * (window_words(transposed, stride, rows, tx, ck) * (gate ? 2 : 1) + 9 * ck * co_s);
}

// Staged column of window column c: a stride-2 window keeps its even
// columns, then its odd ones (half = the even count), so lanes of
// neighbouring output columns read neighbouring words.
template <int S>
__device__ __forceinline__ int win_col(int c, int half) {
  if constexpr (S == 2) return (c & 1) ? half + (c >> 1) : (c >> 1);
  return c;
}

// Calls f(g, r, c) for every channel group g < ng and pixel (r, c) of a wr ×
// wc window, spread over the block's threads: channel group fastest, so
// neighbouring threads take neighbouring words.  A thread keeps its group
// and walks the pixels with a fixed step, so no index is divided in the
// loop (threads past the last whole set of ng take none).
template <typename F>
__device__ __forceinline__ void for_window(int ng, int wr, int wc, F&& f) {
  const int step = blockDim.x / ng;
  const int g = threadIdx.x % ng;
  int p = threadIdx.x / ng;
  if (p >= step) return;
  const int rstep = step / wc, cstep = step - rstep * wc;
  int r = p / wc, c = p - r * wc;
  while (r < wr) {
    f(g, r, c);
    c += cstep;
    r += rstep;
    if (c >= wc) {
      c -= wc;
      ++r;
    }
  }
}

// Copies channels [ci0, ci0 + VEC·ng) (zero past Cin) of window rows gy0 …
// gy0 + wr − 1 and columns gx0 … gx0 + wc − 1 of image n (zero outside the
// plane) into s as ng planes (wr, wc) of VEC channels.
template <int VEC, int S>
__device__ __forceinline__ void stage_window(const float* __restrict__ src, float* s, int64_t n,
                                             int H, int W, int Cin, int ci0, int ng, int gy0,
                                             int gx0, int wr, int wc) {
  const int half = (wc + 1) >> 1;
  const float* img = src + n * H * W * Cin;
  for_window(ng, wr, wc, [&](int g, int r, int c) {
    const int gy = gy0 + r, gx = gx0 + c, ch = ci0 + g * VEC;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && ch < Cin;
    const float* p = ok ? img + ((int64_t)gy * W + gx) * Cin + ch : src;
    float* d = s + ((g * wr + r) * wc + win_col<S>(c, half)) * VEC;
    if constexpr (VEC == 4) cp_async16(d, p, ok);
    else cp_async4(d, p, ok);
  });
}

// After stage_window of the cotangent into s and of its gate into m (and
// cp_async_wait): s = s·[m > 0] on the words this thread copied, so each
// element is masked once.
template <int VEC, int S>
__device__ __forceinline__ void mask_window(float* s, const float* m, int ng, int wr, int wc) {
  const int half = (wc + 1) >> 1;
  for_window(ng, wr, wc, [&](int g, int r, int c) {
    const int o = ((g * wr + r) * wc + win_col<S>(c, half)) * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) s[o + k] = m[o + k] > 0.f ? s[o + k] : 0.f;
  });
}

// Staged position of slab channel co of a block with lcn channel lanes:
// with CO_T = 8 a lane's two float4 sit lcn float4 apart, so one warp-wide
// read of either touches neighbouring words.
template <int CO_T>
__device__ __forceinline__ int w_pos(int co, int lcn) {
  if constexpr (CO_T == 8) return (((co >> 2) & 1) * lcn + (co >> 3)) * 4 + (co & 3);
  return co;
}

// Copies w[tap, ci0 + ci, co0 + co] of w (3, 3, Cin, Cout) for ci < nci and
// co < co_s (zero past Cin and Cout) into s_w[(ci·9 + tap)·co_s + w_pos(co)];
// four channels a copy when wvec (Cout % 4 == 0, co_s % 4 == 0, w aligned).
template <int CO_T>
__device__ __forceinline__ void stage_weights(const float* __restrict__ w, float* s_w, int Cin,
                                              int Cout, int ci0, int nci, int co0, int co_s,
                                              bool wvec) {
  const int lcn = co_s / CO_T;
  const int per = wvec ? 4 : 1;
  // a thread keeps one run of `per` channels and walks the (ci, tap) rows
  for_window(co_s / per, nci * 9, 1, [&](int q, int row, int) {
    const int co = q * per, tap = row % 9, ci = row / 9;
    const bool ok = ci0 + ci < Cin && co0 + co < Cout;
    const float* p = ok ? w + ((int64_t)tap * Cin + ci0 + ci) * Cout + co0 + co : w;
    float* d = s_w + row * co_s + w_pos<CO_T>(co, lcn);
    if (wvec) cp_async16(d, p, ok);
    else cp_async4(d, p, ok);
  });
}

template <int VEC>
__device__ __forceinline__ void load_v(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

// A thread's CO_T weights of one (ci, tap) row of the staged slab.
template <int CO_T>
__device__ __forceinline__ void load_w(const float* row, int lc, int lcn, float (&wv)[CO_T]) {
  if constexpr (CO_T == 8) {
    const float4 a = *reinterpret_cast<const float4*>(row + 4 * lc);
    const float4 b = *reinterpret_cast<const float4*>(row + 4 * (lcn + lc));
    wv[0] = a.x; wv[1] = a.y; wv[2] = a.z; wv[3] = a.w;
    wv[4] = b.x; wv[5] = b.y; wv[6] = b.z; wv[7] = b.w;
  } else {
    wv[0] = row[lc];
  }
}

// Writes v[0 … CO_T) to o[0 …) for the channels co < Cout (plus skip when
// given); float4 stores when all CO_T are in range and Cout % 4 == 0.
template <int CO_T>
__device__ __forceinline__ void store_out(float* __restrict__ o, const float* __restrict__ skip,
                                          int co, int Cout, const float (&v)[CO_T]) {
  if (CO_T % 4 == 0 && co + CO_T <= Cout && Cout % 4 == 0) {
#pragma unroll
    for (int j = 0; j < CO_T; j += 4) {
      float4 t = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      if (skip != nullptr) {
        const float4 s = __ldg(reinterpret_cast<const float4*>(skip + j));
        t.x += s.x; t.y += s.y; t.z += s.z; t.w += s.w;
      }
      *reinterpret_cast<float4*>(o + j) = t;
    }
  } else {
#pragma unroll
    for (int j = 0; j < CO_T; ++j)
      if (co + j < Cout) o[j] = v[j] + (skip != nullptr ? __ldg(skip + j) : 0.f);
  }
}

// out[n, oy, ox, co] = act(bias[co] + Σ_{ci, dy, dx} in'[n, S·oy + dy − 1, S·ox + dx − 1, ci]
//                                                    · w[dy, dx, ci, co]),
// in' = in, or in · [gate > 0] with GATE (gate shaped as in); act = ReLU when
// relu != 0.  Block (tile, slab, n): output rows y0 … y0 + CONV_P·ty_n − 1,
// columns x0 … x0 + tx_n − 1, channels co0 … co0 + co_s − 1; thread (lc,
// txi, tyi), lc fastest, owns rows y0 + CONV_P·tyi + p (p < CONV_P) of
// column x0 + txi and channels co0 + CO_T·lc + j (j < CO_T).  The sum runs
// over channel groups of VEC, then taps, then the group's channels.
template <int S, int VEC, bool GATE, int CO_T>
__global__ void __launch_bounds__(THREADS, 2) conv3x3_kernel(
    const float* __restrict__ in, const float* __restrict__ gate, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int H, int W, int Cin, int Ho, int Wo,
    int Cout, int relu, int co_s, int tx_n, int ty_n, int ck, int wvec) {
  extern __shared__ float4 smem4[];
  float* s_in = reinterpret_cast<float*>(smem4);
  const int rows = CONV_P * ty_n;
  const int wr = window_rows(false, S, rows), wc = window_cols(false, S, tx_n);
  const int words = window_words(false, S, rows, tx_n, ck);
  float* s_gate = s_in + words;
  float* s_w = s_in + (GATE ? 2 : 1) * words;
  const int lcn = co_s / CO_T;
  const int lc = threadIdx.x % lcn, txi = (threadIdx.x / lcn) % tx_n;
  const int tyi = threadIdx.x / (lcn * tx_n);
  const int ntx = (Wo + tx_n - 1) / tx_n;
  const int y0 = (int)(blockIdx.x / ntx) * rows, x0 = (int)(blockIdx.x % ntx) * tx_n;
  const int co0 = blockIdx.y * co_s, co = co0 + CO_T * lc;
  const int64_t n = blockIdx.z;
  const int half = (wc + 1) >> 1;
  const int plane = wr * wc * VEC;

  float acc[CONV_P][CO_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j) {
    const float b = (bias != nullptr && co + j < Cout) ? __ldg(bias + co + j) : 0.f;
#pragma unroll
    for (int p = 0; p < CONV_P; ++p) acc[p][j] = b;
  }
  for (int ci0 = 0; ci0 < Cin; ci0 += ck) {
    const int nci = min(ck, Cin - ci0);
    const int ng = (nci + VEC - 1) / VEC;
    __syncthreads();  // the previous chunk's reads are done
    stage_window<VEC, S>(in, s_in, n, H, W, Cin, ci0, ng, S * y0 - 1, S * x0 - 1, wr, wc);
    if constexpr (GATE)
      stage_window<VEC, S>(gate, s_gate, n, H, W, Cin, ci0, ng, S * y0 - 1, S * x0 - 1, wr, wc);
    stage_weights<CO_T>(w, s_w, Cin, Cout, ci0, ng * VEC, co0, co_s, wvec);
    cp_async_wait();
    if constexpr (GATE) mask_window<VEC, S>(s_in, s_gate, ng, wr, wc);
    __syncthreads();
    for (int g = 0; g < ng; ++g) {
      const float* sg = s_in + g * plane + (S * CONV_P * tyi * wc) * VEC;
      const float* wg = s_w + g * VEC * 9 * co_s;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int col = S == 2 ? (dx == 1 ? half + txi : txi + (dx >> 1)) : txi + dx;
          float v[CONV_P][VEC];
#pragma unroll
          for (int p = 0; p < CONV_P; ++p) load_v<VEC>(sg + ((S * p + dy) * wc + col) * VEC, v[p]);
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            float wv[CO_T];
            load_w<CO_T>(wg + (k * 9 + dy * 3 + dx) * co_s, lc, lcn, wv);
#pragma unroll
            for (int p = 0; p < CONV_P; ++p)
#pragma unroll
              for (int j = 0; j < CO_T; ++j) acc[p][j] = fmaf(v[p][k], wv[j], acc[p][j]);
          }
        }
      }
    }
  }
  const int ox = x0 + txi;
#pragma unroll
  for (int p = 0; p < CONV_P; ++p) {
    const int oy = y0 + CONV_P * tyi + p;
    if (oy >= Ho || ox >= Wo || co >= Cout) continue;
    if (relu) {
#pragma unroll
      for (int j = 0; j < CO_T; ++j) acc[p][j] = fmaxf(acc[p][j], 0.f);
    }
    store_out<CO_T>(out + ((n * Ho + oy) * Wo + ox) * Cout + co, nullptr, co, Cout, acc[p]);
  }
}

// torch ConvTranspose2d(k=3, s=2, p=1, op=1), output (N, 2H, 2W, Cout), by
// output quads: input pixel (i, j) feeds out[2i + a, 2j + b] through
//   (a, b) = (0, 0): in[i, j]·w[1, 1]
//            (0, 1): in[i, j]·w[1, 2] + in[i, j + 1]·w[1, 0]
//            (1, 0): in[i, j]·w[2, 1] + in[i + 1, j]·w[0, 1]
//            (1, 1): in[i, j]·w[2, 2] + in[i, j + 1]·w[2, 0] + in[i + 1, j]·w[0, 2]
//                    + in[i + 1, j + 1]·w[0, 0],
// the i + 1 and j + 1 terms only inside the plane (the staged window holds
// zeros past it), w (ky, kx, Cin, Cout).  Then ReLU when relu != 0 (written
// to act too when act is given), then + skip[n, oy, ox, co] when skip is
// given.  With GATE the input counts only where gate > 0.  Block (tile,
// slab, n): input rows i0 … i0 + QUAD_Q·ty_n − 1, columns j0 … j0 + tx_n −
// 1; thread (lc, txi, tyi) owns input rows i0 + QUAD_Q·tyi + q (q < QUAD_Q)
// of column j0 + txi, all four phases of each, and CO_T channels.  The sum
// runs over channel groups of VEC, then taps (ky, kx), then the group's
// channels.
template <int VEC, bool GATE, int CO_T>
__global__ void __launch_bounds__(THREADS, 2) deconv3x3_s2_kernel(
    const float* __restrict__ in, const float* __restrict__ gate, const float* __restrict__ w,
    const float* __restrict__ skip, float* __restrict__ out, float* __restrict__ act, int H, int W,
    int Cin, int Cout, int relu, int co_s, int tx_n, int ty_n, int ck, int wvec) {
  extern __shared__ float4 smem4[];
  float* s_in = reinterpret_cast<float*>(smem4);
  const int rows = QUAD_Q * ty_n;
  const int wr = window_rows(true, 2, rows), wc = window_cols(true, 2, tx_n);
  const int words = window_words(true, 2, rows, tx_n, ck);
  float* s_gate = s_in + words;
  float* s_w = s_in + (GATE ? 2 : 1) * words;
  const int lcn = co_s / CO_T;
  const int lc = threadIdx.x % lcn, txi = (threadIdx.x / lcn) % tx_n;
  const int tyi = threadIdx.x / (lcn * tx_n);
  const int ntx = (W + tx_n - 1) / tx_n;
  const int i0 = (int)(blockIdx.x / ntx) * rows, j0 = (int)(blockIdx.x % ntx) * tx_n;
  const int co0 = blockIdx.y * co_s, co = co0 + CO_T * lc;
  const int64_t n = blockIdx.z;
  const int plane = wr * wc * VEC;

  float acc[QUAD_Q][2][2][CO_T];
#pragma unroll
  for (int q = 0; q < QUAD_Q; ++q)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int j = 0; j < CO_T; ++j) acc[q][a][b][j] = 0.f;
  for (int ci0 = 0; ci0 < Cin; ci0 += ck) {
    const int nci = min(ck, Cin - ci0);
    const int ng = (nci + VEC - 1) / VEC;
    __syncthreads();  // the previous chunk's reads are done
    stage_window<VEC, 1>(in, s_in, n, H, W, Cin, ci0, ng, i0, j0, wr, wc);
    if constexpr (GATE) stage_window<VEC, 1>(gate, s_gate, n, H, W, Cin, ci0, ng, i0, j0, wr, wc);
    stage_weights<CO_T>(w, s_w, Cin, Cout, ci0, ng * VEC, co0, co_s, wvec);
    cp_async_wait();
    if constexpr (GATE) mask_window<VEC, 1>(s_in, s_gate, ng, wr, wc);
    __syncthreads();
    for (int g = 0; g < ng; ++g) {
      const float* sg = s_in + g * plane + (QUAD_Q * tyi * wc + txi) * VEC;
      const float* wg = s_w + g * VEC * 9 * co_s;
      float v[QUAD_Q + 1][2][VEC];  // the staged neighbourhood, rows then columns
#pragma unroll
      for (int r = 0; r <= QUAD_Q; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) load_v<VEC>(sg + (r * wc + c) * VEC, v[r][c]);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const int a = ky == 1 ? 0 : 1, di = ky == 0 ? 1 : 0;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int b = kx == 1 ? 0 : 1, dj = kx == 0 ? 1 : 0;
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            float wv[CO_T];
            load_w<CO_T>(wg + (k * 9 + ky * 3 + kx) * co_s, lc, lcn, wv);
#pragma unroll
            for (int q = 0; q < QUAD_Q; ++q)
#pragma unroll
              for (int j = 0; j < CO_T; ++j)
                acc[q][a][b][j] = fmaf(v[q + di][dj][k], wv[j], acc[q][a][b][j]);
          }
        }
      }
    }
  }
  const int jj = j0 + txi;
#pragma unroll
  for (int q = 0; q < QUAD_Q; ++q) {
    const int i = i0 + QUAD_Q * tyi + q;
    if (i >= H || jj >= W || co >= Cout) continue;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (relu) {
#pragma unroll
          for (int j = 0; j < CO_T; ++j) acc[q][a][b][j] = fmaxf(acc[q][a][b][j], 0.f);
        }
        const int64_t o = ((n * 2 * H + 2 * i + a) * 2 * W + 2 * jj + b) * Cout + co;
        if (act != nullptr) store_out<CO_T>(act + o, nullptr, co, Cout, acc[q][a][b]);
        store_out<CO_T>(out + o, skip != nullptr ? skip + o : nullptr, co, Cout, acc[q][a][b]);
      }
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
// memory the B strip (tp × cb_t, bmask applied, zero past the row's end and
// past CB) and the A window those pixels read (3 rows × (S·tp + 2) columns ×
// ca_t, zero outside the image, amask and the concat resolved as it is
// staged).  Thread (lane, dy, ca4, cb4) holds a 3 × 4 × 4 register tile (dx,
// 4 ca, 4 cb) and runs outer products over pixels lane, lane + lanes, … of
// the tile: per pixel three float4 reads of A and one of B for 48 FMAs.  The
// thread with dy = 1, ca4 = 0 of a block of the first ca tile also sums B'
// (the bias, an A row of ones).  Each thread's fp32 sums run over at most
// `run` tiles (~10³ pixels), then are added into its own float64 row of
// `part` (row x·lanes + lane; written at the first flush, so no zeroing):
// fixed order, no atomics.
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
  if constexpr (VB) {  // CB % 4 == 0: the group lies in the row or past CB
    // a last cb tile may reach past CB (CB = 264 in tiles of 32): those
    // groups are zeros, not the next pixel's channels or, at B's last pixel,
    // memory past its end
    if (cb >= CB) return make_float4(0.f, 0.f, 0.f, 0.f);
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

using ConvKernel = void (*)(const float*, const float*, const float*, const float*, float*, int,
                            int, int, int, int, int, int, int, int, int, int, int);
using DeconvKernel = void (*)(const float*, const float*, const float*, const float*, float*,
                              float*, int, int, int, int, int, int, int, int, int, int);

template <int S, int VEC, bool GATE>
ConvKernel conv_co(int co_t) {
  return co_t == 8 ? conv3x3_kernel<S, VEC, GATE, 8>
                   : co_t == 1 ? conv3x3_kernel<S, VEC, GATE, 1> : nullptr;
}

// The conv3x3_kernel instance of (stride, VEC, gate, CO_T), or null.
ConvKernel conv_instance(int stride, int vec, bool gate, int co_t) {
  if (stride == 1 && vec == 4) return gate ? conv_co<1, 4, true>(co_t) : conv_co<1, 4, false>(co_t);
  if (stride == 1 && vec == 1) return gate ? conv_co<1, 1, true>(co_t) : conv_co<1, 1, false>(co_t);
  if (stride == 2 && vec == 4) return gate ? conv_co<2, 4, true>(co_t) : conv_co<2, 4, false>(co_t);
  if (stride == 2 && vec == 1) return gate ? conv_co<2, 1, true>(co_t) : conv_co<2, 1, false>(co_t);
  return nullptr;
}

template <int VEC, bool GATE>
DeconvKernel deconv_co(int co_t) {
  return co_t == 8 ? deconv3x3_s2_kernel<VEC, GATE, 8>
                   : co_t == 1 ? deconv3x3_s2_kernel<VEC, GATE, 1> : nullptr;
}

DeconvKernel deconv_instance(int vec, bool gate, int co_t) {
  if (vec == 4) return gate ? deconv_co<4, true>(co_t) : deconv_co<4, false>(co_t);
  if (vec == 1) return gate ? deconv_co<1, true>(co_t) : deconv_co<1, false>(co_t);
  return nullptr;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The launch of a plan (plane_conv.py `plane_conv_plan`): block threads
// (co_s / co_t)·tx·ty, grid (tiles, slabs, N); 0 when the plan is one the
// kernels take and `smem` is its shared memory, else the CUDA error.
cudaError_t check_plan(bool transposed, int stride, int N, int rows_in, int cols_in, int Cin,
                       int Cout, bool gate, int vec, int co_t, int co_s, int tx, int ty, int ck,
                       int smem, dim3* grid, int* threads) {
  if (N < 1 || rows_in < 1 || cols_in < 1 || Cin < 1 || Cout < 1 || (vec != 1 && vec != 4) ||
      (co_t != 1 && co_t != 8) || co_s < co_t || co_s % co_t || co_s > MAX_SLAB || tx < 1 ||
      ty < 1 || ck < vec || ck % vec || (vec == 4 && Cin % 4))
    return cudaErrorInvalidValue;
  *threads = co_s / co_t * tx * ty;
  if (*threads > THREADS || *threads % 32) return cudaErrorInvalidConfiguration;
  const int rows = ty * (transposed ? QUAD_Q : CONV_P);
  if (smem != smem_bytes(transposed, stride, gate, rows, tx, ck, co_s) || smem > MAX_SMEM)
    return cudaErrorInvalidValue;
  const int64_t tiles = (int64_t)((rows_in + rows - 1) / rows) * ((cols_in + tx - 1) / tx);
  const int slabs = (Cout + co_s - 1) / co_s;
  if (tiles > 0x7fffffff || slabs > 65535 || N > 65535) return cudaErrorInvalidConfiguration;
  *grid = dim3((unsigned)tiles, (unsigned)slabs, (unsigned)N);
  return cudaSuccess;
}

}  // namespace

// Lets the kernel instance of (transposed, stride, vec, gate, co_t) use
// `smem` bytes of dynamic shared memory on the current device: the wrapper
// calls it once per instance and size, not per launch.  Returns the CUDA
// error (0 = set).
extern "C" int plane_conv_prepare(int transposed, int stride, int vec, int gate, int co_t,
                                  int smem) {
  if (smem < 0 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const void* k = !transposed ? (const void*)conv_instance(stride, vec, gate, co_t)
                  : stride == 2 ? (const void*)deconv_instance(vec, gate, co_t) : nullptr;
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// 3×3 conv, pad 1, stride 1 or 2: in (N, H, W, Cin), gate (shaped as in) or
// null, w (3, 3, Cin, Cout), bias (Cout) or null, out (N, ceil(H/stride),
// ceil(W/stride), Cout), ReLU when relu != 0.  With a gate, in counts only
// where gate > 0.  The launch is the wrapper's plan (plane_conv.py
// `plane_conv_plan`): vec (4: Cin % 4 == 0 and in, gate 16-byte aligned),
// co_t (8, or 1 for Cout = 1), slab co_s, tile tx × 4·ty outputs, chunks of
// ck input channels, smem bytes (set by plane_conv_prepare).  Launches on
// `stream`, no atomics: the result is the same in every run and under every
// plan.  Returns cudaGetLastError() (0 = launched).
extern "C" int conv3x3_f32(const float* in, const float* gate, const float* w, const float* bias,
                           float* out, int N, int H, int W, int Cin, int Cout, int stride,
                           int relu, int vec, int co_t, int co_s, int tx, int ty, int ck, int smem,
                           void* stream) {
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  dim3 grid;
  int threads;
  cudaError_t err = check_plan(false, stride, N, Ho, Wo, Cin, Cout, gate != nullptr, vec, co_t,
                               co_s, tx, ty, ck, smem, &grid, &threads);
  if (err != cudaSuccess) return (int)err;
  if (!aligned16(out) ||
      (vec == 4 && (!aligned16(in) || (gate != nullptr && !aligned16(gate)))))
    return (int)cudaErrorMisalignedAddress;
  const ConvKernel k = conv_instance(stride, vec, gate != nullptr, co_t);
  const int wvec = Cout % 4 == 0 && co_s % 4 == 0 && aligned16(w);
  k<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, gate, w, bias, out, H, W, Cin, Ho, Wo, Cout, relu, co_s, tx, ty, ck, wvec);
  return (int)cudaGetLastError();
}

// ConvTranspose2d(k=3, s=2, p=1, op=1), then ReLU when relu != 0 (also
// written to act when act is not null), then + skip: in (N, H, W, Cin), gate
// (shaped as in) or null, w (3, 3, Cin, Cout), skip (N, 2H, 2W, Cout) or null,
// out and act (N, 2H, 2W, Cout).  The plan as for conv3x3_f32, the tile tx ×
// 2·ty input pixels.  Launches on `stream`, no atomics.  Returns
// cudaGetLastError() (0 = launched).
extern "C" int deconv3x3_s2_f32(const float* in, const float* gate, const float* w,
                                const float* skip, float* out, float* act, int N, int H, int W,
                                int Cin, int Cout, int relu, int vec, int co_t, int co_s, int tx,
                                int ty, int ck, int smem, void* stream) {
  dim3 grid;
  int threads;
  cudaError_t err = check_plan(true, 2, N, H, W, Cin, Cout, gate != nullptr, vec, co_t, co_s, tx,
                               ty, ck, smem, &grid, &threads);
  if (err != cudaSuccess) return (int)err;
  if (!aligned16(out) || (skip != nullptr && !aligned16(skip)) ||
      (act != nullptr && !aligned16(act)) ||
      (vec == 4 && (!aligned16(in) || (gate != nullptr && !aligned16(gate)))))
    return (int)cudaErrorMisalignedAddress;
  const DeconvKernel k = deconv_instance(vec, gate != nullptr, co_t);
  const int wvec = Cout % 4 == 0 && co_s % 4 == 0 && aligned16(w);
  k<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, gate, w, skip, out, act, H, W, Cin, Cout, relu, co_s, tx, ty, ck, wvec);
  return (int)cudaGetLastError();
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
