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
// weight and bias cotangent is `wgrad_partial_kernel` + `wgrad_reduce_kernel`.
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
// shape) into 9·Cin·Cout values (at most 18,432).  They are deterministic:
// no atomics.  Pass 1 (`wgrad_partial_kernel`): a 2-D grid of (pixel
// ranges) × (output ranges); a thread owns one (tap, ca) and 4 consecutive cb
// (or 1 where CB % 4 != 0) and sums over a strided share of its block's
// pixels in float32; the block's lanes are added in a fixed order and written
// as the block's partial sums.  Pass 2 (`wgrad_reduce_kernel`): one thread per
// output adds the pixel ranges' partials in order, in float64.  The bias
// cotangent is the same reduction with the A operand taken as 1, in the same
// launch.  The A operand may be the channel concat of two tensors, so the
// ConvGRU's concat-convs (satmvs_tpu_torch/csrc/red_recur.cu) take their
// weight cotangents from this kernel too.

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

// Pass 1 of a 3×3 weight cotangent.  A = [a1 (ca1) | a2 (ca2)] (N, Ha, Wa, CA)
// images, B (N, Hb, Wb, CB) cotangents, stride S:
//   dw[tap, ca, cb] = Σ_{n, by, bx} A'[n, S·by + dy − 1, S·bx + dx − 1, ca] · B'[n, by, bx, cb]
// (taps outside A count 0), then with bias db[cb] = Σ B'[n, by, bx, cb];
// A' = a1 · [amask > 0] with amask (only without a2), B' = B · [bmask > 0]
// with bmask.  Outputs o = (tap·CA + ca)·CB + cb, then the CB bias values;
// a chunk is K consecutive outputs (K | CB).  Block (x, y) sums pixels
// [x·ppb, (x + 1)·ppb) into chunks [y·cpb, (y + 1)·cpb): thread t holds chunk
// y·cpb + t % cpb and pixel lane t / cpb of lanes = THREADS / cpb; the lanes
// are added in order and the block writes part[x, o].
template <int K>
__global__ void __launch_bounds__(THREADS) wgrad_partial_kernel(
    const float* __restrict__ a1, const float* __restrict__ a2, const float* __restrict__ amask,
    const float* __restrict__ b, const float* __restrict__ bmask, float* __restrict__ part,
    int Ha, int Wa, int ca1, int ca2, int Hb, int Wb, int CB, int S, int64_t npix, int64_t ppb,
    int n_w_chunks, int n_chunks, int cpb, int n_out) {
  __shared__ float red[THREADS * K];
  const int CA = ca1 + ca2;
  const int lanes = THREADS / cpb;
  const int lane = threadIdx.x / cpb;
  const int j = blockIdx.y * cpb + threadIdx.x % cpb;
  const bool active = lane < lanes && j < n_chunks;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  if (active) {
    const bool is_bias = j >= n_w_chunks;
    int cb0, ca = 0, dy = 0, dx = 0;
    if (is_bias) {
      cb0 = (j - n_w_chunks) * K;
    } else {
      const int o = j * K;
      cb0 = o % CB;
      const int rest = o / CB;
      ca = rest % CA;
      const int tap = rest / CA;
      dy = tap / 3;
      dx = tap % 3;
    }
    const float* ap = ca < ca1 ? a1 + ca : a2 + (ca - ca1);
    const int ac = ca < ca1 ? ca1 : ca2;
    const int64_t p_stop = (int64_t)(blockIdx.x + 1) * ppb;
    const int64_t p_end = p_stop < npix ? p_stop : npix;
    for (int64_t p = (int64_t)blockIdx.x * ppb + lane; p < p_end; p += lanes) {
      float bv[K];
      const float* bp = b + p * CB + cb0;
      if constexpr (K == 4) {
        const float4 t4 = __ldg(reinterpret_cast<const float4*>(bp));
        bv[0] = t4.x; bv[1] = t4.y; bv[2] = t4.z; bv[3] = t4.w;
        if (bmask != nullptr) {
          const float4 m4 = __ldg(reinterpret_cast<const float4*>(bmask + p * CB + cb0));
          bv[0] = m4.x > 0.f ? bv[0] : 0.f;
          bv[1] = m4.y > 0.f ? bv[1] : 0.f;
          bv[2] = m4.z > 0.f ? bv[2] : 0.f;
          bv[3] = m4.w > 0.f ? bv[3] : 0.f;
        }
      } else {
        bv[0] = __ldg(bp);
        if (bmask != nullptr && !(__ldg(bmask + p * CB + cb0) > 0.f)) bv[0] = 0.f;
      }
      float av = 1.f;
      if (!is_bias) {
        const int bx = (int)(p % Wb);
        const int by = (int)((p / Wb) % Hb);
        const int64_t n = p / ((int64_t)Wb * Hb);
        const int ay = S * by + dy - 1, ax = S * bx + dx - 1;
        if (ay < 0 || ay >= Ha || ax < 0 || ax >= Wa) continue;
        const int64_t apix = (n * Ha + ay) * Wa + ax;
        av = __ldg(ap + apix * ac);
        if (amask != nullptr && !(__ldg(amask + apix * ca1 + ca) > 0.f)) av = 0.f;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = fmaf(av, bv[k], acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) red[threadIdx.x * K + k] = acc[k];
  __syncthreads();
  if (threadIdx.x < cpb && blockIdx.y * cpb + threadIdx.x < n_chunks) {
    const int jj = blockIdx.y * cpb + threadIdx.x;
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
      for (int l = 0; l < lanes; ++l) s += red[(l * cpb + threadIdx.x) * K + k];
      part[(int64_t)blockIdx.x * n_out + (int64_t)jj * K + k] = s;
    }
  }
}

// Pass 2: out[o] = Σ_x part[x, o], x in order, in float64.
__global__ void __launch_bounds__(THREADS) wgrad_reduce_kernel(const float* __restrict__ part,
                                                               float* __restrict__ out,
                                                               int gx, int n_out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_out) return;
  double s = 0.0;
  for (int x = 0; x < gx; ++x) s += (double)part[(int64_t)x * n_out + o];
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
// then db (CB).  part is scratch of gx·len(out) floats, gx the pixel ranges
// (≥ 1).  Two launches on `stream`, no atomics: the result is the same in
// every run.  Returns cudaGetLastError() (0 = launched).
extern "C" int wgrad3x3_f32(const float* a1, const float* a2, const float* amask, const float* b,
                            const float* bmask, float* part, float* out, int N, int Ha, int Wa,
                            int ca1, int ca2, int Hb, int Wb, int CB, int S, int bias, int gx,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int CA = ca1 + ca2;
  if (gx < 1 || CB < 1 || CA < 1 || (a2 == nullptr) != (ca2 == 0) ||
      (amask != nullptr && a2 != nullptr) || (S != 1 && S != 2))
    return (int)cudaErrorInvalidValue;
  const bool vec = CB % 4 == 0 && aligned16(b) && (bmask == nullptr || aligned16(bmask));
  const int K = vec ? 4 : 1;
  const int n_w = 9 * CA * CB;
  const int n_out = n_w + (bias ? CB : 0);
  const int n_w_chunks = n_w / K;
  const int n_chunks = n_out / K;
  const int cpb = n_chunks < THREADS ? n_chunks : THREADS;
  const int gy = (n_chunks + cpb - 1) / cpb;
  const int64_t npix = (int64_t)N * Hb * Wb;
  const int64_t ppb = (npix + gx - 1) / gx;
  if (npix == 0) return (int)cudaMemsetAsync(out, 0, sizeof(float) * n_out, st);
  const dim3 grid((unsigned)gx, (unsigned)gy);
  if (vec)
    wgrad_partial_kernel<4><<<grid, THREADS, 0, st>>>(a1, a2, amask, b, bmask, part, Ha, Wa, ca1,
                                                      ca2, Hb, Wb, CB, S, npix, ppb, n_w_chunks,
                                                      n_chunks, cpb, n_out);
  else
    wgrad_partial_kernel<1><<<grid, THREADS, 0, st>>>(a1, a2, amask, b, bmask, part, Ha, Wa, ca1,
                                                      ca2, Hb, Wb, CB, S, npix, ppb, n_w_chunks,
                                                      n_chunks, cpb, n_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wgrad_reduce_kernel<<<(n_out + THREADS - 1) / THREADS, THREADS, 0, st>>>(part, out, gx, n_out);
  return (int)cudaGetLastError();
}
