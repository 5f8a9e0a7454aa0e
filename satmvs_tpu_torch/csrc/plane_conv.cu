// Plane convolutions of the RED regularizer, CUDA for Hopper (sm_90a).
//
// Replaces the TPU kernels of satmvs_tpu/ops/pallas/plane_conv.py:
//   conv_dn   `_conv_dn_impl` (:382, pallas_call :394, kernel :295): stride-2 3×3
//             conv, pad 1, no bias, ReLU (the RED encoder);
//   deconv_up `_deconv_up_impl` (:569, pallas_call :582, kernel :480): stride-2 3×3
//             transposed conv exactly as torch's ConvTranspose2d(k=3, s=2, p=1,
//             op=1), no bias, ReLU (the RED decoder), here with the decoder's
//             skip add fused after the ReLU;
//   conv_head `_conv_head_impl` (:730, pallas_call :738, kernel :663): stride-1 3×3
//             conv + bias, no activation (the RED logit head).
// conv_dn and conv_head are one kernel, `conv3x3_kernel`, with the stride, the
// bias and the ReLU as arguments.
//
// Layout: activations are channels-last (N, H, W, C) float32 planes; weights
// arrive as (3, 3, Cin, Cout), output channels fastest.  The TPU kernels'
// row-packed layout and even/odd column splits are Mosaic workarounds and are
// not carried over.
//
// What bounds them on this card: memory, at the main path's shapes.  A 3×3
// conv at these channel counts does 9·Cin FMAs per output value, so
// 2·9·Cin·Cout flops per pixel against 4·(Cin + Cout) bytes per pixel; at the
// largest shape (Cin 32, Cout 64, stride 2) that is ~18 flops a byte, under the
// H100's ~20 flops/byte fp32 balance, and the other shapes are far under it.
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
// (tap, 0, co0) of the staged (taps, Cin, cop) weights.
template <int VEC>
__device__ __forceinline__ void tap_fma(const float* __restrict__ in, const float* sw, int cin,
                                        int cop, float (&acc)[CO_T]) {
  for (int ci = 0; ci < cin; ci += VEC) {
    float v[VEC];
    load_in<VEC>(in + ci, v);
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

// out[n, oy, ox, co] = act(bias[co] + Σ_{dy, dx, ci} in[n, S·oy + dy − 1, S·ox + dx − 1, ci]
//                                                    · w[dy, dx, ci, co])
template <int STRIDE, int VEC>
__global__ void __launch_bounds__(THREADS) conv3x3_kernel(
    const float* __restrict__ in, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, int N, int H, int W, int Cin, int Ho, int Wo, int Cout, int relu) {
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
        tap_fma<VEC>(in + ((n * H + iy) * W + ix) * Cin, sw + (dy * 3 + dx) * Cin * cop + co0,
                     Cin, cop, acc);
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
//   the latter only while i + 1 < H; the same for columns.  Then ReLU, then
//   + skip[n, oy, ox, co] when skip is given.  w is (ky, kx, Cin, Cout).
template <int VEC>
__global__ void __launch_bounds__(THREADS) deconv3x3_s2_kernel(
    const float* __restrict__ in, const float* __restrict__ w, const float* __restrict__ skip,
    float* __restrict__ out, int N, int H, int W, int Cin, int Cout) {
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
        tap_fma<VEC>(in + ((n * H + iy) * W + ix) * Cin, sw + (ky * 3 + kx) * Cin * cop + co0,
                     Cin, cop, acc);
      }
    }
#pragma unroll
    for (int k = 0; k < CO_T; ++k) acc[k] = fmaxf(acc[k], 0.f);
    store_out(out + pix * Cout + co0, skip != nullptr ? skip + pix * Cout + co0 : nullptr, co0,
              Cout, acc);
  }
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

template <int STRIDE, int VEC>
int launch_conv(const float* in, const float* w, const float* bias, float* out, int N, int H,
                int W, int Cin, int Cout, int relu, cudaStream_t st) {
  const int Ho = (H - 1) / STRIDE + 1, Wo = (W - 1) / STRIDE + 1;
  const int smem = 9 * Cin * round_up(Cout, CO_T) * (int)sizeof(float);
  const int64_t total = (int64_t)N * Ho * Wo * (round_up(Cout, CO_T) / CO_T);
  if (total == 0) return 0;
  cudaError_t err;
  const int64_t blocks = grid_blocks(conv3x3_kernel<STRIDE, VEC>, smem, total, &err);
  if (blocks == 0) return (int)err;
  conv3x3_kernel<STRIDE, VEC><<<(unsigned)blocks, THREADS, smem, st>>>(
      in, w, bias, out, N, H, W, Cin, Ho, Wo, Cout, relu);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_deconv(const float* in, const float* w, const float* skip, float* out, int N, int H,
                  int W, int Cin, int Cout, cudaStream_t st) {
  const int smem = 9 * Cin * round_up(Cout, CO_T) * (int)sizeof(float);
  const int64_t total = (int64_t)N * 4 * H * W * (round_up(Cout, CO_T) / CO_T);
  if (total == 0) return 0;
  cudaError_t err;
  const int64_t blocks = grid_blocks(deconv3x3_s2_kernel<VEC>, smem, total, &err);
  if (blocks == 0) return (int)err;
  deconv3x3_s2_kernel<VEC><<<(unsigned)blocks, THREADS, smem, st>>>(in, w, skip, out, N, H, W,
                                                                   Cin, Cout);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// 3×3 conv, pad 1, stride 1 or 2: in (N, H, W, Cin), w (3, 3, Cin, Cout),
// bias (Cout) or null, out (N, ceil(H/stride), ceil(W/stride), Cout), ReLU when
// relu != 0.  Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int conv3x3_f32(const float* in, const float* w, const float* bias, float* out,
                           int N, int H, int W, int Cin, int Cout, int stride, int relu,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = Cin % 4 == 0 && aligned16(in);
  if (!aligned16(out)) return (int)cudaErrorMisalignedAddress;
  if (stride == 1)
    return vec ? launch_conv<1, 4>(in, w, bias, out, N, H, W, Cin, Cout, relu, st)
               : launch_conv<1, 1>(in, w, bias, out, N, H, W, Cin, Cout, relu, st);
  if (stride == 2)
    return vec ? launch_conv<2, 4>(in, w, bias, out, N, H, W, Cin, Cout, relu, st)
               : launch_conv<2, 1>(in, w, bias, out, N, H, W, Cin, Cout, relu, st);
  return (int)cudaErrorInvalidValue;
}

// relu(ConvTranspose2d(k=3, s=2, p=1, op=1)) (+ skip): in (N, H, W, Cin),
// w (3, 3, Cin, Cout), skip (N, 2H, 2W, Cout) or null, out (N, 2H, 2W, Cout).
// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int deconv3x3_s2_f32(const float* in, const float* w, const float* skip, float* out,
                                int N, int H, int W, int Cin, int Cout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!aligned16(out) || (skip != nullptr && !aligned16(skip)))
    return (int)cudaErrorMisalignedAddress;
  return (Cin % 4 == 0 && aligned16(in))
             ? launch_deconv<4>(in, w, skip, out, N, H, W, Cin, Cout, st)
             : launch_deconv<1>(in, w, skip, out, N, H, W, Cin, Cout, st);
}
