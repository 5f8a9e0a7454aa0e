// Bilinear taps of ops/sampling.bilinear_sample, shared by the sweep kernels
// (sweep_variance.cu, sweep_gather.cu), so the warp of the inference sweep,
// the training gather and its scatter adjoint compute the same corners and
// weights bit for bit.
//
// Contract: a sample at (x, y) reads the corners (x0 + dx, y0 + dy) with
// x0 = floor(x), y0 = floor(y), dx, dy in {0, 1}, weighted
// (1 − wy or wy)·(1 − wx or wx), wx = x − x0, wy = y − y0; a corner outside
// the image contributes zero (grid_sample's padding_mode='zeros'), the
// others keep their weights.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bilinear {

template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int q = 0; q < VEC; q += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + q));
      v[q] = t.x; v[q + 1] = t.y; v[q + 2] = t.z; v[q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

// Writes v to p with streaming stores (__stcs, evict-first): for outputs
// that are not read again by the kernel, so they do not push the features
// out of L2.  An overload below stores bfloat16.
template <int VEC>
__device__ __forceinline__ void store_streaming(float* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) __stcs(p + i, v[i]);
  }
}

// bfloat16 storage of the volumes (stored as their 16 bits): a value is
// rounded to nearest even once, as Tensor.to(torch.bfloat16) rounds it (a
// NaN becomes the quiet NaN 0x7fc0), and widened exactly to float.
__device__ __forceinline__ unsigned short bf16_bits(float x) {
  const unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  return (unsigned short)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ float bf16_value(unsigned short b) {
  return __uint_as_float((unsigned)b << 16);
}

template <int VEC>
__device__ __forceinline__ void load_vec(const unsigned short* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = bf16_value((unsigned short)(u[q] & 0xffffu));
      v[2 * q + 1] = bf16_value((unsigned short)(u[q] >> 16));
    }
  } else if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_value((unsigned short)(t.x & 0xffffu));
    v[1] = bf16_value((unsigned short)(t.x >> 16));
    v[2] = bf16_value((unsigned short)(t.y & 0xffffu));
    v[3] = bf16_value((unsigned short)(t.y >> 16));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = bf16_value(__ldg(p + i));
  }
}

template <int VEC>
__device__ __forceinline__ void store_streaming(unsigned short* __restrict__ p,
                                                const float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    unsigned u[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      u[q] = bf16_bits(v[2 * q]) | ((unsigned)bf16_bits(v[2 * q + 1]) << 16);
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(u[0], u[1], u[2], u[3]));
  } else if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(bf16_bits(v[0]) | ((unsigned)bf16_bits(v[1]) << 16),
                      bf16_bits(v[2]) | ((unsigned)bf16_bits(v[3]) << 16)));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) __stcs(p + i, bf16_bits(v[i]));
  }
}

// The four corners of one sample and their weights, in the order
// (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1).
struct Taps {
  int x0, y0;
  float w[4];

  Taps() = default;
  __device__ __forceinline__ Taps(float cx, float cy, int H, int W) {
    const float fx0 = floorf(cx);
    const float fy0 = floorf(cy);
    const float wx = cx - fx0;
    const float wy = cy - fy0;
    // clamp before the float → int cast (undefined out of range); below -1
    // or above W-1 both corners stay invalid, so validity is unchanged
    x0 = (int)fminf(fmaxf(fx0, -2.f), (float)W);
    y0 = (int)fminf(fmaxf(fy0, -2.f), (float)H);
    w[0] = (1.f - wy) * (1.f - wx);
    w[1] = (1.f - wy) * wx;
    w[2] = wy * (1.f - wx);
    w[3] = wy * wx;
  }

  __device__ __forceinline__ int xi(int k) const { return x0 + (k & 1); }
  __device__ __forceinline__ int yi(int k) const { return y0 + (k >> 1); }

  // Flat pixel index yi·W + xi of corner k, or −1 when it lies off the image.
  __device__ __forceinline__ int64_t pixel(int k, int H, int W) const {
    const int x = xi(k), y = yi(k);
    if (x < 0 || x >= W || y < 0 || y >= H) return -1;
    return (int64_t)y * W + x;
  }
};

// Adds weight · src[yi, xi, c0 : c0 + VEC] when the corner lies in the image.
template <int VEC>
__device__ __forceinline__ void add_corner(const float* __restrict__ src, int yi, int xi,
                                           float weight, int H, int W, int C,
                                           float (&acc)[VEC]) {
  if (xi < 0 || xi >= W || yi < 0 || yi >= H) return;
  float v[VEC];
  load_vec<VEC>(src + ((int64_t)yi * W + xi) * C, v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] += v[i] * weight;
}

// The bilinear sample of src (H, W, C) at taps t, channels c0 : c0 + VEC,
// src already offset by c0.  The corners are summed in Taps order.
template <int VEC>
__device__ __forceinline__ void sample(const float* __restrict__ src, const Taps& t, int H,
                                       int W, int C, float (&out)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) add_corner<VEC>(src, t.yi(k), t.xi(k), t.w[k], H, W, C, out);
}

}  // namespace bilinear
