// ConvGRU depth recurrence of one RED scale over a batch of B independent
// elements, CUDA for Hopper (sm_90a).
//
// Replaces two TPU kernels of satmvs_tpu/ops/pallas/red_recur.py, both with
// this one kernel:
//   `_red_recur_impl` (:259, pallas_call :287, kernel `_red_recur_kernel` :79;
//   public `red_recur_packed` :1370, `red_recur` :1388, `red_recur_from` :1429),
//   which is B = 1 here; and
//   `_red_recur_impl_batched` (:337, pallas_call :368; public
//   `red_recur_from_packed_batched` :1450), the TPU grid (B, D) that reseeds
//   its resident state from element b's h0 at every d = 0.
//
// For each element b, x (D, H, W, Cin), a start state h0 (H, W, C) and plane
// d = 0 .. D−1, with h the previous plane's output (h0 at d = 0):
//
//   g  = conv3x3([x_d | h], Wa) + ba                 (2C: r half, u half)
//   r  = σ(GN1_r(g[:C]));   u = σ(GN1_u(g[C:]))
//   y  = tanh(GN1_y(conv3x3([x_d | r·h], Wb) + bb))
//   out[d] = u·h + (1 − u)·y
//
// Wa is the cell's concat-conv of the gates (its x-half Wx[:2C] stacked over
// Wh along the input channels), Wb the candidate's (Wx[2C:] over Wc); GN1 is
// GroupNorm with one group over the whole (H, W, C) plane, ε = 1e-5, with the
// per-channel scale and shift of gn (6, C) = [r_s, r_b, u_s, u_b, y_s, y_b].
// All tensors are channels-last float32, with the batch axis B leading:
// x (B, D, H, W, Cin), h0 (B, H, W, C), out (B, D, H, W, C).  The elements
// share nothing but the weights.
//
// What bounds it on this card: operations.  Per pixel and plane the two convs
// do 27·(Cin + C)·C FMAs against 4·(Cin + C) bytes of input and output, far
// above the fp32 balance point (~20 flops a byte).  Summed over the
// full-volume forward's 12 calls that is ~183 GFLOP, ~2.7 ms at 67 TFLOP/s.
//
// Design.  GroupNorm(1) makes every plane a grid-wide dependency three times
// over, and the stage-3 state alone is 384·768·8·4 B = 9.4 MB, beyond any SM's
// shared memory.  So one persistent cooperative kernel runs a whole scale for
// all B elements: its grid is at most the blocks that can be resident at once
// (launched with cudaLaunchCooperativeKernel, which refuses a grid that does
// not fit; the wrapper then raises), it loops over the D planes, and
// grid.sync() separates the four phases of a plane:
//   1. the gates conv over [x_d | h] into the scratch g (H, W, 2C), with each
//      block's sums of g and g² for the r and u halves;
//   2. sync; every block combines the per-block sums into the r and u
//      statistics, then m = r·h into the scratch m (H, W, C);
//   3. sync; the candidate conv over [x_d | m] into g's dead r half, with the
//      per-block sums of the candidate;
//   4. sync; the candidate statistics, then the blend into out[d];
//   and a sync before the next plane reads the neighbouring pixels of out[d].
// The state needs no buffer of its own: plane d reads h from out[d − 1] (or
// h0) and writes out[d], so a halo read and a blend write never touch the same
// array.  The x-side convs carry no state and run inside phases 1 and 3 with
// the same loop as the state side, so no (D, H, W, 3C) buffer is made.
//
// Batch.  The grid is B equal groups of `bpe` blocks; group b works on element
// b only (grid-stride loops over that element's pixels), so every block's
// partial sums belong to one element and GroupNorm statistics are never mixed
// across elements.  The four syncs of a plane are shared by all B elements:
// at the coarse scales, where a plane is a few hundred pixels, the work
// between two syncs grows B-fold.
//
// Statistics: one pass.  Each thread sums its values and their squares in
// float64; a block reduces its threads in a fixed tree and writes its partial
// sums; in the next phase every block adds its element's partials in block
// order, so the statistics are deterministic and the same in every block of
// the element.  var = E[g²] − E[g]²
// in float64 loses nothing that matters at these magnitudes (the products of
// two floats are exact in a double), and saves the extra sync per norm that
// the TPU kernel's two passes (mean, then centred variance) would cost.
//
// Work items: one thread owns one pixel and CO_T = 4 output channels (threads
// of one pixel side by side, so their input reads broadcast), in grid-stride
// loops.  Weights are read through the read-only cache as float4 (up to
// 9·128·128·4 B = 590 KB at C = 64, beyond shared memory).  Data written
// inside the kernel (g, m, out, the partial sums) is read with plain loads,
// never through the non-coherent read-only path.  fp32 FMA on the CUDA cores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CO_T = 4;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr double EPS = 1e-5;

struct Args {
  const float* x;    // (B, D, H, W, Cin)
  const float* h0;   // (B, H, W, C)
  float* out;        // (B, D, H, W, C)
  float* g;          // (B, H, W, 2C) scratch: raw gates; the r half then the candidate
  float* m;          // (B, H, W, C) scratch: r·h
  double* part;      // (2, gridDim.x, 4) scratch: per-block sums, element b's at
                     // blocks b·bpe .. (b + 1)·bpe − 1
  const float* wa;   // (9, Cin + C, 2C)
  const float* ba;   // (2C)
  const float* wb;   // (9, Cin + C, C)
  const float* bb;   // (C)
  const float* gn;   // (6, C)
  int B, D, H, W, Cin, C;
};

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ void fma4(float v, const float* __restrict__ w, float (&acc)[CO_T]) {
  const float4 w4 = __ldg(reinterpret_cast<const float4*>(w));
  acc[0] = fmaf(v, w4.x, acc[0]);
  acc[1] = fmaf(v, w4.y, acc[1]);
  acc[2] = fmaf(v, w4.z, acc[2]);
  acc[3] = fmaf(v, w4.w, acc[3]);
}

// acc += 3×3 conv at pixel (y, x) of the channel concat [a (ca) | b (cb)] with
// weights w (9, ca + cb, cout), output channels co0 .. co0 + 3.  a is read-only
// for the whole kernel; b may have been written by other blocks of this launch.
__device__ __forceinline__ void conv_pixel(const float* __restrict__ a, int ca, const float* b,
                                           int cb, const float* __restrict__ w, int cout, int y,
                                           int x, int H, int W, int co0, float (&acc)[CO_T]) {
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = y + dy - 1;
    if (iy < 0 || iy >= H) continue;
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = x + dx - 1;
      if (ix < 0 || ix >= W) continue;
      const int64_t pix = (int64_t)iy * W + ix;
      const float* wr = w + (int64_t)(dy * 3 + dx) * (ca + cb) * cout + co0;
      const float* pa = a + pix * ca;
      for (int ci = 0; ci < ca; ++ci) fma4(__ldg(pa + ci), wr + (int64_t)ci * cout, acc);
      const float* pb = b + pix * cb;
      wr += (int64_t)ca * cout;
      for (int c = 0; c < cb; ++c) fma4(pb[c], wr + (int64_t)c * cout, acc);
    }
  }
}

// Reduces the threads' s[4] over the block in a fixed order; thread 0 writes
// the block's sums to dst[0..3].
__device__ void block_sums(double (&s)[4], double* red, double* dst) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
    for (int k = 0; k < 4; ++k) red[warp * 4 + k] = s[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) {
      double t = 0.0;
      for (int i = 0; i < WARPS; ++i) t += red[i * 4 + k];
      dst[k] = t;
    }
  }
}

// Adds the per-block sums part (nblocks, 4) in block order and writes, for
// each of the `pairs` (sum, sum of squares) columns, the mean and 1/sqrt(var + ε)
// to stats.  Every block computes the same values.
__device__ void plane_stats(const double* part, int nblocks, double inv_n, int pairs,
                            float* stats) {
  if (threadIdx.x < 32) {
    double s[4] = {0.0, 0.0, 0.0, 0.0};
    for (int b = threadIdx.x; b < nblocks; b += 32)
      for (int k = 0; k < 4; ++k) s[k] += part[b * 4 + k];
    for (int k = 0; k < 4; ++k)
      for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
    if (threadIdx.x == 0) {
      for (int j = 0; j < pairs; ++j) {
        const double mean = s[2 * j] * inv_n;
        const double var = fmax(s[2 * j + 1] * inv_n - mean * mean, 0.0);
        stats[2 * j] = (float)mean;
        stats[2 * j + 1] = (float)(1.0 / sqrt(var + EPS));
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS) red_recur_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double red[WARPS * 4];
  __shared__ float stats[6];  // mean and 1/std of r, u, y
  const int C = a.C, C2 = 2 * C, Cin = a.Cin, W = a.W, H = a.H;
  const int64_t P = (int64_t)H * W;
  const int64_t plane = P * C;
  const double inv_n = 1.0 / (double)plane;
  // this block's element b and its place among the element's bpe blocks
  const int bpe = gridDim.x / a.B;
  const int b = blockIdx.x / bpe;
  const int64_t first = (int64_t)(blockIdx.x - b * bpe) * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)bpe * blockDim.x;
  const int ga = C2 / CO_T, gc = C / CO_T;
  const float* x = a.x + (int64_t)b * a.D * P * Cin;
  const float* h0 = a.h0 + (int64_t)b * plane;
  float* out = a.out + (int64_t)b * a.D * plane;
  float* g = a.g + (int64_t)b * P * C2;
  float* mm = a.m + (int64_t)b * plane;
  double* part_g = a.part;
  double* part_y = a.part + 4 * (int64_t)gridDim.x;
  const double* elem_g = part_g + 4 * (int64_t)b * bpe;  // element b's partials
  const double* elem_y = part_y + 4 * (int64_t)b * bpe;
  const float* gn = a.gn;

  for (int d = 0; d < a.D; ++d) {
    const float* xd = x + (int64_t)d * P * Cin;
    const float* h = d == 0 ? h0 : out + (int64_t)(d - 1) * plane;
    float* hn = out + (int64_t)d * plane;

    // 1. gates
    double s[4] = {0.0, 0.0, 0.0, 0.0};
    for (int64_t t = first; t < P * ga; t += step) {
      const int co0 = (int)(t % ga) * CO_T;
      const int64_t p = t / ga;
      float acc[CO_T];
#pragma unroll
      for (int k = 0; k < CO_T; ++k) acc[k] = __ldg(a.ba + co0 + k);
      conv_pixel(xd, Cin, h, C, a.wa, C2, (int)(p / W), (int)(p % W), H, W, co0, acc);
      *reinterpret_cast<float4*>(g + p * C2 + co0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      const int half = co0 < C ? 0 : 2;
#pragma unroll
      for (int k = 0; k < CO_T; ++k) {
        s[half] += acc[k];
        s[half + 1] += (double)acc[k] * acc[k];
      }
    }
    block_sums(s, red, part_g + 4 * blockIdx.x);
    grid.sync();

    // 2. r and u statistics; m = σ(GN1_r(g_r))·h
    plane_stats(elem_g, bpe, inv_n, 2, stats);
    for (int64_t t = first; t < P * gc; t += step) {
      const int c0 = (int)(t % gc) * CO_T;
      const int64_t p = t / gc;
      const float4 gr = *reinterpret_cast<const float4*>(g + p * C2 + c0);
      const float4 hv = *reinterpret_cast<const float4*>(h + p * C + c0);
      const float graw[CO_T] = {gr.x, gr.y, gr.z, gr.w};
      const float hh[CO_T] = {hv.x, hv.y, hv.z, hv.w};
      float mv[CO_T];
#pragma unroll
      for (int k = 0; k < CO_T; ++k) {
        const int c = c0 + k;
        const float r =
            sigmoid((graw[k] - stats[0]) * stats[1] * __ldg(gn + c) + __ldg(gn + C + c));
        mv[k] = r * hh[k];
      }
      *reinterpret_cast<float4*>(mm + p * C + c0) = make_float4(mv[0], mv[1], mv[2], mv[3]);
    }
    grid.sync();

    // 3. candidate, into the r half of g
    s[0] = s[1] = s[2] = s[3] = 0.0;
    for (int64_t t = first; t < P * gc; t += step) {
      const int c0 = (int)(t % gc) * CO_T;
      const int64_t p = t / gc;
      float acc[CO_T];
#pragma unroll
      for (int k = 0; k < CO_T; ++k) acc[k] = __ldg(a.bb + c0 + k);
      conv_pixel(xd, Cin, mm, C, a.wb, C, (int)(p / W), (int)(p % W), H, W, c0, acc);
      *reinterpret_cast<float4*>(g + p * C2 + c0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
#pragma unroll
      for (int k = 0; k < CO_T; ++k) {
        s[0] += acc[k];
        s[1] += (double)acc[k] * acc[k];
      }
    }
    block_sums(s, red, part_y + 4 * blockIdx.x);
    grid.sync();

    // 4. candidate statistics; blend
    plane_stats(elem_y, bpe, inv_n, 1, stats + 4);
    for (int64_t t = first; t < P * gc; t += step) {
      const int c0 = (int)(t % gc) * CO_T;
      const int64_t p = t / gc;
      const float4 yv = *reinterpret_cast<const float4*>(g + p * C2 + c0);
      const float4 uv = *reinterpret_cast<const float4*>(g + p * C2 + C + c0);
      const float4 hv = *reinterpret_cast<const float4*>(h + p * C + c0);
      const float yraw[CO_T] = {yv.x, yv.y, yv.z, yv.w};
      const float uraw[CO_T] = {uv.x, uv.y, uv.z, uv.w};
      const float hh[CO_T] = {hv.x, hv.y, hv.z, hv.w};
      float o[CO_T];
#pragma unroll
      for (int k = 0; k < CO_T; ++k) {
        const int c = c0 + k;
        const float y = tanhf((yraw[k] - stats[4]) * stats[5] * __ldg(gn + 4 * C + c) +
                              __ldg(gn + 5 * C + c));
        const float u = sigmoid((uraw[k] - stats[2]) * stats[3] * __ldg(gn + 2 * C + c) +
                                __ldg(gn + 3 * C + c));
        o[k] = u * hh[k] + (1.f - u) * y;
      }
      *reinterpret_cast<float4*>(hn + p * C + c0) = make_float4(o[0], o[1], o[2], o[3]);
    }
    grid.sync();
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Blocks that red_recur_f32 launches for B elements of an (H, W) plane with C
// state channels: B equal groups, each of at most the blocks one element's
// gate work fills, all resident at once and at most max_blocks in all.  A
// negative CUDA error code when not even one block per element fits.  The
// caller sizes the `part` scratch as 8 doubles per block.
extern "C" int red_recur_blocks(int B, int H, int W, int C, int max_blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if (B < 1) return -(int)cudaErrorInvalidValue;
  if ((err = cudaGetDevice(&dev))) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, red_recur_kernel, THREADS, 0)))
    return -(int)err;
  int64_t per = ((int64_t)H * W * (2 * C / CO_T) + THREADS - 1) / THREADS;
  const int64_t resident = (int64_t)per_sm * sms / B;
  if (resident < per) per = resident;
  if (max_blocks / B < per) per = max_blocks / B;
  return per < 1 ? -(int)cudaErrorCooperativeLaunchTooLarge : (int)(B * per);
}

// Runs the recurrence of B elements over all D planes in one cooperative
// launch of `blocks` blocks (from red_recur_blocks; a multiple of B) on
// `stream`; returns cudaGetLastError()-style codes (0 = launched).  C must be a
// multiple of 4 and every float pointer 16-byte aligned.
extern "C" int red_recur_f32(const float* x, const float* h0, float* out, float* g, float* m,
                             double* part, const float* wa, const float* ba, const float* wb,
                             const float* bb, const float* gn, int B, int D, int H, int W,
                             int Cin, int C, int blocks, void* stream) {
  if (C % CO_T != 0 || B < 1 || blocks < B || blocks % B != 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {h0, out, g, m, part, wa, ba, wb, bb, gn};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  if (D == 0) return 0;
  Args a{x, h0, out, g, m, part, wa, ba, wb, bb, gn, B, D, H, W, Cin, C};
  void* kargs[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)red_recur_kernel, dim3(blocks),
                                                dim3(THREADS), kargs, 0,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch is not sticky: clear it for later launches
    return (int)err;
  }
  return (int)cudaGetLastError();
}
