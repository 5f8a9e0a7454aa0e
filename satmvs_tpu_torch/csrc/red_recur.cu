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
//
// The backward, `red_recur_bwd_kernel`, replaces two more TPU kernels with
// one: the reverse-plane adjoint `_red_recur_bwd_pallas` (:755, pallas_call
// :802, kernel `_red_recur_bwd_kernel` :421) and its slab-streamed twin
// `_red_recur_bwd_pallas_stream` (:1197, pallas_call :1246, kernel :853),
// which streams x and dx from HBM only because the stage-3 plane does not
// fit VMEM (dispatch `_red_recur_bwd` :1471).  Here every buffer lives in
// device memory anyway, so one kernel serves every plane size, and it has
// the forward's batch axis.  Its inputs are x, out and the cotangent g (and
// h0), as the JAX VJP's residuals: nothing else is saved in the forward.
//
// What bounds it: operations, three times the forward's.  It recomputes each
// plane (the forward's two convs), takes the data cotangents (convᵀ of the
// candidate's cotangent through Wc, of the gates' through Wh, and dx through
// Wx: 27·C·(C + Cin) FMAs a pixel) and the weight cotangents (as many).
// Summed over a B = 1 train step's 12 calls that is ~3 × 183 GFLOP.
//
// Design.  The same persistent cooperative grid and per-element block groups
// as the forward, walking the planes from D − 1 down to 0 with the state's
// cotangent dh carried in a (B, H, W, C) buffer; each plane takes seven
// grid syncs (its phases are listed above the kernel).  The recompute uses
// the forward's own code and statistics formulation (conv_pixel in the same
// order, one-pass float64 sums, gn_affine), so r, u and y are the values the
// forward produced, up to the rounding of the float64 sums split over
// another number of blocks.  The GroupNorm transposes need two whole-plane
// sums each, taken like the forward's statistics (float64 per-block
// partials added in block order).  The convᵀ are gathers (conv_pixel with
// flipped, channel-transposed weights made by the wrapper), so no atomics.
// The weight cotangents are not reduced in the kernel: a per-block partial
// of dWa + dWb at C = 64 is 9·128·192 floats (885 KB), a few hundred MB over
// the grid.  Instead the kernel keeps every plane's gate and candidate
// cotangents (B, D, H, W, 3C) and the recomputed r·h (B, D, H, W, C), 0.3 GB
// at stage-3 scale 1, and the wrapper reduces them with plane_conv.cu's
// two-pass weight kernel (fixed order) after the loop.  The six GroupNorm
// parameter cotangents (6·C values) accumulate in registers (each thread
// keeps one channel group for the whole kernel) and are reduced once at the
// end in a fixed order.  Every result is the same in every run.

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

// GroupNorm(1)'s affine map of a raw value, one expression for the forward
// and the backward's recompute, so both round alike
__device__ __forceinline__ float gn_affine(float raw, float mean, float inv, float scale,
                                           float shift) {
  return (raw - mean) * inv * scale + shift;
}

__device__ __forceinline__ void fma4(float v, const float* __restrict__ w, float (&acc)[CO_T]) {
  const float4 w4 = __ldg(reinterpret_cast<const float4*>(w));
  acc[0] = fmaf(v, w4.x, acc[0]);
  acc[1] = fmaf(v, w4.y, acc[1]);
  acc[2] = fmaf(v, w4.z, acc[2]);
  acc[3] = fmaf(v, w4.w, acc[3]);
}

// acc += 3×3 conv at pixel (y, x) of the channel concat [a (ca) | b (cb)] with
// weights w (9, ca + cb, cout), output channels co0 .. co0 + 3.  With A_RO, a
// is read-only for the whole kernel (read through the read-only cache);
// otherwise, like b, it may have been written by other blocks of this launch.
template <bool A_RO>
__device__ __forceinline__ void conv_pixel(const float* a, int ca, const float* b,
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
      for (int ci = 0; ci < ca; ++ci)
        fma4(A_RO ? __ldg(pa + ci) : pa[ci], wr + (int64_t)ci * cout, acc);
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
      conv_pixel<true>(xd, Cin, h, C, a.wa, C2, (int)(p / W), (int)(p % W), H, W, co0, acc);
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
            sigmoid(gn_affine(graw[k], stats[0], stats[1], __ldg(gn + c), __ldg(gn + C + c)));
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
      conv_pixel<true>(xd, Cin, mm, C, a.wb, C, (int)(p / W), (int)(p % W), H, W, c0, acc);
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
        const float y = tanhf(
            gn_affine(yraw[k], stats[4], stats[5], __ldg(gn + 4 * C + c), __ldg(gn + 5 * C + c)));
        const float u = sigmoid(
            gn_affine(uraw[k], stats[2], stats[3], __ldg(gn + 2 * C + c), __ldg(gn + 3 * C + c)));
        o[k] = u * hh[k] + (1.f - u) * y;
      }
      *reinterpret_cast<float4*>(hn + p * C + c0) = make_float4(o[0], o[1], o[2], o[3]);
    }
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// The backward: the reverse-plane adjoint of red_recur_kernel.

struct BwdArgs {
  const float* x;     // (B, D, H, W, Cin)
  const float* h0;    // (B, H, W, C)
  const float* out;   // (B, D, H, W, C) the forward's states
  const float* gout;  // (B, D, H, W, C) their cotangent
  float* dx;          // (B, D, H, W, Cin)
  float* dg;          // (B, D, H, W, 2C) per plane [dr_pre | du_pre], then the gates' cotangent
  float* dyl;         // (B, D, H, W, C) per plane do, then the candidate's cotangent dy_lin
  float* m;           // (B, D, H, W, C) per plane r·h, recomputed
  float* graw;        // (B, H, W, 2C) scratch: raw gates
  float* yraw;        // (B, H, W, C) scratch: raw candidate
  float* dh;          // (B, H, W, C) the state's cotangent, carried down the planes (zeros in)
  double* part;       // (4, gridDim.x, 4) per-block sums
  double* gnpart;     // (gridDim.x, 6, C) per-block GroupNorm parameter cotangents
  float* dgn;         // (6, C) the GroupNorm parameter cotangents
  const float* wa;    // (9, Cin + C, 2C)
  const float* ba;    // (2C)
  const float* wb;    // (9, Cin + C, C)
  const float* bb;    // (C)
  const float* gn;    // (6, C)
  const float* whT;   // (9, 2C, C)   [t][co][c]  = wa[8 − t][Cin + c][co]
  const float* wcT;   // (9, C, C)    [t][co][c]  = wb[8 − t][Cin + c][co]
  const float* wxT;   // (9, 3C, cinp) [t][co][ci] = wa[8 − t][ci][co], then wb's for co ≥ 2C
  int B, D, H, W, Cin, C, cinp;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[CO_T]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void unpack4(float4 t, float (&v)[CO_T]) {
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// Adds the per-block sums part (nblocks, 4) in block order and writes the
// first n of them times inv_n to out.  Every block computes the same values.
__device__ void plane_means(const double* part, int nblocks, double inv_n, int n, float* out) {
  if (threadIdx.x < 32) {
    double s[4] = {0.0, 0.0, 0.0, 0.0};
    for (int b = threadIdx.x; b < nblocks; b += 32)
      for (int k = 0; k < 4; ++k) s[k] += part[b * 4 + k];
    for (int k = 0; k < 4; ++k)
      for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
    if (threadIdx.x == 0)
      for (int k = 0; k < n; ++k) out[k] = (float)(s[k] * inv_n);
  }
  __syncthreads();
}

// For d = D−1 .. 0 and every element b (h = out[d − 1], h0 at d = 0), with
// x̂ = (raw − mean)·inv the normalised values of each GroupNorm(1), γ its scale:
//   1. recompute the gates g = conv([x_d | h], Wa) + ba      (the forward's phase 1)
//   2. r, u statistics; m = r·h                              (phase 2)
//   3. candidate conv([x_d | m], Wb) + bb                    (phase 3)
//   4. y statistics; dht = dh + gout_d; do = dht·(1 − u)·(1 − y²);
//      du = dht·(h − y)·u·(1 − u); dh ← dht·u; sums of do·γ_y, do·γ_y·ŷ, du·γ_u, du·γ_u·û
//   5. dy_lin = inv_y·(do·γ_y − mean(do·γ_y) − ŷ·mean(do·γ_y·ŷ)), the same GN_uᵀ of du
//   6. dm = convᵀ(dy_lin, Wc); dr = dm·h·r·(1 − r); dh += dm·r; sums of dr·γ_r, dr·γ_r·r̂
//   7. the GN_rᵀ of dr
//   8. dh += convᵀ([dgr | dgu], Wh);  dx_d = convᵀ([dgr | dgu], Wx_g) + convᵀ(dy_lin, Wx_c)
// with a grid.sync() after each of phases 1-7.  Phase 8 needs none before the
// next plane: that plane's phases 1-3 read only x, out and h0 and write
// scratch phase 8 does not read.  The GroupNorm parameter cotangents
// Σ do·ŷ, Σ do, Σ dr·r̂, Σ dr, Σ du·û, Σ du accumulate in each thread's
// registers (a thread's channel group is the same in every own-pixel phase,
// since C/4 divides the block size) and are reduced once at the end in a
// fixed order.  The weight and bias cotangents are left to the caller: dg,
// dyl and m keep every plane's values for it.
__global__ void __launch_bounds__(THREADS, 2) red_recur_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double red[WARPS * 4];
  __shared__ float stats[12];  // mean, 1/std of r, u, y; then the transposes' means
  __shared__ float gsm[WARPS][32];
  const int C = a.C, C2 = 2 * C, Cin = a.Cin, W = a.W, H = a.H;
  const int64_t P = (int64_t)H * W;
  const int64_t plane = P * C;
  const double inv_n = 1.0 / (double)plane;
  const int bpe = gridDim.x / a.B;
  const int b = blockIdx.x / bpe;
  const int64_t first = (int64_t)(blockIdx.x - b * bpe) * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)bpe * blockDim.x;
  const int ga = C2 / CO_T, gc = C / CO_T, gx = a.cinp / CO_T;
  const float* x = a.x + (int64_t)b * a.D * P * Cin;
  const float* h0 = a.h0 + (int64_t)b * plane;
  const float* out = a.out + (int64_t)b * a.D * plane;
  const float* gout = a.gout + (int64_t)b * a.D * plane;
  float* dx = a.dx + (int64_t)b * a.D * P * Cin;
  float* dgs = a.dg + (int64_t)b * a.D * P * C2;
  float* dyls = a.dyl + (int64_t)b * a.D * plane;
  float* ms = a.m + (int64_t)b * a.D * plane;
  float* G = a.graw + (int64_t)b * P * C2;
  float* Y = a.yraw + (int64_t)b * plane;
  float* DH = a.dh + (int64_t)b * plane;
  double* part[4];
  const double* elem[4];
  for (int k = 0; k < 4; ++k) {
    part[k] = a.part + 4 * (int64_t)k * gridDim.x;
    elem[k] = part[k] + 4 * (int64_t)b * bpe;
  }
  const float* gn = a.gn;
  const int c0 = (int)(threadIdx.x % gc) * CO_T;  // this thread's channels in own-pixel phases
  float gacc[6][CO_T];  // Σ dr·r̂, Σ dr, Σ du·û, Σ du, Σ do·ŷ, Σ do for channels c0 ..
#pragma unroll
  for (int q = 0; q < 6; ++q)
#pragma unroll
    for (int k = 0; k < CO_T; ++k) gacc[q][k] = 0.f;
  // GroupNorm scale and shift of norm q (r, u, y) for this thread's channel c0 + k
  auto gam = [&](int q, int k) { return __ldg(gn + 2 * q * C + c0 + k); };
  auto bet = [&](int q, int k) { return __ldg(gn + (2 * q + 1) * C + c0 + k); };

  for (int d = a.D - 1; d >= 0; --d) {
    const float* xd = x + (int64_t)d * P * Cin;
    const float* h = d == 0 ? h0 : out + (int64_t)(d - 1) * plane;
    const float* gd = gout + (int64_t)d * plane;
    float* M = ms + (int64_t)d * plane;
    float* DG = dgs + (int64_t)d * P * C2;
    float* DYL = dyls + (int64_t)d * plane;
    float* DX = dx + (int64_t)d * P * Cin;

    // 1. gates, as the forward
    double s[4] = {0.0, 0.0, 0.0, 0.0};
    for (int64_t t = first; t < P * ga; t += step) {
      const int co0 = (int)(t % ga) * CO_T;
      const int64_t p = t / ga;
      float acc[CO_T];
#pragma unroll
      for (int k = 0; k < CO_T; ++k) acc[k] = __ldg(a.ba + co0 + k);
      conv_pixel<true>(xd, Cin, h, C, a.wa, C2, (int)(p / W), (int)(p % W), H, W, co0, acc);
      st4(G + p * C2 + co0, acc);
      const int half = co0 < C ? 0 : 2;
#pragma unroll
      for (int k = 0; k < CO_T; ++k) {
        s[half] += acc[k];
        s[half + 1] += (double)acc[k] * acc[k];
      }
    }
    block_sums(s, red, part[0] + 4 * blockIdx.x);
    grid.sync();

    // 2. r and u statistics; m = r·h
    plane_stats(elem[0], bpe, inv_n, 2, stats);
    for (int64_t p = first / gc; p < P; p += step / gc) {
      float gr[CO_T], hh[CO_T], mv[CO_T];
      unpack4(ld4(G + p * C2 + c0), gr);
      unpack4(ld4(h + p * C + c0), hh);
#pragma unroll
      for (int k = 0; k < CO_T; ++k)
        mv[k] = sigmoid(gn_affine(gr[k], stats[0], stats[1], gam(0, k), bet(0, k))) * hh[k];
      st4(M + p * C + c0, mv);
    }
    grid.sync();

    // 3. candidate, as the forward
    s[0] = s[1] = s[2] = s[3] = 0.0;
    for (int64_t t = first; t < P * gc; t += step) {
      const int cc = (int)(t % gc) * CO_T;
      const int64_t p = t / gc;
      float acc[CO_T];
#pragma unroll
      for (int k = 0; k < CO_T; ++k) acc[k] = __ldg(a.bb + cc + k);
      conv_pixel<true>(xd, Cin, M, C, a.wb, C, (int)(p / W), (int)(p % W), H, W, cc, acc);
      st4(Y + p * C + cc, acc);
#pragma unroll
      for (int k = 0; k < CO_T; ++k) {
        s[0] += acc[k];
        s[1] += (double)acc[k] * acc[k];
      }
    }
    block_sums(s, red, part[1] + 4 * blockIdx.x);
    grid.sync();

    // 4. the blend's and the tanh's adjoints; GN_y and GN_u transpose sums
    plane_stats(elem[1], bpe, inv_n, 1, stats + 4);
    s[0] = s[1] = s[2] = s[3] = 0.0;
    for (int64_t p = first / gc; p < P; p += step / gc) {
      float gu[CO_T], yr[CO_T], hh[CO_T], dhv[CO_T], gv[CO_T], dov[CO_T], duv[CO_T];
      unpack4(ld4(G + p * C2 + C + c0), gu);
      unpack4(ld4(Y + p * C + c0), yr);
      unpack4(ld4(h + p * C + c0), hh);
      unpack4(ld4(DH + p * C + c0), dhv);
      unpack4(ld4(gd + p * C + c0), gv);
#pragma unroll
      for (int k = 0; k < CO_T; ++k) {
        const float uh = (gu[k] - stats[2]) * stats[3];
        const float u = sigmoid(gn_affine(gu[k], stats[2], stats[3], gam(1, k), bet(1, k)));
        const float yh = (yr[k] - stats[4]) * stats[5];
        const float y = tanhf(gn_affine(yr[k], stats[4], stats[5], gam(2, k), bet(2, k)));
        const float dht = dhv[k] + gv[k];
        const float dov_ = dht * (1.f - u) * (1.f - y * y);
        const float duv_ = dht * (hh[k] - y) * u * (1.f - u);
        dov[k] = dov_;
        duv[k] = duv_;
        dhv[k] = dht * u;
        gacc[4][k] += dov_ * yh;
        gacc[5][k] += dov_;
        gacc[2][k] += duv_ * uh;
        gacc[3][k] += duv_;
        const double dyg = (double)dov_ * gam(2, k), dug = (double)duv_ * gam(1, k);
        s[0] += dyg;
        s[1] += dyg * yh;
        s[2] += dug;
        s[3] += dug * uh;
      }
      st4(DH + p * C + c0, dhv);
      st4(DYL + p * C + c0, dov);
      st4(DG + p * C2 + C + c0, duv);
    }
    block_sums(s, red, part[2] + 4 * blockIdx.x);
    grid.sync();

    // 5. dy_lin and dgu through the GroupNorm transposes
    plane_means(elem[2], bpe, inv_n, 4, stats + 6);
    for (int64_t p = first / gc; p < P; p += step / gc) {
      float gu[CO_T], yr[CO_T], dov[CO_T], duv[CO_T];
      unpack4(ld4(G + p * C2 + C + c0), gu);
      unpack4(ld4(Y + p * C + c0), yr);
      unpack4(ld4(DYL + p * C + c0), dov);
      unpack4(ld4(DG + p * C2 + C + c0), duv);
#pragma unroll
      for (int k = 0; k < CO_T; ++k) {
        const float yh = (yr[k] - stats[4]) * stats[5];
        const float uh = (gu[k] - stats[2]) * stats[3];
        dov[k] = (dov[k] * gam(2, k) - stats[6] - yh * stats[7]) * stats[5];
        duv[k] = (duv[k] * gam(1, k) - stats[8] - uh * stats[9]) * stats[3];
      }
      st4(DYL + p * C + c0, dov);
      st4(DG + p * C2 + C + c0, duv);
    }
    grid.sync();

    // 6. dm = convᵀ(dy_lin, Wc); the r chain; GN_r transpose sums
    s[0] = s[1] = 0.0;
    for (int64_t p = first / gc; p < P; p += step / gc) {
      float dm[CO_T] = {0.f, 0.f, 0.f, 0.f};
      conv_pixel<false>(nullptr, 0, DYL, C, a.wcT, C, (int)(p / W), (int)(p % W), H, W, c0, dm);
      float gr[CO_T], hh[CO_T], dhv[CO_T], drv[CO_T];
      unpack4(ld4(G + p * C2 + c0), gr);
      unpack4(ld4(h + p * C + c0), hh);
      unpack4(ld4(DH + p * C + c0), dhv);
#pragma unroll
      for (int k = 0; k < CO_T; ++k) {
        const float rh = (gr[k] - stats[0]) * stats[1];
        const float r = sigmoid(gn_affine(gr[k], stats[0], stats[1], gam(0, k), bet(0, k)));
        const float drv_ = dm[k] * hh[k] * r * (1.f - r);
        drv[k] = drv_;
        dhv[k] += dm[k] * r;
        gacc[0][k] += drv_ * rh;
        gacc[1][k] += drv_;
        const double drg = (double)drv_ * gam(0, k);
        s[0] += drg;
        s[1] += drg * rh;
      }
      st4(DH + p * C + c0, dhv);
      st4(DG + p * C2 + c0, drv);
    }
    block_sums(s, red, part[3] + 4 * blockIdx.x);
    grid.sync();

    // 7. dgr through GN_r's transpose
    plane_means(elem[3], bpe, inv_n, 2, stats + 10);
    for (int64_t p = first / gc; p < P; p += step / gc) {
      float gr[CO_T], drv[CO_T];
      unpack4(ld4(G + p * C2 + c0), gr);
      unpack4(ld4(DG + p * C2 + c0), drv);
#pragma unroll
      for (int k = 0; k < CO_T; ++k) {
        const float rh = (gr[k] - stats[0]) * stats[1];
        drv[k] = (drv[k] * gam(0, k) - stats[10] - rh * stats[11]) * stats[1];
      }
      st4(DG + p * C2 + c0, drv);
    }
    grid.sync();

    // 8. the state's cotangent for plane d − 1, and dx_d
    for (int64_t p = first / gc; p < P; p += step / gc) {
      float dhv[CO_T];
      unpack4(ld4(DH + p * C + c0), dhv);
      conv_pixel<false>(nullptr, 0, DG, C2, a.whT, C, (int)(p / W), (int)(p % W), H, W, c0, dhv);
      st4(DH + p * C + c0, dhv);
    }
    for (int64_t t = first; t < P * gx; t += step) {
      const int ci0 = (int)(t % gx) * CO_T;
      const int64_t p = t / gx;
      float acc[CO_T] = {0.f, 0.f, 0.f, 0.f};
      conv_pixel<false>(DG, C2, DYL, C, a.wxT, a.cinp, (int)(p / W), (int)(p % W), H, W, ci0,
                        acc);
      for (int k = 0; k < CO_T && ci0 + k < Cin; ++k) DX[p * Cin + ci0 + k] = acc[k];
    }
  }

  // the GroupNorm parameter cotangents: lanes of one channel group, then the
  // warps, then (after the sync) the blocks, each in a fixed order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = gc < 32 ? gc : 32;
  for (int q = 0; q < 6; ++q) {
    for (int k = 0; k < CO_T; ++k) {
      float v = gacc[q][k];
      for (int off = 16; off >= groups; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane < groups) gsm[warp][lane] = v;
      __syncthreads();
      if ((int)threadIdx.x < groups) {
        double t = 0.0;
        for (int w = 0; w < WARPS; ++w) t += gsm[w][threadIdx.x];
        a.gnpart[((int64_t)blockIdx.x * 6 + q) * C + threadIdx.x * CO_T + k] = t;
      }
      __syncthreads();
    }
  }
  grid.sync();
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < 6 * C; i += blockDim.x) {
      double t = 0.0;
      for (int blk = 0; blk < (int)gridDim.x; ++blk) t += a.gnpart[(int64_t)blk * 6 * C + i];
      a.dgn[i] = (float)t;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Blocks of a cooperative launch of `kernel` for B elements of an (H, W)
// plane with C state channels: B equal groups, each of at most the blocks one
// element's gate work fills, all resident at once and at most max_blocks in
// all.  A negative CUDA error code when not even one block per element fits.
template <typename K>
int coop_blocks(K kernel, int B, int H, int W, int C, int max_blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if (B < 1) return -(int)cudaErrorInvalidValue;
  if ((err = cudaGetDevice(&dev))) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0)))
    return -(int)err;
  int64_t per = ((int64_t)H * W * (2 * C / CO_T) + THREADS - 1) / THREADS;
  const int64_t resident = (int64_t)per_sm * sms / B;
  if (resident < per) per = resident;
  if (max_blocks / B < per) per = max_blocks / B;
  return per < 1 ? -(int)cudaErrorCooperativeLaunchTooLarge : (int)(B * per);
}

// One cooperative launch of `kernel` with its argument struct; returns
// cudaGetLastError()-style codes (0 = launched).
template <typename K, typename A>
int coop_launch(K kernel, A a, int blocks, void* stream) {
  void* kargs[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(THREADS),
                                                kargs, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch is not sticky: clear it for later launches
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks that red_recur_f32 launches (see coop_blocks); the caller sizes the
// `part` scratch as 8 doubles per block.
extern "C" int red_recur_blocks(int B, int H, int W, int C, int max_blocks) {
  return coop_blocks(red_recur_kernel, B, H, W, C, max_blocks);
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
  return coop_launch(red_recur_kernel, Args{x, h0, out, g, m, part, wa, ba, wb, bb, gn, B, D, H, W,
                                            Cin, C},
                     blocks, stream);
}

// Blocks that red_recur_bwd_f32 launches (see coop_blocks); the caller sizes
// `part` as 16 doubles per block and `gnpart` as 6·C.
extern "C" int red_recur_bwd_blocks(int B, int H, int W, int C, int max_blocks) {
  return coop_blocks(red_recur_bwd_kernel, B, H, W, C, max_blocks);
}

// The reverse-plane adjoint of red_recur_f32 over B elements in one
// cooperative launch of `blocks` blocks (from red_recur_bwd_blocks) on
// `stream`: dx, the per-plane cotangents dg (B, D, H, W, 2C) and dyl
// (B, D, H, W, C), the recomputed m (B, D, H, W, C) for the caller's weight
// cotangents, and dgn (6, C).  dh must hold zeros.  C/4 must be a power of
// two and at most 32, cinp = Cin rounded up to 4, every float pointer but x's
// and dx's 16-byte aligned.  Returns cudaGetLastError()-style codes (0 = launched).
extern "C" int red_recur_bwd_f32(const float* x, const float* h0, const float* out,
                                 const float* gout, float* dx, float* dg, float* dyl, float* m,
                                 float* graw, float* yraw, float* dh, double* part,
                                 double* gnpart, float* dgn, const float* wa, const float* ba,
                                 const float* wb, const float* bb, const float* gn,
                                 const float* whT, const float* wcT, const float* wxT, int B,
                                 int D, int H, int W, int Cin, int C, int blocks, void* stream) {
  const int gc = C / CO_T;
  if (C % CO_T != 0 || gc > 32 || (gc & (gc - 1)) != 0 || B < 1 || blocks < B ||
      blocks % B != 0)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {h0, out, gout, dg, dyl, m, graw, yraw, dh, part, gnpart,
                        wa, ba, wb, bb, gn, whT, wcT, wxT};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  if (D == 0) return 0;
  return coop_launch(red_recur_bwd_kernel,
                     BwdArgs{x, h0, out, gout, dx, dg, dyl, m, graw, yraw, dh, part, gnpart, dgn,
                             wa, ba, wb, bb, gn, whT, wcT, wxT, B, D, H, W, Cin, C,
                             (Cin + CO_T - 1) / CO_T * CO_T},
                     blocks, stream);
}
