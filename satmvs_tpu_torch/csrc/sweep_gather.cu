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
// bf16 cotangents, :666-681) has kernels of its own, below the fp32 ones:
// sweep_gather_bf16_kernel sums the taps in float and rounds each value
// once, at the store, to nearest even (Tensor.to(torch.bfloat16));
// sweep_scatter_bf16_kernel widens each bf16 cotangent exactly at the read
// and sums in float into a float dsrc.  The volume's bytes halve: at the
// train shapes the gather's least traffic falls from 162.8, 174.6 and
// 103.8 MB a view and stage to 87.3, 99.1 and 66.0 MB.  What paced them as
// instances of the fp32 templates was not those bytes: 8 bytes of volume a
// thread and plane, four corner loads for every sample, and in the scatter
// up to four 16-byte global atomics for every 8 bytes of cotangent read.
//
// The bf16 gather gives a thread 8 channels (two float4 corner loads, one
// 16-byte streaming store of 8 bf16 values), loads the next plane's
// coordinates while it samples this one, and keeps its four corners in
// registers while the floor corner stays from plane to plane (the planes of
// a coarse stage move by a fraction of a pixel; sweep_variance.cu does the
// same).  Each sample is bilinear.cuh's `sample`: the valid corners in Taps
// order, each an fma onto a sum from 0, so it gives the fp32 instance's
// bits before the rounding.
//
// The bf16 scatter is the TPU kernel's resident accumulator cut to what one
// block can hold.  A block owns a tile of ty × tx reference pixels, a group
// of cg channels and a chunk of P planes.  It first reads the chunk's
// coordinates and reduces the box of the image pixels its samples touch
// (a tap off the image adds nothing, so the box is clamped to the image).
// sm_90 has no shared-memory float add: atomicAdd on shared memory is a
// compare-and-swap loop, and a window summed that way ran no faster than
// the global atomics it replaces.  So the window is summed without float
// atomics: the block sorts its samples by floor corner (a count per corner
// with integer shared atomics, a prefix sum, a list of the samples' offsets
// and tap weights),
// and then a thread owns one touched pixel and 8 channels (g read 16 bytes
// at a time) and sums in registers the tap-weighted values of the samples
// whose corner lands on it, those of its four neighbouring floor corners,
// and adds the sums into dsrc with one float4 atomic per four channels.
// When the sort does not fit the block's shared memory (a wide footprint,
// samples far apart), the block takes the fp32 kernel's path instead: runs
// of planes summed in registers, then float4 global atomics.  `blocks[0]`
// counts the blocks, `blocks[1]` those that took that path.  Both paths
// form each product __fmul_rn(w, g) and sum in some order, so the bound
// above holds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear.cuh"

#include <climits>

namespace {

using bilinear::store_streaming;

// Thread (i, j, channel group) of grid (W·groups / 256, H, plane chunks)
// samples planes [z·P, z·P + P) of its pixel, two at a time.  The pixel and
// channel come from the grid, one 32-bit division per thread.
template <int VEC>
__global__ void __launch_bounds__(256) sweep_gather_kernel(
    const float* __restrict__ src, const float* __restrict__ xs,
    const float* __restrict__ ys, float* __restrict__ out, int D, int H, int W, int C, int P,
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

// Planes [d0, d1) of one (pixel, VEC channels) of a scatter, g and pix at
// plane d0: while consecutive planes share their floor corner (x0, y0), it
// sums the tap-weighted values of each corner in registers; when the
// corner moves, and at the end, it adds the four sums into dsrc.
template <int VEC, typename In>
__device__ __forceinline__ void scatter_runs(const In* __restrict__ g,
                                             const float* __restrict__ xs,
                                             const float* __restrict__ ys,
                                             float* __restrict__ dsrc, int64_t pix,
                                             int64_t plane, int d0, int d1, int Hs, int W,
                                             int C, int c0) {
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

// Thread (i, j, channel group) of grid (W·groups / 256, H, plane chunks)
// walks planes [z·P, z·P + P) of its pixel in order (scatter_runs).  The
// pixel and channel come from the grid, one 32-bit division per thread.
template <int VEC>
__global__ void __launch_bounds__(256) sweep_scatter_kernel(
    const float* __restrict__ g, const float* __restrict__ xs,
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
  scatter_runs<VEC>(g, xs, ys, dsrc, d0 * plane + (int64_t)blockIdx.y * W + j, plane, d0, d1,
                    Hs, W, C, c0);
}

// Thread (i, j, channel group) of grid (W·groups / 256, H, plane chunks)
// samples planes [z·P, z·P + P) of its pixel in order: the next plane's
// coordinates load while this plane is sampled, and the four corners'
// values (and which of them lie in the image) stay in registers while the
// floor corner does.
template <int VEC>
__global__ void __launch_bounds__(256) sweep_gather_bf16_kernel(
    const float* __restrict__ src, const float* __restrict__ xs,
    const float* __restrict__ ys, unsigned short* __restrict__ out, int D, int H, int W, int C,
    int P, int Hs) {
  const int groups = C / VEC;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W * groups) return;
  const int j = t / groups;
  const int c0 = (t - j * groups) * VEC;
  const int d0 = blockIdx.z * P;
  const int d1 = d0 + P < D ? d0 + P : D;
  const int64_t plane = (int64_t)H * W;
  int64_t pix = d0 * plane + (int64_t)blockIdx.y * W + j;
  float nx = __ldcs(xs + pix), ny = __ldcs(ys + pix);
  float cv[4][VEC] = {};
  unsigned valid = 0;  // bit k: corner k lies in the image
  int cx = -3, cy = -3;  // no corner yet: Taps clamps to ≥ −2
  for (int d = d0; d < d1; ++d, pix += plane) {
    const bilinear::Taps taps(nx, ny, Hs, W);
    if (d + 1 < d1) {
      nx = __ldcs(xs + pix + plane);
      ny = __ldcs(ys + pix + plane);
    }
    if (taps.x0 != cx || taps.y0 != cy) {
      cx = taps.x0;
      cy = taps.y0;
      valid = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t p = taps.pixel(k, Hs, W);
        if (p >= 0) {
          bilinear::load_vec<VEC>(src + p * C + c0, cv[k]);
          valid |= 1u << k;
        }
      }
    }
    // bilinear::sample: the valid corners in Taps order, each an fma
    float o[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (valid & (1u << k)) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) o[i] = __fmaf_rn(cv[k][i], taps.w[k], o[i]);
      }
    store_streaming<VEC>(out + pix * C + c0, o);
  }
}

// The image pixels a sample's taps touch: x0..x1 × y0..y1, empty (x0 > x1)
// when no corner lies in the image.
struct Touched {
  int x0, x1, y0, y1;

  __device__ __forceinline__ Touched(const bilinear::Taps& t, int H, int W) {
    x0 = max(t.x0, 0);
    x1 = min(t.x0 + 1, W - 1);
    y0 = max(t.y0, 0);
    y1 = min(t.y0 + 1, H - 1);
    if (y0 > y1) x0 = INT_MAX;  // no row in the image: empty
  }
};

// In place: p[0 .. n) → its exclusive prefix sums, p[n] = the total; all
// threads of the block call it.  part: a warp's worth of ints.
__device__ __forceinline__ void block_exclusive_scan(int* p, int n, int* part) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += p[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    int w = lane < nw ? part[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += up;
    }
    if (lane < nw) part[lane] = w;  // inclusive totals of the warps
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? part[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int v = p[i];
    p[i] = run;
    run += v;
  }
  if (threadIdx.x == blockDim.x - 1) p[n] = part[(blockDim.x - 1) >> 5];
  __syncthreads();
}

constexpr int kScatterThreads = 256;  // the plan's threads a block, at most
constexpr int kScatterBlocks = 4;     // resident blocks an SM (64 registers a thread)
// the window's ints at most: 48 KB of shared memory, the most a block
// takes without an opt-in, less the kernel's static 144 bytes (box and the
// scan's warp totals); kScatterBlocks such blocks share an SM's 227 KB
constexpr int kMaxWindow = (48 * 1024 - 144) / sizeof(int);

// Block (tile, chunk, channel group) of grid (tiles_y·tiles_x, ceil(D / P),
// ceil(C / cg)): pixels (i0 .. i0 + ty − 1, j0 .. j0 + tx − 1), planes
// [d0, d1), channels [cb, cb + cg); `lanes` = cg / VEC threads a pixel,
// side by side.  The window: `budget` ints of dynamic shared memory.
template <int VEC>
__global__ void __launch_bounds__(kScatterThreads, kScatterBlocks) sweep_scatter_bf16_kernel(
    const unsigned short* __restrict__ g, const float* __restrict__ xs,
    const float* __restrict__ ys, float* __restrict__ dsrc, int D, int H, int W, int C, int Hs,
    int cg, int ty, int tx, int P, int budget, unsigned* __restrict__ blocks) {
  extern __shared__ int smem[];
  __shared__ int box[4];   // x0, y0, −x1, −y1 of the touched pixels
  __shared__ int part[32];  // the scan's warp totals
  const int tiles_x = (W + tx - 1) / tx;
  const int i0 = blockIdx.x / tiles_x * ty;
  const int j0 = (blockIdx.x % tiles_x) * tx;
  const int d0 = blockIdx.y * P;
  const int d1 = min(d0 + P, D);
  const int cb = blockIdx.z * cg;
  const int lanes = cg / VEC;
  const int64_t plane = (int64_t)H * W;
  const int tile = ty * tx, ns = tile * (d1 - d0);  // the block's samples
  if (threadIdx.x < 4) box[threadIdx.x] = INT_MAX;
  __syncthreads();

  // the box of the pixels touched by the chunk's samples
  int bx0 = INT_MAX, by0 = INT_MAX, bx1 = INT_MAX, by1 = INT_MAX;  // x1, y1 negated
  for (int q = threadIdx.x; q < ns; q += blockDim.x) {
    const int dd = q / tile, r = q - dd * tile;
    const int i = i0 + r / tx, j = j0 + r % tx;
    if (i >= H || j >= W) continue;
    const int64_t pix = (d0 + dd) * plane + (int64_t)i * W + j;
    const Touched t(bilinear::Taps(__ldg(xs + pix), __ldg(ys + pix), Hs, W), Hs, W);
    if (t.x0 > t.x1) continue;
    bx0 = min(bx0, t.x0);
    by0 = min(by0, t.y0);
    bx1 = min(bx1, -t.x1);
    by1 = min(by1, -t.y1);
  }
  bx0 = __reduce_min_sync(0xffffffffu, bx0);
  by0 = __reduce_min_sync(0xffffffffu, by0);
  bx1 = __reduce_min_sync(0xffffffffu, bx1);
  by1 = __reduce_min_sync(0xffffffffu, by1);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(box, bx0);
    atomicMin(box + 1, by0);
    atomicMin(box + 2, bx1);
    atomicMin(box + 3, by1);
  }
  __syncthreads();
  const int x0 = box[0], y0 = box[1];
  if (x0 == INT_MAX) {  // no sample of the block touches the image
    if (threadIdx.x == 0) atomicAdd(blocks, 1u);
    return;
  }
  const int ww = -box[2] - x0 + 1, wh = -box[3] - y0 + 1;
  // floor corners of the touching samples: (x0 − 1 .. x1) × (y0 − 1 .. y1)
  const int fw = ww + 1, nf = fw * (wh + 1);
  const bool fits = (int64_t)nf + 1 + 7 * (int64_t)ns <= budget &&
                    (int64_t)(d1 - d0) * plane <= INT_MAX;
  if (threadIdx.x == 0) {
    atomicAdd(blocks, 1u);
    if (!fits) atomicAdd(blocks + 1, 1u);
  }

  if (!fits) {  // 8 channels as two runs of 4: their sums stay in registers
    for (int it = threadIdx.x; it < tile * lanes; it += blockDim.x) {
      const int q = it / lanes, c0 = cb + (it - q * lanes) * VEC;
      const int i = i0 + q / tx, j = j0 + q % tx;
      if (i >= H || j >= W || c0 >= C) continue;
      const int64_t pix = d0 * plane + (int64_t)i * W + j;
      constexpr int R = VEC == 8 ? 4 : VEC;
#pragma unroll
      for (int c = 0; c < VEC; c += R)
        scatter_runs<R>(g, xs, ys, dsrc, pix, plane, d0, d1, Hs, W, C, c0 + c);
    }
    return;
  }

  // a counting sort of the samples by floor corner: in sorted order each
  // sample's four tap weights and its offset from plane d0 (an int: the
  // chunk fits); off[nf + 1] the counts, then their prefix sums; each
  // sample's floor corner and its slot among that corner's samples
  float4* weights = reinterpret_cast<float4*>(smem);
  int* list = smem + 4 * ns;
  int* off = list + ns;
  int* slot = off + nf + 1;
  int* corner = slot + ns;
  for (int k = threadIdx.x; k <= nf; k += blockDim.x) off[k] = 0;
  __syncthreads();
  for (int q = threadIdx.x; q < ns; q += blockDim.x) {
    const int dd = q / tile, r = q - dd * tile;
    const int i = i0 + r / tx, j = j0 + r % tx;
    corner[q] = -1;
    if (i >= H || j >= W) continue;
    const int64_t pix = (d0 + dd) * plane + (int64_t)i * W + j;
    const bilinear::Taps t(__ldg(xs + pix), __ldg(ys + pix), Hs, W);
    const Touched u(t, Hs, W);
    if (u.x0 > u.x1) continue;
    const int f = (t.y0 - y0 + 1) * fw + (t.x0 - x0 + 1);
    corner[q] = f;
    slot[q] = atomicAdd(off + f, 1);
  }
  __syncthreads();
  block_exclusive_scan(off, nf, part);
  for (int q = threadIdx.x; q < ns; q += blockDim.x) {
    const int f = corner[q];
    if (f < 0) continue;
    const int dd = q / tile, r = q - dd * tile;
    const int rel = (int)(dd * plane + (int64_t)(i0 + r / tx) * W + j0 + r % tx);
    const bilinear::Taps t(__ldg(xs + d0 * plane + rel), __ldg(ys + d0 * plane + rel), Hs, W);
    const int n = off[f] + slot[q];
    list[n] = rel;
    weights[n] = make_float4(t.w[0], t.w[1], t.w[2], t.w[3]);
  }
  __syncthreads();

  // item (touched pixel, VEC channels): the sum of the tap-weighted values
  // of the samples whose corner k lands on it, those of floor corner
  // (x − (k & 1), y − (k >> 1)), in registers; then one atomic into dsrc
  const float* wk = reinterpret_cast<const float*>(weights);
  for (int it = threadIdx.x; it < ww * wh * lanes; it += blockDim.x) {
    const int cell = it / lanes, lc = (it - cell * lanes) * VEC;
    if (cb + lc >= C) continue;
    const int cy = cell / ww, cx = cell - cy * ww;
    float acc[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[c] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = (cy + 1 - (k >> 1)) * fw + cx + 1 - (k & 1);
      int n = off[f];
      const int e = off[f + 1];
      for (; n + 1 < e; n += 2) {  // two samples' loads in flight
        const float w0 = wk[4 * n + k], w1 = wk[4 * n + 4 + k];
        float v0[VEC], v1[VEC];
        bilinear::load_vec<VEC>(g + (d0 * plane + list[n]) * C + cb + lc, v0);
        bilinear::load_vec<VEC>(g + (d0 * plane + list[n + 1]) * C + cb + lc, v1);
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[c] += __fmul_rn(w0, v0[c]);
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[c] += __fmul_rn(w1, v1[c]);
      }
      if (n < e) {
        const float w = wk[4 * n + k];
        float v[VEC];
        bilinear::load_vec<VEC>(g + (d0 * plane + list[n]) * C + cb + lc, v);
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[c] += __fmul_rn(w, v[c]);
      }
    }
    float* dst = dsrc + ((int64_t)(y0 + cy) * W + x0 + cx) * C + cb + lc;
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int q = 0; q < VEC; q += 4)
        if (acc[q] != 0.f || acc[q + 1] != 0.f || acc[q + 2] != 0.f || acc[q + 3] != 0.f)
          atomicAdd(reinterpret_cast<float4*>(dst + q),
                    make_float4(acc[q], acc[q + 1], acc[q + 2], acc[q + 3]));
    } else {
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        if (acc[c] != 0.f) atomicAdd(dst + c, acc[c]);
    }
  }
}

constexpr int kThreads = 256;

// The grid of the per-pixel kernels, (W·groups / kThreads, H, chunks of
// `planes` planes); false when the arguments are invalid.  A grid without
// blocks means there is no work.
bool sweep_grid(int D, int H, int W, int C, int vec, int planes, int Hs, dim3& grid) {
  if ((vec != 1 && vec != 4 && vec != 8) || C % vec != 0 || planes < 1 || D < 0 || H < 0 ||
      W < 0 || H > 65535 || Hs < 0)
    return false;
  const int64_t row_threads = (int64_t)W * (C / vec);
  const int64_t chunks = ((int64_t)D + planes - 1) / planes;
  if (row_threads > 0x7fffffff || chunks > 65535) return false;
  grid = dim3((unsigned)((row_threads + kThreads - 1) / kThreads), (unsigned)H, (unsigned)chunks);
  return true;
}

// Runs launch(grid, stream) on the grid of sweep_grid; returns
// cudaGetLastError(), or cudaErrorInvalidValue for invalid arguments.
template <typename Launch>
int on_grid(int D, int H, int W, int C, int vec, int planes, int Hs, void* stream,
            Launch launch) {
  dim3 grid;
  if (!sweep_grid(D, H, W, C, vec, planes, Hs, grid)) return (int)cudaErrorInvalidValue;
  if (grid.x == 0 || grid.y == 0 || grid.z == 0) return 0;
  launch(grid, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

template <int VEC>
int scatter_bf16(const unsigned short* g, const float* xs, const float* ys, float* dsrc, int D,
                 int H, int W, int C, int Hs, int cg, int ty, int tx, int planes, int threads,
                 int budget, unsigned* blocks, cudaStream_t st) {
  const dim3 grid((unsigned)(((H + ty - 1) / ty) * ((W + tx - 1) / tx)),
                  (unsigned)((D + planes - 1) / planes), (unsigned)((C + cg - 1) / cg));
  sweep_scatter_bf16_kernel<VEC><<<grid, threads, budget * sizeof(int), st>>>(
      g, xs, ys, dsrc, D, H, W, C, Hs, cg, ty, tx, planes, budget, blocks);
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
  if (vec == 8) return (int)cudaErrorInvalidValue;
  return on_grid(D, H, W, C, vec, planes, Hs, stream, [&](dim3 grid, cudaStream_t st) {
    if (vec == 4)
      sweep_gather_kernel<4><<<grid, kThreads, 0, st>>>(src, xs, ys, out, D, H, W, C, planes, Hs);
    else
      sweep_gather_kernel<1><<<grid, kThreads, 0, st>>>(src, xs, ys, out, D, H, W, C, planes, Hs);
  });
}

// The same with a bfloat16 out (its 16 bits): the taps summed in float,
// rounded once at the store to nearest even; vec may also be 8 (C % 8 ==
// 0, all pointers 16-byte aligned).
extern "C" int sweep_gather_bf16(const float* src, const float* xs, const float* ys,
                                 unsigned short* out, int D, int H, int W, int C, int vec,
                                 int planes, int Hs, void* stream) {
  return on_grid(D, H, W, C, vec, planes, Hs, stream, [&](dim3 grid, cudaStream_t st) {
    if (vec == 8)
      sweep_gather_bf16_kernel<8><<<grid, kThreads, 0, st>>>(src, xs, ys, out, D, H, W, C,
                                                             planes, Hs);
    else if (vec == 4)
      sweep_gather_bf16_kernel<4><<<grid, kThreads, 0, st>>>(src, xs, ys, out, D, H, W, C,
                                                             planes, Hs);
    else
      sweep_gather_bf16_kernel<1><<<grid, kThreads, 0, st>>>(src, xs, ys, out, D, H, W, C,
                                                             planes, Hs);
  });
}

// dsrc (Hs, W, C) += the transpose of the gather applied to g (D, H, W, C);
// the caller zeroes dsrc.  Same launch contract.
extern "C" int sweep_scatter_f32(const float* g, const float* xs, const float* ys, float* dsrc,
                                 int D, int H, int W, int C, int vec, int planes, int Hs,
                                 void* stream) {
  if (vec == 8) return (int)cudaErrorInvalidValue;
  return on_grid(D, H, W, C, vec, planes, Hs, stream, [&](dim3 grid, cudaStream_t st) {
    if (vec == 4)
      sweep_scatter_kernel<4><<<grid, kThreads, 0, st>>>(g, xs, ys, dsrc, D, H, W, C, planes, Hs);
    else
      sweep_scatter_kernel<1><<<grid, kThreads, 0, st>>>(g, xs, ys, dsrc, D, H, W, C, planes, Hs);
  });
}

// The same with a bfloat16 g (its 16 bits), widened exactly at the read;
// the sums and dsrc stay float.  The launch plan (ops/kernels/
// sweep_gather.py `scatter_window_plan`): tiles of ty × tx pixels, groups
// of cg channels (a multiple of vec), chunks of `planes` planes, `threads`
// threads a block (a multiple of 32, ≤ 256), a window of at most `budget`
// floats; vec 8 (C % 8 == 0), 4 (C % 4 == 0) or 1, all pointers 16-byte
// aligned unless vec is 1.  blocks[0] += the blocks launched, blocks[1] +=
// those whose window did not fit.
extern "C" int sweep_scatter_bf16(const unsigned short* g, const float* xs, const float* ys,
                                  float* dsrc, int D, int H, int W, int C, int Hs, int vec,
                                  int cg, int ty, int tx, int planes, int threads, int budget,
                                  unsigned* blocks, void* stream) {
  if ((vec != 1 && vec != 4 && vec != 8) || C % vec != 0 || cg < vec || cg % vec != 0 ||
      ty < 1 || tx < 1 || planes < 1 || threads < 32 || threads > kScatterThreads ||
      threads % 32 != 0 || budget < 0 || budget > kMaxWindow || D < 0 ||
      H < 0 || W < 0 || C < 0 || Hs < H || (int64_t)ty * tx * (cg / vec) > 0x7fffffff ||
      (D + (int64_t)planes - 1) / planes > 65535 || ((int64_t)C + cg - 1) / cg > 65535 ||
      (int64_t)((H + ty - 1) / ty) * ((W + tx - 1) / tx) > 0x7fffffff || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  if (D == 0 || H == 0 || W == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8)
    return scatter_bf16<8>(g, xs, ys, dsrc, D, H, W, C, Hs, cg, ty, tx, planes, threads, budget,
                           blocks, st);
  if (vec == 4)
    return scatter_bf16<4>(g, xs, ys, dsrc, D, H, W, C, Hs, cg, ty, tx, planes, threads, budget,
                           blocks, st);
  return scatter_bf16<1>(g, xs, ys, dsrc, D, H, W, C, Hs, cg, ty, tx, planes, threads, budget,
                         blocks, st);
}
