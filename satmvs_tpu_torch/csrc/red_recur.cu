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
// grid.sync() ends each of a plane's three phases:
//   A. the gates conv over [x_d | h] into the raw-gate scratch G (H, W, 2C),
//      with each block's sums of g and g² for the r and u halves;
//   B. every block combines the per-block sums into the r and u statistics;
//      the candidate conv over [x_d | m] into the raw scratch Y (H, W, C),
//      m = σ(GN_r(g))·h mapped in shared memory as the conv stages G and h,
//      with the per-block sums of the candidate;
//   C. the candidate statistics, then the blend into out[d] at the block's
//      own pixels (the next plane reads its neighbours there as halo; after
//      the last plane no sync is needed).
// The state needs no buffer of its own: plane d reads h from out[d − 1] (or
// h0) and writes out[d], so a halo read and a blend write never touch the same
// array.  The x-side convs carry no state and run inside A and B with the
// same loop as the state side, so no (D, H, W, 3C) buffer is made.  Folding
// the blend into the next plane's gate staging (two syncs a plane) would
// stage three raw operands a state channel and need a second G; not done.
//
// The two convs are phases A and B of the backward kernel below, the same
// device functions (`gates_pass`, `candidate_pass`) on the same block-tiled
// routine `conv_items` (described there), under the same launch plan: the
// wrapper takes the adjoint's plan's two first convs and its blocks per
// element (ops/kernels/red_recur.py `red_recur_plan`), so the adjoint's
// recompute repeats the forward's arithmetic in the same order.
//
// Batch.  The grid is B equal groups of `bpe` blocks; group b works on element
// b only (its items and own pixels), so every block's partial sums belong to
// one element and GroupNorm statistics are never mixed across elements.  The
// three syncs of a plane are shared by all B elements: at the coarse scales,
// where a plane is a few hundred pixels, the work between two syncs grows
// B-fold.
//
// Statistics: one pass.  Each thread sums its values and their squares in
// float64; a block reduces its threads in a fixed tree and writes its partial
// sums; in the next phase every block adds its element's partials with all
// its threads in one fixed order, so the statistics are deterministic and the
// same in every block of the element.  var = E[g²] − E[g]² in float64 loses
// nothing that matters at these magnitudes (the products of two floats are
// exact in a double), and saves the extra sync per norm that the TPU kernel's
// two passes (mean, then centred variance) would cost.  Data written inside
// the kernel (G, Y, out, the partial sums) is read with plain loads or
// cp.async, never through the non-coherent read-only path.
//
// Widths that are not a multiple of 4.  The kernels move C in float4
// groups, so a state of Cn channels runs at C = 4⌈Cn/4⌉: the wrapper pads
// the start state, the cotangent and the weights with zeros (zero gate and
// candidate outputs for the pad channels, zero rows for the pad state
// inputs, zero GroupNorm scale and shift).  A pad channel's raw gates and
// candidate are then exactly 0, which adds nothing to the sums of g and
// g²; r = u = σ(0) and y = tanh(0) = 0 keep its state at 0 plane after
// plane, and every transpose sum weighs it by a zero scale.  Only the
// count changes: the statistics and the transposes' means divide by
// H·W·Cn, the real values of a plane.  At Cn = C nothing differs.
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
// What bounds it: operations.  Per plane it recomputes the forward's two
// convs and takes the data cotangents (convᵀ of the candidate's cotangent
// through Wc, of the gates' through Wh, and dx through Wx): twice the
// forward's 27·(Cin + C)·C FMAs a pixel, ~367 GFLOP over a B = 1 train
// step's 12 calls, ~5.5 ms at 67 TFLOP/s.  The weight cotangents (as many
// operations again) are left to plane_conv.cu's reduction.
//
// Design.  The forward's persistent cooperative grid and per-element block
// groups, walking the planes from D − 1 down to 0 with the state's cotangent
// dh carried in a (B, H, W, C) buffer.  A plane takes four grid syncs, after
// its phases A-D (listed above the kernel); phase E needs none, because the
// next plane's phase A writes only the other one of two raw-gate buffers
// (chosen by the parity of d) and per-block sums that E does not read.  The
// elementwise passes that existed only so that the next conv could read
// mapped values at neighbouring pixels are folded into the staging of that
// conv: B stages m = r·h from the raw gates and h, D stages dy_lin from the
// raw do and the raw candidate, E stages the gate cotangents from the raw dr
// and du and the raw gates.  The raw do, du and dr live in plane-sized
// scratch that no phase writes while another block reads it as halo; the
// mapped values go to the per-plane m, dyl and dg slices for the weight
// reductions (m and dyl written by the work item that owns the pixel, dg by
// E's own-pixel pass).
//
// The four convs (the gates, the candidate, convᵀ through Wc, and one convᵀ
// whose output channels are dh's C and then dx's Cin, through [Wh | Wx])
// share one block-tiled routine on the CUDA cores in fp32 FMA.  A work item
// is a tile of 32 columns × wr·PX rows of one element's plane and a slab of
// wc·8 output channels.  For each chunk of ck input channels (8 to 64) the
// block copies the tile's raw operands with their one-pixel halo (one a
// channel for the gates, two for the others: the raw gate and h for m, the
// raw do and candidate for dy_lin, the raw dr or du and gate for the gate
// cotangents) and the matching weights [9][ck][slab] into shared memory
// with cp.async, zeros outside the plane, all copies in flight at once; the
// threads then map the raw operands in place.  Staged channels are planes
// of ≡ 32/min(ck, 32) words mod 32, so a warp's copies land in 32 banks.
// Each thread holds PX (1 or 2) rows × 8 channels of one column in
// registers and, per input channel and column shift, reads PX + 2 inputs and
// 3 × 8 weights (one address across the warp: a broadcast) for 24·PX FMAs;
// four rows a thread would spill registers.  Weight traffic from L2 falls by
// the tile's pixel count.  Where a plane has few items, wk warps split each
// chunk's input channels and add their sums in a fixed order.  The launch
// plan (PX, wr, wc, wk, ck per conv, blocks per element) comes from a cost
// model in Python (ops/kernels/red_recur.py `red_recur_bwd_plan`; the
// forward's `red_recur_plan` is its first two convs).  A tile's
// position comes from the item index (one 32-bit division per item), never
// per element.
//
// Phases A and B are the forward's own (the same device functions, plan and
// blocks per element), so the recomputed r, u and y repeat the forward's
// arithmetic in the same order: the adjoint is that of red_recur_kernel's
// own states.  The statistics and the GroupNorm transposes' two whole-plane
// sums each are float64 per-block partials, which every block of the element
// adds with all its threads in one fixed order.  The weight cotangents are
// not reduced in the kernel: a per-block partial of dWa + dWb
// at C = 64 is 9·128·192 floats (885 KB), a few hundred MB over the grid.
// Instead the kernel keeps every plane's gate and candidate cotangents
// (B, D, H, W, 3C) and the recomputed r·h (B, D, H, W, C), and the wrapper
// reduces them with plane_conv.cu's weight kernel (fixed order) after the
// loop.  The six GroupNorm parameter cotangents (6·C values) are summed in
// each thread's own shared-memory slots (a thread keeps one group of four
// channels in the elementwise passes) and reduced once at the end in a fixed
// order.  No atomics: every result is the same in every run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BT = 256;            // threads of a block
constexpr int WARPS = BT / 32;
constexpr double EPS = 1e-5;
constexpr int BCO = 8;             // output channels a thread holds in a conv
constexpr int TW = 32;             // tile columns: one per lane
constexpr int RS = TW + 2;         // a staged row: the tile's columns and the halo
constexpr int TR_MAX = 16;         // tile rows at most: 8 row groups × 2 rows
constexpr int SLAB_MAX = WARPS * BCO;  // output channels of a slab at most

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// GroupNorm(1)'s affine map of a raw value, one expression for the forward
// and the backward's recompute, so both round alike
__device__ __forceinline__ float gn_affine(float raw, float mean, float inv, float scale,
                                           float shift) {
  return (raw - mean) * inv * scale + shift;
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

// Words of one staged input channel of a tile of tr rows when a chunk holds
// ck (8, 16, 32 or 64) channels: at least (tr + 2)·RS and ≡ m (mod 32),
// m = 32 / min(ck, 32), so the staging's m pixels × min(ck, 32) channels of a
// warp store to 32 different banks.
__host__ __device__ constexpr int staged_plane(int tr, int ck) {
  return ((tr + 2) * RS - 32 / (ck < 32 ? ck : 32) + 31) / 32 * 32 + 32 / (ck < 32 ? ck : 32);
}

// the staged inputs (or a reduction of the warps' shares): a chunk's raw
// operands, two a channel of 16 channels of an 8-row tile (or of 8 channels
// of a 16-row tile); and the staged weights, 9 × ck × slab
constexpr int IN_WORDS = 2 * 16 * staged_plane(TR_MAX / 2, 16);
constexpr int W_WORDS = 9 * 16 * SLAB_MAX;
constexpr int GACC = 24;  // GroupNorm parameter sums a thread keeps: 6 sums × 4 channels
constexpr int FWD_SMEM = (IN_WORDS + W_WORDS) * 4;
constexpr int BWD_SMEM = FWD_SMEM + GACC * BT * 4;

// One conv's launch plan: px rows a thread; wr row groups × wc channel groups
// × wk shares of each chunk's input channels = the block's 8 warps; ck input
// channels a chunk (8, 16, 32 or 64, as the tile and the slab leave room).
// An item is (wr·px) × TW pixels of one element's plane and wc·BCO output
// channels.
struct ConvPlan {
  int px, wr, wc, wk, ck;
};

struct FwdArgs {
  const float* x;   // (B, D, H, W, Cin)
  const float* h0;  // (B, H, W, C)
  float* out;       // (B, D, H, W, C)
  float* graw;      // (B, H, W, 2C) scratch: raw gates
  float* yraw;      // (B, H, W, C) scratch: raw candidate
  double* part;     // (2, gridDim.x, 4) per-block sums
  const float* wa;  // (9, Cin + C, 2C)
  const float* ba;  // (2C)
  const float* wb;  // (9, Cin + C, C)
  const float* bb;  // (C)
  const float* gn;  // (6, C)
  ConvPlan cv[2];   // the gates, the candidate
  int B, D, H, W, Cin, C;
  int Cn;           // the real state channels, C − 3 .. C (the statistics' count)
};

struct BwdArgs {
  const float* x;     // (B, D, H, W, Cin)
  const float* h0;    // (B, H, W, C)
  const float* out;   // (B, D, H, W, C) the forward's states
  const float* gout;  // (B, D, H, W, C) their cotangent
  float* dx;          // (B, D, H, W, Cin)
  float* dg;          // (B, D, H, W, 2C) per plane the gates' cotangent [dgr | dgu]
  float* dyl;         // (B, D, H, W, C) per plane the candidate's cotangent dy_lin
  float* m;           // (B, D, H, W, C) per plane r·h, recomputed
  float* graw;        // (2, B, H, W, 2C) scratch: raw gates, by the parity of d
  float* yraw;        // (B, H, W, C) scratch: raw candidate
  float* dh;          // (B, H, W, C) the state's cotangent, carried down the planes (zeros in)
  float* draw;        // (3, B, H, W, C) scratch: raw do, du, dr
  double* part;       // (4, gridDim.x, 4) per-block sums
  double* gnpart;     // (gridDim.x, 6, C) per-block GroupNorm parameter cotangents
  float* dgn;         // (6, C) the GroupNorm parameter cotangents
  const float* wa;    // (9, Cin + C, 2C)
  const float* ba;    // (2C)
  const float* wb;    // (9, Cin + C, C)
  const float* bb;    // (C)
  const float* gn;    // (6, C)
  const float* wcT;   // (9, C, C)      [t][k][c] = wb[8 − t][Cin + c][k]
  const float* weT;   // (9, 3C, ce)    [t][g][c] = wa[8 − t][Cin + c][g] for c < C, g < 2C
                      //                (0 for g ≥ 2C); [t][g][C + i] = wa[8 − t][i][g], then
                      //                wb's for g ≥ 2C; ce = C + Cin rounded up to 4
  ConvPlan cv[4];     // the gates, the candidate, convᵀ Wc, convᵀ [Wh | Wx]
  int B, D, H, W, Cin, C;
  int Cn;             // the real state channels, C − 3 .. C (the statistics' count)
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// An asynchronous 16-byte copy from global to shared memory (zeros when
// !valid; src must still be a valid address), completed by cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// The same for 4 bytes (through L1).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void unpack4(float4 t, float (&v)[4]) {
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// Adds an element's per-block sums part (nblocks, 4) with all the block's
// threads (thread t takes blocks t, t + BT, ..., then block_sums' fixed
// tree) into tot (4 doubles in shared memory), and writes to stats, for each
// of the `pairs` (sum, sum of squares) columns, the mean and
// 1/sqrt(var + ε), then the first `means` sums times inv_n.  Every block of
// the element computes the same values.
__device__ void elem_stats(const double* part, int nblocks, double inv_n, int pairs, int means,
                           double* red, double* tot, float* stats) {
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < nblocks; i += BT)
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] += part[i * 4 + k];
  block_sums(s, red, tot);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < means; ++k) stats[2 * pairs + k] = (float)(tot[k] * inv_n);
    for (int j = 0; j < pairs; ++j) {
      const double mean = tot[2 * j] * inv_n;
      const double var = fmax(tot[2 * j + 1] * inv_n - mean * mean, 0.0);
      stats[2 * j] = (float)mean;
      stats[2 * j + 1] = (float)(1.0 / sqrt(var + EPS));
    }
  }
  __syncthreads();
}

// The items item0, item0 + istep, ... of one conv over an element's plane:
// ny·nx·ns items (row tiles, column tiles, channel slabs; the slab fastest).
//   out[p, co] = Σ over the 3×3 taps t and input channels c of in[p + shift(t), c]·w[t, c, co]
// with c < cin, or < cin_short in a slab that ends at or below co_cut, and
// in(p, c) = map(p, c, *src(p, c, 0), *src(p, c, 1)) inside the plane, 0
// outside.  src(p, c, k) points at the k-th of the NRAW raw operands of
// in(p, c) (nullptr for none: map must not use that one; it must point at
// valid memory for any pixel and c < cin); with NRAW = 1, in = *src(p, c, 0)
// and map is not called.  keep(p, c, v) is called once for every pixel and
// input channel, by the item that owns it (slab 0, the tile's interior),
// with v = in(p, c) (not with NRAW = 1).  w is (9, cin, coutw), coutw a
// multiple of 4; epi(p, co, v) takes v = out[p, co .. co + 3] for each group
// of four channels with co < cout.
//
// Per chunk of ck input channels the raw operands and the weights are copied
// into shared memory with cp.async (zeros outside the plane), all in flight
// at once; then, with NRAW = 2, each thread maps its share in place.  All
// threads of the block call it with the same arguments.
template <int PX, int NRAW, typename Src, typename Map, typename Keep, typename Epi>
__device__ __forceinline__ void conv_items(const ConvPlan& pl, int H, int W, int cin,
                                           int cin_short, int co_cut,
                                           const float* __restrict__ w, int cout, int coutw,
                                           int item0, int istep, float* sm, Src src, Map map,
                                           Keep keep, Epi epi) {
  const int tr = pl.wr * PX, slab = pl.wc * BCO, ck = pl.ck;
  const int ck_log = 31 - __clz(ck);
  const int ny = (H + tr - 1) / tr, nx = (W + TW - 1) / TW, ns = (cout + slab - 1) / slab;
  const int items = ny * nx * ns;
  const int ps = staged_plane(tr, ck);
  const int n_in = (tr + 2) * RS * ck;  // staged inputs of a chunk
  const int s4 = slab / 4;
  const int n_w = 9 * ck * s4;          // staged float4 weights of a chunk
  float* s_in = sm;                     // [raw operand][ci][row][col]
  float* s_w = sm + IN_WORDS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kidx = warp % pl.wk;
  const int cgrp = warp / pl.wk % pl.wc, rgrp = warp / (pl.wk * pl.wc);
  for (int it = item0; it < items; it += istep) {
    const int s = it % ns, t = it / ns;
    const int y0 = t / nx * tr, x0 = t % nx * TW, co0 = s * slab;
    const int cin_it = co0 + slab <= co_cut ? cin_short : cin;
    float acc[PX][BCO];
#pragma unroll
    for (int j = 0; j < PX; ++j)
#pragma unroll
      for (int k = 0; k < BCO; ++k) acc[j][k] = 0.f;
    for (int ci0 = 0; ci0 < cin_it; ci0 += ck) {
      // the weights [tap][ci][slab channel] and the raw operands, as they are
      for (int e = threadIdx.x; e < n_w; e += BT) {
        const int q = e % s4, rest = e / s4;
        const int ci = rest & (ck - 1), tap = rest >> ck_log;
        const int co = co0 + 4 * q, c = ci0 + ci;
        const bool valid = c < cin_it && co < coutw;
        cp_async16(s_w + 4 * e, valid ? w + ((int64_t)tap * cin + c) * coutw + co : w, valid);
      }
      for (int e = threadIdx.x; e < n_in; e += BT) {
        const int pos = e >> ck_log, ci = e & (ck - 1), c = ci0 + ci;
        const int r = pos / RS, iy = y0 - 1 + r, ix = x0 - 1 + pos - r * RS;
        const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && c < cin_it;
        const int p = ok ? iy * W + ix : 0;
#pragma unroll
        for (int k = 0; k < NRAW; ++k) {
          const float* g = src(p, ok ? c : 0, k);
          cp_async4(s_in + (k * ck + ci) * ps + pos, g ? g : w, ok && g != nullptr);
        }
      }
      cp_async_wait();
      __syncthreads();
      if constexpr (NRAW > 1) {
        for (int e = threadIdx.x; e < n_in; e += BT) {
          const int pos = e >> ck_log, ci = e & (ck - 1), c = ci0 + ci;
          const int r = pos / RS, col = pos - r * RS;
          const int iy = y0 - 1 + r, ix = x0 - 1 + col;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W && c < cin_it) {
            const int p = iy * W + ix;
            const float v = map(p, c, s_in[ci * ps + pos], s_in[(ck + ci) * ps + pos]);
            s_in[ci * ps + pos] = v;
            if (s == 0 && r >= 1 && r <= tr && col >= 1 && col <= TW) keep(p, c, v);
          }
        }
        __syncthreads();
      }
      const float* bi = s_in + rgrp * PX * RS + lane;
      const float* bw = s_w + cgrp * BCO;
      for (int ci = kidx; ci < ck; ci += pl.wk) {
        const float* pi = bi + ci * ps;
        const float* pw = bw + ci * slab;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float v[PX + 2];
#pragma unroll
          for (int j = 0; j < PX + 2; ++j) v[j] = pi[j * RS + dx];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const float4* wt = reinterpret_cast<const float4*>(pw + (dy * 3 + dx) * ck * slab);
            const float4 w0 = wt[0], w1 = wt[1];
            const float wv[BCO] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int j = 0; j < PX; ++j)
#pragma unroll
              for (int k = 0; k < BCO; ++k) acc[j][k] = fmaf(v[j + dy], wv[k], acc[j][k]);
          }
        }
      }
      __syncthreads();
    }
    if (pl.wk > 1) {
      // the wk warps of one (row group, channel group) add their shares in
      // kidx order, through the free staging buffer
      float* red = s_in;
      if (kidx > 0) {
#pragma unroll
        for (int j = 0; j < PX; ++j)
#pragma unroll
          for (int k = 0; k < BCO; ++k) red[((warp * PX + j) * BCO + k) * 32 + lane] = acc[j][k];
      }
      __syncthreads();
      if (kidx == 0) {
        for (int q = 1; q < pl.wk; ++q)
#pragma unroll
          for (int j = 0; j < PX; ++j)
#pragma unroll
            for (int k = 0; k < BCO; ++k)
              acc[j][k] += red[(((warp + q) * PX + j) * BCO + k) * 32 + lane];
      }
      __syncthreads();
    }
    if (kidx == 0) {
      const int x = x0 + lane;
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int y = y0 + rgrp * PX + j;
        if (y < H && x < W) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int co = co0 + cgrp * BCO + 4 * q;
            if (co < cout) {
              const float v[4] = {acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2],
                                  acc[j][4 * q + 3]};
              epi(y * W + x, co, v);
            }
          }
        }
      }
    }
  }
}

// conv_items at the plan's rows per thread
template <int NRAW, typename Src, typename Map, typename Keep, typename Epi>
__device__ __forceinline__ void conv(const ConvPlan& pl, int H, int W, int cin, int cin_short,
                                     int co_cut, const float* __restrict__ w, int cout,
                                     int coutw, int item0, int istep, float* sm, Src src,
                                     Map map, Keep keep, Epi epi) {
  if (pl.px == 1)
    conv_items<1, NRAW>(pl, H, W, cin, cin_short, co_cut, w, cout, coutw, item0, istep, sm, src,
                        map, keep, epi);
  else
    conv_items<2, NRAW>(pl, H, W, cin, cin_short, co_cut, w, cout, coutw, item0, istep, sm, src,
                        map, keep, epi);
}

// u = σ(GN_u(g_u)) and y = tanh(GN_y(y_raw)) from the statistics (mean and
// 1/std of r, u, y in stats[0..5]) and the channel's GroupNorm scale and
// shift: the forward's blend and the adjoint's recompute map them alike
__device__ __forceinline__ float gate_u(float raw, const float* stats, float scale, float shift) {
  return sigmoid(gn_affine(raw, stats[2], stats[3], scale, shift));
}

__device__ __forceinline__ float cand_y(float raw, const float* stats, float scale, float shift) {
  return tanhf(gn_affine(raw, stats[4], stats[5], scale, shift));
}

// Phase A of both kernels, plane d of one element (xd its input plane, h the
// previous state): the raw gates g = conv([x_d | h], Wa) + ba into G (H, W,
// 2C) under the block's share (item0 = its place kb among the element's bpe
// blocks), and the block's sums of g and g² over the r half and the u half
// into part[0..3].
__device__ __forceinline__ void gates_pass(const ConvPlan& pl, int H, int W, int Cin, int C,
                                           const float* xd, const float* h,
                                           const float* __restrict__ wa,
                                           const float* __restrict__ ba, float* G, int kb,
                                           int bpe, float* sm, double* red, double* part) {
  const int C2 = 2 * C;
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  conv<1>(
      pl, H, W, Cin + C, Cin + C, 0, wa, C2, C2, kb, bpe, sm,
      [&](int p, int c, int) { return c < Cin ? xd + p * Cin + c : h + p * C + c - Cin; },
      [](int, int, float r0, float) { return r0; }, [](int, int, float) {},
      [&](int p, int co, const float (&v)[4]) {
        float o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = v[k] + __ldg(ba + co + k);
        st4(G + p * C2 + co, o);
        double t = 0.0, t2 = 0.0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          t += o[k];
          t2 += (double)o[k] * o[k];
        }
        if (co < C) {  // the r half, then the u half
          s[0] += t;
          s[1] += t2;
        } else {
          s[2] += t;
          s[3] += t2;
        }
      });
  block_sums(s, red, part);
}

// Phase B of both kernels: the r and u statistics from the element's phase-A
// partials (elem, bpe blocks) into stats[0..3]; the raw candidate y =
// conv([x_d | m], Wb) + bb into Y (H, W, C), m = σ(GN_r(g_r))·h mapped from
// G and h as the conv stages them (keep(p, k, m) for state channel k, by the
// item that owns pixel p); the block's sums of y and y² into part[0..1].
template <typename Keep>
__device__ __forceinline__ void candidate_pass(const ConvPlan& pl, int H, int W, int Cin, int C,
                                               const float* xd, const float* G, const float* h,
                                               const float* __restrict__ wb,
                                               const float* __restrict__ bb,
                                               const float* __restrict__ gn, float* Y, int kb,
                                               int bpe, const double* elem, double inv_n,
                                               float* sm, double* red, double* tot, float* stats,
                                               double* part, Keep keep) {
  elem_stats(elem, bpe, inv_n, 2, 0, red, tot, stats);
  const int C2 = 2 * C;
  double s[4] = {0.0, 0.0, 0.0, 0.0};
  conv<2>(
      pl, H, W, Cin + C, Cin + C, 0, wb, C, C, kb, bpe, sm,
      [&](int p, int c, int k) -> const float* {
        if (c < Cin) return k == 0 ? xd + p * Cin + c : nullptr;
        return k == 0 ? G + p * C2 + c - Cin : h + p * C + c - Cin;
      },
      [&](int, int c, float g, float hv) {
        if (c < Cin) return g;
        const int k = c - Cin;
        return sigmoid(gn_affine(g, stats[0], stats[1], __ldg(gn + k), __ldg(gn + C + k))) * hv;
      },
      [&](int p, int c, float v) {
        if (c >= Cin) keep(p, c - Cin, v);
      },
      [&](int p, int co, const float (&v)[4]) {
        float o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = v[k] + __ldg(bb + co + k);
        st4(Y + p * C + co, o);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s[0] += o[k];
          s[1] += (double)o[k] * o[k];
        }
      });
  block_sums(s, red, part);
}

// For d = 0 .. D−1 and every element b (h = out[d − 1], h0 at d = 0):
//   A. the raw gates into G; sums of g, g² (gates_pass)
//   B. r, u statistics; the raw candidate into Y, m staged (candidate_pass)
//   C. y statistics; own pixels: out[d] = u·h + (1 − u)·y
// with a grid.sync() after each, but none after the last plane's C.
__global__ void __launch_bounds__(BT, 2) red_recur_kernel(FwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ double red[WARPS * 4];
  __shared__ double tot[4];
  __shared__ float stats[6];  // mean, 1/std of r, u, y
  const int C = a.C, Cin = a.Cin, W = a.W, H = a.H;
  const int P = H * W;
  const int plane = P * C;
  const double inv_n = 1.0 / ((double)P * a.Cn);  // over the real channels alone
  const int bpe = gridDim.x / a.B;
  const int b = blockIdx.x / bpe;
  const int kb = blockIdx.x - b * bpe;  // this block among element b's
  const int64_t e1 = (int64_t)b * plane;  // element b in the (B, H, W, C) arrays
  // the per-block sums of pass k, and element b's first block's
  auto part = [&](int k) { return a.part + 4 * ((int64_t)k * gridDim.x + blockIdx.x); };
  auto elem = [&](int k) { return a.part + 4 * ((int64_t)k * gridDim.x + (int64_t)b * bpe); };

  // each phase derives its pointers from the arguments, so few stay live
  // across the convs
  for (int d = 0; d < a.D; ++d) {
    const int64_t ed = ((int64_t)b * a.D + d) * plane;  // plane d of element b, C channels
    {  // A. gates
      const float* h = d == 0 ? a.h0 + e1 : a.out + ed - plane;
      float* G = a.graw + 2 * e1;
      const float* xd = a.x + ((int64_t)b * a.D + d) * P * Cin;
      gates_pass(a.cv[0], H, W, Cin, C, xd, h, a.wa, a.ba, G, kb, bpe, sm, red, part(0));
    }
    grid.sync();

    {  // B. r and u statistics; candidate over [x_d | m]
      const float* h = d == 0 ? a.h0 + e1 : a.out + ed - plane;
      float* G = a.graw + 2 * e1;
      const float* xd = a.x + ((int64_t)b * a.D + d) * P * Cin;
      candidate_pass(a.cv[1], H, W, Cin, C, xd, G, h, a.wb, a.bb, a.gn, a.yraw + e1, kb, bpe,
                     elem(0), inv_n, sm, red, tot, stats, part(1), [](int, int, float) {});
    }
    grid.sync();

    {  // C. y statistics; the blend at the block's own pixels, thread → (pixel
       // lane, group of four channels)
      elem_stats(elem(1), bpe, inv_n, 1, 0, red, tot, stats + 4);
      const int gc = C / 4, npl = BT / gc;
      const int lp = threadIdx.x / gc, c0 = (threadIdx.x - lp * gc) * 4;
      const float* h = d == 0 ? a.h0 + e1 : a.out + ed - plane;
      const float* G = a.graw + 2 * e1;
      const float* Y = a.yraw + e1;
      float* hn = a.out + ed;
      if (lp < npl) {
        for (int p = kb * npl + lp; p < P; p += bpe * npl) {
          float gu[4], yr[4], hh[4], o[4];
          unpack4(ld4(G + p * 2 * C + C + c0), gu);
          unpack4(ld4(Y + p * C + c0), yr);
          unpack4(ld4(h + p * C + c0), hh);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int c = c0 + k;
            const float u = gate_u(gu[k], stats, __ldg(a.gn + 2 * C + c), __ldg(a.gn + 3 * C + c));
            const float y = cand_y(yr[k], stats, __ldg(a.gn + 4 * C + c), __ldg(a.gn + 5 * C + c));
            o[k] = u * hh[k] + (1.f - u) * y;
          }
          st4(hn + p * C + c0, o);
        }
      }
    }
    if (d + 1 < a.D) grid.sync();
  }
}

// For d = D−1 .. 0 and every element b (h = out[d − 1], h0 at d = 0), with
// x̂ = (raw − mean)·inv the normalised values of each GroupNorm(1), γ its scale:
//   A. recompute the gates g = conv([x_d | h], Wa) + ba into G[d & 1]; sums of g, g²
//   B. r, u statistics; candidate conv([x_d | m], Wb) + bb into Y, m = r·h
//      staged from G and h (and kept in m[d] by the item that owns it); sums
//   C. y statistics; own pixels: dht = dh + gout_d; do = dht·(1 − u)·(1 − y²),
//      du = dht·(h − y)·u·(1 − u) into the raw scratch; dh ← dht·u; sums of
//      do·γ_y, do·γ_y·ŷ, du·γ_u, du·γ_u·û
//   D. the transposes' means; dm = convᵀ(dy_lin, Wc) with
//      dy_lin = inv_y·(do·γ_y − mean(do·γ_y) − ŷ·mean(do·γ_y·ŷ)) staged from the
//      raw do and Y (and kept in dyl[d]); dr = dm·h·r·(1 − r) into the raw
//      scratch, dh += dm·r; sums of dr·γ_r, dr·γ_r·r̂
//   E. GN_r's transpose means; [dh | dx_d] += convᵀ([dgr | dgu | dy_lin], [Wh | Wx])
//      with dgr and dgu, the GN_r and GN_u transposes of dr and du, staged from
//      the raw scratch and G; own pixels write them to dg[d]
// with a grid.sync() after each of A-D.  E needs none before the next plane:
// that plane's A reads x, out and h0 and writes G[(d − 1) & 1] and the first
// per-block sums, none of which E reads; its B writes Y and m[d − 1] after
// a sync.  The GroupNorm parameter cotangents Σ do·ŷ, Σ do (C), Σ du·û,
// Σ du (C) and Σ dr·r̂, Σ dr (E) accumulate in each thread's own slots (a
// thread keeps the same four channels in every own-pixel pass) and are
// reduced once at the end in a fixed order.  The weight and bias cotangents
// are left to the caller: dg, dyl and m keep every plane's values for it.
// Each phase derives its pointers from the arguments, so few stay live
// across the plane loop.
__global__ void __launch_bounds__(BT, 2) red_recur_bwd_kernel(BwdArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* gsm = sm + IN_WORDS + W_WORDS;  // [GACC][BT]: each thread's own sums
  __shared__ double red[WARPS * 4];
  __shared__ double tot[4];
  __shared__ float stats[12];  // mean, 1/std of r, u, y; then the transposes' means
  const int C = a.C, C2 = 2 * C, Cin = a.Cin, W = a.W, H = a.H;
  const int P = H * W;
  const int plane = P * C;
  const double inv_n = 1.0 / ((double)P * a.Cn);  // over the real channels alone
  const int bpe = gridDim.x / a.B;
  const int b = blockIdx.x / bpe;
  const int kb = blockIdx.x - b * bpe;  // this block among element b's
  // own-pixel passes: thread → (pixel lane, group of four channels)
  const int gc = C / 4, npl = BT / gc;
  const int lp = threadIdx.x / gc, c0 = (threadIdx.x - lp * gc) * 4;
  const bool own_lane = lp < npl;
  const int p_first = kb * npl + lp, p_step = bpe * npl;
  const int64_t e1 = (int64_t)b * plane;  // element b in the (B, H, W, C) arrays
  // the per-block sums of pass k, and element b's first block's
  auto part = [&](int k) { return a.part + 4 * ((int64_t)k * gridDim.x + blockIdx.x); };
  auto elem = [&](int k) { return a.part + 4 * ((int64_t)k * gridDim.x + (int64_t)b * bpe); };
  const float* gn = a.gn;
  // slot (q·4 + k)·BT + thread: Σ dr·r̂, Σ dr, Σ du·û, Σ du, Σ do·ŷ, Σ do (q = 0 .. 5)
  // of this thread's channel c0 + k
  float* gsl = gsm + threadIdx.x;
  for (int i = 0; i < GACC; ++i) gsl[i * BT] = 0.f;
  // GroupNorm scale and shift of norm q (r, u, y) for this thread's channel c0 + k
  auto gam = [&](int q, int k) { return __ldg(gn + 2 * q * C + c0 + k); };
  auto bet = [&](int q, int k) { return __ldg(gn + (2 * q + 1) * C + c0 + k); };
  auto none = [](int, int, float) {};

  for (int d = a.D - 1; d >= 0; --d) {
    const int64_t ed = ((int64_t)b * a.D + d) * plane;  // plane d of element b, C channels
    const float* h = d == 0 ? a.h0 + e1 : a.out + ed - plane;
    float* G = a.graw + ((int64_t)(d & 1) * a.B + b) * P * C2;

    {  // A. gates
      const float* xd = a.x + ((int64_t)b * a.D + d) * P * Cin;
      gates_pass(a.cv[0], H, W, Cin, C, xd, h, a.wa, a.ba, G, kb, bpe, sm, red, part(0));
    }
    grid.sync();

    {  // B. r and u statistics; candidate over [x_d | m], m kept in m[d]
      const float* xd = a.x + ((int64_t)b * a.D + d) * P * Cin;
      float* M = a.m + ed;
      candidate_pass(a.cv[1], H, W, Cin, C, xd, G, h, a.wb, a.bb, gn, a.yraw + e1, kb, bpe,
                     elem(0), inv_n, sm, red, tot, stats, part(1),
                     [&](int p, int k, float v) { M[p * C + k] = v; });
    }
    grid.sync();

    {  // C. the blend's and the tanh's adjoints; GN_y and GN_u transpose sums
      elem_stats(elem(1), bpe, inv_n, 1, 0, red, tot, stats + 4);
      const float* Y = a.yraw + e1;
      const float* gd = a.gout + ed;
      float* DH = a.dh + e1;
      float* DO = a.draw + e1;
      float* DU = DO + (int64_t)a.B * plane;
      double s[4] = {0.0, 0.0, 0.0, 0.0};
      if (own_lane) {
        float ga[4][4];  // Σ du·û, Σ du, Σ do·ŷ, Σ do
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) ga[q][k] = gsl[((2 + q) * 4 + k) * BT];
        for (int p = p_first; p < P; p += p_step) {
          float gu[4], yr[4], hh[4], dhv[4], gv[4], dov[4], duv[4];
          unpack4(ld4(G + p * C2 + C + c0), gu);
          unpack4(ld4(Y + p * C + c0), yr);
          unpack4(ld4(h + p * C + c0), hh);
          unpack4(ld4(DH + p * C + c0), dhv);
          unpack4(ld4(gd + p * C + c0), gv);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float uh = (gu[k] - stats[2]) * stats[3];
            const float u = gate_u(gu[k], stats, gam(1, k), bet(1, k));
            const float yh = (yr[k] - stats[4]) * stats[5];
            const float y = cand_y(yr[k], stats, gam(2, k), bet(2, k));
            const float dht = dhv[k] + gv[k];
            const float dov_ = dht * (1.f - u) * (1.f - y * y);
            const float duv_ = dht * (hh[k] - y) * u * (1.f - u);
            dov[k] = dov_;
            duv[k] = duv_;
            dhv[k] = dht * u;
            ga[0][k] += duv_ * uh;
            ga[1][k] += duv_;
            ga[2][k] += dov_ * yh;
            ga[3][k] += dov_;
            const double dyg = (double)dov_ * gam(2, k), dug = (double)duv_ * gam(1, k);
            s[0] += dyg;
            s[1] += dyg * yh;
            s[2] += dug;
            s[3] += dug * uh;
          }
          st4(DH + p * C + c0, dhv);
          st4(DO + p * C + c0, dov);
          st4(DU + p * C + c0, duv);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) gsl[((2 + q) * 4 + k) * BT] = ga[q][k];
      }
      block_sums(s, red, part(2));
    }
    grid.sync();

    {  // D. dm = convᵀ(dy_lin, Wc); the r chain; GN_r transpose sums
      elem_stats(elem(2), bpe, inv_n, 0, 4, red, tot, stats + 6);
      const float* Y = a.yraw + e1;
      const float* DO = a.draw + e1;
      float* DR = a.draw + 2 * (int64_t)a.B * plane + e1;
      float* DH = a.dh + e1;
      float* DYL = a.dyl + ed;
      double s[4] = {0.0, 0.0, 0.0, 0.0};
      conv<2>(
          a.cv[2], H, W, C, C, 0, a.wcT, C, C, kb, bpe, sm,
          [&](int p, int c, int k) { return (k == 0 ? DO : Y) + p * C + c; },
          [&](int, int c, float dov, float yr) {
            const float yh = (yr - stats[4]) * stats[5];
            return (dov * __ldg(gn + 4 * C + c) - stats[6] - yh * stats[7]) * stats[5];
          },
          [&](int p, int c, float v) { DYL[p * C + c] = v; },
          [&](int p, int co, const float (&dm)[4]) {
            float gr[4], hh[4], dhv[4], drv[4];
            unpack4(ld4(G + p * C2 + co), gr);
            unpack4(ld4(h + p * C + co), hh);
            unpack4(ld4(DH + p * C + co), dhv);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int c = co + k;
              const float g_s = __ldg(gn + c);
              const float rh = (gr[k] - stats[0]) * stats[1];
              const float r =
                  sigmoid(gn_affine(gr[k], stats[0], stats[1], g_s, __ldg(gn + C + c)));
              const float drv_ = dm[k] * hh[k] * r * (1.f - r);
              drv[k] = drv_;
              dhv[k] += dm[k] * r;
              const double drg = (double)drv_ * g_s;
              s[0] += drg;
              s[1] += drg * rh;
            }
            st4(DH + p * C + co, dhv);
            st4(DR + p * C + co, drv);
          });
      block_sums(s, red, part(3));
    }
    grid.sync();

    {  // E. the state's cotangent for plane d − 1, and dx_d
      elem_stats(elem(3), bpe, inv_n, 0, 2, red, tot, stats + 10);
      const float* DU = a.draw + (int64_t)a.B * plane + e1;
      const float* DR = DU + (int64_t)a.B * plane;
      const float* DYL = a.dyl + ed;
      float* DH = a.dh + e1;
      float* DX = a.dx + ((int64_t)b * a.D + d) * P * Cin;
      conv<2>(
          a.cv[3], H, W, 3 * C, C2, C, a.weT, C + Cin, (C + Cin + 3) / 4 * 4, kb, bpe, sm,
          [&](int p, int c, int k) -> const float* {
            // the raw dr (c < C) or du (c < 2C) and the raw gate, else dy_lin
            if (c >= C2) return k == 0 ? DYL + p * C + c - C2 : nullptr;
            if (k == 1) return G + p * C2 + c;
            return c < C ? DR + p * C + c : DU + p * C + c - C;
          },
          [&](int, int c, float raw, float gr) {
            // the GN_r or GN_u transpose of dr or du
            if (c >= C2) return raw;
            const bool is_r = c < C;
            const int k = is_r ? c : c - C;
            const float mean = is_r ? stats[0] : stats[2], inv = is_r ? stats[1] : stats[3];
            const float t0 = is_r ? stats[10] : stats[8], t1 = is_r ? stats[11] : stats[9];
            const float xh = (gr - mean) * inv;
            return (raw * __ldg(gn + (is_r ? 0 : C2) + k) - t0 - xh * t1) * inv;
          },
          none,
          [&](int p, int co, const float (&v)[4]) {
            if (co < C) {
              float dhv[4];
              unpack4(ld4(DH + p * C + co), dhv);
#pragma unroll
              for (int k = 0; k < 4; ++k) dhv[k] += v[k];
              st4(DH + p * C + co, dhv);
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k)
                if (co + k < C + Cin) DX[p * Cin + co + k - C] = v[k];
            }
          });
      // own pixels: the gate cotangents of plane d for the weight
      // reductions; GN_r's parameter sums
      if (own_lane) {
        float* DG = a.dg + ((int64_t)b * a.D + d) * P * C2;
        float ga[2][4];  // Σ dr·r̂, Σ dr
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) ga[q][k] = gsl[(q * 4 + k) * BT];
        for (int p = p_first; p < P; p += p_step) {
          float gr[4], gu[4], drv[4], duv[4], dgr[4], dgu[4];
          unpack4(ld4(G + p * C2 + c0), gr);
          unpack4(ld4(G + p * C2 + C + c0), gu);
          unpack4(ld4(DR + p * C + c0), drv);
          unpack4(ld4(DU + p * C + c0), duv);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float rh = (gr[k] - stats[0]) * stats[1];
            const float uh = (gu[k] - stats[2]) * stats[3];
            ga[0][k] += drv[k] * rh;
            ga[1][k] += drv[k];
            dgr[k] = (drv[k] * gam(0, k) - stats[10] - rh * stats[11]) * stats[1];
            dgu[k] = (duv[k] * gam(1, k) - stats[8] - uh * stats[9]) * stats[3];
          }
          st4(DG + p * C2 + c0, dgr);
          st4(DG + p * C2 + C + c0, dgu);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) gsl[(q * 4 + k) * BT] = ga[q][k];
      }
    }
  }

  // the GroupNorm parameter cotangents: each block's threads in order, then
  // (after the sync) the blocks in order
  __syncthreads();
  for (int i = threadIdx.x; i < 6 * C; i += BT) {
    const int q = i / C, c = i - q * C, grp = c / 4, k = c - 4 * grp;
    double t = 0.0;
    for (int l = 0; l < npl; ++l) t += gsm[(q * 4 + k) * BT + l * gc + grp];
    a.gnpart[(int64_t)blockIdx.x * 6 * C + i] = t;
  }
  grid.sync();
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < 6 * C; i += BT) {
      double t = 0.0;
      for (int blk = 0; blk < (int)gridDim.x; ++blk) t += a.gnpart[(int64_t)blk * 6 * C + i];
      a.dgn[i] = (float)t;
    }
  }
}
bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// The shapes both kernels take: 4 ≤ C ≤ 4·BT with C % 4 == 0 and C − 4 <
// Cn ≤ C real channels, a grid of B equal groups, and every plane index of
// (3C + Cin) channels within 32 bits.
bool valid_shape(int B, int H, int W, int Cin, int C, int Cn, int blocks) {
  return C >= 4 && C % 4 == 0 && C / 4 <= BT && Cn > C - 4 && Cn <= C && Cin >= 1 && B >= 1 &&
         blocks >= B && blocks % B == 0 && (int64_t)H * W * (3 * C + Cin) < ((int64_t)1 << 31);
}

// Reads n convs' (px, wr, wc, wk, ck) from plan into cv; false for one the
// kernels cannot run.  nraw[i]: raw operands a staged channel of conv i reads.
bool read_plans(const int* plan, int n, const int* nraw, ConvPlan* cv) {
  for (int i = 0; i < n; ++i) {
    const int* q = plan + 5 * i;
    const ConvPlan p{q[0], q[1], q[2], q[3], q[4]};
    if ((p.px != 1 && p.px != 2) || !pow2(p.wr) || !pow2(p.wc) || !pow2(p.wk) ||
        p.wr * p.wc * p.wk != WARPS || p.ck < 8 || p.ck > 64 || !pow2(p.ck) ||
        nraw[i] * p.ck * staged_plane(p.wr * p.px, p.ck) > IN_WORDS ||
        9 * p.ck * p.wc * BCO > W_WORDS)
      return false;
    cv[i] = p;
  }
  return true;
}

constexpr int NRAW[4] = {1, 2, 2, 2};  // the gates, the candidate, convᵀ Wc, convᵀ [Wh | Wx]

// Blocks of `kernel` with `smem` bytes of dynamic shared memory that the
// current device holds at once, or a negative CUDA error code.
template <typename K>
int resident_blocks(K kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev))) return -(int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return -(int)err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return -(int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BT, smem)))
    return -(int)err;
  return per_sm * sms;
}

// One cooperative launch of `kernel` with its argument struct and `smem`
// bytes of dynamic shared memory; returns cudaGetLastError()-style codes
// (0 = launched).
template <typename K, typename A>
int coop_launch(K kernel, A a, int blocks, int smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  void* kargs[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(BT), kargs, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch is not sticky: clear it for later launches
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a forward and a backward block take (the
// launch plan's constants RED_FWD_SMEM and RED_BWD_SMEM mirror them).
extern "C" int red_recur_smem() { return FWD_SMEM; }
extern "C" int red_recur_bwd_smem() { return BWD_SMEM; }

// Blocks that the current device holds at once of the forward kernel and of
// the backward kernel, whichever is fewer (both plans take it, so the two
// kernels split a plane alike), or a negative CUDA error code.
extern "C" int red_recur_resident() {
  const int f = resident_blocks(red_recur_kernel, FWD_SMEM);
  const int b = resident_blocks(red_recur_bwd_kernel, BWD_SMEM);
  return f < 0 ? f : b < 0 ? b : f < b ? f : b;
}

// Runs the recurrence of B elements over all D planes in one cooperative
// launch of `blocks` blocks (B equal groups, at most red_recur_resident()) on
// `stream`: out (B, D, H, W, C) from x and h0, with the scratch graw (B, H, W,
// 2C), yraw (B, H, W, C) and part (2, blocks, 4).  plan holds (px, wr, wc, wk,
// ck) of the gates' and the candidate's convs (see ConvPlan;
// ops/kernels/red_recur.py `red_recur_plan`).  C must be a multiple of 4 and
// at most 4·BT; Cn of its channels are real (the header's padded widths),
// the rest pads.  Every float pointer but x's 16-byte aligned.  Returns
// cudaGetLastError()-style codes (0 = launched).
extern "C" int red_recur_f32(const float* x, const float* h0, float* out, float* graw,
                             float* yraw, double* part, const float* wa, const float* ba,
                             const float* wb, const float* bb, const float* gn, const int* plan,
                             int B, int D, int H, int W, int Cin, int C, int Cn, int blocks,
                             void* stream) {
  FwdArgs args{x, h0, out, graw, yraw, part, wa, ba, wb, bb, gn, {}, B, D, H, W, Cin, C, Cn};
  if (!valid_shape(B, H, W, Cin, C, Cn, blocks) || !read_plans(plan, 2, NRAW, args.cv))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {h0, out, graw, yraw, part, wa, ba, wb, bb, gn};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  if (D == 0) return 0;
  return coop_launch(red_recur_kernel, args, blocks, FWD_SMEM, stream);
}

// The reverse-plane adjoint of red_recur_f32 over B elements in one
// cooperative launch of `blocks` blocks (B equal groups, at most
// red_recur_resident()) on `stream`: dx, the per-plane cotangents dg
// (B, D, H, W, 2C) and dyl (B, D, H, W, C), the recomputed m (B, D, H, W, C)
// for the caller's weight cotangents, and dgn (6, C).  plan holds (px, wr, wc,
// wk, ck) of the four convs (see ConvPlan; ops/kernels/red_recur.py
// `red_recur_bwd_plan`).  dh must hold zeros.  C must be a multiple of 4 and
// at most 4·BT, Cn of its channels real; every float pointer but x's and
// dx's 16-byte aligned.  Returns cudaGetLastError()-style codes (0 =
// launched).
extern "C" int red_recur_bwd_f32(const float* x, const float* h0, const float* out,
                                 const float* gout, float* dx, float* dg, float* dyl, float* m,
                                 float* graw, float* yraw, float* dh, float* draw, double* part,
                                 double* gnpart, float* dgn, const float* wa, const float* ba,
                                 const float* wb, const float* bb, const float* gn,
                                 const float* wcT, const float* weT, const int* plan, int B,
                                 int D, int H, int W, int Cin, int C, int Cn, int blocks,
                                 void* stream) {
  BwdArgs args{x,  h0, out, gout, dx, dg, dyl, m,  graw, yraw, dh, draw, part, gnpart, dgn,
               wa, ba, wb,  bb,   gn, wcT, weT, {}, B,    D,    H,  W,    Cin,  C,   Cn};
  if (!valid_shape(B, H, W, Cin, C, Cn, blocks) || !read_plans(plan, 4, NRAW, args.cv))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {h0, out, gout, dg, dyl, m, graw, yraw, dh, draw, part, gnpart,
                        wa, ba, wb, bb, gn, wcT, weT};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  if (D == 0) return 0;
  return coop_launch(red_recur_bwd_kernel, args, blocks, BWD_SMEM, stream);
}
