// Whole 3-D conv blocks of the CostRegNet families (CascadeMVSNet, UCSNet),
// CUDA for Hopper (sm_90a), one launch per block.
//
// Replaces the packed CostRegNet's per-depth-tap composition,
// satmvs_tpu/nn/costreg.py `packed_costreg_forward` (:57-160):
//   c3d_s1 (:111) and c3d_s2 (:121): three 2-D Pallas calls per 3-D conv,
//     `conv_head` (satmvs_tpu/ops/pallas/plane_conv.py:730, pallas_call :738)
//     and `conv_dn` (:382, pallas_call :394) with relu off, summed, then
//     bias and ReLU at the XLA boundary;
//   d3dT (:134): three `deconv_up` calls (:569, pallas_call :582), the even
//     and odd output planes stacked, then bias, ReLU and the skip add.
// JAX cut each 3-D conv into depth taps because XLA's conv3d ran these
// shapes at < 5 % of the MXU; what it computes is a BatchNorm-folded 3-D
// conv block, and that is what runs here:
//   conv3d_block_kernel<false, S>: 3×3×3 conv, stride S ∈ {1, 2}, with the
//     front zero pads given per axis (0 or 1) and the output extents given
//     (so the back pads follow), + bias, optional ReLU, optional + skip;
//   conv3d_block_kernel<true, 1>: ConvTranspose3d(k=3, s=2, p=1, op=1) read
//     as a gather, + bias, ReLU, + skip.  Along each axis
//     output 2m reads input m through tap 1, output 2m + 1 reads m through
//     tap 2 and m + 1 through tap 0 (zero past the input's end, or the next
//     slab's halo row that the caller joined on).  The eight output parity
//     classes (ad, ah, aw) are eight small convolutions of 1-8 taps; one
//     launch runs all of them, even and odd planes alike.
//
// Layout: x (N, D, H, W, Cin) channels-last float32; weights prepared by the
// wrapper (ops/kernels/conv3d_block.py) as (27, Cin8, slabs·NT): tap (kd,
// kh, kw) of the forward kernel, Cin rounded up to 8 and Cout up to NT ∈
// {8, 16, 32, 64} with zeros, or past 64 channels to slabs of NT = 64; bias
// (Cout) or null; skip shaped as out or null.
//
// What bounds it on this card.  A block does 27·Cin·Cout multiply-adds per
// output voxel against 4·(Cin + Cout) bytes (Cin = 8-64, Cout = 1-64 at the
// default widths; 8b channels at base width b): the
// wide full-resolution blocks (8 → 8 channels, the 8 → 1 head) are bound by
// bytes, the 16-64-channel ones by arithmetic.  The arithmetic is fp32 to
// the repository's rule (TF32 is off in every reference), done on the
// tensor cores as a 3×TF32 split: a = a_hi + a_lo, b = b_hi + b_lo, each
// part rounded to TF32 (cvt.rna), and a·b ≈ a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi (a_lo·b_lo, ~2⁻²² of a·b, dropped), three mma.sync.m16n8k8
// each, so the rate that bounds it is 495 / 3 TFLOP/s.
//
// Design: implicit GEMM, M = a tile of TH × TW = 8 × 16 output voxels of one
// plane (transposed: input positions m of one parity class), N = Cout padded
// to NT, K = the taps × Cin.
//   * 4 warps along M (two tile rows, two m16 fragments, each), NT / 32
//     warps along N for NT = 64; a warp holds every n8 fragment of its
//     columns.  B (the batch) is folded into the grid: a block owns one
//     tile of one element's plane, so an element's output never depends on
//     the others.  Past 64 output channels the grid's second axis is the
//     slab of 64 channels a block computes, its own columns of the weights
//     and of the channels-last output: one launch still runs the whole
//     block, each slab re-reading the tile's input window (from L2).
//   * The K loop runs over stages (depth tap, chunk of CK = 8 input
//     channels).  A stage stages with cp.async, zeros outside the volume (a
//     zero source size), the input window its tile reads on that plane, (TH
//     − 1)·S + 3 rows × (TW − 1)·S + 3 columns × 8 channels (stride 2:
//     even columns first, then odd, so the lanes of a fragment read
//     neighbouring voxels), CKP = 12 words a voxel so a fragment's eight
//     lanes hit eight bank quads, and the weights of that depth tap's (row,
//     column) taps and channel chunk; two stages in a ring, the next
//     staged while the current one computes.  The 64 → 64 block's 442 KB of
//     weights thus stream through 18 KB stages and are never held whole.
//   * Each stage's products go into a zeroed fragment and are then added to
//     the fp32 accumulator with round-to-nearest adds, so the tensor
//     cores' own accumulation (truncating) spans 27 products a stage at
//     most, not the whole K.
//   * The epilogue adds the bias, applies the ReLU and adds the skip in
//     registers and stores once: no tap volume or pre-activation volume
//     reaches device memory.
//   * The 1-channel head (Cout = 1) takes an instance on the CUDA cores
//     (NT = 1): the same stages, each thread one output voxel of the tile,
//     fp32 FMAs over the stage's (row tap, column tap, channel) in order.
//     Padded to N = 8 the tensor-core instance did 24 products for each
//     useful one (3 × 8).
//   * One fixed sum order per output: over stages (depth tap, channel
//     chunk), in each the (row tap, column tap) in order, each an mma over
//     the chunk's 8 channels; the same for every output whatever its place
//     in a tile, the batch or the slab, so a B = 2 call gives each element
//     the bits of its B = 1 call and a D-slab or H-band with its halo the
//     bits of the whole volume.  No atomics: the same bits in every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;    // tile rows: output rows (conv) or input rows m (transposed)
constexpr int TW = 16;   // tile columns: the 16 rows of one m16n8k8 fragment
constexpr int CK = 8;    // input channels a stage holds: the k of one mma
constexpr int CKP = 12;  // words a staged voxel takes
constexpr int MAX_SMEM = 232448;  // bytes a block may use on sm_90

template <bool TRANS, int S>
struct Window {
  static constexpr int rows = TRANS ? TH + 1 : (TH - 1) * S + 3;
  static constexpr int cols = TRANS ? TW + 1 : (TW - 1) * S + 3;
  static constexpr bool split = !TRANS && S == 2;
  static constexpr int half = (cols + 1) / 2;  // stride 2: the even columns, then the odd
  static constexpr int stored = split ? 2 * half : cols;
  static constexpr int words = rows * stored * CKP;
  static constexpr int taps = TRANS ? 4 : 9;  // (row, column) taps of a stage's weights at most
  __device__ static int col(int c) { return split ? (c & 1) * half + (c >> 1) : c; }
};

// NT = 1: the 1-channel head's instance, fp32 FMAs on the CUDA cores, one
// output voxel a thread (the weights as the wrapper lays them out, 8 columns)
template <int NT>
struct NTile {
  static constexpr bool fma = NT == 1;
  static constexpr int cols = fma ? 8 : NT;          // weight columns in memory
  static constexpr int warp_n = NT > 32 ? 32 : NT;  // output channels a warp owns
  static constexpr int threads = 128 * (NT / warp_n);
  static constexpr int frags = fma ? 1 : warp_n / 8;
  static constexpr int ldb = cols == 8 ? 8 : cols + 8;  // ≡ 8 or 24 mod 32: no bank conflict
};

template <bool TRANS, int S, int NT>
constexpr int smem_bytes() {
  return 2 * 4 * (Window<TRANS, S>::words + Window<TRANS, S>::taps * CK * NTile<NT>::ldb);
}

struct Args {
  const float* x;
  const float* w;
  const float* bias;
  const float* skip;
  float* out;
  int Di, Hi, Wi, Cin, cin8;
  int Do, Ho, Wo, Cout;  // conv: output extents; transposed: extents of m (the output is 2×)
  int pd, ph, pw;        // conv: front zero pads
  int relu;
  int rt, ct;  // tiles along a plane's rows and columns
};

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// x = hi + lo, each rounded to TF32 (to nearest, ties away from zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The transposed conv's taps along one axis for output parity a: tap j reads
// input m + tap_off and kernel index tap_k.
__device__ __forceinline__ int tap_off(int a, int j) { return a ? j : 0; }
__device__ __forceinline__ int tap_k(int a, int j) { return a ? 2 - 2 * j : 1; }

template <bool TRANS, int S, int NT, int VEC>
// (at least one block an SM: ptxas may then take up to 255 registers; at the
// default bound the 64-channel stride-1 instance spilled 20 bytes at 128)
__global__ void __launch_bounds__(NTile<NT>::threads, 1) conv3d_block_kernel(const Args p) {
  using Win = Window<TRANS, S>;
  using Nt = NTile<NT>;
  constexpr int THREADS = Nt::threads;
  constexpr int STAGE = Win::words + Win::taps * CK * Nt::ldb;
  constexpr int SX = TRANS ? 1 : S;  // window columns (rows) per tile column (row)
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  // the slab of output channels: its first channel, and the weights' row length
  const int co0 = (int)blockIdx.y * NT;
  const int wcols = (int)gridDim.y * Nt::cols;

  // the tile: ((element · planes + plane) · rt + row tile) · ct + column tile [· 8 + class]
  unsigned b = blockIdx.x;
  const int cls = TRANS ? (int)(b & 7) : 0;
  if (TRANS) b >>= 3;
  const int ct = (int)(b % p.ct);
  b /= p.ct;
  const int rt = (int)(b % p.rt);
  b /= p.rt;
  const int plane = (int)(b % p.Do);
  const int n = (int)(b / p.Do);
  const int r0 = rt * TH, c0 = ct * TW;
  const int ad = cls >> 2, ah = (cls >> 1) & 1, aw = cls & 1;
  const int nd = TRANS ? 1 + ad : 3, nh = TRANS ? 1 + ah : 3, nw = TRANS ? 1 + aw : 3;
  const int row0 = TRANS ? r0 : r0 * S - p.ph;  // the window's first input row and column
  const int col0 = TRANS ? c0 : c0 * S - p.pw;
  const int nck = (p.Cin + CK - 1) / CK;
  const int stages = nd * nck;
  const size_t plane_words = (size_t)p.Hi * p.Wi * p.Cin;

  auto stage = [&](int it) {
    float* win = smem + (it & 1) * STAGE;
    float* wsm = win + Win::words;
    const int jd = it / nck, cc = it - jd * nck;
    const int di = TRANS ? plane + tap_off(ad, jd) : plane * S - p.pd + jd;
    const int kd = TRANS ? tap_k(ad, jd) : jd;
    const bool dok = di >= 0 && di < p.Di;
    const float* xp = p.x + ((size_t)n * p.Di + (dok ? di : 0)) * plane_words + cc * CK;
    constexpr int VPV = CK / VEC;  // copies a staged voxel takes
    for (int i = tid; i < Win::rows * Win::cols * VPV; i += THREADS) {
      const int v = i % VPV, rc = i / VPV, c = rc % Win::cols, r = rc / Win::cols;
      const int hi = row0 + r, wi = col0 + c;
      const bool ok = dok && hi >= 0 && hi < p.Hi && wi >= 0 && wi < p.Wi &&
                      cc * CK + v * VEC < p.Cin;
      const float* src = ok ? xp + ((size_t)hi * p.Wi + wi) * p.Cin + v * VEC : p.x;
      float* dst = win + (r * Win::stored + Win::col(c)) * CKP + v * VEC;
      if constexpr (VEC == 4) cp_async16(dst, src, ok);
      else cp_async4(dst, src, ok);
    }
    for (int i = tid; i < nh * nw * CK * (Nt::cols / 4); i += THREADS) {
      const int q = i % (Nt::cols / 4), rest = i / (Nt::cols / 4);
      const int k = rest % CK, tap = rest / CK;
      const int jh = tap / nw, jw = tap - jh * nw;
      const int kh = TRANS ? tap_k(ah, jh) : jh, kw = TRANS ? tap_k(aw, jw) : jw;
      const float* src =
          p.w + ((size_t)((kd * 3 + kh) * 3 + kw) * p.cin8 + cc * CK + k) * wcols + co0 + 4 * q;
      cp_async16(wsm + (tap * CK + k) * Nt::ldb + 4 * q, src, true);
    }
    cp_async_commit();
  };

  // the mma fragments' accumulators (the FMA instance: acc[0][0][0])
  float acc[2][Nt::frags][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int f = 0; f < Nt::frags; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][f][e] = 0.f;

  stage(0);
  for (int it = 0; it < stages; ++it) {
    if (it + 1 < stages) {
      stage(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* win = smem + (it & 1) * STAGE;
    const float* wsm = win + Win::words;
    float part[2][Nt::frags][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int f = 0; f < Nt::frags; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][f][e] = 0.f;
    for (int jh = 0; jh < nh; ++jh) {
      for (int jw = 0; jw < nw; ++jw) {
        const int oh = TRANS ? tap_off(ah, jh) : jh;  // window offsets of this tap
        const int ow = TRANS ? tap_off(aw, jw) : jw;
        const int tap = jh * nw + jw;
        if constexpr (Nt::fma) {
          const int row = tid / TW, col = tid % TW;
          const float* a = win + ((row * SX + oh) * Win::stored + Win::col(col * SX + ow)) * CKP;
          const float* wv = wsm + tap * CK * Nt::ldb;
          const float4 a0 = *reinterpret_cast<const float4*>(a);
          const float4 a1 = *reinterpret_cast<const float4*>(a + 4);
          const float av[CK] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int k = 0; k < CK; ++k)
            part[0][0][0] = fmaf(av[k], wv[k * Nt::ldb], part[0][0][0]);
        } else {
          uint32_t ahi[2][4], alo[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int r = (wm * 2 + mi) * SX + oh;
            const float* p0 = win + (r * Win::stored + Win::col(g * SX + ow)) * CKP + t;
            const float* p1 = win + (r * Win::stored + Win::col((g + 8) * SX + ow)) * CKP + t;
            split_tf32(p0[0], ahi[mi][0], alo[mi][0]);
            split_tf32(p1[0], ahi[mi][1], alo[mi][1]);
            split_tf32(p0[4], ahi[mi][2], alo[mi][2]);
            split_tf32(p1[4], ahi[mi][3], alo[mi][3]);
          }
#pragma unroll
          for (int f = 0; f < Nt::frags; ++f) {
            const float* bp = wsm + (tap * CK + t) * Nt::ldb + wn * Nt::warp_n + f * 8 + g;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(bp[0], bh0, bl0);
            split_tf32(bp[4 * Nt::ldb], bh1, bl1);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_tf32(part[mi][f], alo[mi], bh0, bh1);
              mma_tf32(part[mi][f], ahi[mi], bl0, bl1);
              mma_tf32(part[mi][f], ahi[mi], bh0, bh1);
            }
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int f = 0; f < Nt::frags; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][f][e] = __fadd_rn(acc[mi][f][e], part[mi][f][e]);
    __syncthreads();  // the next stage overwrites this buffer
  }

  // epilogue: + bias, ReLU, + skip, one store per output
  const int Do = TRANS ? 2 * p.Do : p.Do, Ho = TRANS ? 2 * p.Ho : p.Ho;
  const int Wo = TRANS ? 2 * p.Wo : p.Wo;
  const int od = TRANS ? 2 * plane + ad : plane;
  auto store = [&](size_t o, int co, float v) {
    if (p.bias != nullptr) v = __fadd_rn(v, p.bias[co]);
    if (p.relu) v = fmaxf(v, 0.f);
    if (p.skip != nullptr) v = __fadd_rn(v, p.skip[o]);
    p.out[o] = v;
  };
  if constexpr (Nt::fma) {
    const int pr = r0 + tid / TW, pc = c0 + tid % TW;
    if (pr < p.Ho && pc < p.Wo) {
      const int oh = TRANS ? 2 * pr + ah : pr, ow = TRANS ? 2 * pc + aw : pc;
      store((((size_t)n * Do + od) * Ho + oh) * Wo + ow, 0, acc[0][0][0]);
    }
    return;
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int pr = r0 + wm * 2 + mi;
    if (pr >= p.Ho) continue;
    const int oh = TRANS ? 2 * pr + ah : pr;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int pc = c0 + g + 8 * hf;
      if (pc >= p.Wo) continue;
      const int ow = TRANS ? 2 * pc + aw : pc;
      const size_t vox = (((size_t)n * Do + od) * Ho + oh) * Wo + ow;
#pragma unroll
      for (int f = 0; f < Nt::frags; ++f) {
        const int co = co0 + wn * Nt::warp_n + f * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (co + e < p.Cout) store(vox * p.Cout + co + e, co + e, acc[mi][f][2 * hf + e]);
      }
    }
  }
}

template <bool TRANS, int S, int NT, int VEC>
cudaError_t launch(const Args& a, int N, int slabs, cudaStream_t stream) {
  constexpr int smem = smem_bytes<TRANS, S, NT>();
  static_assert(smem <= MAX_SMEM, "a stage ring must fit a block's shared memory");
  const auto kernel = conv3d_block_kernel<TRANS, S, NT, VEC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)N * a.Do * a.rt * a.ct * (TRANS ? 8 : 1);
  if (blocks < 1 || blocks >= (1LL << 31) || slabs < 1 || slabs > 65535)
    return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks, slabs), NTile<NT>::threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool TRANS, int S>
cudaError_t dispatch(Args a, int N, void* stream) {
  if (N < 1 || a.Di < 1 || a.Hi < 1 || a.Wi < 1 || a.Cin < 1 || a.Do < 1 || a.Ho < 1 ||
      a.Wo < 1 || a.Cout < 1)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(a.w) % 16) return cudaErrorMisalignedAddress;
  a.cin8 = (a.Cin + CK - 1) / CK * CK;
  a.rt = (a.Ho + TH - 1) / TH;
  a.ct = (a.Wo + TW - 1) / TW;
  const bool vec = a.Cin % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  const int nt = a.Cout == 1 ? 1 : a.Cout <= 8 ? 8 : a.Cout <= 16 ? 16 : a.Cout <= 32 ? 32 : 64;
  const int slabs = (a.Cout + nt - 1) / nt;  // past 64 channels, slabs of 64
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CONV3D_NT(NT) \
  return vec ? launch<TRANS, S, NT, 4>(a, N, slabs, st) : launch<TRANS, S, NT, 1>(a, N, slabs, st)
  switch (nt) {
    case 1: CONV3D_NT(1);
    case 8: CONV3D_NT(8);
    case 16: CONV3D_NT(16);
    case 32: CONV3D_NT(32);
    default: CONV3D_NT(64);
  }
#undef CONV3D_NT
}

}  // namespace

// 3×3×3 conv of x (N, Di, Hi, Wi, Cin) with w (27, Cin8, slabs·NT) (see
// the header), stride 1 or 2: output voxel o reads input o·stride − p + k
// along each axis (p = pd, ph, pw ∈ {0, 1}, zero outside x) → out (N, Do,
// Ho, Wo, Cout), + bias (or null), ReLU when relu != 0, + skip (or null).
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int conv3d_block_f32(const float* x, const float* w, const float* bias,
                                const float* skip, float* out, int N, int Di, int Hi, int Wi,
                                int Cin, int Do, int Ho, int Wo, int Cout, int stride, int pd,
                                int ph, int pw, int relu, void* stream) {
  if ((pd | ph | pw) & ~1) return (int)cudaErrorInvalidValue;
  const Args a{x, w, bias, skip, out, Di, Hi, Wi, Cin, 0, Do, Ho, Wo, Cout, pd, ph, pw, relu,
               0, 0};
  if (stride == 1) return (int)dispatch<false, 1>(a, N, stream);
  if (stride == 2) return (int)dispatch<false, 2>(a, N, stream);
  return (int)cudaErrorInvalidValue;
}

// ConvTranspose3d(k=3, s=2, p=1, op=1) of x (N, Di, Hi, Wi, Cin) with w (27,
// Cin8, slabs·NT) (the ConvTranspose3d weight (Cin, Cout, kd, kh, kw) in
// the header's layout), as a gather over the input positions m < (Dm, Hm,
// Wm) (each Di or Di − 1: a last plane, row or column that is the next
// slab's halo is read but not an m) → out (N, 2Dm, 2Hm, 2Wm, Cout), + bias
// (or null), ReLU, + skip (or null).  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).
extern "C" int deconv3d_block_f32(const float* x, const float* w, const float* bias,
                                  const float* skip, float* out, int N, int Di, int Hi, int Wi,
                                  int Cin, int Dm, int Hm, int Wm, int Cout, void* stream) {
  const Args a{x, w, bias, skip, out, Di, Hi, Wi, Cin, 0, Dm, Hm, Wm, Cout, 0, 0, 0, 1, 0, 0};
  return (int)dispatch<true, 1>(a, N, stream);
}
