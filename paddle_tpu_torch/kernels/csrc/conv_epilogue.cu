// conv_epilogue.cu — conv + per-channel batch-norm statistics, and the
// batch-norm epilogue (normalise, affine, residual, ReLU), fp32 and bf16, for
// sm_90a.
//
// Layouts are the TPU kernels' own: x [N, H, W, C] NHWC, w [K, K, C, F]
// (HWIO), the conv output and y [N, Ho, Wo, F] NHWC, which is a row-major
// [M, F] matrix with M = N * Ho * Wo.
//
// Element types.  Each kernel has an fp32 entry (`*_f32`) and a bf16 entry
// (`*_bf16`) over activations and weights of that type; the [F] vectors
// (sum, sumsq, mean, inv, gamma, beta) are fp32 in both.  bf16 rounds where
// the TPU kernels round, and only there: every product of bf16 x and w is
// exact and accumulates in fp32 over all taps and channels
// (conv_epilogue.py:129-131), the conv output is stored rounded to bf16
// (`_stats_update`, :140) while sum and sumsq take the unrounded fp32
// accumulator (:147-148); the epilogue widens out and z, runs the affine,
// residual and ReLU in fp32 and rounds y once, at the store (:186-192).
//
// ---------------------------------------------------------------------------
// conv_stats_f32, conv_stats_bf16
//
// Replaces: paddle_tpu/kernels/conv_epilogue.py, the pallas_calls of
// `conv_bn_act` at line 347 (body `_conv_stats_kernel_inpad`: stride 1, the
// halo padded inside the kernel) and line 383 (body `_conv_stats_kernel`:
// host-padded, stride-phase decomposed, row tiled).  Both compute one
// function: out = conv(x, w) with stride s and symmetric zero padding p,
// written once, plus sum[f] and sumsq[f] of out over N, Ho, Wo.
//
// Design.  An implicit GEMM: out[M, F] = A[M, K*K*C] @ B[K*K*C, F], where
// A[m, (kh, kw, c)] = x[n, ho*s - p + kh, wo*s - p + kw, c] is never built —
// each 64 x 16 chunk of A is gathered from NHWC x straight into shared
// memory, with stride and padding handled by bounds checks (a pixel outside
// the image reads 0).  So the host-side padding, the stride-phase planes and
// the row tiles of the TPU kernel (Mosaic cannot lower strided vector slices
// or blocks larger than VMEM) have no counterpart here.  B is w itself,
// contiguous [K*K*C, F].  One block of 256 threads owns a 64 x 64 (M x F)
// output tile; each thread keeps a 4 x 4 register tile and the K loop stages
// 16-deep chunks of A and B through shared memory, the next chunk's global
// loads issued before the current chunk's FMAs.
//
// The statistics.  The TPU kernel carries sum and sumsq across its
// sequential grid in VMEM (`_stats_update`, line 136).  Blocks on the card
// run in no order, so each block reduces its own tile's 64 rows per channel
// inside the block and writes the two partial rows to [ceil(M/64), F]
// buffers; a second kernel sums the partials in a fixed order.  No atomics,
// so the sums are the same on every run.  Rows past M hold exact zeros
// (their A rows were zero) and add nothing.  mean, var and inv are formed
// outside the kernels from the two [F] vectors, as the JAX module does.
//
// fp32 (`conv_stats_kernel`): each thread keeps a 4 x 4 register tile of
// fp32 FMAs fed from shared memory.  bf16 (`conv_stats_mma_kernel`): the same
// tiles in 32-deep chunks staged as raw bf16 (16-byte loads where C and F
// are multiples of 8), the products on the tensor cores with mma.sync
// m16n8k16 (bf16 in, fp32 accumulate), each of eight warps owning a 32 x 16
// sub-tile.
//
// What bounds it on an H100.  fp32: operations; 2 * M * K*K*C * F flops over
// about 4 * (|x| + |w| + |out|) bytes is hundreds of flops a byte for every
// ResNet-50 conv, far above the card's fp32 balance of 20 (67 TFLOP/s over
// 3.35 TB/s).  bf16: the dense bf16 tensor rate (989 TFLOP/s) against half
// the bytes puts the balance near 295 flops a byte, so the 1x1 convs and the
// stem sit on the bytes side and the 3x3 convs near the line.  Both kernels
// are first versions: single-stage register prefetch, scalar gathers of A,
// 64 x 64 tiles; wgmma, TMA and deeper pipelines are later steps.
//
// ---------------------------------------------------------------------------
// bn_epilogue_f32, bn_epilogue_bf16
//
// Replaces: paddle_tpu/kernels/conv_epilogue.py, the pallas_call of
// `conv_bn_act` at line 412 (body `_bn_epilogue_kernel`, line 182):
// y = act((out - mean) * inv * gamma + beta [+ z]), act relu or none.
//
// Design.  One grid-stride pass over [M, F], four elements a thread at a time
// (16-byte fp32 or 8-byte bf16 loads and stores) when F is a multiple of 4;
// the four [F] vectors are read through the read-only cache.  The residual z
// is optional (a null pointer).
//
// What bounds it: bytes.  It reads out (and z) and writes y once, a few
// flops per element, far below the balance of either type.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Element access by type: `load` widens one element to fp32, `load4` four
// neighbours, `store` rounds to the element type (round to nearest even),
// `store4` four neighbours.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);  // 4 x bf16, 8 bytes
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&a);
    u.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

constexpr int BM = 64;        // output rows (N*Ho*Wo) per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // reduction depth per shared-memory chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int APAD = 4;       // keeps float4 alignment, spreads store banks

__global__ void __launch_bounds__(THREADS)
conv_stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, float* __restrict__ psum,
                  float* __restrict__ psumsq, int N, int H, int W, int C,
                  int F, int K, int stride, int pad, int Ho, int Wo) {
  __shared__ __align__(16) float As[BK][BM + APAD];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float red_s[BM / 4][BN];
  __shared__ float red_q[BM / 4][BN];

  const int t = threadIdx.x;
  const long long M = (long long)N * Ho * Wo;
  const int Ktot = K * K * C;
  const long long m0 = (long long)blockIdx.x * BM;
  const int f0 = blockIdx.y * BN;

  // A loader: column ak of the chunk, rows am + 16 i of the tile
  const int ak = t % BK;
  const int am = t / BK;
  int a_n[4], a_hi[4], a_wi[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + am + 16 * i;
    a_ok[i] = m < M;
    const long long mm = a_ok[i] ? m : 0;
    const int n = (int)(mm / ((long long)Ho * Wo));
    const int r = (int)(mm - (long long)n * Ho * Wo);
    const int ho = r / Wo;
    const int wo = r - ho * Wo;
    a_n[i] = n;
    a_hi[i] = ho * stride - pad;
    a_wi[i] = wo * stride - pad;
  }
  // B loader: rows bk + 4 i of the chunk, column bf of the tile
  const int bk = t / BN;
  const int bf = t % BN;

  float a_reg[4], b_reg[4];
  auto load = [&](int k0) {
    const int kk = k0 + ak;
    const bool kok = kk < Ktot;
    int c = 0, kh = 0, kw = 0;
    if (kok) {
      c = kk % C;
      const int r = kk / C;
      kw = r % K;
      kh = r / K;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.f;
      const int ih = a_hi[i] + kh;
      const int iw = a_wi[i] + kw;
      if (kok && a_ok[i] && ih >= 0 && ih < H && iw >= 0 && iw < W)
        v = x[(((long long)a_n[i] * H + ih) * W + iw) * C + c];
      a_reg[i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + bk + 4 * i;
      const int f = f0 + bf;
      b_reg[i] = (k < Ktot && f < F) ? w[(long long)k * F + f] : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[ak][am + 16 * i] = a_reg[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) Bs[bk + 4 * i][bf] = b_reg[i];
  };

  const int tx = t % 16;  // output columns tx*4 .. tx*4+3
  const int ty = t / 16;  // output rows ty*4 .. ty*4+3
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < Ktot; k0 += BK) {
    const bool more = k0 + BK < Ktot;
    if (more) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  // epilogue 1: the conv output, 16-byte stores where the row allows
  const int fc = f0 + tx * 4;
  const bool vec = (F % 4 == 0) && (fc + 3 < F);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
    float* row = out + m * F;
    if (vec) {
      *reinterpret_cast<float4*>(row + fc) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (fc + j < F) row[fc + j] = acc[i][j];
    }
  }

  // epilogue 2: per-channel partial sums of this tile, in a fixed order
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s += acc[i][j];
      q = fmaf(acc[i][j], acc[i][j], q);
    }
    red_s[ty][tx * 4 + j] = s;
    red_q[ty][tx * 4 + j] = q;
  }
  __syncthreads();
  if (t < BN && f0 + t < F) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int r = 0; r < BM / 4; ++r) {
      s += red_s[r][t];
      q += red_q[r][t];
    }
    psum[(long long)blockIdx.x * F + f0 + t] = s;
    psumsq[(long long)blockIdx.x * F + f0 + t] = q;
  }
}

// The bf16 conv: the same 64 x 64 output tile, 32-deep chunks staged
// through shared memory as raw bf16, and the products on the tensor cores
// (mma.sync m16n8k16, bf16 operands, fp32 accumulators).  Eight warps as
// 2 (M) x 4 (N), each owning a 32 x 16 sub-tile: two 16-row A fragments
// times two 8-column B fragments, four mma per 16-deep step.  As is [m][k],
// so an A fragment register is one 32-bit read; Bs is [k][n] as in the fp32
// kernel.  Row paddings keep every fragment read free of bank conflicts.
// VEC (C and F multiples of 8, every ResNet conv but the stem): each thread
// loads eight channels of one A row and eight columns of one B row as one
// 16-byte load a chunk; otherwise (the stem's C = 3) eight scalar gathers.
constexpr int MBK = 32;          // chunk depth of the bf16 kernel
constexpr int MMA_AS = MBK + 8;  // As row stride, bf16 elements
constexpr int MMA_BS = BN + 8;   // Bs row stride

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (n, ho * stride - pad, wo * stride - pad) of output row m, or ok = false
// past M
struct RowOrigin {
  int n, hi, wi;
  bool ok;
};

__device__ __forceinline__ RowOrigin row_origin(long long m, long long M,
                                                int Ho, int Wo, int stride,
                                                int pad) {
  RowOrigin o;
  o.ok = m < M;
  const long long mm = o.ok ? m : 0;
  o.n = (int)(mm / ((long long)Ho * Wo));
  const int r = (int)(mm - (long long)o.n * Ho * Wo);
  const int ho = r / Wo;
  o.hi = ho * stride - pad;
  o.wi = (r - ho * Wo) * stride - pad;
  return o;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
conv_stats_mma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ w,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ psum, float* __restrict__ psumsq,
                      int N, int H, int W, int C, int F, int K, int stride,
                      int pad, int Ho, int Wo) {
  __shared__ __align__(16) unsigned short As[BM][MMA_AS];
  __shared__ __align__(16) unsigned short Bs[MBK][MMA_BS];
  __shared__ float red_s[2][BN];
  __shared__ float red_q[2][BN];

  const unsigned short* __restrict__ xb =
      reinterpret_cast<const unsigned short*>(x);
  const unsigned short* __restrict__ wb =
      reinterpret_cast<const unsigned short*>(w);
  const int t = threadIdx.x;
  const long long M = (long long)N * Ho * Wo;
  const int Ktot = K * K * C;
  const long long m0 = (long long)blockIdx.x * BM;
  const int f0 = blockIdx.y * BN;

  // A loader.  VEC: row t / 4, columns 8 (t % 4) .. + 7 of the chunk.
  // Scalar: column t % 32, rows t / 32 + 8 i.  A pixel outside the image,
  // or past M or Ktot, reads 0 (bf16 +0).
  constexpr int AROWS = VEC ? 1 : 8;
  const int ak = VEC ? 8 * (t % 4) : t % MBK;
  const int am = VEC ? t / 4 : t / MBK;
  RowOrigin ao[AROWS];
#pragma unroll
  for (int i = 0; i < AROWS; ++i)
    ao[i] = row_origin(m0 + am + 8 * i, M, Ho, Wo, stride, pad);
  // B loader.  VEC: row t / 8, columns 8 (t % 8) .. + 7.  Scalar: column
  // t % 64, rows t / 64 + 4 i.
  const int bk = VEC ? t / 8 : t / BN;
  const int bf = VEC ? 8 * (t % 8) : t % BN;

  uint4 a_vec, b_vec;
  unsigned short a_reg[8], b_reg[8];
  auto load = [&](int k0) {
    const int kk = k0 + ak;
    const bool kok = kk < Ktot;
    int c = 0, kh = 0, kw = 0;
    if (kok) {
      c = kk % C;
      const int r = kk / C;
      kw = r % K;
      kh = r / K;
    }
    if constexpr (VEC) {
      const int ih = ao[0].hi + kh;
      const int iw = ao[0].wi + kw;
      a_vec = make_uint4(0, 0, 0, 0);
      if (kok && ao[0].ok && ih >= 0 && ih < H && iw >= 0 && iw < W)
        a_vec = *reinterpret_cast<const uint4*>(
            xb + (((long long)ao[0].n * H + ih) * W + iw) * C + c);
      const int k = k0 + bk;
      const int f = f0 + bf;
      b_vec = make_uint4(0, 0, 0, 0);
      if (k < Ktot && f < F)
        b_vec = *reinterpret_cast<const uint4*>(wb + (long long)k * F + f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        unsigned short v = 0;
        const int ih = ao[i].hi + kh;
        const int iw = ao[i].wi + kw;
        if (kok && ao[i].ok && ih >= 0 && ih < H && iw >= 0 && iw < W)
          v = xb[(((long long)ao[i].n * H + ih) * W + iw) * C + c];
        a_reg[i] = v;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + bk + 4 * i;
        const int f = f0 + bf;
        b_reg[i] = (k < Ktot && f < F) ? wb[(long long)k * F + f] : 0;
      }
    }
  };
  auto store = [&]() {
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(&As[am][ak]) = a_vec;
      *reinterpret_cast<uint4*>(&Bs[bk][bf]) = b_vec;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) As[am + 8 * i][ak] = a_reg[i];
#pragma unroll
      for (int i = 0; i < 8; ++i) Bs[bk + 4 * i][bf] = b_reg[i];
    }
  };

  const int lane = t % 32;
  const int warp = t / 32;
  const int g = lane / 4;     // fragment row group
  const int tig = lane % 4;   // thread in group
  const int wm = warp % 2;    // rows 32 wm .. 32 wm + 31 of the tile
  const int wn = warp / 2;    // columns 16 wn .. 16 wn + 15
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < Ktot; k0 += MBK) {
    const bool more = k0 + MBK < Ktot;
    if (more) load(k0 + MBK);
#pragma unroll
    for (int ks = 0; ks < MBK; ks += 16) {
      unsigned a[2][4], b[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 32 * wm + 16 * i + g;
        const int k = ks + 2 * tig;
        a[i][0] = *reinterpret_cast<const unsigned*>(&As[r][k]);
        a[i][1] = *reinterpret_cast<const unsigned*>(&As[r + 8][k]);
        a[i][2] = *reinterpret_cast<const unsigned*>(&As[r][k + 8]);
        a[i][3] = *reinterpret_cast<const unsigned*>(&As[r + 8][k + 8]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = 16 * wn + 8 * j + g;
        const int k = ks + 2 * tig;
        b[j][0] = (unsigned)Bs[k][n] | ((unsigned)Bs[k + 1][n] << 16);
        b[j][1] = (unsigned)Bs[k + 8][n] | ((unsigned)Bs[k + 9][n] << 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

  // epilogue 1: the conv output rounded to bf16; element e of fragment
  // (i, j) is row 32 wm + 16 i + g + 8 (e / 2), column 16 wn + 8 j + 2 tig
  // + e % 2
  const bool pairs = (F % 2 == 0);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + 32 * wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
      __nv_bfloat16* row = out + m * F;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int f = f0 + 16 * wn + 8 * j + 2 * tig;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pairs && f + 1 < F) {
          *reinterpret_cast<__nv_bfloat162*>(row + f) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (f < F) row[f] = __float2bfloat16_rn(v0);
          if (f + 1 < F) row[f + 1] = __float2bfloat16_rn(v1);
        }
      }
    }

  // epilogue 2: per-channel partial sums of the tile from the unrounded
  // accumulators, in a fixed order: each thread's four rows, then the eight
  // row groups of the warp (shuffles), then the two warps along M
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = acc[i][j][2 * h + e];
          s += v;
          q = fmaf(v, v, q);
        }
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (g == 0) {
        const int col = 16 * wn + 8 * j + 2 * tig + e;
        red_s[wm][col] = s;
        red_q[wm][col] = q;
      }
    }
  __syncthreads();
  if (t < BN && f0 + t < F) {
    psum[(long long)blockIdx.x * F + f0 + t] = red_s[0][t] + red_s[1][t];
    psumsq[(long long)blockIdx.x * F + f0 + t] = red_q[0][t] + red_q[1][t];
  }
}

// Sums the [T, F] partial rows per channel: block (32 channels) x (32 row
// lanes); each lane walks every 32nd row, then lane 0 adds the 32 lanes.
__global__ void __launch_bounds__(1024)
stats_reduce_kernel(const float* __restrict__ psum,
                    const float* __restrict__ psumsq, float* __restrict__ sum,
                    float* __restrict__ sumsq, int T, int F) {
  __shared__ float s_s[32][33];
  __shared__ float s_q[32][33];
  const int col = threadIdx.x;
  const int lane = threadIdx.y;
  const int f = blockIdx.x * 32 + col;
  float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
  if (f < F) {
    int r = lane;
    for (; r + 32 < T; r += 64) {
      s0 += psum[(long long)r * F + f];
      q0 += psumsq[(long long)r * F + f];
      s1 += psum[(long long)(r + 32) * F + f];
      q1 += psumsq[(long long)(r + 32) * F + f];
    }
    if (r < T) {
      s0 += psum[(long long)r * F + f];
      q0 += psumsq[(long long)r * F + f];
    }
  }
  s_s[lane][col] = s0 + s1;
  s_q[lane][col] = q0 + q1;
  __syncthreads();
  if (lane == 0 && f < F) {
    float s = 0.f, q = 0.f;
    for (int i = 0; i < 32; ++i) {
      s += s_s[i][col];
      q += s_q[i][col];
    }
    sum[f] = s;
    sumsq[f] = q;
  }
}

__device__ __forceinline__ float bn_one(float o, float mean, float inv,
                                        float gamma, float beta) {
  return (o - mean) * inv * gamma + beta;
}

// relu that keeps a NaN a NaN, as torch.relu and jnp.maximum do
__device__ __forceinline__ float relu_nan(float v) { return v < 0.f ? 0.f : v; }

template <typename T>
__global__ void bn_epilogue_vec4_kernel(
    const T* __restrict__ out, const float* __restrict__ mean,
    const float* __restrict__ inv, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ z,
    T* __restrict__ y, long long n4, int F, int relu) {
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n4;
       v += (long long)gridDim.x * blockDim.x) {
    const int f = (int)((v * 4) % F);
    const float4 o = Elem<T>::load4(out + v * 4);
    float4 r;
    r.x = bn_one(o.x, __ldg(mean + f), __ldg(inv + f), __ldg(gamma + f),
                 __ldg(beta + f));
    r.y = bn_one(o.y, __ldg(mean + f + 1), __ldg(inv + f + 1),
                 __ldg(gamma + f + 1), __ldg(beta + f + 1));
    r.z = bn_one(o.z, __ldg(mean + f + 2), __ldg(inv + f + 2),
                 __ldg(gamma + f + 2), __ldg(beta + f + 2));
    r.w = bn_one(o.w, __ldg(mean + f + 3), __ldg(inv + f + 3),
                 __ldg(gamma + f + 3), __ldg(beta + f + 3));
    if (z != nullptr) {
      const float4 zz = Elem<T>::load4(z + v * 4);
      r.x += zz.x;
      r.y += zz.y;
      r.z += zz.z;
      r.w += zz.w;
    }
    if (relu) {
      r.x = relu_nan(r.x);
      r.y = relu_nan(r.y);
      r.z = relu_nan(r.z);
      r.w = relu_nan(r.w);
    }
    Elem<T>::store4(y + v * 4, r);
  }
}

template <typename T>
__global__ void bn_epilogue_kernel(const T* __restrict__ out,
                                   const float* __restrict__ mean,
                                   const float* __restrict__ inv,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   const T* __restrict__ z, T* __restrict__ y,
                                   long long n, int F, int relu) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int f = (int)(i % F);
    float r = bn_one(Elem<T>::load(out + i), __ldg(mean + f), __ldg(inv + f),
                     __ldg(gamma + f), __ldg(beta + f));
    if (z != nullptr) r += Elem<T>::load(z + i);
    if (relu) r = relu_nan(r);
    Elem<T>::store(y + i, r);
  }
}

int epilogue_blocks(long long items) {
  const long long cap = 132LL * 16;  // enough resident blocks for 132 SMs
  long long b = (items + 255) / 256;
  if (b > cap) b = cap;
  return (int)(b < 1 ? 1 : b);
}

// conv_stats_kernel (float) or conv_stats_mma_kernel (bf16), then the fixed-
// order reduction of the partial sums
template <typename T>
int conv_stats(const T* x, const T* w, T* out, float* psum, float* psumsq,
               float* sum, float* sumsq, int N, int H, int W, int C, int F,
               int K, int stride, int pad, int Ho, int Wo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * Ho * Wo;
  const long long tiles = (M + BM - 1) / BM;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)((F + BN - 1) / BN));
  if constexpr (sizeof(T) == 4) {
    conv_stats_kernel<<<grid, THREADS, 0, s>>>(x, w, out, psum, psumsq, N, H,
                                               W, C, F, K, stride, pad, Ho,
                                               Wo);
  } else if (C % 8 == 0 && F % 8 == 0) {
    conv_stats_mma_kernel<true><<<grid, THREADS, 0, s>>>(
        x, w, out, psum, psumsq, N, H, W, C, F, K, stride, pad, Ho, Wo);
  } else {
    conv_stats_mma_kernel<false><<<grid, THREADS, 0, s>>>(
        x, w, out, psum, psumsq, N, H, W, C, F, K, stride, pad, Ho, Wo);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_reduce_kernel<<<(F + 31) / 32, dim3(32, 32), 0, s>>>(
      psum, psumsq, sum, sumsq, (int)tiles, F);
  return (int)cudaGetLastError();
}

template <typename T>
int bn_epilogue(const T* out, const float* mean, const float* inv,
                const float* gamma, const float* beta, const T* z, T* y,
                long long M, int F, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = M * F;
  const unsigned long long addr =
      (unsigned long long)out | (unsigned long long)y | (unsigned long long)z;
  if (F % 4 == 0 && (addr & (4 * sizeof(T) - 1)) == 0) {
    bn_epilogue_vec4_kernel<T><<<epilogue_blocks(n / 4), 256, 0, s>>>(
        out, mean, inv, gamma, beta, z, y, n / 4, F, relu);
  } else {
    bn_epilogue_kernel<T><<<epilogue_blocks(n), 256, 0, s>>>(
        out, mean, inv, gamma, beta, z, y, n, F, relu);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, H, W, C], w [K, K, C, F], out [N, Ho, Wo, F] (all contiguous, all
// fp32 or all bf16); psum, psumsq fp32 scratch of [ceil(N*Ho*Wo / 64), F];
// sum, sumsq [F] fp32.
extern "C" int conv_stats_f32(const float* x, const float* w, float* out,
                              float* psum, float* psumsq, float* sum,
                              float* sumsq, int N, int H, int W, int C, int F,
                              int K, int stride, int pad, int Ho, int Wo,
                              void* stream) {
  return conv_stats<float>(x, w, out, psum, psumsq, sum, sumsq, N, H, W, C, F,
                           K, stride, pad, Ho, Wo, stream);
}

extern "C" int conv_stats_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                               __nv_bfloat16* out, float* psum, float* psumsq,
                               float* sum, float* sumsq, int N, int H, int W,
                               int C, int F, int K, int stride, int pad,
                               int Ho, int Wo, void* stream) {
  return conv_stats<__nv_bfloat16>(x, w, out, psum, psumsq, sum, sumsq, N, H,
                                   W, C, F, K, stride, pad, Ho, Wo, stream);
}

// out, z (nullable), y [M, F] contiguous, all fp32 or all bf16; mean, inv,
// gamma, beta [F] fp32.
extern "C" int bn_epilogue_f32(const float* out, const float* mean,
                               const float* inv, const float* gamma,
                               const float* beta, const float* z, float* y,
                               long long M, int F, int relu, void* stream) {
  return bn_epilogue<float>(out, mean, inv, gamma, beta, z, y, M, F, relu,
                            stream);
}

extern "C" int bn_epilogue_bf16(const __nv_bfloat16* out, const float* mean,
                                const float* inv, const float* gamma,
                                const float* beta, const __nv_bfloat16* z,
                                __nv_bfloat16* y, long long M, int F,
                                int relu, void* stream) {
  return bn_epilogue<__nv_bfloat16>(out, mean, inv, gamma, beta, z, y, M, F,
                                    relu, stream);
}
