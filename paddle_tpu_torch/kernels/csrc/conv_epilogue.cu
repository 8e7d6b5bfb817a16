// conv_epilogue.cu — conv + per-channel batch-norm statistics, and the
// batch-norm epilogue (normalise, affine, residual, ReLU), fp32, for sm_90a.
//
// Layouts are the TPU kernels' own: x [N, H, W, C] NHWC, w [K, K, C, F]
// (HWIO), the conv output and y [N, Ho, Wo, F] NHWC, which is a row-major
// [M, F] matrix with M = N * Ho * Wo.
//
// ---------------------------------------------------------------------------
// conv_stats_f32
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
// What bounds it on an H100: operations.  2 * M * K*K*C * F fp32 flops over
// about 4 * (|x| + |w| + |out|) bytes is hundreds of flops a byte for every
// ResNet-50 conv, far above the card's fp32 balance of 20 (67 TFLOP/s over
// 3.35 TB/s).  This first version is fp32 FMA from shared memory without
// tensor cores; TF32 or bf16 wgmma tiles, deeper pipelining and larger
// tiles are later steps.
//
// ---------------------------------------------------------------------------
// bn_epilogue_f32
//
// Replaces: paddle_tpu/kernels/conv_epilogue.py, the pallas_call of
// `conv_bn_act` at line 412 (body `_bn_epilogue_kernel`, line 182):
// y = act((out - mean) * inv * gamma + beta [+ z]), act relu or none.
//
// Design.  One grid-stride pass over [M, F], 16-byte loads and stores when
// F is a multiple of 4; the four [F] vectors are read through the read-only
// cache.  The residual z is optional (a null pointer).
//
// What bounds it: bytes.  It reads out (and z) and writes y once, a few
// flops per 4-byte element, far below the fp32 balance.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

namespace {

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

__global__ void bn_epilogue_vec4_kernel(
    const float4* __restrict__ out, const float* __restrict__ mean,
    const float* __restrict__ inv, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float4* __restrict__ z,
    float4* __restrict__ y, long long n4, int F, int relu) {
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n4;
       v += (long long)gridDim.x * blockDim.x) {
    const int f = (int)((v * 4) % F);
    const float4 o = out[v];
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
      const float4 zz = z[v];
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
    y[v] = r;
  }
}

__global__ void bn_epilogue_kernel(const float* __restrict__ out,
                                   const float* __restrict__ mean,
                                   const float* __restrict__ inv,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   const float* __restrict__ z,
                                   float* __restrict__ y, long long n, int F,
                                   int relu) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int f = (int)(i % F);
    float r = bn_one(out[i], __ldg(mean + f), __ldg(inv + f), __ldg(gamma + f),
                     __ldg(beta + f));
    if (z != nullptr) r += z[i];
    if (relu) r = relu_nan(r);
    y[i] = r;
  }
}

int epilogue_blocks(long long items) {
  const long long cap = 132LL * 16;  // enough resident blocks for 132 SMs
  long long b = (items + 255) / 256;
  if (b > cap) b = cap;
  return (int)(b < 1 ? 1 : b);
}

}  // namespace

// x [N, H, W, C], w [K, K, C, F], out [N, Ho, Wo, F] (all contiguous fp32);
// psum, psumsq scratch of [ceil(N*Ho*Wo / 64), F]; sum, sumsq [F].
extern "C" int conv_stats_f32(const float* x, const float* w, float* out,
                              float* psum, float* psumsq, float* sum,
                              float* sumsq, int N, int H, int W, int C, int F,
                              int K, int stride, int pad, int Ho, int Wo,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * Ho * Wo;
  const long long tiles = (M + BM - 1) / BM;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)((F + BN - 1) / BN));
  conv_stats_kernel<<<grid, THREADS, 0, s>>>(x, w, out, psum, psumsq, N, H, W,
                                             C, F, K, stride, pad, Ho, Wo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stats_reduce_kernel<<<(F + 31) / 32, dim3(32, 32), 0, s>>>(
      psum, psumsq, sum, sumsq, (int)tiles, F);
  return (int)cudaGetLastError();
}

// out, z (nullable), y [M, F] contiguous fp32; mean, inv, gamma, beta [F].
extern "C" int bn_epilogue_f32(const float* out, const float* mean,
                               const float* inv, const float* gamma,
                               const float* beta, const float* z, float* y,
                               long long M, int F, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = M * F;
  const unsigned long long addr =
      (unsigned long long)out | (unsigned long long)y | (unsigned long long)z;
  if (F % 4 == 0 && (addr & 15) == 0) {
    bn_epilogue_vec4_kernel<<<epilogue_blocks(n / 4), 256, 0, s>>>(
        reinterpret_cast<const float4*>(out), mean, inv, gamma, beta,
        reinterpret_cast<const float4*>(z), reinterpret_cast<float4*>(y),
        n / 4, F, relu);
  } else {
    bn_epilogue_kernel<<<epilogue_blocks(n), 256, 0, s>>>(
        out, mean, inv, gamma, beta, z, y, n, F, relu);
  }
  return (int)cudaGetLastError();
}
