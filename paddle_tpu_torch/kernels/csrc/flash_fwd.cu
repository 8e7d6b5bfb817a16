// flash_fwd.cu — forward flash attention, fp32 and bf16, for sm_90a.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, the pallas_call built by
// `_fwd_call` (line 317) with body `_flash_kernel` (and its fwd-only variant
// `_flash_kernel_fwd_only`).  A null `lse` pointer is the fwd-only variant
// (serving's prefill); a non-null one also writes the per-row logsumexp the
// backward kernels (flash_bwd.cu) rebuild P from, as emit_lse=True does.
//
// Computes o = softmax(q k^T * scale + mask) v on [B, H, S, D] tensors of one
// element type, float (`flash_fwd_f32`) or bf16 (`flash_fwd_bf16`), with the
// TPU kernel's masking contract:
//   - key padding: key j of batch row b is visible iff j < min(Sk, klen[b]);
//   - causal (optional), bottom-right aligned like tril(k = Sk - Sq): query i
//     sees keys j <= i + Sk - Sq;
//   - a fully masked row returns zeros: the running max starts at NEG_INF/2,
//     so a masked score (NEG_INF) gives exp(NEG_INF - NEG_INF/2) = 0, l stays
//     0 and the output is acc / max(l, 1e-30) = 0 (never the mean of V);
//   - lse[r] = m + log(l) for a row with a visible key, and -NEG_INF = +1e30
//     for a fully masked row (l == 0), as the TPU kernel writes it: the
//     backward's exp(S - lse) then underflows to exactly 0 on that row.
//
// bf16 rounds where the TPU kernel rounds, and only there: the scores, the
// running max and sum and the accumulator are fp32 (bf16 operands widen
// exactly on load, so every product is exact); P = exp(S - m) is rounded to
// V's dtype before the PV product (flash_attention.py:173) while the row sum
// l takes the unrounded P; the output rounds once, at the store (:181); lse
// stays fp32.  For float every rounding is the identity, so both entries are
// one template.
//
// Design.  One thread block per (b*h, 64-query tile): 256 threads as a 16x16
// grid, thread (ty, tx) owning query rows ty + 16i and key columns tx + 16j
// (i, j < 4) of each 64x64 score tile, and output columns tx + 16c of its four
// rows.  A loop over 64-key tiles takes the place of the TPU grid's sequential
// k dimension: K and V tiles go through shared memory, the running max m, sum
// l and the fp32 accumulator stay in registers, and row reductions are 16-lane
// shuffles inside a half-warp.  The loop stops at the tile's last visible key
// (k_lengths and the causal frontier), so padded and future keys cost nothing.
// The ragged edges (S not a multiple of 64) are masked in the kernel; nothing
// is padded in device memory.  Q and K rows are padded by one float in shared
// memory so the column reads of the score product are free of bank conflicts.
//
// What bounds it on an H100.  Its floor is the larger of the bytes (Q, K, V
// read once, O written once) over the published 3.35 TB/s and the fp32 flops
// (4*D per visible query-key pair) over the published 67 TFLOP/s.  At serving
// prompts (S <= 256, D = 64) each key meets at most S queries, so the bytes
// floor is a little ahead of the flops floor and both are microseconds.  In
// practice the kernel is bound by instruction issue: every score and every PV
// term is an fp32 FMA on the CUDA cores fed from shared memory, and the
// serving shape gives 8*8*2 = 128 blocks, one partial wave on 132 SMs.  The
// design keeps work off that path: the tile loop ends at the last visible
// key, the running state stays in registers, and 4x4 register blocking makes
// each shared-memory load feed four FMAs.  Tensor cores (TF32 or bf16 wgmma)
// and a TMA pipeline are the later steps; fp32 FMA keeps this first kernel
// within 1e-4 of the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Element access by type: loads widen four elements to fp32, `round` rounds
// an fp32 value to the element type and back, `store` narrows for the output.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);  // 4 x bf16, 8 bytes
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_floats() {
  // q [BQ][D+1], k [BK][D+1], v [BK][D], p [BQ][BK+1]
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ k_lengths,
                 T* __restrict__ o, float* __restrict__ lse, int H, int Sq,
                 int Sk, float scale, int causal) {
  using E = Elem<T>;
  constexpr int DC = D / 16;  // output columns per thread
  constexpr int D4 = D / 4;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [BQ][D+1]
  float* k_s = q_s + BQ * (D + 1);     // [BK][D+1]
  float* v_s = k_s + BK * (D + 1);     // [BK][D]   (16-byte aligned)
  float* p_s = v_s + BK * D;           // [BQ][BK+1]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;

  const int klen = max(0, min(Sk, k_lengths[b]));
  const int offset = Sk - Sq;  // bottom-right causal alignment
  int k_end = klen;
  if (causal) k_end = min(k_end, q0 + BQ + offset);

  for (int idx = tid; idx < BQ * D4; idx += THREADS) {
    const int r = idx / D4, d = (idx % D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) x = E::load4(qb + (size_t)(q0 + r) * D + d);
    float* dst = q_s + r * (D + 1) + d;
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF / 2;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // q_s written / previous tile fully consumed
    for (int idx = tid; idx < BK * D4; idx += THREADS) {
      const int c = idx / D4, d = (idx % D4) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + c < klen) {
        kx = E::load4(kb + (size_t)(k0 + c) * D + d);
        vx = E::load4(vb + (size_t)(k0 + c) * D + d);
      }
      float* kd = k_s + c * (D + 1) + d;
      kd[0] = kx.x; kd[1] = kx.y; kd[2] = kx.z; kd[3] = kx.w;
      *reinterpret_cast<float4*>(v_s + c * D + d) = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < klen && (!causal || kj <= qi + offset);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off, 16));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);  // masked: exp(<= -5e29) = 0
        // P rounds to V's dtype for the PV product; l sums it unrounded
        p_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = E::round(p);
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off, 16);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // p_s complete

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = v_s[c * D + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

  T* ob = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      ob[(size_t)r * D + tx + 16 * c] = E::store(acc[i][c] / denom);
    if (lse != nullptr && tx == 0)  // m, l are equal across the 16 lanes
      lse[(size_t)bh * Sq + r] = l[i] > 0.f ? m[i] + logf(denom) : -NEG_INF;
  }
}

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, const int* k_lengths, T* o,
           float* lse, int B, int H, int Sq, int Sk, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      q, k, v, k_lengths, o, lse, H, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, const int* k_lengths, T* o,
             float* lse, int B, int H, int Sq, int Sk, int D, float scale,
             int causal, void* stream) {
  if (B * H == 0 || Sq == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, k_lengths, o, lse, B, H, Sq, Sk, scale,
                           causal, st);
    case 128:
      return launch<T, 128>(q, k, v, k_lengths, o, lse, B, H, Sq, Sk, scale,
                            causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,Sq,D], k/v [B,H,Sk,D], o [B,H,Sq,D]: contiguous on the device, all
// fp32 (`flash_fwd_f32`) or all bf16 (`flash_fwd_bf16`), 16-byte aligned.
// k_lengths [B] int32 on the device.  lse [B,H,Sq] fp32, or null to skip it.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported head_dim).
extern "C" int flash_fwd_f32(const float* q, const float* k, const float* v,
                             const int* k_lengths, float* o, float* lse,
                             int B, int H, int Sq, int Sk, int D, float scale,
                             int causal, void* stream) {
  return dispatch<float>(q, k, v, k_lengths, o, lse, B, H, Sq, Sk, D, scale,
                         causal, stream);
}

extern "C" int flash_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, const int* k_lengths,
                              __nv_bfloat16* o, float* lse, int B, int H,
                              int Sq, int Sk, int D, float scale, int causal,
                              void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, k_lengths, o, lse, B, H, Sq, Sk, D,
                                 scale, causal, stream);
}
