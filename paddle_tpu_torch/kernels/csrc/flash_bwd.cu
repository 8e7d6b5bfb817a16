// flash_bwd.cu — flash attention backward (dQ, and dK/dV), fp32 and bf16, for
// sm_90a.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, the two pallas_calls built
// by `_bwd_calls`: dq (line 391, body `_flash_bwd_dq_kernel`) and dkv (line
// 409, body `_flash_bwd_dkv_kernel`).  The FlashAttention-2 split: P is
// rebuilt from the forward's per-row logsumexp (flash_fwd.cu, lse != null),
// so nothing score-shaped is stored between the passes, and each output has
// one owner block, so the kernels need no atomics.
//
// With S = scale * Q K^T, P = exp(S - lse) on visible entries and 0 on masked
// ones, dP = dO V^T, D = rowsum(dO * O) (computed by the caller) and
// dS = P * (dP - D) * scale:
//   dq:  dQ = dS K                      one block per (b*h, 64-query tile)
//   dkv: dK = dS^T Q,  dV = P^T dO      one block per (b*h, 64-key tile)
//
// The masking contract is the forward's (and `_reference_attention`'s):
//   - key padding: key j of batch row b is visible iff j < min(Sk, klen[b]);
//   - causal, bottom-right aligned: query i sees keys j <= i + Sk - Sq;
//   - only keys are padded: query rows past a length are live rows;
//   - masked entries get P = 0 explicitly, not through exp underflow, so a
//     row with klen = 0 (lse = +1e30) gives dQ = 0 and adds nothing to dK/dV;
//     key rows at or past klen get dK = dV = 0.
//
// Element types: q, k, v, dout and the gradients are all float
// (`flash_bwd_*_f32`) or all bf16 (`flash_bwd_*_bf16`); lse and D are fp32
// either way.  bf16 rounds where the TPU kernels round, and only there: S, P,
// dP, dS and the accumulators are fp32; dS is rounded to K's dtype before
// dS K (flash_attention.py:227), dS^T to Q's dtype before dS^T Q (:267), P^T
// to dO's dtype before P^T dO (:270), and each gradient once, at its store
// (:232, :275-276).  For float every rounding is the identity, so both
// entries are one template.
//
// Design.  256 threads as a 16x16 grid; each thread owns a 4x4 block of every
// 64x64 tile product (rows ty + 16i, columns tx + 16j) and the output columns
// tx + 16c of its four rows, as in flash_fwd.cu.  A loop inside the block
// takes the place of the TPU grid's innermost sequential dimension: the dq
// block walks key tiles up to its causal frontier and the key length, the
// dkv block walks query tiles from the first one that can see its keys.  The
// operand tiles go through shared memory (rows padded by one float so the
// column reads of the tile products are free of bank conflicts), P and dS
// are staged there for the second product, and the fp32 accumulators stay in
// registers.  The tiles are 64 rows for head_dim 64 and 128; shared memory
// (83 KB / 149 KB for dq, 100 KB / 166 KB for dkv) is above the 48 KB static
// limit and is opted into as dynamic shared memory.
//
// What bounds it on an H100.  The floor is the larger of the bytes (Q, K, V,
// dO, lse, D read once; dQ, or dK and dV, written once) over the published
// 3.35 TB/s and the fp32 flops of the visible query-key pairs (dq: 6*D per
// pair for S, dP and dQ; dkv: 8*D for S, dP, dK and dV) over the published
// 67 TFLOP/s.  At the training shape (S = 256, D = 64) the flops floor leads.
// In practice the kernels are bound by instruction issue: every product is an
// fp32 FMA on the CUDA cores fed from shared memory, and one or two blocks fit
// an SM.  Tensor cores (TF32 or bf16 wgmma) and a TMA pipeline are the later
// steps; fp32 FMA keeps this first kernel within 1e-4 of the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Element access by type: loads widen four elements to fp32, `round` rounds
// an fp32 value to the element type and back, `store` narrows for an output.
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

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1e30f;

// Copies rows [r0, r0 + 64) of a [S, D] matrix into a [64][D + 1] fp32
// shared tile; rows at or past `valid` are zero.
template <typename T, int D>
__device__ void load_tile(float* dst, const T* src, int r0, int valid,
                          int tid) {
  constexpr int D4 = D / 4;
  for (int idx = tid; idx < 64 * D4; idx += THREADS) {
    const int r = idx / D4, d = (idx % D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < valid) x = Elem<T>::load4(src + (size_t)(r0 + r) * D + d);
    float* p = dst + r * (D + 1) + d;
    p[0] = x.x; p[1] = x.y; p[2] = x.z; p[3] = x.w;
  }
}

// acc[i][j] += sum_d a[ty + 16i][d] * b[tx + 16j][d] over two [64][D+1] tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][c] += sum_r w[ty + 16i][r] * m[r][tx + 16c]: w a [64][65] staging
// tile, m a [64][D + 1] operand tile.
template <int D>
__device__ __forceinline__ void tile_matmul(float (&acc)[4][D / 16],
                                            const float* w, const float* m,
                                            int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    float wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = w[(ty + 16 * i) * 65 + r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float mv = m[r * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(wv[i], mv, acc[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_smem_floats() {
  // q, do, k, v [64][D+1]; ds [64][65]
  return 4 * (size_t)64 * (D + 1) + (size_t)64 * 65;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec,
                    const int* __restrict__ k_lengths, T* __restrict__ dq,
                    int H, int Sq, int Sk, float scale, int causal) {
  using E = Elem<T>;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [BQ][D+1]
  float* do_s = q_s + BQ * (D + 1);   // [BQ][D+1]
  float* k_s = do_s + BQ * (D + 1);   // [BK][D+1]
  float* v_s = k_s + BK * (D + 1);    // [BK][D+1]
  float* ds_s = v_s + BK * (D + 1);   // [BQ][BK+1]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qb = q + (size_t)bh * Sq * D;
  const T* dob = dout + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;

  const int klen = max(0, min(Sk, k_lengths[b]));
  const int offset = Sk - Sq;  // bottom-right causal alignment
  int k_end = klen;
  if (causal) k_end = min(k_end, q0 + BQ + offset);

  load_tile<T, D>(q_s, qb, q0, Sq, tid);
  load_tile<T, D>(do_s, dob, q0, Sq, tid);
  float row_lse[4], row_d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    row_lse[i] = r < Sq ? lse[(size_t)bh * Sq + r] : -NEG_INF;
    row_d[i] = r < Sq ? dvec[(size_t)bh * Sq + r] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // q/do tiles written; previous k tile fully consumed
    load_tile<T, D>(k_s, kb, k0, klen, tid);
    load_tile<T, D>(v_s, vb, k0, klen, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<D>(s, q_s, k_s, ty, tx);
    tile_dot<D>(dp, do_s, v_s, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < klen && (!causal || kj <= qi + offset);
        const float p = ok ? expf(s[i][j] * scale - row_lse[i]) : 0.f;
        // dS rounds to K's dtype for the dS K product
        ds_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] =
            E::round(p * (dp[i][j] - row_d[i]) * scale);
      }
    }
    __syncthreads();  // ds tile complete
    tile_matmul<D>(acc, ds_s, k_s, ty, tx);
  }

  T* dqb = dq + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dqb[(size_t)r * D + tx + 16 * c] = E::store(acc[i][c]);
  }
}

template <int D>
constexpr size_t dkv_smem_floats() {
  // k, v, q, do [64][D+1]; pt, dst [64][65]; lse, d [64]
  return 4 * (size_t)64 * (D + 1) + 2 * (size_t)64 * 65 + 2 * 64;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec,
                     const int* __restrict__ k_lengths, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, float scale,
                     int causal) {
  using E = Elem<T>;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                  // [BK][D+1]
  float* v_s = k_s + BK * (D + 1);    // [BK][D+1]
  float* q_s = v_s + BK * (D + 1);    // [BQ][D+1]
  float* do_s = q_s + BQ * (D + 1);   // [BQ][D+1]
  float* pt_s = do_s + BQ * (D + 1);  // [BK][BQ+1]  P^T
  float* dst_s = pt_s + BK * (BQ + 1);  // [BK][BQ+1]  dS^T
  float* lse_s = dst_s + BK * (BQ + 1);  // [BQ]
  float* d_s = lse_s + BQ;               // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qb = q + (size_t)bh * Sq * D;
  const T* dob = dout + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;

  const int klen = max(0, min(Sk, k_lengths[b]));
  const int offset = Sk - Sq;
  // first query tile holding a row that sees key k0: i >= k0 - offset
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - offset) / BQ * BQ;
  // no visible key in this tile: the loop is empty and zeros are written

  load_tile<T, D>(k_s, kb, k0, klen, tid);
  load_tile<T, D>(v_s, vb, k0, klen, tid);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int q_end = k0 < klen ? Sq : 0;
  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    __syncthreads();  // k/v tiles written; previous q tile fully consumed
    load_tile<T, D>(q_s, qb, q0, Sq, tid);
    load_tile<T, D>(do_s, dob, q0, Sq, tid);
    if (tid < BQ) {
      const int r = q0 + tid;
      lse_s[tid] = r < Sq ? lse[(size_t)bh * Sq + r] : -NEG_INF;
      d_s[tid] = r < Sq ? dvec[(size_t)bh * Sq + r] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows are keys (ty + 16i), columns queries (tx + 16j)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<D>(s, k_s, q_s, ty, tx);
    tile_dot<D>(dp, v_s, do_s, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tx + 16 * j;
        const int qi = q0 + qr;
        const bool ok = kj < klen && (!causal || kj <= qi + offset);
        const float p = ok ? expf(s[i][j] * scale - lse_s[qr]) : 0.f;
        // P^T rounds to dO's dtype, dS^T to Q's (one element type here)
        pt_s[(ty + 16 * i) * (BQ + 1) + qr] = E::round(p);
        dst_s[(ty + 16 * i) * (BQ + 1) + qr] =
            E::round(p * (dp[i][j] - d_s[qr]) * scale);
      }
    }
    __syncthreads();  // P^T and dS^T complete
    tile_matmul<D>(dv_acc, pt_s, do_s, ty, tx);
    tile_matmul<D>(dk_acc, dst_s, q_s, ty, tx);
  }

  T* dkb = dk + (size_t)bh * Sk * D;
  T* dvb = dv + (size_t)bh * Sk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= Sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkb[(size_t)r * D + tx + 16 * c] = E::store(dk_acc[i][c]);
      dvb[(size_t)r * D + tx + 16 * c] = E::store(dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
int launch_dq(const T* q, const T* k, const T* v, const T* dout,
              const float* lse, const float* dvec, const int* k_lengths, T* dq,
              int B, int H, int Sq, int Sk, float scale, int causal,
              cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, dvec, k_lengths, dq, H, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const T* q, const T* k, const T* v, const T* dout,
               const float* lse, const float* dvec, const int* k_lengths,
               T* dk, T* dv, int B, int H, int Sq, int Sk, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sk + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      q, k, v, dout, lse, dvec, k_lengths, dk, dv, H, Sq, Sk, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(const T* q, const T* k, const T* v, const T* dout,
                const float* lse, const float* dvec, const int* k_lengths,
                T* dq, int B, int H, int Sq, int Sk, int D, float scale,
                int causal, void* stream) {
  if (B * H == 0 || Sq == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, lse, dvec, k_lengths, dq, B, H,
                              Sq, Sk, scale, causal, st);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, lse, dvec, k_lengths, dq, B, H,
                               Sq, Sk, scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dkv(const T* q, const T* k, const T* v, const T* dout,
                 const float* lse, const float* dvec, const int* k_lengths,
                 T* dk, T* dv, int B, int H, int Sq, int Sk, int D,
                 float scale, int causal, void* stream) {
  if (B * H == 0 || Sk == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, dvec, k_lengths, dk, dv, B,
                               H, Sq, Sk, scale, causal, st);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, dvec, k_lengths, dk, dv,
                                B, H, Sq, Sk, scale, causal, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/dout/dq [B,H,Sq,D], k/v/dk/dv [B,H,Sk,D]: contiguous on the device, all
// fp32 (`*_f32`) or all bf16 (`*_bf16`), 16-byte aligned; lse/dvec [B,H,Sq]
// fp32; k_lengths [B] int32 on the device.  Each entry returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for an
// unsupported head_dim).
extern "C" int flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                                const float* dout, const float* lse,
                                const float* dvec, const int* k_lengths,
                                float* dq, int B, int H, int Sq, int Sk, int D,
                                float scale, int causal, void* stream) {
  return dispatch_dq<float>(q, k, v, dout, lse, dvec, k_lengths, dq, B, H, Sq,
                            Sk, D, scale, causal, stream);
}

extern "C" int flash_bwd_dkv_f32(const float* q, const float* k,
                                 const float* v, const float* dout,
                                 const float* lse, const float* dvec,
                                 const int* k_lengths, float* dk, float* dv,
                                 int B, int H, int Sq, int Sk, int D,
                                 float scale, int causal, void* stream) {
  return dispatch_dkv<float>(q, k, v, dout, lse, dvec, k_lengths, dk, dv, B,
                             H, Sq, Sk, D, scale, causal, stream);
}

extern "C" int flash_bwd_dq_bf16(const __nv_bfloat16* q,
                                 const __nv_bfloat16* k,
                                 const __nv_bfloat16* v,
                                 const __nv_bfloat16* dout, const float* lse,
                                 const float* dvec, const int* k_lengths,
                                 __nv_bfloat16* dq, int B, int H, int Sq,
                                 int Sk, int D, float scale, int causal,
                                 void* stream) {
  return dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, dvec, k_lengths, dq,
                                    B, H, Sq, Sk, D, scale, causal, stream);
}

extern "C" int flash_bwd_dkv_bf16(const __nv_bfloat16* q,
                                  const __nv_bfloat16* k,
                                  const __nv_bfloat16* v,
                                  const __nv_bfloat16* dout, const float* lse,
                                  const float* dvec, const int* k_lengths,
                                  __nv_bfloat16* dk, __nv_bfloat16* dv, int B,
                                  int H, int Sq, int Sk, int D, float scale,
                                  int causal, void* stream) {
  return dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, dvec, k_lengths, dk,
                                     dv, B, H, Sq, Sk, D, scale, causal,
                                     stream);
}
