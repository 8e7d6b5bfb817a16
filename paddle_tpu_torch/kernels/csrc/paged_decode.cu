// paged_decode.cu — single-token decode attention over a paged KV pool, fp32,
// for sm_90a.
//
// Replaces: paddle_tpu/kernels/paged_attention.py, the pallas_call built by
// `_paged_call` (line 645) with body `_paged_kernel`, in the variant the
// serving decode step runs: Sq = 1, flat zero-padded [B, max_pages] int32
// page tables, [B] lengths, head-major pool [H_kv, P, page_size, D], no int8
// scales, no explicit page starts, no window.
//
// Computes, for every sequence b and query head h = h_kv * G + g,
//   o[b, h] = softmax(q[b, h] . K[b, h_kv, :len]^T * scale) V[b, h_kv, :len]
// where K/V token t of sequence b lives in pool page tables[b, t / page_size]
// at slot t % page_size, and len = lengths[b].  Positions >= len are masked;
// zero-padded table entries (page 0) lie past len and are never read.  A
// sequence with len = 0 returns zeros (running-max floor NEG_INF/2, as in the
// TPU kernel).
//
// Design.  One thread block per (kv head, sequence).  The block reads its own
// table row and length (a GPU has no scalar prefetch: the indices come from
// global memory at the block's start of each chunk), then walks the sequence
// in chunks of 64 token slots.  Each chunk's K and V rows — gathered from as
// many pages as the chunk spans, with 16-byte loads — are loaded into shared
// memory ONCE and reused by all G query heads of the group (GQA), the point
// of the TPU kernel's (B, H_kv, pages) grid.  The online softmax keeps m, l
// per query row in shared memory and the fp32 output accumulator in
// registers (G*D <= 1024 outputs over 128 threads).
//
// What bounds it on an H100: bytes.  Per layer and step it must read every
// live K and V row once (2 * sum(len) * H_kv * D * 4 bytes) and does G/2
// flops per byte read, far under the card's fp32 balance of 20 flops a byte
// (the published 67 TFLOP/s over 3.35 TB/s).  The first
// version runs one block per (b, h_kv) — B*H_kv blocks, 64 at the serving
// shape, under half the 132 SMs — with no load pipelining, so it sits well
// below the 3.35 TB/s bound; splitting long sequences across blocks (a second
// reduction pass) and cp.async double buffering are the later steps.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 64;     // token slots per iteration
constexpr int THREADS = 128;
constexpr int MAX_OUT = 8;    // outputs per thread: G * D <= THREADS * MAX_OUT
constexpr float NEG_INF = -1e30f;

template <int D>
size_t smem_floats(int G) {
  // k [CHUNK][D+1], v [CHUNK][D], q [G][D], p [G][CHUNK], m/l/corr [G]
  return (size_t)CHUNK * (D + 1) + (size_t)CHUNK * D + (size_t)G * D +
         (size_t)G * CHUNK + 3 * (size_t)G;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, float* __restrict__ o,
                    int H_kv, int G, int P, int page_size, int max_pages,
                    float scale) {
  constexpr int D4 = D / 4;
  extern __shared__ float smem[];
  float* k_s = smem;                    // [CHUNK][D+1]
  float* v_s = k_s + CHUNK * (D + 1);   // [CHUNK][D]  (16-byte aligned)
  float* q_s = v_s + CHUNK * D;         // [G][D]
  float* p_s = q_s + G * D;             // [G][CHUNK]
  float* m_s = p_s + G * CHUNK;         // [G]
  float* l_s = m_s + G;                 // [G]
  float* c_s = l_s + G;                 // [G]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int GD = G * D;

  const int len = max(0, min(lengths[b], max_pages * page_size));
  const int* table = tables + (size_t)b * max_pages;
  const size_t head_off = (size_t)h * P * page_size * D;
  const size_t qo_off = ((size_t)b * H_kv + h) * GD;

  for (int idx = tid; idx < GD; idx += THREADS) q_s[idx] = q[qo_off + idx];
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF / 2;
    l_s[g] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < len; t0 += CHUNK) {
    __syncthreads();  // q/m/l initialised, previous chunk consumed
    for (int idx = tid; idx < CHUNK * D4; idx += THREADS) {
      const int j = idx / D4, d = (idx % D4) * 4;
      const int t = t0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (t < len) {
        // a page id outside [0, P) is clamped, as XLA clamps a gather
        // index: a corrupt table can never read outside the pool
        const int page = min(max(table[t / page_size], 0), P - 1);
        const size_t off =
            head_off + ((size_t)page * page_size + t % page_size) * D + d;
        kx = *reinterpret_cast<const float4*>(k_pages + off);
        vx = *reinterpret_cast<const float4*>(v_pages + off);
      }
      float* kd = k_s + j * (D + 1) + d;
      kd[0] = kx.x; kd[1] = kx.y; kd[2] = kx.z; kd[3] = kx.w;
      *reinterpret_cast<float4*>(v_s + j * D + d) = vx;
    }
    __syncthreads();

    for (int pr = tid; pr < G * CHUNK; pr += THREADS) {
      const int g = pr / CHUNK, j = pr % CHUNK;
      const float* qg = q_s + g * D;
      const float* kj = k_s + j * (D + 1);
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qg[d], kj[d], s);
      p_s[pr] = (t0 + j < len) ? s * scale : NEG_INF;
    }
    __syncthreads();

    for (int g = warp; g < G; g += THREADS / 32) {
      float* pg = p_s + g * CHUNK;
      const float a0 = pg[lane], a1 = pg[lane + 32];
      float mx = fmaxf(a0, a1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float e0 = expf(a0 - m_new), e1 = expf(a1 - m_new);
      pg[lane] = e0;
      pg[lane + 32] = e1;
      float sum = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAX_OUT; ++i) {
      const int idx = tid + THREADS * i;
      if (idx < GD) {
        const int g = idx / D, d = idx % D;
        const float* pg = p_s + g * CHUNK;
        float a = acc[i] * c_s[g];
#pragma unroll 8
        for (int j = 0; j < CHUNK; ++j) a = fmaf(pg[j], v_s[j * D + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();  // l_s final (also when len == 0)

#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) {
    const int idx = tid + THREADS * i;
    if (idx < GD) o[qo_off + idx] = acc[i] / fmaxf(l_s[idx / D], 1e-30f);
  }
}

template <int D>
int launch(const float* q, const float* k_pages, const float* v_pages,
           const int* tables, const int* lengths, float* o, int B, int H_kv,
           int G, int P, int page_size, int max_pages, float scale,
           cudaStream_t stream) {
  if (G * D > THREADS * MAX_OUT) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats<D>(G) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H_kv, B);
  paged_decode_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k_pages, v_pages, tables, lengths, o, H_kv, G, P, page_size,
      max_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H_kv*G, D] (query head h_kv*G + g), k/v pages [H_kv, P, page_size, D],
// o like q: contiguous fp32 on the device.  tables [B, max_pages] and
// lengths [B]: contiguous int32 on the device.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported head_dim or a
// group wider than the kernel's per-thread output budget).
extern "C" int paged_decode_f32(const float* q, const float* k_pages,
                                const float* v_pages, const int* tables,
                                const int* lengths, float* o, int B, int H_kv,
                                int G, int P, int page_size, int max_pages,
                                int D, float scale, void* stream) {
  if (B * H_kv == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k_pages, v_pages, tables, lengths, o, B, H_kv, G, P,
                        page_size, max_pages, scale, st);
    case 128:
      return launch<128>(q, k_pages, v_pages, tables, lengths, o, B, H_kv, G,
                         P, page_size, max_pages, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
