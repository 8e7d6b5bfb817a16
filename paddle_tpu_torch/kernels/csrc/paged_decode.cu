// paged_decode.cu — decode and speculative-verify attention over a paged KV
// pool, fp32 or int8 pages, for sm_90a.
//
// Replaces: paddle_tpu/kernels/paged_attention.py, the pallas_call built by
// `_paged_call` (line 645) with body `_paged_kernel` (line 434), in four
// variants of one kernel: Sq = 1 (decode) or Sq > 1 with ragged q_lengths
// (the multi-token verify step of speculative decoding), over fp32 pages or
// int8 pages with one fp32 scale per page for each of K and V.  Flat
// zero-padded [B, max_pages] int32 page tables, [B] lengths, head-major pool
// [H_kv, P, page_size, D].  Not ported here: explicit page starts with the
// window + sink mask, and two-level tables.
//
// Computes, for every sequence b, KV head h, group member g and query row t
// (query head h * G + g), with ql = q_lengths[b] (Sq when absent) and
// len = lengths[b]:
//   qpos = len - ql + t
//   o[b, h*G+g, t] = softmax_j(q . K[j] * scale) V[j]
//   over the keys j with j <= qpos and j < len,
// where K/V token j of sequence b lives in pool page tables[b, j / page_size]
// at slot j % page_size, dequantized as int8 * scale[page] for an int8 pool.
// For Sq = 1, ql = 1 and the rule is j < len.  Rows t >= ql compute values
// nobody reads.  A row with no visible key returns zeros (running-max floor
// NEG_INF/2, as in the TPU kernel).  Zero-padded table entries (page 0) lie
// past len and are never read.
//
// Design.  q [B, H_kv * G, Sq, D] is read as [B, H_kv, R = G * Sq, D]: row
// r = g * Sq + t, group-major as in the TPU kernel, a pure reshape.  One
// thread block per (kv head, sequence, tile of rows): a tile holds at most
// 1024 / D rows (1024 outputs, 8 a thread over 128 threads), so any G * Sq
// is taken; each tile walks the sequence's pages on its own.  The block
// reads its own table row and length (a GPU has no scalar prefetch), then
// walks the sequence in chunks of 64 token slots.  Each chunk's K and V rows
// — gathered from as many pages as the chunk spans, with 16-byte loads (4
// fp32 or 16 int8 elements a thread), int8 multiplied by its page's scale as
// it is staged — sit in fp32 shared memory ONCE and serve all the tile's
// rows: every query head of the group and every draft token.  The online
// softmax keeps m, l per row in shared memory and the fp32 accumulator in
// registers.
//
// What bounds it on an H100: bytes.  Per layer and step it must read every
// live K and V row once (2 * sum(len) * H_kv * D bytes per element) and does
// G * Sq / 2 flops per fp32 element read (4 times that per int8 element),
// under the card's fp32 balance of 20 flops a byte (67 TFLOP/s over
// 3.35 TB/s) at the serving shapes.  That is the point of verify: the KV
// bytes do not grow with the draft depth.  Costs this version leaves for
// later: one block per (b, h_kv, tile) — B * H_kv blocks at the serving
// shape, under half the 132 SMs; no load pipelining (cp.async double
// buffering); no split of long sequences across blocks; and when G * Sq * D
// > 1024 every row tile re-streams the sequence's pages, so such a verify
// pays the KV bytes once per tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 64;     // token slots per iteration
constexpr int THREADS = 128;
constexpr int MAX_OUT = 8;    // outputs per thread: tile rows * D <= 1024
constexpr int TILE_OUT = THREADS * MAX_OUT;
constexpr float NEG_INF = -1e30f;

template <int D>
size_t smem_floats(int RT) {
  // k [CHUNK][D+1], v [CHUNK][D], q [RT][D], p [RT][CHUNK],
  // m/l/corr/frontier [RT]
  return (size_t)CHUNK * (D + 1) + (size_t)CHUNK * D + (size_t)RT * D +
         (size_t)RT * CHUNK + 4 * (size_t)RT;
}

// Loads 16 bytes of K and of V at element offset `off` (a multiple of the
// vector width) as fp32: 4 elements of an fp32 pool, 16 of an int8 pool
// times the page's scale.
template <typename KV>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, size_t off, float s,
                              float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p + off);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  __device__ static void load(const int8_t* p, size_t off, float s,
                              float* out) {
    const int4 x = *reinterpret_cast<const int4*>(p + off);
    const int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[4 * i + b] = (float)(int8_t)((w[i] >> (8 * b)) & 0xff) * s;
  }
};

template <int D, typename KV>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const float* __restrict__ q, const KV* __restrict__ k_pages,
                  const KV* __restrict__ v_pages,
                  const float* __restrict__ k_scales,
                  const float* __restrict__ v_scales,
                  const int* __restrict__ tables,
                  const int* __restrict__ lengths,
                  const int* __restrict__ q_lengths, float* __restrict__ o,
                  int H_kv, int R, int RT, int Sq, int P, int page_size,
                  int max_pages, float scale) {
  constexpr int VN = Vec<KV>::N;
  constexpr int DV = D / VN;
  extern __shared__ float smem[];
  float* k_s = smem;                    // [CHUNK][D+1]
  float* v_s = k_s + CHUNK * (D + 1);   // [CHUNK][D]  (16-byte aligned)
  float* q_s = v_s + CHUNK * D;         // [RT][D]
  float* p_s = q_s + RT * D;            // [RT][CHUNK]
  float* m_s = p_s + RT * CHUNK;        // [RT]
  float* l_s = m_s + RT;                // [RT]
  float* c_s = l_s + RT;                // [RT]
  int* f_s = reinterpret_cast<int*>(c_s + RT);  // [RT] last visible key

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * RT;       // first row of this tile
  const int rows = min(RT, R - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int TD = rows * D;

  const int len = max(0, min(lengths[b], max_pages * page_size));
  // row r sees keys pos <= q_start + r % Sq and pos < len
  const int q_start = len - (q_lengths ? q_lengths[b] : Sq);
  const int* table = tables + (size_t)b * max_pages;
  const size_t head_off = (size_t)h * P * page_size * D;
  const size_t qo_off = (((size_t)b * H_kv + h) * R + r0) * D;

  for (int idx = tid; idx < TD; idx += THREADS) q_s[idx] = q[qo_off + idx];
  for (int r = tid; r < rows; r += THREADS) {
    m_s[r] = NEG_INF / 2;
    l_s[r] = 0.f;
    f_s[r] = min(len - 1, q_start + (r0 + r) % Sq);
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < len; t0 += CHUNK) {
    __syncthreads();  // q/m/l initialised, previous chunk consumed
    for (int idx = tid; idx < CHUNK * DV; idx += THREADS) {
      const int j = idx / DV, d = (idx % DV) * VN;
      const int t = t0 + j;
      float kx[VN], vx[VN];
      if (t < len) {
        // a page id outside [0, P) is clamped, as XLA clamps a gather
        // index: a corrupt table can never read outside the pool
        const int page = min(max(table[t / page_size], 0), P - 1);
        const size_t off =
            head_off + ((size_t)page * page_size + t % page_size) * D + d;
        Vec<KV>::load(k_pages, off, k_scales ? k_scales[page] : 1.f, kx);
        Vec<KV>::load(v_pages, off, v_scales ? v_scales[page] : 1.f, vx);
      } else {
#pragma unroll
        for (int i = 0; i < VN; ++i) kx[i] = vx[i] = 0.f;
      }
      float* kd = k_s + j * (D + 1) + d;
#pragma unroll
      for (int i = 0; i < VN; ++i) kd[i] = kx[i];
#pragma unroll
      for (int i = 0; i < VN; i += 4)
        *reinterpret_cast<float4*>(v_s + j * D + d + i) =
            make_float4(vx[i], vx[i + 1], vx[i + 2], vx[i + 3]);
    }
    __syncthreads();

    for (int pr = tid; pr < rows * CHUNK; pr += THREADS) {
      const int r = pr / CHUNK, j = pr % CHUNK;
      const float* qr = q_s + r * D;
      const float* kj = k_s + j * (D + 1);
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kj[d], s);
      p_s[pr] = (t0 + j <= f_s[r]) ? s * scale : NEG_INF;
    }
    __syncthreads();

    for (int r = warp; r < rows; r += THREADS / 32) {
      float* pr = p_s + r * CHUNK;
      const float a0 = pr[lane], a1 = pr[lane + 32];
      float mx = fmaxf(a0, a1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float e0 = expf(a0 - m_new), e1 = expf(a1 - m_new);
      pr[lane] = e0;
      pr[lane + 32] = e1;
      float sum = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAX_OUT; ++i) {
      const int idx = tid + THREADS * i;
      if (idx < TD) {
        const int r = idx / D, d = idx % D;
        const float* pr = p_s + r * CHUNK;
        float a = acc[i] * c_s[r];
#pragma unroll 8
        for (int j = 0; j < CHUNK; ++j) a = fmaf(pr[j], v_s[j * D + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();  // l_s final (also when len == 0)

#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) {
    const int idx = tid + THREADS * i;
    if (idx < TD) o[qo_off + idx] = acc[i] / fmaxf(l_s[idx / D], 1e-30f);
  }
}

template <int D, typename KV>
int launch(const float* q, const KV* k_pages, const KV* v_pages,
           const float* k_scales, const float* v_scales, const int* tables,
           const int* lengths, const int* q_lengths, float* o, int B,
           int H_kv, int G, int Sq, int P, int page_size, int max_pages,
           float scale, cudaStream_t stream) {
  const int R = G * Sq;
  const int RT = min(R, TILE_OUT / D);
  const int tiles = (R + RT - 1) / RT;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats<D>(RT) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H_kv, B, tiles);
  paged_attn_kernel<D, KV><<<grid, THREADS, smem, stream>>>(
      q, k_pages, v_pages, k_scales, v_scales, tables, lengths, q_lengths, o,
      H_kv, R, RT, Sq, P, page_size, max_pages, scale);
  return (int)cudaGetLastError();
}

template <typename KV>
int dispatch(const float* q, const KV* k_pages, const KV* v_pages,
             const float* k_scales, const float* v_scales, const int* tables,
             const int* lengths, const int* q_lengths, float* o, int B,
             int H_kv, int G, int Sq, int P, int page_size, int max_pages,
             int D, float scale, void* stream) {
  if (B * H_kv * G * Sq == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, KV>(q, k_pages, v_pages, k_scales, v_scales, tables,
                            lengths, q_lengths, o, B, H_kv, G, Sq, P,
                            page_size, max_pages, scale, st);
    case 128:
      return launch<128, KV>(q, k_pages, v_pages, k_scales, v_scales, tables,
                             lengths, q_lengths, o, B, H_kv, G, Sq, P,
                             page_size, max_pages, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Every entry: q [B, H_kv*G, Sq, D] (query head h_kv*G + g), o like q:
// contiguous fp32 on the device, 16-byte aligned.  k/v pages [H_kv, P,
// page_size, D]: contiguous, 16-byte aligned, fp32 or int8.  tables
// [B, max_pages], lengths [B] and q_lengths [B]: contiguous int32 on the
// device.  k_scales / v_scales [P]: contiguous fp32 on the device.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head_dim
// other than 64 or 128).

// Sq = 1 over an fp32 pool: the serving decode step.
extern "C" int paged_decode_f32(const float* q, const float* k_pages,
                                const float* v_pages, const int* tables,
                                const int* lengths, float* o, int B, int H_kv,
                                int G, int P, int page_size, int max_pages,
                                int D, float scale, void* stream) {
  return dispatch<float>(q, k_pages, v_pages, nullptr, nullptr, tables,
                         lengths, nullptr, o, B, H_kv, G, 1, P, page_size,
                         max_pages, D, scale, stream);
}

// Sq > 1 over an fp32 pool (k_scales, v_scales ignored; q_lengths null
// means every sequence fed Sq rows): the speculative verify step.
extern "C" int paged_verify_f32(const float* q, const float* k_pages,
                                const float* v_pages, const float* k_scales,
                                const float* v_scales, const int* tables,
                                const int* lengths, const int* q_lengths,
                                float* o, int B, int H_kv, int G, int Sq,
                                int P, int page_size, int max_pages, int D,
                                float scale, void* stream) {
  return dispatch<float>(q, k_pages, v_pages, nullptr, nullptr, tables,
                         lengths, q_lengths, o, B, H_kv, G, Sq, P, page_size,
                         max_pages, D, scale, stream);
}

// Sq = 1 over an int8 pool with per-page scales (q_lengths ignored).
extern "C" int paged_decode_i8(const float* q, const int8_t* k_pages,
                               const int8_t* v_pages, const float* k_scales,
                               const float* v_scales, const int* tables,
                               const int* lengths, const int* q_lengths,
                               float* o, int B, int H_kv, int G, int Sq,
                               int P, int page_size, int max_pages, int D,
                               float scale, void* stream) {
  return dispatch<int8_t>(q, k_pages, v_pages, k_scales, v_scales, tables,
                          lengths, nullptr, o, B, H_kv, G, 1, P, page_size,
                          max_pages, D, scale, stream);
}

// Sq > 1 over an int8 pool with per-page scales.
extern "C" int paged_verify_i8(const float* q, const int8_t* k_pages,
                               const int8_t* v_pages, const float* k_scales,
                               const float* v_scales, const int* tables,
                               const int* lengths, const int* q_lengths,
                               float* o, int B, int H_kv, int G, int Sq,
                               int P, int page_size, int max_pages, int D,
                               float scale, void* stream) {
  return dispatch<int8_t>(q, k_pages, v_pages, k_scales, v_scales, tables,
                          lengths, q_lengths, o, B, H_kv, G, Sq, P,
                          page_size, max_pages, D, scale, stream);
}
