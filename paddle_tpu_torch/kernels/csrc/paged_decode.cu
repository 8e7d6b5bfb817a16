// paged_decode.cu — decode and speculative-verify attention over a paged KV
// pool, fp32, int8 or bf16 pages, for sm_90a.
//
// Replaces: paddle_tpu/kernels/paged_attention.py, the pallas_call built by
// `_paged_call` (line 645) with body `_paged_kernel` (line 434): Sq = 1
// (decode) or Sq > 1 with ragged q_lengths (the multi-token verify step of
// speculative decoding), over fp32 pages, int8 pages with one fp32 scale
// per page for each of K and V, or bf16 pages, [B] lengths, head-major pool
// [H_kv, P, page_size, D].  Three table walks of one templated kernel:
// - FLAT: zero-padded [B, max_pages] int32 tables, page i of a row starting
//   at token i * page_size (rows 4a-4c of the port's kernel table);
// - STARTS (`has_starts` / `windowed`, row 4d): the same table plus
//   explicit [B, max_pages] page starts (PAD_START past a row's pages), and
//   optional per-row windows and sinks;
// - TWO_LEVEL (`block_size`, row 4e): an L1 directory [B, max_pages / bs]
//   over L2 blocks [n_blocks, bs] of page ids and of starts.
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
// The STARTS and TWO_LEVEL walks go over table SLOTS, not positions: an
// evicted sequence's table is compacted, so slot s holds page entry
// e = s / page_size, whose slot 0 sits at position start(e), and the slot's
// position is start(e) + s % page_size.  The walk ends at the row's last
// live entry (the last with start < len: starts rise strictly, PAD_START
// after them), found once per block; len is not clamped to the table.  A
// slot is live iff its position is < len; dead slots (PAD_START entries,
// the tail past len) load nothing and hold zeros.  Key slot j is visible
// to row t at qpos = q_start + t iff pos_j <= min(len - 1, qpos) and, with
// windows, start_j < sinks[b] or start_j + page_size > qpos + 1 - windows[b]
// (the JAX kernel's page-granular rule, on the unclamped qpos, in int32).
// int8 scales: the JAX kernel gathers per-block scale rows outside the
// kernel because of the TPU's scalar-memory budget; here the [P] scales sit
// in global memory and are read by the page id the walk already resolved,
// which gives the same numbers.
//
// bf16 pages compute what the TPU kernel computes on them, rounding where
// it rounds and nowhere else (the `ROUND` trait of the element type):
// q is rounded to bf16 as it is staged; K and V widen to fp32 exactly and
// s = (q . K) * scale is fp32; the running max, l and the correction
// factor update once per PAGE, in the walk's slot order, as the TPU grid's
// page axis does (a chunk then holds whole pages only: page_size <= 64);
// p = exp(s - m) is rounded to bf16 for the PV product, which is summed
// per page and added to acc * correction, while l sums the unrounded p;
// the output acc / max(l, 1e-30) is rounded to bf16 and returned as fp32.
// fp32 and int8 pages keep one update per 64-slot chunk: they have no
// rounding point, so the grouping moves only fp32 ulps.
//
// Design.  q [B, H_kv * G, Sq, D] is read as [B, H_kv, R = G * Sq, D]: row
// r = g * Sq + t, group-major as in the TPU kernel, a pure reshape.  One
// thread block per (kv head, sequence, tile of rows): a tile holds at most
// 1024 / D rows (1024 outputs, 8 a thread over 128 threads), so any G * Sq
// is taken; each tile walks the sequence's pages on its own.  The block
// reads its own table row and length (a GPU has no scalar prefetch), then
// walks the sequence in chunks of 64 token slots.  Each chunk's K and V rows
// — gathered from as many pages as the chunk spans, with 16-byte loads (4
// fp32, 16 int8 or 8 bf16 elements a thread), int8 multiplied by its page's
// scale as it is staged — sit in fp32 shared memory ONCE and serve all the tile's
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
// buffering); no split of long sequences across blocks, so a long context
// is one block's serial walk (a 4096-token flat walk is 64 chunks in a
// row); and when G * Sq * D > 1024 every row tile re-streams the sequence's
// pages, so such a verify pays the KV bytes once per tile.  The STARTS and
// TWO_LEVEL walks load every live slot of the table, also those the window
// hides: the serving loop evicts those pages first, so its walk is the
// sink and window pages only, and a chunk the window hides whole is not
// skipped.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 64;     // token slots per iteration
constexpr int THREADS = 128;
constexpr int MAX_OUT = 8;    // outputs per thread: tile rows * D <= 1024
constexpr int TILE_OUT = THREADS * MAX_OUT;
constexpr float NEG_INF = -1e30f;

enum Walk { FLAT = 0, STARTS = 1, TWO_LEVEL = 2 };

// Every operand of one launch.  tables is the flat [B, max_pages] table, or
// the L1 directory [B, max_pages / block_size] of a TWO_LEVEL walk; l2 and
// starts as the walk needs them (null otherwise); windows and sinks null
// when unwindowed.
struct Args {
  const float* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;
  const float* v_scales;
  const int* tables;
  const int* l2;
  const int* starts;
  const int* lengths;
  const int* q_lengths;
  const int* windows;
  const int* sinks;
  float* o;
  int B, H_kv, G, Sq, P, page_size, max_pages, block_size, n_blocks;
  float scale;
};

// corrections kept per row: one per chunk, or one per page of a chunk when
// the element type rounds (at most CHUNK pages of one slot)
__host__ __device__ constexpr int n_corr(bool round) {
  return round ? CHUNK : 1;
}

template <int D, bool ROUND>
size_t smem_bytes(int RT) {
  // floats: k [CHUNK][D+1], v [CHUNK][D], q [RT][D], p [RT][CHUNK],
  // m/l [RT], corr [RT][n_corr]; ints: frontier, window floor [RT],
  // page/pos/vis-start [CHUNK], the walk's last entry
  return sizeof(float) * ((size_t)CHUNK * (D + 1) + (size_t)CHUNK * D +
                          (size_t)RT * D + (size_t)RT * CHUNK + 2 * (size_t)RT +
                          (size_t)RT * n_corr(ROUND)) +
         sizeof(int) * (2 * (size_t)RT + 3 * (size_t)CHUNK + 1);
}

// Loads 16 bytes of K and of V at element offset `off` (a multiple of the
// vector width) as fp32: 4 elements of an fp32 pool, 16 of an int8 pool
// times the page's scale, 8 of a bf16 pool (widened exactly).  ROUND: the
// element type has the TPU kernel's bf16 rounding points.
template <typename KV>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static constexpr bool ROUND = false;
  __device__ static void load(const float* p, size_t off, float s,
                              float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p + off);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  static constexpr bool ROUND = false;
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

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr bool ROUND = true;
  __device__ static void load(const __nv_bfloat16* p, size_t off, float,
                              float* out) {
    const int4 x = *reinterpret_cast<const int4*>(p + off);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// x rounded to bf16 (to nearest even) and widened back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The table operands of one block's walk, taken out of Args once.
struct Table {
  const int* tables;  // this row's flat table, or its L1 directory row
  const int* l2;
  const int* starts;  // this row's flat starts, or the L2 starts blocks
  int block_size, n_blocks, page_size;
};

// Page id and slot-0 position of table entry e.  An L1 entry outside
// [0, n_blocks) is clamped, as a page id is: a corrupt table can never
// read outside its operands.
template <int WALK>
__device__ __forceinline__ void entry(const Table t, int e, int& page,
                                      int& start) {
  if (WALK == TWO_LEVEL) {
    const int blk = min(max(t.tables[e / t.block_size], 0), t.n_blocks - 1);
    const size_t at = (size_t)blk * t.block_size + e % t.block_size;
    page = t.l2[at];
    start = t.starts[at];
  } else {
    page = t.tables[e];
    start = WALK == STARTS ? t.starts[e] : e * t.page_size;
  }
}

template <int D, typename KV, int WALK>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const Args a, int R, int RT) {
  constexpr int VN = Vec<KV>::N;
  constexpr int DV = D / VN;
  constexpr bool ROUND = Vec<KV>::ROUND;
  constexpr int NC = n_corr(ROUND);
  const float* __restrict__ q = a.q;
  const KV* __restrict__ k_pages = static_cast<const KV*>(a.k_pages);
  const KV* __restrict__ v_pages = static_cast<const KV*>(a.v_pages);
  const float* __restrict__ k_scales = a.k_scales;
  const float* __restrict__ v_scales = a.v_scales;
  const int page_size = a.page_size;
  const int P = a.P;
  // token slots per chunk: whole pages only when the update is per page
  const int CH = ROUND ? (CHUNK / page_size) * page_size : CHUNK;
  const int n_seg = ROUND ? CH / page_size : 1;
  extern __shared__ float smem[];
  float* k_s = smem;                    // [CHUNK][D+1]
  float* v_s = k_s + CHUNK * (D + 1);   // [CHUNK][D]  (16-byte aligned)
  float* q_s = v_s + CHUNK * D;         // [RT][D]
  float* p_s = q_s + RT * D;            // [RT][CHUNK]
  float* m_s = p_s + RT * CHUNK;        // [RT]
  float* l_s = m_s + RT;                // [RT]
  float* c_s = l_s + RT;                // [RT][NC] correction factors
  int* f_s = reinterpret_cast<int*>(c_s + RT * NC);  // [RT] last visible
                                                     //      position
  int* w_s = f_s + RT;                  // [RT] window floor: visible iff
                                        //      start + page_size > w_s
  int* pg_s = w_s + RT;                 // [CHUNK] page id of each slot
  int* pos_s = pg_s + CHUNK;            // [CHUNK] position (INT_MAX: dead)
  int* vst_s = pos_s + CHUNK;           // [CHUNK] start + page_size
                                        //      (INT_MAX: a sink page)
  int* last_s = vst_s + CHUNK;          // [1] live table entries

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * RT;       // first row of this tile
  const int rows = min(RT, R - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int TD = rows * D;
  const int Sq = a.Sq;

  // the flat walk's positions are its slots, so its length is clamped to
  // the table; an explicit-starts walk's length is the sequence's own
  const int len = WALK == FLAT
                      ? max(0, min(a.lengths[b], a.max_pages * page_size))
                      : max(0, a.lengths[b]);
  // row r sees keys pos <= q_start + r % Sq and pos < len
  const int q_start = len - (a.q_lengths ? a.q_lengths[b] : Sq);
  const int win = a.windows ? a.windows[b] : 0;
  const int sink = a.sinks ? a.sinks[b] : 0;
  // this row's table: the flat table (and starts) row, or the L1 row
  const int n_entries = WALK == TWO_LEVEL ? a.max_pages / a.block_size
                                          : a.max_pages;
  const int* table = a.tables + (size_t)b * n_entries;
  const Table walk_tab{table, a.l2,
                       WALK == STARTS ? a.starts + (size_t)b * a.max_pages
                                      : a.starts,
                       a.block_size, a.n_blocks, page_size};
  const size_t head_off = (size_t)h * P * page_size * D;
  const size_t qo_off = (((size_t)b * a.H_kv + h) * R + r0) * D;

  for (int idx = tid; idx < TD; idx += THREADS)
    q_s[idx] = ROUND ? round_bf16(q[qo_off + idx]) : q[qo_off + idx];
  for (int r = tid; r < rows; r += THREADS) {
    const int qpos = q_start + (r0 + r) % Sq;
    m_s[r] = NEG_INF / 2;
    l_s[r] = 0.f;
    f_s[r] = min(len - 1, qpos);
    const long long wfloor = (long long)qpos + 1 - win;
    w_s[r] = a.windows ? (int)max(wfloor, (long long)INT_MIN) : INT_MIN;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) acc[i] = 0.f;

  int n_slots = len;
  if (WALK != FLAT) {
    // the walk ends after the last table entry whose start is < len
    if (tid == 0) *last_s = 0;
    __syncthreads();
    int last = 0;
    for (int e = tid; e < a.max_pages; e += THREADS) {
      int page, start;
      entry<WALK>(walk_tab, e, page, start);
      if (start < len) last = e + 1;
    }
    if (last) atomicMax(last_s, last);
    __syncthreads();
    n_slots = *last_s * page_size;
  }

  for (int t0 = 0; t0 < n_slots; t0 += CH) {
    __syncthreads();  // q/m/l initialised, previous chunk consumed
    if (WALK != FLAT) {
      // resolve each slot of the chunk once: page id, position, window key
      if (tid < CHUNK) {
        const int s = t0 + tid;
        int page = 0, pos = INT_MAX, vst = INT_MAX;
        if (tid < CH && s < n_slots) {
          int start;
          entry<WALK>(walk_tab, s / page_size, page, start);
          if (start < len && start + s % page_size < len) {
            pos = start + s % page_size;
            vst = start < sink ? INT_MAX : start + page_size;
          }
        }
        // a page id outside [0, P) is clamped, as XLA clamps a gather
        // index: a corrupt table can never read outside the pool
        pg_s[tid] = min(max(page, 0), P - 1);
        pos_s[tid] = pos;
        vst_s[tid] = vst;
      }
      __syncthreads();
    }
    for (int idx = tid; idx < CHUNK * DV; idx += THREADS) {
      const int j = idx / DV, d = (idx % DV) * VN;
      const int t = t0 + j;
      float kx[VN], vx[VN];
      bool live;
      int page;
      if (WALK == FLAT) {
        live = j < CH && t < len;
        page = live ? min(max(table[t / page_size], 0), P - 1) : 0;
      } else {
        live = pos_s[j] != INT_MAX;
        page = pg_s[j];
      }
      if (live) {
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
      const bool vis = WALK == FLAT
                           ? j < CH && t0 + j <= f_s[r]
                           : pos_s[j] <= f_s[r] && vst_s[j] > w_s[r];
      p_s[pr] = vis ? s * a.scale : NEG_INF;
    }
    __syncthreads();

    for (int r = warp; r < rows && ROUND; r += THREADS / 32) {
      // one update per page of the chunk, in slot order; a slot past CH
      // (page n_seg) takes part in none
      float* pr = p_s + r * CHUNK;
      const float a0 = pr[lane], a1 = pr[lane + 32];
      const int g0 = lane / page_size, g1 = (lane + 32) / page_size;
      float m = m_s[r], l = l_s[r], e0 = 0.f, e1 = 0.f;
      for (int k = 0; k < n_seg; ++k) {
        float mx = fmaxf(g0 == k ? a0 : NEG_INF, g1 == k ? a1 : NEG_INF);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m, mx);
        if (g0 == k) e0 = expf(a0 - m_new);
        if (g1 == k) e1 = expf(a1 - m_new);
        float sum = (g0 == k ? e0 : 0.f) + (g1 == k ? e1 : 0.f);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float corr = expf(m - m_new);
        l = corr * l + sum;  // the unrounded p
        m = m_new;
        if (lane == 0) c_s[r * NC + k] = corr;
      }
      __syncwarp();
      pr[lane] = round_bf16(e0);  // the PV product's p
      pr[lane + 32] = round_bf16(e1);
      if (lane == 0) {
        m_s[r] = m;
        l_s[r] = l;
      }
    }
    for (int r = warp; r < rows && !ROUND; r += THREADS / 32) {
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
        c_s[r * NC] = corr;
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
        float acc_i = acc[i];
        if (ROUND) {
          // per page: acc * correction + the page's own p . V
          for (int k = 0, j = 0; k < n_seg; ++k) {
            float dot = 0.f;
            for (const int j_end = j + page_size; j < j_end; ++j)
              dot = fmaf(pr[j], v_s[j * D + d], dot);
            acc_i = acc_i * c_s[r * NC + k] + dot;
          }
        } else {
          acc_i *= c_s[r * NC];
#pragma unroll 8
          for (int j = 0; j < CHUNK; ++j)
            acc_i = fmaf(pr[j], v_s[j * D + d], acc_i);
        }
        acc[i] = acc_i;
      }
    }
  }
  __syncthreads();  // l_s final (also when len == 0)

#pragma unroll
  for (int i = 0; i < MAX_OUT; ++i) {
    const int idx = tid + THREADS * i;
    if (idx < TD) {
      const float o = acc[i] / fmaxf(l_s[idx / D], 1e-30f);
      a.o[qo_off + idx] = ROUND ? round_bf16(o) : o;
    }
  }
}

template <int D, typename KV, int WALK>
int launch(const Args& a, cudaStream_t stream) {
  const int R = a.G * a.Sq;
  const int RT = min(R, TILE_OUT / D);
  const int tiles = (R + RT - 1) / RT;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<D, Vec<KV>::ROUND>(RT);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel<D, KV, WALK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.H_kv, a.B, tiles);
  paged_attn_kernel<D, KV, WALK><<<grid, THREADS, smem, stream>>>(a, R, RT);
  return (int)cudaGetLastError();
}

template <typename KV, int WALK>
int dispatch(const Args& a, int D, void* stream) {
  if (a.B * a.H_kv * a.G * a.Sq == 0) return 0;
  // a per-page update needs whole pages in a chunk
  if (Vec<KV>::ROUND && (a.page_size < 1 || a.page_size > CHUNK))
    return (int)cudaErrorInvalidValue;
  if (WALK == TWO_LEVEL &&
      (a.block_size < 1 || a.max_pages % a.block_size || a.n_blocks < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, KV, WALK>(a, st);
    case 128:
      return launch<128, KV, WALK>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

Args flat_args(const float* q, const void* k_pages, const void* v_pages,
               const float* k_scales, const float* v_scales,
               const int* tables, const int* lengths, const int* q_lengths,
               float* o, int B, int H_kv, int G, int Sq, int P,
               int page_size, int max_pages, float scale) {
  return Args{q, k_pages, v_pages, k_scales, v_scales, tables, nullptr,
              nullptr, lengths, q_lengths, nullptr, nullptr, o, B, H_kv, G,
              Sq, P, page_size, max_pages, 0, 0, scale};
}

template <typename KV>
int walk(const float* q, const KV* k_pages, const KV* v_pages,
         const float* k_scales, const float* v_scales, const int* tables,
         const int* l2, const int* starts, const int* lengths,
         const int* q_lengths, const int* windows, const int* sinks,
         float* o, int B, int H_kv, int G, int Sq, int P, int page_size,
         int max_pages, int block_size, int n_blocks, int D, float scale,
         void* stream) {
  if (starts == nullptr || (block_size > 0) != (l2 != nullptr) ||
      (windows == nullptr) != (sinks == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, tables, l2, starts,
               lengths, q_lengths, windows, sinks, o, B, H_kv, G, Sq, P,
               page_size, max_pages, block_size, n_blocks, scale};
  return block_size > 0 ? dispatch<KV, TWO_LEVEL>(a, D, stream)
                        : dispatch<KV, STARTS>(a, D, stream);
}

}  // namespace

// Every entry: q [B, H_kv*G, Sq, D] (query head h_kv*G + g), o like q:
// contiguous fp32 on the device, 16-byte aligned.  k/v pages [H_kv, P,
// page_size, D]: contiguous, 16-byte aligned, fp32 or int8.  tables
// [B, max_pages], lengths [B] and q_lengths [B]: contiguous int32 on the
// device.  k_scales / v_scales [P]: contiguous fp32 on the device.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head_dim
// other than 64 or 128, or operands a walk cannot take).

// Sq = 1 over an fp32 pool: the serving decode step.
extern "C" int paged_decode_f32(const float* q, const float* k_pages,
                                const float* v_pages, const int* tables,
                                const int* lengths, float* o, int B, int H_kv,
                                int G, int P, int page_size, int max_pages,
                                int D, float scale, void* stream) {
  return dispatch<float, FLAT>(
      flat_args(q, k_pages, v_pages, nullptr, nullptr, tables, lengths,
                nullptr, o, B, H_kv, G, 1, P, page_size, max_pages, scale),
      D, stream);
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
  return dispatch<float, FLAT>(
      flat_args(q, k_pages, v_pages, nullptr, nullptr, tables, lengths,
                q_lengths, o, B, H_kv, G, Sq, P, page_size, max_pages, scale),
      D, stream);
}

// Sq = 1 over an int8 pool with per-page scales (q_lengths ignored).
extern "C" int paged_decode_i8(const float* q, const int8_t* k_pages,
                               const int8_t* v_pages, const float* k_scales,
                               const float* v_scales, const int* tables,
                               const int* lengths, const int* q_lengths,
                               float* o, int B, int H_kv, int G, int Sq,
                               int P, int page_size, int max_pages, int D,
                               float scale, void* stream) {
  return dispatch<int8_t, FLAT>(
      flat_args(q, k_pages, v_pages, k_scales, v_scales, tables, lengths,
                nullptr, o, B, H_kv, G, 1, P, page_size, max_pages, scale),
      D, stream);
}

// Sq > 1 over an int8 pool with per-page scales.
extern "C" int paged_verify_i8(const float* q, const int8_t* k_pages,
                               const int8_t* v_pages, const float* k_scales,
                               const float* v_scales, const int* tables,
                               const int* lengths, const int* q_lengths,
                               float* o, int B, int H_kv, int G, int Sq,
                               int P, int page_size, int max_pages, int D,
                               float scale, void* stream) {
  return dispatch<int8_t, FLAT>(
      flat_args(q, k_pages, v_pages, k_scales, v_scales, tables, lengths,
                q_lengths, o, B, H_kv, G, Sq, P, page_size, max_pages, scale),
      D, stream);
}

// The explicit-starts walks (rows 4d and 4e), any Sq (q_lengths null means
// every sequence fed Sq rows), fp32 pages (scales ignored) or int8 pages
// with per-page scales.  block_size 0: tables and starts are flat [B,
// max_pages]; block_size > 0: tables is the L1 directory [B, max_pages /
// block_size], l2 and starts [n_blocks, block_size].  windows and sinks
// [B], both or neither.
extern "C" int paged_walk_f32(const float* q, const float* k_pages,
                              const float* v_pages, const float* k_scales,
                              const float* v_scales, const int* tables,
                              const int* l2, const int* starts,
                              const int* lengths, const int* q_lengths,
                              const int* windows, const int* sinks, float* o,
                              int B, int H_kv, int G, int Sq, int P,
                              int page_size, int max_pages, int block_size,
                              int n_blocks, int D, float scale,
                              void* stream) {
  return walk<float>(q, k_pages, v_pages, nullptr, nullptr, tables, l2,
                     starts, lengths, q_lengths, windows, sinks, o, B, H_kv,
                     G, Sq, P, page_size, max_pages, block_size, n_blocks, D,
                     scale, stream);
}

extern "C" int paged_walk_i8(const float* q, const int8_t* k_pages,
                             const int8_t* v_pages, const float* k_scales,
                             const float* v_scales, const int* tables,
                             const int* l2, const int* starts,
                             const int* lengths, const int* q_lengths,
                             const int* windows, const int* sinks, float* o,
                             int B, int H_kv, int G, int Sq, int P,
                             int page_size, int max_pages, int block_size,
                             int n_blocks, int D, float scale, void* stream) {
  if (k_scales == nullptr || v_scales == nullptr)
    return (int)cudaErrorInvalidValue;
  return walk<int8_t>(q, k_pages, v_pages, k_scales, v_scales, tables, l2,
                      starts, lengths, q_lengths, windows, sinks, o, B, H_kv,
                      G, Sq, P, page_size, max_pages, block_size, n_blocks, D,
                      scale, stream);
}

// The bf16 entries: pages [H_kv, P, page_size, D] bf16 (page_size <= 64),
// q and o fp32, at the TPU kernel's bf16 rounding points (file comment).
// k_scales, v_scales ignored.  Sq = 1 (q_lengths ignored), Sq > 1, and the
// explicit-starts walks, as the fp32 entries above.
extern "C" int paged_decode_bf16(const float* q, const __nv_bfloat16* k_pages,
                                 const __nv_bfloat16* v_pages,
                                 const float* k_scales, const float* v_scales,
                                 const int* tables, const int* lengths,
                                 const int* q_lengths, float* o, int B,
                                 int H_kv, int G, int Sq, int P,
                                 int page_size, int max_pages, int D,
                                 float scale, void* stream) {
  return dispatch<__nv_bfloat16, FLAT>(
      flat_args(q, k_pages, v_pages, nullptr, nullptr, tables, lengths,
                nullptr, o, B, H_kv, G, 1, P, page_size, max_pages, scale),
      D, stream);
}

extern "C" int paged_verify_bf16(const float* q, const __nv_bfloat16* k_pages,
                                 const __nv_bfloat16* v_pages,
                                 const float* k_scales, const float* v_scales,
                                 const int* tables, const int* lengths,
                                 const int* q_lengths, float* o, int B,
                                 int H_kv, int G, int Sq, int P,
                                 int page_size, int max_pages, int D,
                                 float scale, void* stream) {
  return dispatch<__nv_bfloat16, FLAT>(
      flat_args(q, k_pages, v_pages, nullptr, nullptr, tables, lengths,
                q_lengths, o, B, H_kv, G, Sq, P, page_size, max_pages, scale),
      D, stream);
}

extern "C" int paged_walk_bf16(const float* q, const __nv_bfloat16* k_pages,
                               const __nv_bfloat16* v_pages,
                               const float* k_scales, const float* v_scales,
                               const int* tables, const int* l2,
                               const int* starts, const int* lengths,
                               const int* q_lengths, const int* windows,
                               const int* sinks, float* o, int B, int H_kv,
                               int G, int Sq, int P, int page_size,
                               int max_pages, int block_size, int n_blocks,
                               int D, float scale, void* stream) {
  return walk<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr, tables,
                             l2, starts, lengths, q_lengths, windows, sinks,
                             o, B, H_kv, G, Sq, P, page_size, max_pages,
                             block_size, n_blocks, D, scale, stream);
}
