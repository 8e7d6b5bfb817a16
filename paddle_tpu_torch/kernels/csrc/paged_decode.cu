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
// s = (q . K) * scale is fp32; the running max m updates once per PAGE, in
// the walk's order, as the TPU grid's page axis does; p = exp(s - m) is
// rounded to bf16 for the PV product, while l sums the unrounded p; the
// output acc / max(l, 1e-30) is rounded to bf16 and returned as fp32.
//
// What bounds it on an H100: bytes.  Per layer and step it must read every
// live K and V row once (2 * sum(len) * H_kv * D elements) and does
// G * Sq / 2 flops per fp32 element read (4 times that per int8 element,
// twice per bf16), far under the card's balance of 20 fp32 flops a byte.
// One block to each (KV head, sequence, row tile) walking a sequence
// serially would leave 64 blocks on 132 SMs at the serving shape, a
// 4080-token context as one block's walk, and no load in flight behind
// the compute.
//
// Design.  q [B, H_kv * G, Sq, D] is read as [B, H_kv, R = G * Sq, D]: row
// r = g * Sq + t, group-major as in the TPU kernel, a pure reshape.  A
// tile holds at most 1024 / D rows (1024 outputs), so any G * Sq is taken.
// The S blocks of one (KV head, sequence, row tile) form a thread-block
// cluster (grid (S * H_kv, B, tiles), cluster (S, 1, 1)); S is the
// wrapper's choice, from the table width and the grid (one block an SM
// measured fastest: S = 2 at 8 sequences of 8 heads over 34 or 255
// pages, S = 1 at the serving lengths).  S = 1 launches without the
// cluster attribute (every block is then its own cluster) and takes block
// barriers.  The cluster walks the sequence's n live table entries in
// rounds of S * PPR whole pages (entries, not positions, so the flat,
// starts and two-level walks of one table split at the same pages); rank
// i takes entries [(round * S + i) * PPR, + PPR), PPR = min(ceil(n / S),
// the cap that keeps a round's scores in shared memory), so a 4096-token
// context is one round.  Ranks past the last live entry take nothing and
// contribute m = NEG_INF/2, l = 0, acc = 0.  A round:
// 1. Each slot's pool row is resolved once (table entry, liveness, the
//    pages no row of the tile can see: past every row's frontier, hidden
//    by the window).  K streams as raw pages, in its own type, with
//    16-byte cp.async copies (one shared load and an address a copy) into
//    a ring of NST stages of SL slots (108 KiB), V's stages right after
//    K's, so V is in flight while the maxima are exchanged; dead rows are
//    zero-filled, not read.  One thread per (row, key), 256 threads,
//    computes s = (q . K) * scale with one fmaf chain in ascending d (the
//    order of a serial walk), widening (and scaling int8) as it
//    reads; masked keys take NEG_INF.  The scores of the range stay in
//    shared memory (RT * PPR * page_size fp32, at most 32 KiB; 8 KiB at
//    the 4080-token decode): K is read once.
// 2. Exchange: each rank publishes its range's max per row; cluster.sync;
//    each rank reads the maxima of all ranks through distributed shared
//    memory.  M_in = max(the earlier rounds' max, the maxima of ranks
//    below it) is exactly the prefix max the serial walk had at the rank's
//    first page (max is exact), so m_k, the running max after the rank's
//    page k (a warp's max scan from M_in), and every p = exp(s - m_k) the
//    TPU kernel rounds are the serial walk's own.  M_end, the max over
//    all ranks, is the round's common reference.
// 3. Weights: for a key of page k, w = bf16(p) * exp(m_k - M_end) (p
//    itself for fp32 and int8 pages, times the V scale for int8), and l
//    adds p * exp(m_k - M_end).  This scales each page's term straight to
//    M_end instead of through the product of the later pages' correction
//    factors (C_hi = expf(M_end_lo - M_end_hi) in effect): the same number
//    in real arithmetic, fp32 ulps apart, no rounding point moved.
// 4. V: acc += w . V from the ring, each thread 16 bytes of output columns
//    for a group of keys, so every thread works at Sq = 1.
// A later round with a larger max rescales acc and l by exp(M_old - M_new).
// Combine: every rank's acc and l are relative to the same M_end, so after
// cluster.sync the ranks, each for a slice of the outputs, sum the S
// partials in rank order through distributed shared memory and divide
// (a final cluster.sync keeps every block's shared memory alive until all
// have read it).  fp32 and int8 pages take the same path; their gate is
// the fp32 one.  Measured slower on the H100 and left out (PERF.md): one
// bulk (TMA) copy per slot row, loads straight into registers behind
// bulk L2 prefetches of whole pages, and 128 threads a block.
//
// Costs still left: no tensor cores (at Sq = 1, G = 1 this is a
// matrix-vector walk); the ring is issued by all threads, not by a
// producer warp; the phases of a round are serial within a block (V
// stages beyond the ring's depth are not in flight during the exchange),
// and a cluster's blocks meet at two or three barriers; for Sq > 1 a key
// row is widened again for each row of the tile; the explicit-starts
// walks scan the whole table row for its last live entry; when
// G * Sq * D > 1024 every row tile re-streams the sequence's pages.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_OUT = 1024;  // outputs of a row tile: RT * D <= 1024
constexpr int S_MAX = 16;       // cluster size (> 8 is non-portable)
constexpr int SCORE_CAP = 8192; // fp32 scores a block keeps for a round
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

// Widens 16 bytes of a staged row to fp32: 4 elements of an fp32 pool, 16
// of an int8 pool times `s`, 8 of a bf16 pool (exactly).  ROUND: the
// element type has the TPU kernel's bf16 rounding points.
template <typename KV>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static constexpr bool ROUND = false;
  __device__ static void widen(const int4 x, float, float* out) {
    out[0] = __int_as_float(x.x);
    out[1] = __int_as_float(x.y);
    out[2] = __int_as_float(x.z);
    out[3] = __int_as_float(x.w);
  }
};

template <>
struct Vec<int8_t> {
  static constexpr int N = 16;
  static constexpr bool ROUND = false;
  // (float)int8 exactly, without a conversion instruction: byte + 128
  // under the exponent of 2^23 is the float 2^23 + 128 + int8
  __device__ static void widen(const int4 x, float s, float* out) {
    const unsigned w[4] = {(unsigned)x.x ^ 0x80808080u,
                           (unsigned)x.y ^ 0x80808080u,
                           (unsigned)x.z ^ 0x80808080u,
                           (unsigned)x.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        out[4 * i + b] =
            (__uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 + b)) -
             8388736.f) *
            s;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static constexpr bool ROUND = true;
  __device__ static void widen(const int4 x, float, float* out) {
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

// 16 bytes global -> shared, zero-filled (nothing read) when !live
__device__ __forceinline__ void cp16(void* dst, const void* src, bool live) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Ring geometry of head dim D over element type KV: SL slots a stage (one
// key a thread at D 64), each row padded by 16 bytes so that the 16-byte
// reads of eight consecutive rows fall in distinct banks, CPR copies a
// row, NST stages, as many as fit in 108 KiB (at least 2).
template <int D, typename KV>
struct Ring {
  static constexpr int SL = 16384 / D;
  static constexpr int CPR = D * (int)sizeof(KV) / 16;
  static constexpr int ROW = D * (int)sizeof(KV) + 16;  // bytes
  static constexpr int NST_FIT = 110592 / (SL * ROW);
  static constexpr int NST = NST_FIT < 2 ? 2 : NST_FIT;
  static constexpr size_t BYTES = (size_t)NST * SL * ROW;
};

// The shared-memory layout of one block, from the row tile RT and the
// pages a rank keeps per round (ppr), computed alike on host and device.
// The scores (RT x ppr * ps) and, after the last V pass, the key-group
// partials and the rank's acc share one region.
struct Layout {
  size_t q, s, row, pm, ek, pub, lsum, mref, fac, cin, lred, pg, st, f, w,
      last, total;
  __host__ __device__ Layout(size_t ring, int RT, int D, int ppr, int ps,
                             int red) {
    size_t at = ring;
    auto take = [&at](size_t bytes) {
      const size_t here = at;
      at += (bytes + 15) & ~(size_t)15;
      return here;
    };
    const size_t scores = 4 * (size_t)RT * ppr * ps;
    const size_t partials = 4 * ((size_t)red + TILE_OUT);
    q = take(4 * (size_t)RT * D);
    s = take(scores > partials ? scores : partials);
    row = take(4 * (size_t)ppr * ps);
    pm = take(4 * (size_t)RT * ppr);
    ek = take(4 * (size_t)RT * ppr);
    pub = take(4 * 2 * (size_t)RT);
    lsum = take(4 * (size_t)RT);
    mref = take(4 * (size_t)RT);
    fac = take(4 * (size_t)RT);
    cin = take(4 * (size_t)RT);
    lred = take(4 * (size_t)RT * WARPS);
    pg = take(4 * (size_t)ppr);
    st = take(4 * (size_t)ppr);
    f = take(4 * (size_t)RT);
    w = take(4 * (size_t)RT);
    last = take(4);
    total = at;
  }
};

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D, typename KV, int WALK>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const Args a, int R, int RT, int S, int ppr_max) {
  constexpr int VN = Vec<KV>::N;
  constexpr int DV = D / VN;  // 16-byte vectors a row
  constexpr int NOV = (TILE_OUT / VN + THREADS - 1) / THREADS;
  constexpr bool ROUND = Vec<KV>::ROUND;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  // rank i's copy of a shared-memory float (this block's own when S = 1)
  auto peer = [&cluster, S](float* p, int i) {
    return S == 1 ? p : cluster.map_shared_rank(p, i);
  };
  // a barrier over the cluster (over the block when it is the cluster)
  auto sync_all = [&cluster, S]() {
    if (S > 1)
      cluster.sync();
    else
      __syncthreads();
  };

  const KV* __restrict__ k_pages = static_cast<const KV*>(a.k_pages);
  const KV* __restrict__ v_pages = static_cast<const KV*>(a.v_pages);
  const int ps = a.page_size;
  const int NSL = ppr_max * ps;  // score row stride
  extern __shared__ __align__(16) unsigned char smem[];
  using RG = Ring<D, KV>;
  constexpr int SL = RG::SL;
  constexpr int NST = RG::NST;
  const Layout L(RG::BYTES, RT, D, ppr_max, ps, THREADS * NOV * VN);
  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + L.q);      // [RT][D]
  float* s_s = reinterpret_cast<float*>(smem + L.s);      // [RT][NSL]
  int* row_s = reinterpret_cast<int*>(smem + L.row);      // [NSL] pool row
  float* pm_s = reinterpret_cast<float*>(smem + L.pm);    // [RT][ppr]
  float* ek_s = reinterpret_cast<float*>(smem + L.ek);    // [RT][ppr]
  float* pub_s = reinterpret_cast<float*>(smem + L.pub);  // [2][RT]
  float* lsum_s = reinterpret_cast<float*>(smem + L.lsum);
  float* mref_s = reinterpret_cast<float*>(smem + L.mref);
  float* fac_s = reinterpret_cast<float*>(smem + L.fac);
  float* cin_s = reinterpret_cast<float*>(smem + L.cin);    // M_in
  float* lred_s = reinterpret_cast<float*>(smem + L.lred);  // [RT][WARPS]
  int* pg_s = reinterpret_cast<int*>(smem + L.pg);  // page id, -1: skip
  int* st_s = reinterpret_cast<int*>(smem + L.st);  // slot-0 position
  int* f_s = reinterpret_cast<int*>(smem + L.f);    // last visible pos
  int* w_s = reinterpret_cast<int*>(smem + L.w);    // window floor: visible
                                                    // iff start + ps > w_s
  int* last_s = reinterpret_cast<int*>(smem + L.last);

  const int h = blockIdx.x / S;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * RT;  // first row of this tile
  const int rows = min(RT, R - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int TD = rows * D;
  const int Sq = a.Sq;

  // the flat walk's positions are its slots, so its length is clamped to
  // the table; an explicit-starts walk's length is the sequence's own
  const int len = WALK == FLAT
                      ? max(0, min(a.lengths[b], a.max_pages * ps))
                      : max(0, a.lengths[b]);
  // row r sees keys pos <= q_start + r % Sq and pos < len
  const int q_start = len - (a.q_lengths ? a.q_lengths[b] : Sq);
  const bool windowed = a.windows != nullptr;
  const int win = windowed ? a.windows[b] : 0;
  const int sink = windowed ? a.sinks[b] : 0;
  const int n_entries = WALK == TWO_LEVEL ? a.max_pages / a.block_size
                                          : a.max_pages;
  const Table tab{a.tables + (size_t)b * n_entries, a.l2,
                  WALK == STARTS ? a.starts + (size_t)b * a.max_pages
                                 : a.starts,
                  a.block_size, a.n_blocks, ps};
  const size_t head_off = (size_t)h * a.P * ps * D;
  const size_t qo_off = (((size_t)b * a.H_kv + h) * R + r0) * D;
  const KV* k_head = k_pages + head_off;
  const KV* v_head = v_pages + head_off;

  for (int i = tid; i < TD; i += THREADS) {
    const float x = a.q[qo_off + i];
    q_s[i] = ROUND ? round_bf16(x) : x;
  }
  // slot -> page of the rank's range without an integer division: exact
  // for slots < 2^22 ((jj + 1/2) / ps lies 1 / (2 ps) or more from an
  // integer, the fp32 product within 2^-23 of it)
  const float inv_ps = 1.f / (float)ps;
  auto page_of = [inv_ps](int jj) {
    return (int)(((float)jj + 0.5f) * inv_ps);
  };
  // the tile's widest frontier and lowest window floor decide which pages
  // any of its rows can see
  int f_max = INT_MIN, w_min = INT_MAX;
  for (int r = 0; r < rows; ++r) {
    const int qpos = q_start + (r0 + r) % Sq;
    const long long wf = (long long)qpos + 1 - win;
    const int wfl = windowed ? (int)max(wf, (long long)INT_MIN) : INT_MIN;
    f_max = max(f_max, min(len - 1, qpos));
    w_min = min(w_min, wfl);
    if (tid == 0) {
      f_s[r] = min(len - 1, qpos);
      w_s[r] = wfl;
      lsum_s[r] = 0.f;
      mref_s[r] = NEG_INF / 2;
    }
  }
  int n_live;
  if (WALK == FLAT) {
    n_live = (len + ps - 1) / ps;
  } else {
    // the walk ends after the last table entry whose start is < len
    if (tid == 0) *last_s = 0;
    __syncthreads();
    int last = 0;
    for (int e = tid; e < a.max_pages; e += THREADS) {
      int page, start;
      entry<WALK>(tab, e, page, start);
      if (start < len) last = e + 1;
    }
    if (last) atomicMax(last_s, last);
    __syncthreads();
    n_live = *last_s;
  }

  // PV: thread -> (key group kg, output vectors ov = tid % OV + n * ...)
  const int OV = rows * DV;
  const int KG = OV >= THREADS ? 1 : THREADS / OV;
  const int kg = OV >= THREADS ? 0 : tid / OV;
  // this thread's n-th output vector, OV (none) past its share
  auto ov_of = [&](int n) {
    return OV >= THREADS ? tid + n * THREADS : (n == 0 ? tid % OV : OV);
  };
  float acc[NOV][VN];
#pragma unroll
  for (int n = 0; n < NOV; ++n)
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[n][e] = 0.f;

  const int ppr = min((n_live + S - 1) / S, ppr_max);
  const int rounds = n_live ? (n_live + S * ppr - 1) / (S * ppr) : 0;
  for (int round = 0; round < rounds; ++round) {
    const int e0 = (round * S + rank) * ppr;
    const int npr = max(0, min(ppr, n_live - e0));  // this rank's pages
    const int nsl = npr * ps;                       // and slots
    const int par = round & 1;
    __syncthreads();  // the previous round's entries and scores consumed
    // each slot's pool row (-1: dead, loads nothing), and each page's id
    // (-1: no row of the tile sees it) and slot-0 position
    for (int jj = tid; jj < nsl; jj += THREADS) {
      const int k = page_of(jj), o = jj - k * ps;
      int page, start;
      entry<WALK>(tab, e0 + k, page, start);
      const bool seen = start < len && start <= f_max &&
                        (!windowed || start < sink || start + ps > w_min);
      // a page id outside [0, P) is clamped, as XLA clamps a gather
      // index: a corrupt table can never read outside the pool
      page = min(max(page, 0), a.P - 1);
      row_s[jj] = seen && start + o < len ? page * ps + o : -1;
      if (o == 0) {
        pg_s[k] = seen ? page : -1;
        st_s[k] = start;
      }
    }
    __syncthreads();

    // the ring: item i < nks is K stage i, then V stage i - nks; CPR
    // consecutive threads copy one slot row (a dead row reads nothing and
    // holds zeros), NST - 1 stages in flight ahead of the one consumed
    const int nks = (nsl + SL - 1) / SL;
    auto load = [&](int item) {
      if (item < 2 * nks) {
        const bool is_v = item >= nks;
        const KV* head = is_v ? v_head : k_head;
        const int base = (is_v ? item - nks : item) * SL;
        unsigned char* dst = ring + (size_t)(item % NST) * SL * RG::ROW;
        const int part = tid % RG::CPR;
#pragma unroll
        for (int j = tid / RG::CPR; j < SL; j += THREADS / RG::CPR) {
          const int jj = base + j;
          const int prow = jj < nsl ? row_s[jj] : -1;
          cp16(dst + j * RG::ROW + part * 16,
               head + (size_t)max(prow, 0) * D + part * (16 / sizeof(KV)),
               prow >= 0);
        }
      }
      cp_commit();
    };
    auto stage_at = [&](int item) {
      return ring + (size_t)(item % NST) * SL * RG::ROW;
    };
#pragma unroll
    for (int i = 0; i < NST - 1; ++i) load(i);

    // QK: one thread per (row, key), one fmaf chain in ascending d
    for (int it = 0; it < nks; ++it) {
      load(it + NST - 1);
      cp_wait<NST - 1>();
      __syncthreads();
      const unsigned char* stage = stage_at(it);
      const int base = it * SL;
      for (int i = tid; i < rows * SL; i += THREADS) {
        const int r = i / SL, j = i % SL, jj = base + j;
        if (jj >= nsl) continue;
        const int k = page_of(jj), o = jj - k * ps;
        const int start = st_s[k], pos = start + o;
        const bool vis = row_s[jj] >= 0 && pos <= f_s[r] &&
                         (!windowed || start < sink || start + ps > w_s[r]);
        float s = 0.f;
        if (vis) {
          const unsigned char* kr = stage + j * RG::ROW;
          const float4* qr = reinterpret_cast<const float4*>(q_s + r * D);
          const float ksc = a.k_scales ? a.k_scales[pg_s[k]] : 1.f;
#pragma unroll
          for (int c = 0; c < DV; ++c) {
            float kx[VN];
            Vec<KV>::widen(*reinterpret_cast<const int4*>(kr + c * 16), ksc,
                           kx);
#pragma unroll
            for (int e = 0; e < VN; e += 4) {
              const float4 qv = qr[(c * VN + e) / 4];
              s = fmaf(qv.x, kx[e], s);
              s = fmaf(qv.y, kx[e + 1], s);
              s = fmaf(qv.z, kx[e + 2], s);
              s = fmaf(qv.w, kx[e + 3], s);
            }
          }
        }
        s_s[(size_t)r * NSL + jj] = vis ? s * a.scale : NEG_INF;
      }
      __syncthreads();  // the stage consumed before the ring reuses it
    }
    // the exchange: page maxima, the cluster's maxima, the weights
    for (int i = tid; i < rows * npr; i += THREADS) {
      const int r = i / npr, k = i - r * npr;
      const float* sr = s_s + (size_t)r * NSL + k * ps;
      float mx = NEG_INF;
      for (int o = 0; o < ps; ++o) mx = fmaxf(mx, sr[o]);
      pm_s[r * ppr_max + k] = mx;
    }
    __syncthreads();
    for (int r = tid; r < rows; r += THREADS) {
      float mx = NEG_INF;
      for (int k = 0; k < npr; ++k) mx = fmaxf(mx, pm_s[r * ppr_max + k]);
      pub_s[par * RT + r] = mx;
    }
    sync_all();
    for (int r = tid; r < rows; r += THREADS) {
      float x[S_MAX];
#pragma unroll
      for (int i = 0; i < S_MAX; ++i)
        x[i] = i < S ? *peer(pub_s + par * RT + r, i) : NEG_INF;
      const float m_old = mref_s[r];
      float m_in = m_old, m_end = m_old;
#pragma unroll
      for (int i = 0; i < S_MAX; ++i) {
        if (i < rank) m_in = fmaxf(m_in, x[i]);
        m_end = fmaxf(m_end, x[i]);
      }
      const float fac = expf(m_old - m_end);
      fac_s[r] = fac;
      mref_s[r] = m_end;
      lsum_s[r] *= fac;
      cin_s[r] = m_in;
    }
    __syncthreads();
    // m_k, the serial walk's running max after the rank's page k: a warp's
    // max scan over the pages of a row, from M_in; ek = exp(m_k - M_end)
    for (int r = warp; r < rows; r += WARPS) {
      float carry = cin_s[r];
      const float m_end = mref_s[r];
      for (int k0 = 0; k0 < npr; k0 += 32) {
        const int k = k0 + lane;
        float m = k < npr ? pm_s[r * ppr_max + k] : NEG_INF;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, m, off);
          if (lane >= off) m = fmaxf(m, y);
        }
        m = fmaxf(m, carry);
        if (k < npr) {
          pm_s[r * ppr_max + k] = m;
          ek_s[r * ppr_max + k] = expf(m - m_end);
        }
        carry = __shfl_sync(0xffffffffu, m, 31);
      }
    }
    __syncthreads();
    // weights: w = bf16(p) * exp(m_k - M_end) (times the int8 V scale),
    // l += p * exp(m_k - M_end) with the unrounded p
    for (int r = 0; r < rows; ++r) {
      float* sr = s_s + (size_t)r * NSL;
      const float* mr = pm_s + r * ppr_max;
      const float* er = ek_s + r * ppr_max;
      float lp = 0.f;
      for (int j = tid; j < nsl; j += THREADS) {
        const int k = page_of(j);
        const float p = expf(sr[j] - mr[k]);
        float wgt = (ROUND ? round_bf16(p) : p) * er[k];
        if (a.v_scales && pg_s[k] >= 0) wgt *= a.v_scales[pg_s[k]];
        sr[j] = wgt;
        lp += p * er[k];
      }
      lp = warp_sum(lp);
      if (lane == 0) lred_s[r * WARPS + warp] = lp;
    }
    // acc follows the round's reference max
#pragma unroll
    for (int n = 0; n < NOV; ++n) {
      const int ov = ov_of(n);
      if (ov < OV && kg < KG) {
        const float fac = fac_s[ov / DV];
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[n][e] *= fac;
      }
    }
    __syncthreads();
    for (int r = tid; r < rows; r += THREADS) {
      float l = lsum_s[r];
      for (int i = 0; i < WARPS; ++i) l += lred_s[r * WARPS + i];
      lsum_s[r] = l;
    }

    // PV: acc += w . V over the V stages, each thread 16 bytes of columns
    // for a key group
    for (int it = nks; it < 2 * nks; ++it) {
      load(it + NST - 1);
      cp_wait<NST - 1>();
      __syncthreads();
      const unsigned char* stage = stage_at(it);
      const int base = (it - nks) * SL;
      const int jn = min(SL, nsl - base);
#pragma unroll
      for (int n = 0; n < NOV; ++n) {
        const int ov = ov_of(n);
        if (ov < OV && kg < KG) {
          const int r = ov / DV, c = ov % DV;
          const float* wr = s_s + (size_t)r * NSL + base;
          for (int j = kg; j < jn; j += KG) {
            const float wgt = wr[j];
            float vx[VN];
            Vec<KV>::widen(
                *reinterpret_cast<const int4*>(stage + j * RG::ROW + c * 16),
                1.f, vx);
#pragma unroll
            for (int e = 0; e < VN; ++e)
              acc[n][e] = fmaf(wgt, vx[e], acc[n][e]);
          }
        }
      }
      __syncthreads();  // the stage consumed before the ring reuses it
    }
  }

  // the rank's partial acc, summed over key groups in order
  __syncthreads();
  float* red = s_s;                        // [KG][OV][VN]
  float* pacc = red + THREADS * NOV * VN;  // [rows][D]
  if (KG == 1) {
#pragma unroll
    for (int n = 0; n < NOV; ++n) {
      const int ov = tid + n * THREADS;
      if (ov < OV)
#pragma unroll
        for (int e = 0; e < VN; ++e) pacc[ov * VN + e] = acc[n][e];
    }
  } else {
    if (kg < KG)
#pragma unroll
      for (int e = 0; e < VN; ++e)
        red[(kg * OV + tid % OV) * VN + e] = acc[0][e];
    __syncthreads();
    for (int i = tid; i < OV * VN; i += THREADS) {
      float x = 0.f;
      for (int g = 0; g < KG; ++g) x += red[g * OV * VN + i];
      pacc[i] = x;
    }
  }
  sync_all();
  // the combine: each rank a slice of the outputs, the S partials summed
  // in rank order
  for (int i = rank * THREADS + tid; i < TD; i += S * THREADS) {
    const int r = i / D;
    float xs[S_MAX], ls[S_MAX];
#pragma unroll
    for (int k = 0; k < S_MAX; ++k) {
      xs[k] = k < S ? *peer(pacc + i, k) : 0.f;
      ls[k] = k < S ? *peer(lsum_s + r, k) : 0.f;
    }
    float x = 0.f, l = 0.f;
#pragma unroll
    for (int k = 0; k < S_MAX; ++k) {
      x += xs[k];
      l += ls[k];
    }
    const float o = x / fmaxf(l, 1e-30f);
    a.o[qo_off + i] = ROUND ? round_bf16(o) : o;
  }
  if (S > 1) cluster.sync();  // no block leaves while another reads its
                              // partials
}

template <int D, typename KV>
size_t smem_bytes(int RT, int ppr, int ps) {
  constexpr int NOV = (TILE_OUT / Vec<KV>::N + THREADS - 1) / THREADS;
  return Layout(Ring<D, KV>::BYTES, RT, D, ppr, ps,
                THREADS * NOV * Vec<KV>::N)
      .total;
}

template <int D, typename KV, int WALK>
int launch(const Args& a, int S, cudaStream_t stream) {
  const int R = a.G * a.Sq;
  const int RT = min(R, TILE_OUT / D);
  const int tiles = (R + RT - 1) / RT;
  if (tiles > 65535 || S < 1 || S > S_MAX || a.page_size < 1)
    return (int)cudaErrorInvalidValue;
  // pages a rank keeps per round: its share of the table, within the
  // score budget (at least one page)
  const int share = (a.max_pages + S - 1) / S;
  const int ppr = max(1, min(share, SCORE_CAP / (RT * a.page_size)));
  const size_t smem = smem_bytes<D, KV>(RT, ppr, a.page_size);
  auto kernel = paged_attn_kernel<D, KV, WALK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && S > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S * a.H_kv, a.B, tiles);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = S > 1 ? 1 : 0;  // S = 1: every block its own cluster
    err = cudaLaunchKernelEx(&cfg, kernel, a, R, RT, S, ppr);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no error for the next
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename KV, int WALK>
int dispatch(const Args& a, int D, int S, void* stream) {
  if (a.B * a.H_kv * a.G * a.Sq == 0) return 0;
  if (WALK == TWO_LEVEL &&
      (a.block_size < 1 || a.max_pages % a.block_size || a.n_blocks < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, KV, WALK>(a, S, st);
    case 128:
      return launch<128, KV, WALK>(a, S, st);
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
         int max_pages, int block_size, int n_blocks, int D, int S,
         float scale, void* stream) {
  if (starts == nullptr || (block_size > 0) != (l2 != nullptr) ||
      (windows == nullptr) != (sinks == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, tables, l2, starts,
               lengths, q_lengths, windows, sinks, o, B, H_kv, G, Sq, P,
               page_size, max_pages, block_size, n_blocks, scale};
  return block_size > 0 ? dispatch<KV, TWO_LEVEL>(a, D, S, stream)
                        : dispatch<KV, STARTS>(a, D, S, stream);
}

}  // namespace

// Every entry: q [B, H_kv*G, Sq, D] (query head h_kv*G + g), o like q:
// contiguous fp32 on the device, 16-byte aligned.  k/v pages [H_kv, P,
// page_size, D]: contiguous, 16-byte aligned, fp32, int8 or bf16.  tables
// [B, max_pages], lengths [B] and q_lengths [B]: contiguous int32 on the
// device.  k_scales / v_scales [P]: contiguous fp32 on the device.  S: the
// cluster size, 1 to 16, that splits each sequence's walk.  Returns
// cudaGetLastError() after the launch, or the launch's own error
// (cudaErrorInvalidValue for a head_dim other than 64 or 128, or operands
// a walk cannot take; a cluster the card cannot place, as
// cudaErrorClusterOutOfResources).

// Sq = 1 over an fp32 pool: the serving decode step.
extern "C" int paged_decode_f32(const float* q, const float* k_pages,
                                const float* v_pages, const int* tables,
                                const int* lengths, float* o, int B, int H_kv,
                                int G, int P, int page_size, int max_pages,
                                int D, int S, float scale, void* stream) {
  return dispatch<float, FLAT>(
      flat_args(q, k_pages, v_pages, nullptr, nullptr, tables, lengths,
                nullptr, o, B, H_kv, G, 1, P, page_size, max_pages, scale),
      D, S, stream);
}

// Sq > 1 over an fp32 pool (k_scales, v_scales ignored; q_lengths null
// means every sequence fed Sq rows): the speculative verify step.
extern "C" int paged_verify_f32(const float* q, const float* k_pages,
                                const float* v_pages, const float* k_scales,
                                const float* v_scales, const int* tables,
                                const int* lengths, const int* q_lengths,
                                float* o, int B, int H_kv, int G, int Sq,
                                int P, int page_size, int max_pages, int D,
                                int S, float scale, void* stream) {
  return dispatch<float, FLAT>(
      flat_args(q, k_pages, v_pages, nullptr, nullptr, tables, lengths,
                q_lengths, o, B, H_kv, G, Sq, P, page_size, max_pages, scale),
      D, S, stream);
}

// Sq = 1 over an int8 pool with per-page scales (q_lengths ignored).
extern "C" int paged_decode_i8(const float* q, const int8_t* k_pages,
                               const int8_t* v_pages, const float* k_scales,
                               const float* v_scales, const int* tables,
                               const int* lengths, const int* q_lengths,
                               float* o, int B, int H_kv, int G, int Sq,
                               int P, int page_size, int max_pages, int D,
                               int S, float scale, void* stream) {
  return dispatch<int8_t, FLAT>(
      flat_args(q, k_pages, v_pages, k_scales, v_scales, tables, lengths,
                nullptr, o, B, H_kv, G, 1, P, page_size, max_pages, scale),
      D, S, stream);
}

// Sq > 1 over an int8 pool with per-page scales.
extern "C" int paged_verify_i8(const float* q, const int8_t* k_pages,
                               const int8_t* v_pages, const float* k_scales,
                               const float* v_scales, const int* tables,
                               const int* lengths, const int* q_lengths,
                               float* o, int B, int H_kv, int G, int Sq,
                               int P, int page_size, int max_pages, int D,
                               int S, float scale, void* stream) {
  return dispatch<int8_t, FLAT>(
      flat_args(q, k_pages, v_pages, k_scales, v_scales, tables, lengths,
                q_lengths, o, B, H_kv, G, Sq, P, page_size, max_pages, scale),
      D, S, stream);
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
                              int n_blocks, int D, int S, float scale,
                              void* stream) {
  return walk<float>(q, k_pages, v_pages, nullptr, nullptr, tables, l2,
                     starts, lengths, q_lengths, windows, sinks, o, B, H_kv,
                     G, Sq, P, page_size, max_pages, block_size, n_blocks, D,
                     S, scale, stream);
}

extern "C" int paged_walk_i8(const float* q, const int8_t* k_pages,
                             const int8_t* v_pages, const float* k_scales,
                             const float* v_scales, const int* tables,
                             const int* l2, const int* starts,
                             const int* lengths, const int* q_lengths,
                             const int* windows, const int* sinks, float* o,
                             int B, int H_kv, int G, int Sq, int P,
                             int page_size, int max_pages, int block_size,
                             int n_blocks, int D, int S, float scale,
                             void* stream) {
  if (k_scales == nullptr || v_scales == nullptr)
    return (int)cudaErrorInvalidValue;
  return walk<int8_t>(q, k_pages, v_pages, k_scales, v_scales, tables, l2,
                      starts, lengths, q_lengths, windows, sinks, o, B, H_kv,
                      G, Sq, P, page_size, max_pages, block_size, n_blocks, D,
                      S, scale, stream);
}

// The bf16 entries: pages [H_kv, P, page_size, D] bf16, q and o fp32, at
// the TPU kernel's bf16 rounding points (file comment).  k_scales,
// v_scales ignored.  Sq = 1 (q_lengths ignored), Sq > 1, and the
// explicit-starts walks, as the fp32 entries above.
extern "C" int paged_decode_bf16(const float* q, const __nv_bfloat16* k_pages,
                                 const __nv_bfloat16* v_pages,
                                 const float* k_scales, const float* v_scales,
                                 const int* tables, const int* lengths,
                                 const int* q_lengths, float* o, int B,
                                 int H_kv, int G, int Sq, int P,
                                 int page_size, int max_pages, int D, int S,
                                 float scale, void* stream) {
  return dispatch<__nv_bfloat16, FLAT>(
      flat_args(q, k_pages, v_pages, nullptr, nullptr, tables, lengths,
                nullptr, o, B, H_kv, G, 1, P, page_size, max_pages, scale),
      D, S, stream);
}

extern "C" int paged_verify_bf16(const float* q, const __nv_bfloat16* k_pages,
                                 const __nv_bfloat16* v_pages,
                                 const float* k_scales, const float* v_scales,
                                 const int* tables, const int* lengths,
                                 const int* q_lengths, float* o, int B,
                                 int H_kv, int G, int Sq, int P,
                                 int page_size, int max_pages, int D, int S,
                                 float scale, void* stream) {
  return dispatch<__nv_bfloat16, FLAT>(
      flat_args(q, k_pages, v_pages, nullptr, nullptr, tables, lengths,
                q_lengths, o, B, H_kv, G, Sq, P, page_size, max_pages, scale),
      D, S, stream);
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
                               int D, int S, float scale, void* stream) {
  return walk<__nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr, tables,
                             l2, starts, lengths, q_lengths, windows, sinks,
                             o, B, H_kv, G, Sq, P, page_size, max_pages,
                             block_size, n_blocks, D, S, scale, stream);
}
