// flash_bwd.cu — flash attention backward (dQ, and dK/dV), fp32 and bf16, for
// sm_90a.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, the two pallas_calls built
// by `_bwd_calls`: dq (line 391, body `_flash_bwd_dq_kernel`) and dkv (line
// 409, body `_flash_bwd_dkv_kernel`).  The FlashAttention-2 split: P is
// rebuilt from the forward's per-row logsumexp (flash_fwd.cu, lse != null),
// so nothing score-shaped is stored between the passes, and each output has
// one owner block, so the kernels need no atomics and two launches on the
// same inputs give bit-equal outputs.
//
// With S = scale * Q K^T, P = exp(S - lse) on visible entries and 0 on masked
// ones, dP = dO V^T, D = rowsum(dO * O) (computed by the caller) and
// dS = P * (dP - D) * scale:
//   dq:  dQ = dS K                      one block per (b*h, 64-query tile)
//   dkv: dK = dS^T Q,  dV = P^T dO      one block per (b*h, 64-key tile)
// A loop inside the block takes the place of the TPU grid's innermost
// sequential dimension: the dq block walks key tiles up to min(klen, its
// causal frontier q0 + 64 + Sk - Sq), the dkv block walks query tiles from
// the first one that can see its keys, (k0 - (Sk - Sq)) rounded down to a
// tile.
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
// either way.  The two element types run two designs.
//
// fp32 only: FMA tiles.  256 threads as a 16x16 grid; each thread owns a 4x4
// block of every 64x64 tile product (rows ty + 16i, columns tx + 16j) and the
// output columns tx + 16c of its four rows, as in flash_fwd.cu.  The operand
// tiles go through shared memory (rows padded by one float so the column reads
// are free of bank conflicts), P and dS are staged there for the second
// product, and the fp32 accumulators stay in registers; shared memory (83 KB /
// 149 KB for dq, 100 KB / 166 KB for dkv at head_dim 64 / 128) is opted into
// as dynamic shared memory.  The products stay exact fp32 FMAs: TF32 tensor
// cores would round the operands to 10 mantissa bits, beyond the fp32 gate.
// Bound on an H100: the fp32 flops of the visible (query, key) pairs (dq 6*D
// a pair for S, dP and dQ; dkv 8*D for S, dP, dK and dV) over 67 TFLOP/s lead
// the bytes at the training shape; in practice instruction issue bounds it
// (8 shared loads for 16 FMAs), with one or two blocks an SM.
//
// bf16 only: tensor-core tiles.  The bf16 arithmetic of the TPU kernels is
// what mma.sync.m16n8k16 with bf16 operands and fp32 accumulators computes:
// exact products summed in fp32.  The three operand roundings the TPU kernels
// make, dS to K's dtype before dS K (flash_attention.py:227), dS^T to Q's
// before dS^T Q (:267) and P^T to dO's before P^T dO (:270), are the
// conversions the tensor cores need anyway; dS^T is built from the unrounded
// P^T, as the TPU builds ds from p (:263-265); each gradient rounds once, at
// its store (:232, :275-276).  S, P, dP, dS and the accumulators are fp32.
// Bound on an H100: at the training shape (S 256, D 64) the bytes (Q, K, V,
// dO, lse, D read once; dQ, or dK and dV, written once) over 3.35 TB/s lead
// the bf16 flops over 989 TFLOP/s by about 3x, so what counts is keeping the
// card's memory busy: no scalar product loop, bf16 (not fp32) in shared
// memory, the next tile's copy in flight under the current tile's products,
// and enough blocks on each SM.  The design:
//   - 128 threads, four warps; each warp owns 16 rows of the block's 64-row
//     tile (query rows in dq, key rows in dkv) and their fp32 accumulators
//     in registers (dQ: 16 x D; dK and dV: 2 x 16 x D);
//   - the block's own tiles (Q and dO in dq, K and V in dkv) stay in shared
//     memory; the walked ones (K, V in dq; Q, dO, lse, D in dkv) pass through
//     a two-stage ring filled by cp.async (16 bytes a thread a copy; 4 for
//     lse and D, whose rows need not be 16-byte aligned), the next tile's
//     copies issued before the current tile's products, one barrier a tile;
//     rows past Sq or klen are zero-filled (src-size 0), since garbage bf16
//     can be Inf or NaN and 0 * NaN would poison a whole accumulator row;
//   - rows are padded by 8 elements (16 bytes), so the eight 16-byte row
//     reads of every ldmatrix fall in distinct banks;
//   - products on mma.sync.m16n8k16 (bf16 in, fp32 accumulate): fragments by
//     ldmatrix, and by ldmatrix.trans where B is a row-major [key][d] or
//     [query][d] tile (K in dS K; Q and dO in dS^T Q and P^T dO);
//   - dkv computes the transposed scores S^T = K Q^T and dP^T = V dO^T, so P^T
//     and dS^T land in the accumulators of the warp that owns those key rows;
//     they are rounded and packed straight into A fragments (the m16n8
//     accumulators of two adjacent 8-column tiles are the m16k16 A layout),
//     and nothing score-shaped goes through shared memory; dq does the same
//     with S and dP untransposed;
//   - the walked tile is taken in sub-blocks (32 keys in dq, 16 queries in
//     dkv) so that S, dP and the accumulators stay in registers: the
//     register file, not shared memory, caps the blocks an SM holds.  dq
//     fits 128 registers a thread, four blocks an SM; dkv also keeps its
//     warp's K and V rows as A fragments for the whole walk (they are the
//     same for every query tile), within 168 registers, three blocks.
//     Shared memory: 55,296 bytes a block for dq, 56,320 for dkv at
//     head_dim 64, against the SM's 233,472; at 128, two blocks of each.
// What the card shows: at the training shape the kernels stay about 3x off
// their bytes floor, and from S 1024 on they are bound by the products at
// a small share of the tensor cores' rate.  Variants with more or fewer
// blocks an SM, longer or shorter sub-blocks, and the stationary fragments
// reloaded or kept moved the times by a few per cent, so no single one of
// occupancy and fragment traffic bounds them.  What is left, not measured
// apart, is the exp and mask work between the two products and the walk's
// barrier a tile.
// wgmma and TMA are not used: at the training shape the flops floor is a
// third of the bytes floor, so mma.sync at a fraction of wgmma's rate was
// expected not to bound the kernels there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// fp32: FMA tiles
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;  // 16 x 16

// Copies rows [r0, r0 + 64) of a [S, D] matrix into a [64][D + 1] fp32
// shared tile; rows at or past `valid` are zero.
template <int D>
__device__ void load_tile(float* dst, const float* src, int r0, int valid,
                          int tid) {
  constexpr int D4 = D / 4;
  for (int idx = tid; idx < 64 * D4; idx += THREADS) {
    const int r = idx / D4, d = (idx % D4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < valid)
      x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + d);
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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec,
                    const int* __restrict__ k_lengths, float* __restrict__ dq,
                    int H, int Sq, int Sk, float scale, int causal) {
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

  const float* qb = q + (size_t)bh * Sq * D;
  const float* dob = dout + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;

  const int klen = max(0, min(Sk, k_lengths[b]));
  const int offset = Sk - Sq;  // bottom-right causal alignment
  int k_end = klen;
  if (causal) k_end = min(k_end, q0 + BQ + offset);

  load_tile<D>(q_s, qb, q0, Sq, tid);
  load_tile<D>(do_s, dob, q0, Sq, tid);
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
    load_tile<D>(k_s, kb, k0, klen, tid);
    load_tile<D>(v_s, vb, k0, klen, tid);
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
        ds_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] =
            p * (dp[i][j] - row_d[i]) * scale;
      }
    }
    __syncthreads();  // ds tile complete
    tile_matmul<D>(acc, ds_s, k_s, ty, tx);
  }

  float* dqb = dq + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) dqb[(size_t)r * D + tx + 16 * c] = acc[i][c];
  }
}

template <int D>
constexpr size_t dkv_smem_floats() {
  // k, v, q, do [64][D+1]; pt, dst [64][65]; lse, d [64]
  return 4 * (size_t)64 * (D + 1) + 2 * (size_t)64 * 65 + 2 * 64;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec,
                     const int* __restrict__ k_lengths,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int Sq, int Sk, float scale, int causal) {
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

  const float* qb = q + (size_t)bh * Sq * D;
  const float* dob = dout + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;

  const int klen = max(0, min(Sk, k_lengths[b]));
  const int offset = Sk - Sq;
  // first query tile holding a row that sees key k0: i >= k0 - offset
  int q_begin = 0;
  if (causal) q_begin = max(0, k0 - offset) / BQ * BQ;
  // no visible key in this tile: the loop is empty and zeros are written

  load_tile<D>(k_s, kb, k0, klen, tid);
  load_tile<D>(v_s, vb, k0, klen, tid);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int q_end = k0 < klen ? Sq : 0;
  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    __syncthreads();  // k/v tiles written; previous q tile fully consumed
    load_tile<D>(q_s, qb, q0, Sq, tid);
    load_tile<D>(do_s, dob, q0, Sq, tid);
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
        pt_s[(ty + 16 * i) * (BQ + 1) + qr] = p;
        dst_s[(ty + 16 * i) * (BQ + 1) + qr] =
            p * (dp[i][j] - d_s[qr]) * scale;
      }
    }
    __syncthreads();  // P^T and dS^T complete
    tile_matmul<D>(dv_acc, pt_s, do_s, ty, tx);
    tile_matmul<D>(dk_acc, dst_s, q_s, ty, tx);
  }

  float* dkb = dk + (size_t)bh * Sk * D;
  float* dvb = dv + (size_t)bh * Sk * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= Sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkb[(size_t)r * D + tx + 16 * c] = dk_acc[i][c];
      dvb[(size_t)r * D + tx + 16 * c] = dv_acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int MMA_THREADS = 128;  // four warps, 16 rows of the tile each
constexpr unsigned CHUNK_BYTES = 16 * sizeof(bf16);  // a 16-deep k chunk

// A [64][D + 8] bf16 tile: rows padded by 16 bytes
template <int D>
struct Tile {
  static constexpr int LD = D + 8;
  static constexpr int ELEMS = 64 * LD;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled (nothing read) when !live
__device__ __forceinline__ void cp16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, zero-filled when !live
__device__ __forceinline__ void cp4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i .. 8i + 7 give the
// row addresses of matrix i, and register i holds matrix i's (row lane / 4,
// columns 2 (lane % 4), + 1) — with .trans, (rows 2 (lane % 4), + 1, column
// lane / 4).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b, a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 fp32.  With
// g = lane / 4 and t = lane % 4: a = {(g, 2t..2t+1), (g + 8, 2t..), (g,
// 2t + 8..), (g + 8, 2t + 8..)}, b = {(k 2t..2t+1, n g), (k 2t + 8.., n g)},
// c = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// The A fragment of a 16 x 16 block from the m16n8 accumulators of its two
// 8-column halves, rounded to bf16: lo's (row g, columns 2t, 2t + 1) and
// (row g + 8, ...) are a[0] and a[1], hi's a[2] and a[3]
__device__ __forceinline__ void pack_a(unsigned (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Issues the 16-byte copies of rows [r0, r0 + 64) of a [S, D] bf16 matrix
// into a Tile<D>; rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int r0,
                                          int valid, int tid) {
  constexpr int CPR = D / 8;  // copies a row
#pragma unroll
  for (int i = 0; i < 64 * CPR / MMA_THREADS; ++i) {
    const int idx = tid + i * MMA_THREADS;
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const bool live = r0 + r < valid;
    cp16(dst + r * Tile<D>::LD + c,
         src + (live ? (size_t)(r0 + r) * D + c : 0), live);
  }
}

// ldmatrix row / column of this lane within a 16 x 16 block.  A operands and
// .trans B operands: matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15),
// (8-15, 8-15).  Untransposed B operands ([n][k] in memory): (n 0-7, k 0-7),
// (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15), so that registers
// {0, 1} are the b fragment of n-tile 0 and {2, 3} that of n-tile 1.
struct Lanes {
  int a_row, a_col, b_row, b_col;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row((lane & 7) + ((lane >> 3) & 1) * 8),
        a_col((lane >> 4) * 8),
        b_row((lane & 7) + (lane >> 4) * 8),
        b_col(((lane >> 3) & 1) * 8) {}
};

template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // q, do; a two-stage ring of (k, v)
  return 6 * (size_t)Tile<D>::ELEMS * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, D == 64 ? 4 : 2)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec,
                        const int* __restrict__ k_lengths,
                        bf16* __restrict__ dq, int H, int Sq, int Sk,
                        float scale, int causal) {
  constexpr int LD = Tile<D>::LD, TILE = Tile<D>::ELEMS;
  constexpr int KC = D / 16;  // 16-deep chunks of a d sum
  constexpr int SUB = 32;     // keys a sub-block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + TILE;
  bf16* ring = do_s + TILE;  // stage s: k at ring + 2 s TILE, v after it

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Lanes ln(lane);

  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* dob = dout + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;

  const int klen = max(0, min(Sk, k_lengths[b]));
  const int offset = Sk - Sq;  // bottom-right causal alignment
  int k_end = klen;
  if (causal) k_end = min(k_end, q0 + BQ + offset);
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  if (n_tiles > 0) {
    copy_tile<D>(q_s, qb, q0, Sq, tid);
    copy_tile<D>(do_s, dob, q0, Sq, tid);
    copy_tile<D>(ring, kb, 0, klen, tid);
    copy_tile<D>(ring + TILE, vb, 0, klen, tid);
    cp_commit();
  }

  // this thread's rows of the warp's 16: row0 (g) and row0 + 8 (g + 8)
  const int row0 = q0 + warp * 16 + g;
  float row_lse[2], row_d[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    row_lse[h] = r < Sq ? lse[(size_t)bh * Sq + r] : -NEG_INF;
    row_d[h] = r < Sq ? dvec[(size_t)bh * Sq + r] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const unsigned q_a = smem_addr(q_s + (warp * 16 + ln.a_row) * LD + ln.a_col);
  const unsigned do_a =
      smem_addr(do_s + (warp * 16 + ln.a_row) * LD + ln.a_col);

  for (int it = 0; it < n_tiles; ++it) {
    // tile it has landed, and every warp is done with the stage tile it + 1
    // goes to
    cp_wait_all();
    __syncthreads();
    if (it + 1 < n_tiles) {
      bf16* nxt = ring + ((it + 1) & 1) * 2 * TILE;
      copy_tile<D>(nxt, kb, (it + 1) * BK, klen, tid);
      copy_tile<D>(nxt + TILE, vb, (it + 1) * BK, klen, tid);
      cp_commit();
    }
    const bf16* k_t = ring + (it & 1) * 2 * TILE;
    const bf16* v_t = k_t + TILE;
    const int k0 = it * BK;

#pragma unroll
    for (int sub = 0; sub < BK; sub += SUB) {
      // S = Q K^T and dP = dO V^T over this sub-block's 32 keys
      float s[SUB / 8][4], dp[SUB / 8][4];
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        unsigned qa[4], da[4];
        ldsm_x4(qa, q_a + kc * CHUNK_BYTES);
        ldsm_x4(da, do_a + kc * CHUNK_BYTES);
#pragma unroll
        for (int np = 0; np < SUB / 16; ++np) {
          const int off = (sub + np * 16 + ln.b_row) * LD + kc * 16 + ln.b_col;
          unsigned kf[4], vf[4];
          ldsm_x4(kf, smem_addr(k_t + off));
          ldsm_x4(vf, smem_addr(v_t + off));
          mma_bf16_16816(s[2 * np], qa, kf[0], kf[1]);
          mma_bf16_16816(s[2 * np + 1], qa, kf[2], kf[3]);
          mma_bf16_16816(dp[2 * np], da, vf[0], vf[1]);
          mma_bf16_16816(dp[2 * np + 1], da, vf[2], vf[3]);
        }
      }
      // P and dS in the accumulators: element e of n-tile j is query row
      // row0 + 8 (e / 2), key k0 + sub + 8 j + 2 t + e % 2
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int qi = row0 + 8 * h;
          const int kj = k0 + sub + 8 * j + 2 * t + (e & 1);
          const bool ok = kj < klen && (!causal || kj <= qi + offset);
          const float p = ok ? expf(s[j][e] * scale - row_lse[h]) : 0.f;
          s[j][e] = p * (dp[j][e] - row_d[h]) * scale;  // dS, fp32
        }
      }
      // dQ += dS K: dS rounds to K's dtype as it is packed into A
#pragma unroll
      for (int kc = 0; kc < SUB / 16; ++kc) {
        unsigned dsa[4];
        pack_a(dsa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          unsigned kf[4];
          ldsm_x4_t(kf, smem_addr(k_t + (sub + kc * 16 + ln.a_row) * LD +
                                  np * 16 + ln.a_col));
          mma_bf16_16816(acc[2 * np], dsa, kf[0], kf[1]);
          mma_bf16_16816(acc[2 * np + 1], dsa, kf[2], kf[3]);
        }
      }
    }
  }

  // dQ rounds once, at its store
  bf16* dqb = dq + (size_t)bh * Sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= Sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)r * D + 8 * n +
                                         2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

template <int D>
constexpr size_t dkv_mma_smem_bytes() {
  // k, v; a two-stage ring of (q, do) and of (lse, d) [64] fp32 each
  return 6 * (size_t)Tile<D>::ELEMS * sizeof(bf16) + 2 * 2 * 64 * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, D == 64 ? 3 : 2)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec,
                         const int* __restrict__ k_lengths,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                         int Sq, int Sk, float scale, int causal) {
  constexpr int LD = Tile<D>::LD, TILE = Tile<D>::ELEMS;
  constexpr int KC = D / 16;
  constexpr int SUB = 16;  // queries a sub-block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + TILE;
  bf16* ring = v_s + TILE;  // stage s: q at ring + 2 s TILE, do after it
  float* vec_ring = reinterpret_cast<float*>(ring + 4 * TILE);  // [2][lse, d][64]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Lanes ln(lane);

  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* dob = dout + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;
  const float* lse_b = lse + (size_t)bh * Sq;
  const float* d_b = dvec + (size_t)bh * Sq;

  const int klen = max(0, min(Sk, k_lengths[b]));
  const int offset = Sk - Sq;
  // first query tile holding a row that sees key k0: i >= k0 - offset
  const int q_begin = causal ? max(0, k0 - offset) / BQ * BQ : 0;
  // no visible key in this tile: no tile is walked and zeros are written
  const int q_end = k0 < klen ? Sq : 0;
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + BQ - 1) / BQ : 0;

  // the q, do, lse and d rows of query tile q0 into ring stage `st`
  auto copy_q_tile = [&](int st, int q0) {
    bf16* dst = ring + st * 2 * TILE;
    copy_tile<D>(dst, qb, q0, Sq, tid);
    copy_tile<D>(dst + TILE, dob, q0, Sq, tid);
    const int r = tid & 63;  // threads 0-63 copy lse, 64-127 d
    const bool live = q0 + r < Sq;
    cp4(vec_ring + st * 128 + tid, (tid < 64 ? lse_b : d_b) +
                                       (live ? q0 + r : 0), live);
  };

  if (n_tiles > 0) {
    copy_tile<D>(k_s, kb, k0, klen, tid);
    copy_tile<D>(v_s, vb, k0, klen, tid);
    copy_q_tile(0, q_begin);
    cp_commit();
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // this thread's key rows of the warp's 16: key0 (g) and key0 + 8 (g + 8)
  const int key0 = k0 + warp * 16 + g;
  // the warp's K and V rows as A fragments, loaded once the first tile has
  // landed: they are the same for every query tile
  const unsigned k_a = smem_addr(k_s + (warp * 16 + ln.a_row) * LD + ln.a_col);
  const unsigned v_a = smem_addr(v_s + (warp * 16 + ln.a_row) * LD + ln.a_col);
  unsigned ka[KC][4], va[KC][4];

  for (int it = 0; it < n_tiles; ++it) {
    cp_wait_all();
    __syncthreads();
    if (it + 1 < n_tiles) {
      copy_q_tile((it + 1) & 1, q_begin + (it + 1) * BQ);
      cp_commit();
    }
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        ldsm_x4(ka[kc], k_a + kc * CHUNK_BYTES);
        ldsm_x4(va[kc], v_a + kc * CHUNK_BYTES);
      }
    }
    const bf16* q_t = ring + (it & 1) * 2 * TILE;
    const bf16* do_t = q_t + TILE;
    const float* lse_t = vec_ring + (it & 1) * 128;
    const float* d_t = lse_t + 64;
    const int q0 = q_begin + it * BQ;

#pragma unroll
    for (int sub = 0; sub < BQ; sub += SUB) {
      // S^T = K Q^T and dP^T = V dO^T: rows are the warp's keys, columns
      // this sub-block's queries
      float st[SUB / 8][4], dpt[SUB / 8][4];
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
        for (int np = 0; np < SUB / 16; ++np) {
          const int off = (sub + np * 16 + ln.b_row) * LD + kc * 16 + ln.b_col;
          unsigned qf[4], of[4];
          ldsm_x4(qf, smem_addr(q_t + off));
          ldsm_x4(of, smem_addr(do_t + off));
          mma_bf16_16816(st[2 * np], ka[kc], qf[0], qf[1]);
          mma_bf16_16816(st[2 * np + 1], ka[kc], qf[2], qf[3]);
          mma_bf16_16816(dpt[2 * np], va[kc], of[0], of[1]);
          mma_bf16_16816(dpt[2 * np + 1], va[kc], of[2], of[3]);
        }
      }
      // P^T and dS^T: element e of n-tile j is key key0 + 8 (e / 2), query
      // column sub + 8 j + 2 t + e % 2; dS^T from the unrounded P^T
      float dst[SUB / 8][4];
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = key0 + 8 * (e >> 1);
          const int col = sub + 8 * j + 2 * t + (e & 1);
          const int qi = q0 + col;
          const bool ok = kj < klen && qi < Sq &&
                          (!causal || kj <= qi + offset);
          const float p = ok ? expf(st[j][e] * scale - lse_t[col]) : 0.f;
          dst[j][e] = p * (dpt[j][e] - d_t[col]) * scale;
          st[j][e] = p;
        }
      }
      // dV += P^T dO, dK += dS^T Q, 16 queries at a time: P^T rounds to
      // dO's dtype and dS^T to Q's as they are packed into A
#pragma unroll
      for (int kq = 0; kq < SUB / 16; ++kq) {
        unsigned pa[4], dsa[4];
        pack_a(pa, st[2 * kq], st[2 * kq + 1]);
        pack_a(dsa, dst[2 * kq], dst[2 * kq + 1]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          const int off = (sub + kq * 16 + ln.a_row) * LD + np * 16 + ln.a_col;
          unsigned of[4], qf[4];
          ldsm_x4_t(of, smem_addr(do_t + off));
          ldsm_x4_t(qf, smem_addr(q_t + off));
          mma_bf16_16816(dv_acc[2 * np], pa, of[0], of[1]);
          mma_bf16_16816(dv_acc[2 * np + 1], pa, of[2], of[3]);
          mma_bf16_16816(dk_acc[2 * np], dsa, qf[0], qf[1]);
          mma_bf16_16816(dk_acc[2 * np + 1], dsa, qf[2], qf[3]);
        }
      }
    }
  }

  // dK and dV round once, at their stores
  bf16* dkb = dk + (size_t)bh * Sk * D;
  bf16* dvb = dv + (size_t)bh * Sk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = key0 + 8 * h;
    if (r >= Sk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const size_t at = (size_t)r * D + 8 * n + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dkb + at) =
          __floats2bfloat162_rn(dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + at) =
          __floats2bfloat162_rn(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Opts `kernel` into `smem` bytes of dynamic shared memory and launches it
// on a (tiles, B * H) grid.  A refused attribute also sets the thread's last
// error, which is cleared so that it does not surface at a later launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int tiles, int BH, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<dim3(tiles, BH), threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* dvec,
              const int* kl, float* dq, int B, int H, int Sq, int Sk,
              float scale, int causal, cudaStream_t st) {
  return launch(flash_bwd_dq_kernel<D>, (Sq + BQ - 1) / BQ, B * H, THREADS,
                dq_smem_floats<D>() * sizeof(float), st, q, k, v, dout, lse,
                dvec, kl, dq, H, Sq, Sk, scale, causal);
}

template <int D>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
              const float* lse, const float* dvec, const int* kl, bf16* dq,
              int B, int H, int Sq, int Sk, float scale, int causal,
              cudaStream_t st) {
  return launch(flash_bwd_dq_mma_kernel<D>, (Sq + BQ - 1) / BQ, B * H,
                MMA_THREADS, dq_mma_smem_bytes<D>(), st, q, k, v, dout, lse,
                dvec, kl, dq, H, Sq, Sk, scale, causal);
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* dvec,
               const int* kl, float* dk, float* dv, int B, int H, int Sq,
               int Sk, float scale, int causal, cudaStream_t st) {
  return launch(flash_bwd_dkv_kernel<D>, (Sk + BK - 1) / BK, B * H, THREADS,
                dkv_smem_floats<D>() * sizeof(float), st, q, k, v, dout, lse,
                dvec, kl, dk, dv, H, Sq, Sk, scale, causal);
}

template <int D>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               const float* lse, const float* dvec, const int* kl, bf16* dk,
               bf16* dv, int B, int H, int Sq, int Sk, float scale,
               int causal, cudaStream_t st) {
  return launch(flash_bwd_dkv_mma_kernel<D>, (Sk + BK - 1) / BK, B * H,
                MMA_THREADS, dkv_mma_smem_bytes<D>(), st, q, k, v, dout, lse,
                dvec, kl, dk, dv, H, Sq, Sk, scale, causal);
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
      return launch_dq<64>(q, k, v, dout, lse, dvec, k_lengths, dq, B, H, Sq,
                           Sk, scale, causal, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, dvec, k_lengths, dq, B, H,
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
      return launch_dkv<64>(q, k, v, dout, lse, dvec, k_lengths, dk, dv, B, H,
                            Sq, Sk, scale, causal, st);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, dvec, k_lengths, dk, dv, B,
                             H, Sq, Sk, scale, causal, st);
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
