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
// fp32 only: split-TF32 tensor-core tiles.  One pass of TF32 (operands
// rounded to 10 mantissa bits) would put dQ, dK and dV 4e-4 to 8e-4 of
// max(1, max |plain|) off the fp32 result, beyond the 1e-4 gate.  So every
// fp32 operand (Q, K, V and dO, and P and dS, which are built in registers)
// is split into its tf32 big and small parts and each product runs as three
// TF32 products, small terms first (tf32_split.cuh, shared with the fp32
// forward).  The five products are S = Q K^T and dP = dO V^T in both
// kernels, dQ = dS K, dK = dS^T Q and dV = P^T dO.  Only the order of the
// fp32 sums moves against the plain version; the split is the one
// tests/tf32_split.py models on the CPU.
// Bound on an H100: at the training shape (S 256, D 64) the bytes (Q, K,
// V, dO, lse, D read once; dQ, or dK and dV, written once) over 3.35 TB/s
// lead the three TF32 products a multiply over 494.7 TFLOP/s (dq 6*D
// flops a visible pair, dkv 8*D) by about a fifth; the FMA bound of the
// earlier design (the same flops once over 67 TFLOP/s) is about twice
// either.  mma.sync reaches about 63% of the dense TF32 rate on this card,
// and each split takes five integer and float instructions, so in practice
// the issue of the split, the fragment loads and the exp work between the
// products, not the bytes, bounds the kernels.  The design is the bf16
// kernels' skeleton, below, with these changes:
//   - 128 threads, four warps; each warp owns 16 rows of the block's 64-row
//     tile and their fp32 accumulators in registers;
//   - the block's own tiles (Q and dO in dq, K and V in dkv) stay in shared
//     memory, raw, and each warp splits its own A fragments of them; the
//     walked ones (K, V in dq; Q, dO, lse, D in dkv) pass through a
//     two-stage cp.async ring of 32-row tiles, the next tile's copies in
//     flight under the current tile's products; rows past Sq or klen are
//     zero-filled.  Once a walked tile has landed, each thread splits the
//     16-byte pieces it copied, big in place and small beside it, so that
//     the four warps read both parts and the tile is split once, not once
//     a warp (it took 6% off dkv and nothing off dq, where a warp splits
//     more of its own rows);
//   - fp32 tiles are [rows][D + 4], so that fragments read by row and by
//     column pairs are both free of bank conflicts, and P and dS go from
//     the accumulators into A fragments by permuting the k index, with no
//     shuffle and no trip through shared memory (tf32_split.cuh);
//   - dkv computes S^T = K Q^T and dP^T = V dO^T, as the bf16 dkv does, so
//     P^T and dS^T land in the accumulators of the warp that owns those keys;
//   - dkv takes the walked tile in sub-blocks (F32Cfg) so that S^T, dP^T
//     and the accumulators stay in registers with no spills: 162 registers
//     a thread for dq and 198 for dkv at head_dim 64, 208 and 255 at 128.
//     Shared memory is 104,448 bytes a block for dq and 104,960 for dkv at
//     head_dim 64 (two blocks an SM), 202,752 and 203,264 at 128 (one);
//   - the grid is (B * H, tiles), and dq takes its query tiles last first:
//     under a causal mask the blocks that walk the most tiles (dq's last
//     query tile, dkv's first key tile) go out first, and the short ones
//     fill the tail.
// wgmma is not used: it takes tf32 operands only K-major, and K (in S and
// in dS K) and Q and dO (in dkv) are read both ways, so each would need a
// transposed copy in shared memory.
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

#include "tf32_split.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// cp.async of 4 bytes (the rest is in tf32_split.cuh)
// ---------------------------------------------------------------------------

// 4 bytes global -> shared, zero-filled when !live
__device__ __forceinline__ void cp4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

// ---------------------------------------------------------------------------
// fp32: split-TF32 tensor-core tiles
// ---------------------------------------------------------------------------

// Rows of a walked fp32 tile (keys in dq, queries in dkv); dq takes a
// walked tile as one sub-block
constexpr int F32_WALK = 32;

// The fp32 kernels' shapes by head dim: rows of a dkv sub-block (S^T, dP^T
// and the accumulators live in registers together) and the blocks an SM
// the kernels are compiled for.
template <int D>
struct F32Cfg;
template <>
struct F32Cfg<64> {
  static constexpr int DKV_SUB = 32, BLOCKS = 2;
};
template <>
struct F32Cfg<128> {
  static constexpr int DKV_SUB = 8, BLOCKS = 1;
};

template <int D>
constexpr size_t dq_tf32_smem_bytes() {
  // q, do [64]; a two-stage ring of (k, k small, v, v small) [F32_WALK]
  return (2 * 64 + 8 * F32_WALK) * (size_t)f32_ld<D>() * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, F32Cfg<D>::BLOCKS)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec,
                         const int* __restrict__ k_lengths,
                         float* __restrict__ dq, int H, int Sq, int Sk,
                         float scale, int causal) {
  constexpr int LD = f32_ld<D>(), WK = F32_WALK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* do_s = q_s + BQ * LD;
  // stage s of the ring: k, k small, v, v small at ring + (4 s + i) WK LD
  float* ring = do_s + BQ * LD;

  // grid (B * H, query tiles), the last query tile first: under a causal
  // mask it walks the most keys, so the longest blocks go out first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const float* qb = q + (size_t)bh * Sq * D;
  const float* dob = dout + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;

  const int klen = max(0, min(Sk, k_lengths[b]));
  const int offset = Sk - Sq;  // bottom-right causal alignment
  int k_end = klen;
  if (causal) k_end = min(k_end, q0 + BQ + offset);
  const int n_tiles = k_end > 0 ? (k_end + WK - 1) / WK : 0;

  if (n_tiles > 0) {
    copy_tile_f32<D, BQ>(q_s, qb, q0, Sq, tid);
    copy_tile_f32<D, BQ>(do_s, dob, q0, Sq, tid);
    copy_tile_f32<D, WK>(ring, kb, 0, klen, tid);
    copy_tile_f32<D, WK>(ring + 2 * WK * LD, vb, 0, klen, tid);
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

  // (g, t) of the warp's Q and dO rows
  const float* q_w = q_s + (warp * 16 + g) * LD + t;
  const float* do_w = do_s + (warp * 16 + g) * LD + t;

  for (int it = 0; it < n_tiles; ++it) {
    float* k_t = ring + (it & 1) * 4 * WK * LD;
    float* ks_t = k_t + WK * LD;
    float* v_t = ks_t + WK * LD;
    float* vs_t = v_t + WK * LD;
    // this thread's copies of tile it have landed: split them; then the
    // whole tile is split, and every warp is done with the stage tile it + 1
    // goes to
    cp_wait_all();
    split_tile_f32<D, WK>(k_t, ks_t, tid);
    split_tile_f32<D, WK>(v_t, vs_t, tid);
    __syncthreads();
    if (it + 1 < n_tiles) {
      float* nxt = ring + ((it + 1) & 1) * 4 * WK * LD;
      copy_tile_f32<D, WK>(nxt, kb, (it + 1) * WK, klen, tid);
      copy_tile_f32<D, WK>(nxt + 2 * WK * LD, vb, (it + 1) * WK, klen, tid);
      cp_commit();
    }
    const int k0 = it * WK;

    // S = Q K^T and dP = dO V^T over the tile's keys
    float s[WK / 8][4], dp[WK / 8][4];
#pragma unroll
    for (int j = 0; j < WK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 8; ++kc) {
      FragA qa, da;
      load_a<LD>(qa, q_w + kc * 8);
      load_a<LD>(da, do_w + kc * 8);
#pragma unroll
      for (int j = 0; j < WK / 8; ++j) {
        // (k d, n key): rows g of the key block, columns t and t + 4
        const int off = (8 * j + g) * LD + kc * 8 + t;
        FragB kf, vf;
        load_b(kf, k_t, ks_t, off, 4);
        load_b(vf, v_t, vs_t, off, 4);
        mma3(s[j], qa, kf);
        mma3(dp[j], da, vf);
      }
    }
    // P and dS in the accumulators: element e of n-tile j is query row
    // row0 + 8 (e / 2), key k0 + 8 j + 2 t + e % 2
#pragma unroll
    for (int j = 0; j < WK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qi = row0 + 8 * h;
        const int kj = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = kj < klen && (!causal || kj <= qi + offset);
        const float p = ok ? expf(s[j][e] * scale - row_lse[h]) : 0.f;
        s[j][e] = p * (dp[j][e] - row_d[h]) * scale;  // dS
      }
    }
    // dQ += dS K, 8 keys a k step: slot t is key 2t, slot t + 4 key 2t + 1
#pragma unroll
    for (int j = 0; j < WK / 8; ++j) {
      FragA dsa;
      acc_to_a(dsa, s[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int off = (8 * j + 2 * t) * LD + 8 * n + g;
        FragB kf;
        load_b(kf, k_t, ks_t, off, LD);
        mma3(acc[n], dsa, kf);
      }
    }
  }

  float* dqb = dq + (size_t)bh * Sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    if (r >= Sq) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dqb + (size_t)r * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

template <int D>
constexpr size_t dkv_tf32_smem_bytes() {
  // k, v [64]; a two-stage ring of (q, q small, do, do small) [F32_WALK]
  // and of (lse, d) [F32_WALK]
  constexpr int WQ = F32_WALK;
  return (2 * 64 + 8 * WQ) * (size_t)f32_ld<D>() * sizeof(float) +
         2 * 2 * WQ * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, F32Cfg<D>::BLOCKS)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec,
                          const int* __restrict__ k_lengths,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int Sq, int Sk, float scale, int causal) {
  constexpr int LD = f32_ld<D>(), WQ = F32_WALK;
  constexpr int SUB = F32Cfg<D>::DKV_SUB;  // queries a sub-block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = k_s + BK * LD;
  // stage s of the ring: q, q small, do, do small at ring + (4 s + i) WQ LD
  float* ring = v_s + BK * LD;
  float* vec_ring = ring + 8 * WQ * LD;  // [2][lse, d][WQ]

  // grid (B * H, key tiles), the first key tile first: under a causal mask
  // it walks the most queries, so the longest blocks go out first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const float* qb = q + (size_t)bh * Sq * D;
  const float* dob = dout + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;
  const float* lse_b = lse + (size_t)bh * Sq;
  const float* d_b = dvec + (size_t)bh * Sq;

  const int klen = max(0, min(Sk, k_lengths[b]));
  const int offset = Sk - Sq;
  // first query tile holding a row that sees key k0: i >= k0 - offset
  const int q_begin = causal ? max(0, k0 - offset) / WQ * WQ : 0;
  // no visible key in this tile: no tile is walked and zeros are written
  const int q_end = k0 < klen ? Sq : 0;
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + WQ - 1) / WQ : 0;

  // the q, do, lse and d rows of query tile q0 into ring stage `st`
  auto copy_q_tile = [&](int st, int q0) {
    float* dst = ring + st * 4 * WQ * LD;
    copy_tile_f32<D, WQ>(dst, qb, q0, Sq, tid);
    copy_tile_f32<D, WQ>(dst + 2 * WQ * LD, dob, q0, Sq, tid);
    if (tid < 2 * WQ) {  // threads 0 to WQ - 1 copy lse, the next WQ d
      const int r = tid % WQ;
      const bool live = q0 + r < Sq;
      cp4(vec_ring + st * 2 * WQ + tid,
          (tid < WQ ? lse_b : d_b) + (live ? q0 + r : 0), live);
    }
  };

  if (n_tiles > 0) {
    copy_tile_f32<D, BK>(k_s, kb, k0, klen, tid);
    copy_tile_f32<D, BK>(v_s, vb, k0, klen, tid);
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
  // (g, t) of the warp's K and V rows
  const float* k_w = k_s + (warp * 16 + g) * LD + t;
  const float* v_w = v_s + (warp * 16 + g) * LD + t;

  for (int it = 0; it < n_tiles; ++it) {
    float* q_t = ring + (it & 1) * 4 * WQ * LD;
    float* qs_t = q_t + WQ * LD;
    float* do_t = qs_t + WQ * LD;
    float* dos_t = do_t + WQ * LD;
    cp_wait_all();
    split_tile_f32<D, WQ>(q_t, qs_t, tid);
    split_tile_f32<D, WQ>(do_t, dos_t, tid);
    __syncthreads();
    if (it + 1 < n_tiles) {
      copy_q_tile((it + 1) & 1, q_begin + (it + 1) * WQ);
      cp_commit();
    }
    const float* lse_t = vec_ring + (it & 1) * 2 * WQ;
    const float* d_t = lse_t + WQ;
    const int q0 = q_begin + it * WQ;

#pragma unroll 1
    for (int sub = 0; sub < WQ; sub += SUB) {
      // S^T = K Q^T and dP^T = V dO^T: rows are the warp's keys, columns
      // this sub-block's queries
      float st[SUB / 8][4], dpt[SUB / 8][4];
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 8; ++kc) {
        FragA ka, va;
        load_a<LD>(ka, k_w + kc * 8);
        load_a<LD>(va, v_w + kc * 8);
#pragma unroll
        for (int j = 0; j < SUB / 8; ++j) {
          const int off = (sub + 8 * j + g) * LD + kc * 8 + t;
          FragB qf, of;
          load_b(qf, q_t, qs_t, off, 4);
          load_b(of, do_t, dos_t, off, 4);
          mma3(st[j], ka, qf);
          mma3(dpt[j], va, of);
        }
      }
      // P^T and dS^T: element e of n-tile j is key key0 + 8 (e / 2), query
      // column sub + 8 j + 2 t + e % 2
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
          dpt[j][e] = p * (dpt[j][e] - d_t[col]) * scale;  // dS^T
          st[j][e] = p;                                    // P^T
        }
      }
      // dV += P^T dO, dK += dS^T Q, 8 queries a k step: slot t is query
      // 2t, slot t + 4 query 2t + 1
#pragma unroll
      for (int j = 0; j < SUB / 8; ++j) {
        FragA pa, dsa;
        acc_to_a(pa, st[j]);
        acc_to_a(dsa, dpt[j]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const int off = (sub + 8 * j + 2 * t) * LD + 8 * n + g;
          FragB of, qf;
          load_b(of, do_t, dos_t, off, LD);
          load_b(qf, q_t, qs_t, off, LD);
          mma3(dv_acc[n], pa, of);
          mma3(dk_acc[n], dsa, qf);
        }
      }
    }
  }

  float* dkb = dk + (size_t)bh * Sk * D;
  float* dvb = dv + (size_t)bh * Sk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = key0 + 8 * h;
    if (r >= Sk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const size_t at = (size_t)r * D + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(dkb + at) =
          make_float2(dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
      *reinterpret_cast<float2*>(dvb + at) =
          make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr unsigned CHUNK_BYTES = 16 * sizeof(bf16);  // a 16-deep k chunk

// A [64][D + 8] bf16 tile: rows padded by 16 bytes
template <int D>
struct Tile {
  static constexpr int LD = D + 8;
  static constexpr int ELEMS = 64 * LD;
};

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
// on `grid`.  A refused attribute also sets the thread's last error, which
// is cleared so that it does not surface at a later launch.
template <typename Kernel, typename... Args>
int launch_on(Kernel kernel, dim3 grid, int threads, size_t smem,
              cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// launch_on a (tiles, B * H) grid
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int tiles, int BH, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  return launch_on(kernel, dim3(tiles, BH), threads, smem, stream, args...);
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* dvec,
              const int* kl, float* dq, int B, int H, int Sq, int Sk,
              float scale, int causal, cudaStream_t st) {
  return launch_on(flash_bwd_dq_tf32_kernel<D>,
                   dim3(B * H, (Sq + BQ - 1) / BQ), MMA_THREADS,
                   dq_tf32_smem_bytes<D>(), st, q, k, v, dout, lse, dvec, kl,
                   dq, H, Sq, Sk, scale, causal);
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
  return launch_on(flash_bwd_dkv_tf32_kernel<D>,
                   dim3(B * H, (Sk + BK - 1) / BK), MMA_THREADS,
                   dkv_tf32_smem_bytes<D>(), st, q, k, v, dout, lse, dvec, kl,
                   dk, dv, H, Sq, Sk, scale, causal);
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
