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
// Both kernels walk the keys below the block's last visible one, min(klen,
// q0 + 64 + Sk - Sq) when causal and klen otherwise: a fully masked tile
// leaves m, l and the accumulator as they are (corr = 1, p = 0), so walking
// fewer of them changes nothing.  The ragged edges (S not a multiple of a
// tile) are masked in the kernel; nothing is padded in device memory.  The
// two element types run two designs.
//
// fp32 only: split-TF32 tensor-core tiles.  One TF32 product a multiply
// (operands rounded to 10 mantissa bits) puts the output several times the
// fp32 gate of 1e-4 * max(1, max |plain|) off the fp32 result, and two (one
// operand's small part dropped) still put it outside the gate
// (tests/test_torch_flash_fwd_tf32.py, chip_smoke.py's bwd_parity).  So
// Q, K, V and P (built in registers) are split into their tf32 big and
// small parts and each of the two products, S = Q K^T and O += P V, runs as
// three TF32 products on mma.sync.m16n8k8, small terms first (tf32_split.cuh,
// shared with the fp32 backward); only the order of the fp32 sums moves
// against the plain version.  In fp32 the key tile moves nothing but that
// order (no value is rounded to a narrower type against the running max),
// so the walked tile is sized for the card.
// Bound on an H100: at the training shape (B 32, H 8, S 256, D 64, causal)
// the bytes (Q, K, V read once, O and lse written once, over 3.35 TB/s)
// lead the three TF32 products (3 * 4*D flops a visible pair over 494.7
// TFLOP/s) by about half; the FMA bound of the earlier design (4*D flops
// once over 67 TFLOP/s) is about 1.6 times the bytes'.  In practice no one
// resource bounds the kernel: dropping one of the three products a
// multiply (the planted fault of probe_kernel_variants.py) takes only a
// seventh off its time, the tensor pipe runs well under mma.sync's own
// rate, and the fragment loads, the split of the walked tiles and the wait
// for their copies each hold a share.  The design is the fp32 backward's
// dq kernel with dP and dS taken out and the online softmax put in:
//   - one block per (b*h, 64-query tile), 128 threads: four warps, each
//     owning 16 query rows, their fp32 accumulators (16 x D) and their
//     running m (unscaled: scale * max S is the max of the scaled scores)
//     and l (this thread's share of the row sum) in registers; the four
//     lanes of a row reduce their max with two xor shuffles per tile and
//     their sums once, at the end;
//   - the block's Q tile is copied once and split once, in shared memory; at
//     head_dim 64 each warp then keeps its split A fragments in registers
//     for the whole walk (FwdCfg::Q_REGS), at 128 it reads them from the
//     split tile at each use;
//   - K and V pass through a two-stage cp.async ring of [WALK][D + 4]
//     tiles, the next tile's copies in flight under the current tile's
//     products; rows past klen are zero-filled, and each thread splits the
//     16-byte pieces it copied, once per block.  At head_dim 64 the tiles
//     are 16 keys and three blocks share an SM (69,632 bytes of shared
//     memory and at most 168 registers a thread), at 128 they are 32 keys,
//     one block (202,752 bytes);
//   - S's three products go to three accumulators (mma3_apart), each a
//     chain of D / 8 mma.sync, summed as (small·big + big·small) +
//     big·big; S becomes P in place, and acc_to_a turns it into the A
//     fragment of O += P V with k slot t as key 2t, so the V fragment reads
//     rows 2t and 2t + 1: nothing score-shaped goes through shared memory;
//   - exp is the bare MUFU.EX2 (ex2_approx) of one FFMA with scale *
//     log2(e) folded in;
//   - a warp skips the 8-key n-tiles past its rows' last visible key (a
//     tile it sees none of leaves m, l and acc as they are); only n-tiles
//     that cross a row's frontier or klen are masked;
//   - grid (B * H, query tiles), the last query tile first: under a causal
//     mask the blocks that walk the most keys go out first.
// wgmma was tried for S (Q and K split and 128-byte swizzled in shared
// memory, m64n32k8): waited at once it ran within a few per cent of
// mma.sync, and issued a tile ahead under the softmax and P V it ran
// slower and spilled at head_dim 128; P V cannot take it (tf32 operands
// must be K-major, and V is read down its rows).  lse = scale m + log l in
// fp32; the tensor cores' order of the score sums moves an lse near 0 by a
// larger share of itself than elsewhere, which the fp32 gate (absolute, on
// max(1, max |lse|)) allows; the bf16 kernel's in-order re-sum
// (lse_in_order, below) is not needed by any fp32 gate.
//
// bf16 only: tensor-core tiles over the TPU kernel's 128-key tile.  The bf16
// arithmetic of the TPU kernel is what mma.sync.m16n8k16 with bf16 operands
// and fp32 accumulators computes: exact products summed in fp32.  Its
// rounding points are kept, and only those: the running max moves once per
// 128-key tile from key 0, as the TPU kernel's does with its min(128, Sk) key
// block (flash_attention.py:343, :353-354).  So for each tile S = Q K^T is
// formed, masked and reduced to its row max over all the tile's keys before
// any P of the tile exists; then m_new = max(m, tile max), corr =
// exp(scale (m - m_new)), l = corr * l + sum p over the UNROUNDED p (:172)
// and acc *= corr, in fp32; P = exp(scale S - scale m_new) rounds to V's
// dtype as it is packed into the PV product's A fragment, which is the TPU
// kernel's p.astype(v.dtype) (:173); the output is acc / max(l, 1e-30),
// rounded once at the store (:181); lse = scale m + log l stays fp32
// (:185-188).  m is kept on the unscaled scores: rounding is monotone, so
// scale * max S is exactly the max of the scaled scores the TPU kernel takes.
// exp(x) is evaluated as exp2f of one FFMA with scale * log2(e) folded in:
// an fp32 detail that moves no rounding point (on the card the share of
// outputs not bit-equal to the plain version stays below 1e-3, as expf's).
// Bound on an H100: at the training shape (B 32, H 8, S 256, D 64, causal)
// the bytes (Q, K, V read once, O written once) over 3.35 TB/s lead the bf16
// flops over 989 TFLOP/s by about 3x; in practice the kernel is bound by
// latency: each warp's tile is a chain of products, a row reduction, the
// exponentials and more products, and the register file (S alone is 64
// fp32 a thread) caps the warps an SM holds.  The design:
//   - one block per (b*h, 64-query tile), 128 threads: four warps, each
//     owning 16 query rows, their fp32 accumulators (16 x D) and their
//     running m and l in registers (168 registers a thread at head_dim 64,
//     three blocks an SM; 253 at 128, two);
//   - bf16 tiles in shared memory (Q [64], K [128], V [128] rows, each row
//     padded by 8 elements so that the eight 16-byte row reads of every
//     ldmatrix fall in distinct banks), filled by cp.async, 16 bytes a thread
//     a copy; rows past Sq or the block's last visible key are zero-filled
//     (src-size 0), since garbage bf16 can be Inf or NaN and 0 * NaN would
//     poison a whole accumulator row.  46 KB a block at head_dim 64, 87 KB
//     at 128;
//   - K and V have one buffer each and two barriers a tile: after the first,
//     which also says that every warp is done with the previous V tile, V
//     tile it is issued and lands under S and the softmax; after the second,
//     which also says that every warp is done with K tile it, K tile it + 1
//     is issued and lands under the PV product;
//   - S for the warp's 16 rows over the 128 keys is 16 m16n8 accumulator
//     tiles (64 fp32 a thread), the d sum outermost so that consecutive
//     products go to different accumulators; Q's A fragments come from
//     shared memory per 16-deep chunk, K is the untransposed B operand
//     (ldmatrix); P, packed chunk by chunk as it is formed, is the m16k16 A
//     fragment of O += P V, V the B operand by ldmatrix.trans; nothing
//     score-shaped goes through shared memory;
//   - a warp skips the 16-key chunks past its own last visible key (fully
//     masked for its rows: p = 0 exactly, and the keys below are finite); a
//     tile the warp sees whole runs unguarded product loops, and only the
//     chunks that cross a row's frontier or klen are masked;
//   - lse near 0.  Where |lse| < max(1, |scale m|) / 2 the relative error of
//     lse is the scores' rounding magnified by |scale m| / |lse|, and the
//     tensor cores sum each score in another order than an fp32 matmul (the
//     plain version's) does, enough to move such an lse by more than 1e-5
//     relative.  The epilogue sums such a row again
//     (lse_in_order): each visible score by an fp32 FMA chain in d order, the
//     exponentials in fp64.  Only lse changes; such rows are rare (a causal
//     row with few keys and small or negative scores), so it costs little.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32_split.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// fp32: split-TF32 tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int BQ = 64;  // query rows per block, 16 a warp

// The fp32 kernel's shapes by head dim: keys a walked tile, whether each
// warp keeps its split Q fragments in registers for the whole walk (D / 8
// k steps x 8 registers) or reads them from the split Q tile each time, and
// the blocks an SM it is compiled for.
template <int D>
struct FwdCfg;
template <>
struct FwdCfg<64> {
  static constexpr int WALK = 16, BLOCKS = 3;
  static constexpr bool Q_REGS = true;
};
template <>
struct FwdCfg<128> {
  static constexpr int WALK = 32, BLOCKS = 1;
  static constexpr bool Q_REGS = false;
};

template <int D>
constexpr size_t fwd_tf32_smem_bytes() {
  // q, q small [BQ]; a two-stage ring of (k, k small, v, v small) [WALK]
  return (2 * BQ + 8 * FwdCfg<D>::WALK) * (size_t)f32_ld<D>() * sizeof(float);
}

// 2^x by the bare MUFU.EX2 (ex2.approx.ftz, relative error below 2^-22):
// exp2f adds range fix-ups that no argument here needs (a masked score's
// argument, <= -5e29 scale log2(e), still gives exactly 0)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The three products of mma3, each into its own accumulator: c1 +=
// small·big, c2 += big·small, c3 += big·big.  Three chains of dependent
// mma.sync where mma3 makes one three times as long.
__device__ __forceinline__ void mma3_apart(float (&c1)[4], float (&c2)[4],
                                           float (&c3)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32_1688(c1, a.small, b.big[0], b.big[1]);
  mma_tf32_1688(c2, a.big, b.small[0], b.small[1]);
  mma_tf32_1688(c3, a.big, b.big[0], b.big[1]);
}

// S = Q K^T over the first nj 8-key n-tiles of a split K tile (all of them
// when FULL) for the warp's 16 query rows: qf holds the split Q fragments
// when Q_REGS, else they are read from the split Q tile (q_s, qs_s) at
// q_off, (g, t) of the warp's rows.  k_off is (g, t) of the tile.  The
// three products of each multiply go to three accumulators, summed at the
// end as (small·big + big·small) + big·big: an accumulator of one n-tile
// is a chain of D / 8 products, not 3 D / 8.
template <int D, bool FULL, int QN>
__device__ __forceinline__ void qk_tf32(float (&s)[FwdCfg<D>::WALK / 8][4],
                                        const FragA (&qf)[QN],
                                        const float* q_s, const float* qs_s,
                                        int q_off, const float* k_t,
                                        const float* ks_t, int k_off, int nj) {
  constexpr int LD = f32_ld<D>(), NJ = FwdCfg<D>::WALK / 8;
  float s1[NJ][4], s2[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s1[j][e] = s2[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 8; ++kc) {
    FragA qa;
    if constexpr (FwdCfg<D>::Q_REGS) {
      qa = qf[kc];
    } else {
      load_a_split<LD>(qa, q_s, qs_s, q_off + kc * 8);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (FULL || j < nj) {
        FragB kf;
        load_b(kf, k_t, ks_t, k_off + 8 * j * LD + kc * 8, 4);
        mma3_apart(s1[j], s2[j], s[j], qa, kf);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = (s1[j][e] + s2[j][e]) + s[j][e];
}

// acc += P V over the first nj 8-key n-tiles (all of them when FULL): P in
// the S accumulators becomes the A fragment with k slot t as key 2t, so the
// V fragment reads rows 2t and 2t + 1; v_off is (2t, g) of the tile.
template <int D, bool FULL>
__device__ __forceinline__ void pv_tf32(
    float (&acc)[D / 8][4], const float (&p)[FwdCfg<D>::WALK / 8][4],
    const float* v_t, const float* vs_t, int v_off, int nj) {
  constexpr int LD = f32_ld<D>(), NJ = FwdCfg<D>::WALK / 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (FULL || j < nj) {
      FragA pa;
      acc_to_a(pa, p[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        FragB vf;
        load_b(vf, v_t, vs_t, v_off + 8 * j * LD + 8 * n, LD);
        mma3(acc[n], pa, vf);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, FwdCfg<D>::BLOCKS)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int* __restrict__ k_lengths,
                      float* __restrict__ o, float* __restrict__ lse, int H,
                      int Sq, int Sk, float scale, int causal) {
  using Cfg = FwdCfg<D>;
  constexpr int LD = f32_ld<D>(), WK = Cfg::WALK, NJ = WK / 8;
  constexpr int QN = Cfg::Q_REGS ? D / 8 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* qs_s = q_s + BQ * LD;
  // stage s of the ring: k, k small, v, v small at ring + (4 s + i) WK LD
  float* ring = qs_s + BQ * LD;

  // grid (B * H, query tiles), the last query tile first: under a causal
  // mask it walks the most keys, so the longest blocks go out first
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // exp(scale x) = exp2(sc x)
  const float sc = scale * 1.44269504f;

  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)bh * Sk * D;
  const float* vb = v + (size_t)bh * Sk * D;

  const int klen = max(0, min(Sk, k_lengths[b]));
  const int offset = Sk - Sq;  // bottom-right causal alignment
  int k_end = klen;
  if (causal) k_end = min(k_end, q0 + BQ + offset);
  const int n_tiles = k_end > 0 ? (k_end + WK - 1) / WK : 0;
  // this warp's rows row_lo .. row_lo + 15 see every key below w_full and
  // none at or past w_end
  const int row_lo = q0 + warp * 16;
  int w_end = klen, w_full = klen;
  if (causal) {
    w_end = min(w_end, row_lo + 16 + offset);
    w_full = min(w_full, row_lo + 1 + offset);
  }

  if (n_tiles > 0) {
    copy_tile_f32<D, BQ>(q_s, qb, q0, Sq, tid);
    copy_tile_f32<D, WK>(ring, kb, 0, klen, tid);
    copy_tile_f32<D, WK>(ring + 2 * WK * LD, vb, 0, klen, tid);
    cp_commit();
  }

  // this thread's rows of the warp's 16: row0 (g) and row0 + 8 (g + 8)
  const int row0 = row_lo + g;
  float m[2] = {NEG_INF / 2, NEG_INF / 2};  // unscaled: scale * m is the max
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  FragA qf[QN];
  const int q_off = (warp * 16 + g) * LD + t;  // (g, t) of the warp's rows

  for (int it = 0; it < n_tiles; ++it) {
    float* k_t = ring + (it & 1) * 4 * WK * LD;
    float* ks_t = k_t + WK * LD;
    float* v_t = ks_t + WK * LD;
    float* vs_t = v_t + WK * LD;
    // this thread's copies of tile it (and of Q) have landed: split them;
    // then the whole tile is split, and every warp is done with the stage
    // tile it + 1 goes to
    cp_wait_all();
    if (it == 0) split_tile_f32<D, BQ>(q_s, qs_s, tid);
    split_tile_f32<D, WK>(k_t, ks_t, tid);
    split_tile_f32<D, WK>(v_t, vs_t, tid);
    __syncthreads();
    if (it + 1 < n_tiles) {
      float* nxt = ring + ((it + 1) & 1) * 4 * WK * LD;
      copy_tile_f32<D, WK>(nxt, kb, (it + 1) * WK, klen, tid);
      copy_tile_f32<D, WK>(nxt + 2 * WK * LD, vb, (it + 1) * WK, klen, tid);
      cp_commit();
    }
    if constexpr (Cfg::Q_REGS) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < QN; ++kc)
          load_a_split<LD>(qf[kc], q_s, qs_s, q_off + kc * 8);
      }
    }
    const int k0 = it * WK;
    // 8-key n-tiles of this tile that hold a key one of the warp's rows
    // sees; the others are fully masked for it (p = 0 exactly)
    const int nj = min(NJ, max(0, w_end - k0 + 7) / 8);
    if (nj == 0) continue;  // m, l and acc stay as they are
    const bool full = nj == NJ;

    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const int k_off = g * LD + t;
    if (full) {
      qk_tf32<D, true>(s, qf, q_s, qs_s, q_off, k_t, ks_t, k_off, nj);
    } else {
      qk_tf32<D, false>(s, qf, q_s, qs_s, q_off, k_t, ks_t, k_off, nj);
    }

    // mask the unscaled scores where an n-tile crosses a row's frontier or
    // klen (or lies past the warp's last live one) and take the row max.
    // Element e of n-tile j is query row row0 + 8 (e / 2), key k0 + 8 j +
    // 2 t + e % 2.
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (k0 + 8 * j + 8 > w_full) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = kj < klen &&
                          (!causal || kj <= row0 + 8 * (e >> 1) + offset);
          if (!ok) s[j][e] = NEG_INF;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
    // the four lanes t = 0..3 of a row hold its columns; with scale > 0,
    // scale * max S is the max of the scaled scores
    float corr[2], msc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = ex2_approx((m[h] - m_new) * sc);
      m[h] = m_new;
      msc[h] = m_new * sc;
    }
    // P = exp(scale S - scale m) in the S accumulators (masked: exp2(<=
    // -5e29 sc) = 0), l the sum of this thread's share
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (full || j < nj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = ex2_approx(fmaf(s[j][e], sc, -msc[e >> 1]));
          ls[e >> 1] += s[j][e];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * corr[h] + ls[h];
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * h] *= corr[h];
        acc[n][2 * h + 1] *= corr[h];
      }
    }

    const int v_off = 2 * t * LD + g;
    if (full) {
      pv_tf32<D, true>(acc, s, v_t, vs_t, v_off, nj);
    } else {
      pv_tf32<D, false>(acc, s, v_t, vs_t, v_off, nj);
    }
  }

  // the row sums over the four lanes
  float* ob = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = row0 + 8 * h;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(ob + (size_t)r * D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] / denom, acc[n][2 * h + 1] / denom);
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * Sq + r] =
          l[h] > 0.f ? __fmul_rn(m[h], scale) + logf(denom) : -NEG_INF;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int MQ = 64;             // query rows per block, 16 a warp
constexpr int KT = 128;            // keys a softmax tile: the TPU key block
constexpr int CHUNKS = KT / 16;    // 16-key chunks a tile
constexpr unsigned CHUNK_BYTES = 16 * sizeof(bf16);  // a 16-deep k chunk

template <int D>
constexpr size_t mma_smem_bytes() {
  // q [MQ], k [KT], v [KT] rows of D + 8 elements
  return (size_t)(MQ + 2 * KT) * (D + 8) * sizeof(bf16);
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

// Issues the 16-byte copies of rows [r0, r0 + ROWS) of a [S, D] bf16 matrix
// into a [ROWS][D + 8] shared tile; rows at or past `valid` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int r0,
                                          int valid, int tid) {
  constexpr int CPR = D / 8;  // copies a row
#pragma unroll
  for (int i = 0; i < ROWS * CPR / MMA_THREADS; ++i) {
    const int idx = tid + i * MMA_THREADS;
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const bool live = r0 + r < valid;
    cp16(dst + r * (D + 8) + c, src + (live ? (size_t)(r0 + r) * D + c : 0),
         live);
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

// S = Q K^T over the first nc 16-key chunks of a K tile (all of them when
// FULL), for the warp's 16 query rows whose A fragments start at q_a; the d
// sum is outermost, so consecutive products go to different accumulators.
template <int D, bool FULL>
__device__ __forceinline__ void qk_tile(float (&s)[2 * CHUNKS][4],
                                        unsigned q_a, const bf16* k_s, int nc,
                                        const Lanes& ln) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    unsigned qa[4];
    ldsm_x4(qa, q_a + kc * CHUNK_BYTES);
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      if (FULL || c < nc) {
        unsigned kf[4];
        ldsm_x4(kf, smem_addr(k_s + (c * 16 + ln.b_row) * (D + 8) + kc * 16 +
                              ln.b_col));
        mma_bf16_16816(s[2 * c], qa, kf[0], kf[1]);
        mma_bf16_16816(s[2 * c + 1], qa, kf[2], kf[3]);
      }
    }
  }
}

// acc += P V over the first nc 16-key chunks of a V tile (all of them when
// FULL), P given as the bf16 A fragment of each chunk.
template <int D, bool FULL>
__device__ __forceinline__ void pv_tile(float (&acc)[D / 8][4],
                                        const unsigned (&pa)[CHUNKS][4],
                                        const bf16* v_s, int nc,
                                        const Lanes& ln) {
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    if (FULL || c < nc) {
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        unsigned vf[4];
        ldsm_x4_t(vf, smem_addr(v_s + (c * 16 + ln.a_row) * (D + 8) +
                                np * 16 + ln.a_col));
        mma_bf16_16816(acc[2 * np], pa[c], vf[0], vf[1]);
        mma_bf16_16816(acc[2 * np + 1], pa[c], vf[2], vf[3]);
      }
    }
  }
}

// q . k over D bf16 elements (16-byte aligned rows), an fp32 FMA chain in
// d order
template <int D>
__device__ __forceinline__ float dot_in_order(const bf16* q, const bf16* k) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 qv = *reinterpret_cast<const uint4*>(q + 8 * c);
    const uint4 kv = *reinterpret_cast<const uint4*>(k + 8 * c);
    const bf16* qe = reinterpret_cast<const bf16*>(&qv);
    const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      s = fmaf(__bfloat162float(qe[e]), __bfloat162float(ke[e]), s);
  }
  return s;
}

// The lse of query row qr over its first n_vis keys, for a row whose lse
// lies near 0: there the relative error of lse is the scores' rounding
// magnified by |scale m| / |lse|, so each score is summed again by an fp32
// FMA chain in d order, as the plain version's matmul sums it, and the
// exponentials are summed in fp64.  The four lanes of the row (mask) split
// its keys.
template <int D>
__device__ __noinline__ float lse_in_order(const bf16* qr, const bf16* kb, int n_vis,
                              float scale, int t, unsigned mask) {
  float mx = NEG_INF;
  for (int j = t; j < n_vis; j += 4)
    mx = fmaxf(mx, dot_in_order<D>(qr, kb + (size_t)j * D));
  mx = fmaxf(mx, __shfl_xor_sync(mask, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(mask, mx, 2));
  const float ms = __fmul_rn(mx, scale);
  double sum = 0.0;
  for (int j = t; j < n_vis; j += 4)
    sum += exp((double)__fsub_rn(
        __fmul_rn(dot_in_order<D>(qr, kb + (size_t)j * D), scale), ms));
  sum += __shfl_xor_sync(mask, sum, 1);
  sum += __shfl_xor_sync(mask, sum, 2);
  return (float)((double)ms + log(sum));
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, D == 64 ? 3 : 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const int* __restrict__ k_lengths, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Sk,
                     float scale, int causal) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [MQ][LD]
  bf16* k_s = q_s + MQ * LD;                      // [KT][LD]
  bf16* v_s = k_s + KT * LD;                      // [KT][LD]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * MQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const Lanes ln(lane);
  // exp(scale x) = exp2(sc x)
  const float sc = scale * 1.44269504f;

  const bf16* qb = q + (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)bh * Sk * D;
  const bf16* vb = v + (size_t)bh * Sk * D;

  const int klen = max(0, min(Sk, k_lengths[b]));
  const int offset = Sk - Sq;  // bottom-right causal alignment
  int k_end = klen;
  if (causal) k_end = min(k_end, q0 + MQ + offset);
  const int n_tiles = k_end > 0 ? (k_end + KT - 1) / KT : 0;
  // this warp's rows row_lo .. row_lo + 15 see every key below w_full and
  // none at or past w_end
  const int row_lo = q0 + warp * 16;
  int w_end = klen, w_full = klen;
  if (causal) {
    w_end = min(w_end, row_lo + 16 + offset);
    w_full = min(w_full, row_lo + 1 + offset);
  }

  if (n_tiles > 0) {
    copy_rows<D, MQ>(q_s, qb, q0, Sq, tid);
    copy_rows<D, KT>(k_s, kb, 0, k_end, tid);
    cp_commit();
    copy_rows<D, KT>(v_s, vb, 0, k_end, tid);
    cp_commit();
  }

  // this thread's rows of the warp's 16: row0 (g) and row0 + 8 (g + 8)
  const int row0 = row_lo + g;
  float m[2] = {NEG_INF / 2, NEG_INF / 2};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const unsigned q_a =
      smem_addr(q_s + (warp * 16 + ln.a_row) * LD + ln.a_col);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KT;
    // 16-key chunks of this tile that hold a key one of the warp's rows sees
    const int nc = min(CHUNKS, max(0, w_end - k0 + 15) / 16);
    // K tile it (and Q) have landed, and every warp is done with V tile
    // it - 1; V tile 0 may still be in flight
    if (it == 0) {
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (it > 0) {
      copy_rows<D, KT>(v_s, vb, k0, k_end, tid);  // lands under S
      cp_commit();
    }

    // S over the live chunks; a tile the warp sees whole takes the
    // unguarded loop
    float s[2 * CHUNKS][4];
#pragma unroll
    for (int j = 0; j < 2 * CHUNKS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if (nc == CHUNKS) {
      qk_tile<D, true>(s, q_a, k_s, nc, ln);
    } else {
      qk_tile<D, false>(s, q_a, k_s, nc, ln);
    }

    // mask the unscaled scores and take the row max over the whole tile.
    // Element e of n-tile j is query row row0 + 8 (e / 2), key k0 + 8 j +
    // 2 t + e % 2; a chunk below w_full has no masked entry, and a chunk
    // past nc none that is visible.
    float tmax[2][2] = {{NEG_INF, NEG_INF}, {NEG_INF, NEG_INF}};
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      if (k0 + 16 * c + 16 > w_full) {
#pragma unroll
        for (int j = 2 * c; j < 2 * c + 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            const bool ok = kj < klen &&
                            (!causal || kj <= row0 + 8 * (e >> 1) + offset);
            if (!ok) s[j][e] = NEG_INF;
          }
        }
      }
#pragma unroll
      for (int j = 2 * c; j < 2 * c + 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tmax[c & 1][e >> 1] = fmaxf(tmax[c & 1][e >> 1], s[j][e]);
    }
    // the four lanes t = 0..3 of a row hold its columns.  m is kept
    // unscaled: with scale > 0, scale * max S is the max of the scaled
    // scores, as the TPU kernel takes it.
    float corr[2], msc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(tmax[0][h], tmax[1][h]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = exp2f((m[h] - m_new) * sc);
      m[h] = m_new;
      msc[h] = m_new * sc;
    }
    // P = exp(scale S - scale m) in fp32; l sums it unrounded, and P
    // rounds to V's dtype as each chunk is packed into its A fragment
    float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    unsigned pa[CHUNKS][4];
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
#pragma unroll
      for (int j = 2 * c; j < 2 * c + 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // masked: exp2(<= -5e29 sc) = 0
          s[j][e] = exp2f(fmaf(s[j][e], sc, -msc[e >> 1]));
          ls[c & 1][e >> 1] += s[j][e];
        }
      }
      pack_a(pa[c], s[2 * c], s[2 * c + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = l[h] * corr[h] + (ls[0][h] + ls[1][h]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * h] *= corr[h];
        acc[n][2 * h + 1] *= corr[h];
      }
    }

    // V tile it has landed, and every warp is done with K tile it
    cp_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) {
      copy_rows<D, KT>(k_s, kb, k0 + KT, k_end, tid);  // lands under PV
      cp_commit();
    }

    if (nc == CHUNKS) {
      pv_tile<D, true>(acc, pa, v_s, nc, ln);
    } else {
      pv_tile<D, false>(acc, pa, v_s, nc, ln);
    }
  }

  // the row sums over the four lanes; O rounds once, at its store
  bf16* ob = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = row0 + 8 * h;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * D + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h] / denom,
                                acc[n][2 * h + 1] / denom);
    if (lse != nullptr && l[h] > 0.f) {
      const float ms = __fmul_rn(m[h], scale);
      float lv = ms + logf(denom);
      if (fabsf(lv) < 0.5f * fmaxf(1.f, fabsf(ms)))  // the row's four lanes
        lv = lse_in_order<D>(qb + (size_t)r * D, kb,
                             causal ? min(klen, r + offset + 1) : klen, scale,
                             t, 0xFu << (lane & ~3));
      if (t == 0) lse[(size_t)bh * Sq + r] = lv;
    } else if (lse != nullptr && t == 0) {
      lse[(size_t)bh * Sq + r] = -NEG_INF;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Opts `kernel` into `smem` bytes of dynamic shared memory and launches it
// on `grid`.  A refused attribute also sets the thread's last error, which
// is cleared so that it does not surface at a later launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)err;
  }
  kernel<<<grid, MMA_THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const float* q, const float* k, const float* v, const int* kl,
             float* o, float* lse, int B, int H, int Sq, int Sk, float scale,
             int causal, cudaStream_t st) {
  return launch(flash_fwd_tf32_kernel<D>, dim3(B * H, (Sq + BQ - 1) / BQ),
                fwd_tf32_smem_bytes<D>(), st, q, k, v, kl, o, lse, H, Sq, Sk,
                scale, causal);
}

template <int D>
int launch_d(const bf16* q, const bf16* k, const bf16* v, const int* kl,
             bf16* o, float* lse, int B, int H, int Sq, int Sk, float scale,
             int causal, cudaStream_t st) {
  return launch(flash_fwd_mma_kernel<D>, dim3((Sq + MQ - 1) / MQ, B * H),
                mma_smem_bytes<D>(), st, q, k, v, kl, o, lse, H, Sq, Sk,
                scale, causal);
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, const int* k_lengths, T* o,
             float* lse, int B, int H, int Sq, int Sk, int D, float scale,
             int causal, void* stream) {
  if (B * H == 0 || Sq == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<64>(q, k, v, k_lengths, o, lse, B, H, Sq, Sk, scale,
                          causal, st);
    case 128:
      return launch_d<128>(q, k, v, k_lengths, o, lse, B, H, Sq, Sk, scale,
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
