// tf32_split.cuh — what the fp32 flash kernels (flash_fwd.cu, flash_bwd.cu)
// share: cp.async copies, and fp32 products on the tensor cores as three
// TF32 products of split operands.
//
// One pass of TF32 (operands rounded to 10 mantissa bits) puts attention
// outputs and gradients several times the fp32 gate of 1e-4 * max(1, max
// |plain|) off the fp32 result.  So every fp32 operand x is split as x = big
// + small, big = tf32(x) and small = tf32(x - big) (x - big is exact in
// fp32), tf32() rounding as cvt.rna.tf32.f32 does, to nearest with ties away
// from zero, and each product sums small·big + big·small + big·big, small
// terms first, on mma.sync.m16n8k8 with tf32 operands and fp32 accumulators;
// small·small (below 2^-22 of the product) is dropped.  Only the order of
// the fp32 sums moves against an fp32 matmul; tests/tf32_split.py models the
// split on the CPU.
//
// Fragments are 32-bit shared loads (there is no ldmatrix for 32-bit
// elements) from tiles whose rows are padded to D + 4 floats: with a row
// stride of 4 banks, a fragment read by row (8 rows g, 4 columns t) and one
// by column pairs (rows 2t and 2t + 1, 8 columns g) both fall in 32 distinct
// banks.  A tile walked by a block is split once, in place, by the threads
// that copied it (split_tile_f32), and not once a warp.
//
// The m16n8 accumulator holds columns 2t and 2t + 1 where the m16k8 A
// fragment wants columns t and t + 4.  Since a product sums over its k index
// in any order, the next product takes k slot t as column 2t and slot t + 4
// as 2t + 1, in A and in B alike: an accumulator becomes an A fragment with
// no shuffle and no trip through shared memory (acc_to_a), and B reads rows
// 2t and 2t + 1 of its tile (load_b with dr = the row stride).
//
// Included by the kernel sources at file scope, after the CUDA headers; the
// build hashes it with each source that includes it.

#pragma once

namespace {

constexpr int MMA_THREADS = 128;  // four warps, 16 rows of a tile each

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

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
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_wait_all() { cp_wait<0>(); }

// ---------------------------------------------------------------------------
// split-TF32 fragments and products
// ---------------------------------------------------------------------------

// Rows of an fp32 tile are padded by 4 floats (16 bytes, 4 banks)
template <int D>
__host__ __device__ constexpr int f32_ld() {
  return D + 4;
}

// A 16 x 8 A fragment and an 8 x 8 B fragment, each split into its tf32
// big and small parts.  With g = lane / 4 and t = lane % 4: a = {(g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4)}, b = {(k t, n g), (k t + 4, n g)};
// the m16n8 fp32 accumulator c = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1)}.
struct FragA {
  unsigned big[4], small[4];
};
struct FragB {
  unsigned big[2], small[2];
};

// x rounded to tf32 as cvt.rna.tf32.f32 rounds a finite x: to nearest, ties
// away from zero, at 10 mantissa bits.  On the bits, since the magnitude
// sits below the sign: two integer instructions, where cvt.rna.tf32.f32
// compiles to about five (it also keeps Inf and NaN apart, which no input
// here needs: an Inf or NaN operand still gives a non-finite product).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + a rest below 2^-22 |x|: big = tf32(x), small = tf32(x -
// big), where x - big is exact in fp32
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

__device__ __forceinline__ void split_a(FragA& f, float x0, float x1,
                                        float x2, float x3) {
  split_tf32(x0, f.big[0], f.small[0]);
  split_tf32(x1, f.big[1], f.small[1]);
  split_tf32(x2, f.big[2], f.small[2]);
  split_tf32(x3, f.big[3], f.small[3]);
}

// The A fragment of rows (g, g + 8) and columns (t, t + 4) from a shared
// tile with row stride LD, p pointing at (g, t) of the 16 x 8 block
template <int LD>
__device__ __forceinline__ void load_a(FragA& f, const float* p) {
  split_a(f, p[0], p[8 * LD], p[4], p[8 * LD + 4]);
}

// The same A fragment from a tile split by split_tile_f32, `off` at (g, t)
template <int LD>
__device__ __forceinline__ void load_a_split(FragA& f, const float* big,
                                             const float* small, int off) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int at = off + (i & 1) * 8 * LD + (i >> 1) * 4;
    f.big[i] = __float_as_uint(big[at]);
    f.small[i] = __float_as_uint(small[at]);
  }
}

__device__ __forceinline__ void mma_tf32_1688(float (&c)[4],
                                              const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b to about fp32 accuracy: small·big, big·small, then big·big
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32_1688(c, a.small, b.big[0], b.big[1]);
  mma_tf32_1688(c, a.big, b.small[0], b.small[1]);
  mma_tf32_1688(c, a.big, b.big[0], b.big[1]);
}

// The A fragment of an accumulator's 16 x 8 block as the left operand of
// the next product, k slot t taken as column 2t and slot t + 4 as 2t + 1
// (the B operand reads rows 2t and 2t + 1 to match)
__device__ __forceinline__ void acc_to_a(FragA& f, const float (&c)[4]) {
  split_a(f, c[0], c[2], c[1], c[3]);
}

// Issues the 16-byte copies of rows [r0, r0 + ROWS) of a [S, D] fp32 matrix
// into a [ROWS][D + 4] tile; rows at or past `valid` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void copy_tile_f32(float* dst, const float* src,
                                              int r0, int valid, int tid) {
  constexpr int CPR = D / 4;  // copies a row
#pragma unroll
  for (int i = 0; i < ROWS * CPR / MMA_THREADS; ++i) {
    const int idx = tid + i * MMA_THREADS;
    const int r = idx / CPR, c = (idx % CPR) * 4;
    const bool live = r0 + r < valid;
    cp16(dst + r * f32_ld<D>() + c,
         src + (live ? (size_t)(r0 + r) * D + c : 0), live);
  }
}

// Splits, in place, the ROWS x D floats this thread copied into a [ROWS][D +
// 4] tile (copy_tile_f32's chunks of 16 bytes): big = tf32(x) stays, small =
// tf32(x - big) goes to the same place of `small`.  Each warp then reads
// both parts, so a walked tile is split once and not once a warp.
template <int D, int ROWS>
__device__ __forceinline__ void split_tile_f32(float* big, float* small,
                                               int tid) {
  constexpr int CPR = D / 4;
#pragma unroll
  for (int i = 0; i < ROWS * CPR / MMA_THREADS; ++i) {
    const int idx = tid + i * MMA_THREADS;
    const int at = (idx / CPR) * f32_ld<D>() + (idx % CPR) * 4;
    const float4 x = *reinterpret_cast<const float4*>(big + at);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(big + at) = hi;
    *reinterpret_cast<uint4*>(small + at) = lo;
  }
}

// The split B fragment (k rows r and r + dr, n column) of a tile split by
// split_tile_f32, `off` at (r, n)
__device__ __forceinline__ void load_b(FragB& f, const float* big,
                                       const float* small, int off, int dr) {
  f.big[0] = __float_as_uint(big[off]);
  f.big[1] = __float_as_uint(big[off + dr]);
  f.small[0] = __float_as_uint(small[off]);
  f.small[1] = __float_as_uint(small[off + dr]);
}

}  // namespace
