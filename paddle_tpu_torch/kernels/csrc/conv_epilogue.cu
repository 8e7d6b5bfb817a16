// conv_epilogue.cu — conv + per-channel batch-norm statistics, and the
// batch-norm epilogue (normalise, affine, residual, ReLU), fp32 and bf16, for
// sm_90a.
//
// Layouts are the TPU kernels' own: x [N, H, W, C] NHWC, w [K, K, C, F]
// (HWIO), the conv output and y [N, Ho, Wo, F] NHWC, which is a row-major
// [M, F] matrix with M = N * Ho * Wo.
//
// Element types.  Each kernel has an fp32 entry (`*_f32`) and a bf16 entry
// (`*_bf16`) over activations and weights of that type; the [F] vectors
// (sum, sumsq, mean, inv, gamma, beta) are fp32 in both.  bf16 rounds where
// the TPU kernels round, and only there: every product of bf16 x and w is
// exact and accumulates in fp32 over all taps and channels
// (conv_epilogue.py:129-131), the conv output is stored rounded to bf16
// (`_stats_update`, :140) while sum and sumsq take the unrounded fp32
// accumulator (:147-148); the epilogue widens out and z, runs the affine,
// residual and ReLU in fp32 and rounds y once, at the store (:186-192).
//
// ---------------------------------------------------------------------------
// conv_stats_f32, conv_stats_bf16
//
// Replaces: paddle_tpu/kernels/conv_epilogue.py, the pallas_calls of
// `conv_bn_act` at line 347 (body `_conv_stats_kernel_inpad`: stride 1, the
// halo padded inside the kernel) and line 383 (body `_conv_stats_kernel`:
// host-padded, stride-phase decomposed, row tiled).  Both compute one
// function: out = conv(x, w) with stride s and symmetric zero padding p,
// written once, plus sum[f] and sumsq[f] of out over N, Ho, Wo.
//
// Design.  An implicit GEMM: out[M, F] = A[M, K*K*C] @ B[K*K*C, F], where
// A[m, (kh, kw, c)] = x[n, ho*s - p + kh, wo*s - p + kw, c] is never built in
// device memory: each chunk of A is gathered from NHWC x straight into
// shared memory, a pixel outside the image (or a row past M, or a k past
// K*K*C) reading 0.  So the host-side padding, the stride-phase planes and
// the row tiles of the TPU kernel (Mosaic cannot lower strided vector
// slices or blocks larger than VMEM) have no counterpart here.  B is w
// itself, contiguous [K*K*C, F].  A block of 256 threads owns 128 rows of M
// (`TILE_M`, which the wrapper's `_TILE_M` (128) must not exceed: it sizes
// the partial-sum scratch) by BN channels (BN = 128, or 64 where F <= 64).
//
// The statistics.  The TPU kernel carries sum and sumsq across its
// sequential grid in VMEM (`_stats_update`, line 136).  Blocks on the card
// run in no order, so each tile's 128 rows are reduced per channel inside
// the block, in a fixed order (each thread's rows, then shuffles over the
// lanes that share a column, then the warps through shared memory), into
// one partial row of [ceil(M/128), F] buffers, which one or two more
// kernels sum in a fixed order.  No atomics, so two launches are bit-equal.
// Rows past M hold exact zeros (their A rows were zero) and add nothing.
// mean, var and inv are formed outside the kernels from the two [F]
// vectors, as the JAX module does.
//
// bf16: the products on the tensor cores, bf16 in and fp32 accumulate, in
// 64-deep chunks (one 128-byte row of A per output row) laid out in
// shared memory in wgmma's 128-byte swizzle (the 16-byte unit index XOR the
// row's low three bits).  The epilogue rounds out once into a shared-memory
// tile, stores it in coalesced 16-byte runs, and takes the sums from the
// unrounded fp32 accumulators.  The products are wgmma (m64nBNk16, A and B
// by descriptor, B transposed), issued by two warpgroups of 64 rows.
// (mma.sync m16n8k16 with ldmatrix fragments from the same tiles was as
// fast, within 2%, at 3 of ResNet-50's 23 shapes and slower at the other
// 20, and was dropped.)
// - C % 8 == 0 (every ResNet conv but the stem), `conv_stats_bf16_kernel`:
//   one tile a block; each 16-byte cp.async carries 8 channels of one pixel
//   for one tap, zero-filled past the image, into a ring of 4 stages (BN
//   64) or 3 (BN 128) with one barrier a chunk.  One wgmma group stays in
//   flight across the barrier at BN 64, and at BN 128 for K > 1.
// - C % 8 != 0 (the stem, C = 3), `conv_stats_bf16_rows_kernel`: the
//   reduction runs kh by kh, each kh's K*C values padded with zero weights
//   to a multiple of 8.  A block first copies the input rows its taps reach
//   (for the stem 7 to 11 rows of W*C = 672 bf16) into a window with zero
//   halo columns, with 16-byte copies, and builds A's 16-byte units from it
//   (5 words each, realigned by byte_perm): the counterpart of the TPU
//   kernel's halo padded in VMEM (`_conv_stats_kernel_inpad`,
//   conv_epilogue.py:164-179), in place of scalar gathers from device
//   memory.  It walks many tiles with all of B's chunks resident and the
//   next tile's window copied under this tile's products.  Where B's
//   chunks (more than 6) or the windows do not fit, the im2col kernel
//   gathers the same units from x itself into its ring: the one fallback,
//   which no ResNet-50 conv takes.
// Measured and not kept (conv_stats_sweep's shapes; PERF.md): a walk of
// many tiles a block for C % 8 == 0 (its staged out cannot share the ring,
// which lost a stage: slower at 21 of 23 shapes); a patch of padded pixels
// shared by a 3x3/1 conv's nine taps (slower at all four such shapes);
// BN 64 for every F; three blocks an SM.
//
// fp32 (`conv_stats_f32_kernel`): true fp32 FMA (no TF32): each thread owns
// an 8 x 8 register tile (8 x 4 at BN 64) of rows ty + 16 i, fed by 16-byte
// shared-memory reads (a row's 4 k at a time from A, 4 or 8 columns from B:
// 16 FMAs a load at BN 128, 10.7 at 64) through a 3-stage cp.async ring of
// 16-deep chunks: 16-byte copies of 4 channels of one pixel where C % 4 ==
// 0, else 4-byte copies, each zero-filled.  The stem's fp32 launch keeps
// that 4-byte gather inside the pipeline, where a gather already beat the
// library call (PERF.md).
//
// What bounds it on an H100.  fp32: operations; 2 * M * K*K*C * F flops over
// about 4 * (|x| + |w| + |out|) bytes is hundreds of flops a byte for every
// ResNet-50 conv, far above the card's fp32 balance of 20 (67 TFLOP/s over
// 3.35 TB/s).  bf16: the dense bf16 tensor rate (989 TFLOP/s) against half
// the bytes puts the balance near 295 flops a byte, so the 1x1 convs and the
// stem sit on the bytes side and the 3x3 convs near the line.
//
// ---------------------------------------------------------------------------
// bn_epilogue_f32, bn_epilogue_bf16
//
// Replaces: paddle_tpu/kernels/conv_epilogue.py, the pallas_call of
// `conv_bn_act` at line 412 (body `_bn_epilogue_kernel`, line 182):
// y = act((out - mean) * inv * gamma + beta [+ z]), act relu or none.
//
// Design.  One grid-stride pass over [M, F], four elements a thread at a time
// (16-byte fp32 or 8-byte bf16 loads and stores) when F is a multiple of 4;
// the four [F] vectors are read through the read-only cache.  The residual z
// is optional (a null pointer).
//
// What bounds it: bytes.  It reads out (and z) and writes y once, a few
// flops per element, far below the balance of either type.
// ---------------------------------------------------------------------------

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Element access by type: `load` widens one element to fp32, `load4` four
// neighbours, `store` rounds to the element type (round to nearest even),
// `store4` four neighbours.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);  // 4 x bf16, 8 bytes
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&a);
    u.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// -- copies, fragments and products -----------------------------------------
// (flash_bwd.cu has the same few; each source stands alone, since the build
// hashes only the .cu bytes)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared: the first `bytes` (0 to 16) read, the rest
// zero-filled
__device__ __forceinline__ void cp16(unsigned dst, const void* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared, zero-filled (nothing read) when !live
__device__ __forceinline__ void cp4(unsigned dst, const void* src,
                                    bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(live ? 4 : 0)
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

// Byte offset of 16-byte unit u (0-7) of 128-byte row r in a tile laid out
// in wgmma's 128-byte swizzle: the unit index XOR the row's low three bits,
// over 1024-byte-aligned atoms of eight rows.  The copies and the wgmma
// descriptors both address through it.
__device__ __forceinline__ unsigned swz(int r, int u) {
  return (unsigned)(r * 128 + ((u ^ (r & 7)) << 4));
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (each in 16-byte units), base
// offset 0 and layout type 1 (128-byte swizzle).  The swizzle acts on the
// address bits themselves: a start 32 bytes into a row (the k16 steps) or
// whole rows past an atom boundary needs no base offset (set to the row
// within the atom, the products came out wrong on the card).
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr, unsigned lbo16,
                                               unsigned sbo16) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo16 << 16) |
         ((uint64_t)sbo16 << 32) | (1ull << 62);
}

// Shared memory written through the generic proxy (cp.async, st.shared)
// made visible to wgmma's async proxy; each writing thread fences before
// the barrier that publishes its writes.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ unsigned lds32(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// wait until at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A B for a warpgroup: A 64 x 16 bf16 (K-major, by descriptor), B 16 x
// BN bf16 (N contiguous: transposed, by descriptor), d 64 x BN fp32 with
// warp w's thread (g, t) holding d[j][e] = (row 16 w + g + 8 (e / 2),
// column 8 j + 2 t + e % 2): the m16n8 fragment layout, j over the n8
// blocks.
template <int BN>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[8][4], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31},"
        " %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[16][4], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

// -- the conv_stats kernels -------------------------------------------------

constexpr int CS_THREADS = 256;  // threads of a conv_stats block
constexpr int TILE_M = 128;      // output rows (of M) a block, both dtypes
constexpr int HK = 64;           // bf16 chunk depth: a 128-byte row of A
constexpr int FK = 16;           // fp32 chunk depth
constexpr int FAS = FK + 4;      // fp32 A row stride in floats (16-byte rows)
constexpr int F_STAGES = 3;      // fp32 ring depth
constexpr int WIN_MAX_BYTES = 64 * 1024;  // the rows kernel's window cap

// Output row m as its input origin: {((n H + hi0) W + wi0) C, hi0, wi0,
// n H + hi0} with hi0 = ho s - p, wi0 = wo s - p: x's element for tap
// (kh, kw) and channel c is the first plus (kh W + kw) C + c.  A row past
// M gets hi0 = -2^30, so every tap fails the bounds test and reads zero.
__device__ __forceinline__ void fill_rows(int4* rows, long long m0,
                                          long long M, int H, int W, int C,
                                          int Ho, int Wo, int stride,
                                          int pad) {
  for (int r = threadIdx.x; r < TILE_M; r += blockDim.x) {
    const long long m = m0 + r;
    int4 v = make_int4(0, -(1 << 30), 0, 0);
    if (m < M) {
      const int hw = Ho * Wo;
      const int n = (int)(m / hw);
      const int rem = (int)(m - (long long)n * hw);
      const int ho = rem / Wo;
      const int hi0 = ho * stride - pad;
      const int wi0 = (rem - ho * Wo) * stride - pad;
      v = make_int4(((n * H + hi0) * W + wi0) * C, hi0, wi0, n * H + hi0);
    }
    rows[r] = v;
  }
}

// A position k = (kh K + kw) C + c of the reduction, walked forward with no
// division after the first, and its element offset in x from a row's
// origin, off = (kh W + kw) C + c
struct Tap {
  int k, c, kw, kh, off;
  __device__ __forceinline__ void start(int k0, int C, int K, int W) {
    k = k0;
    const int tap = k0 / C;
    c = k0 - tap * C;
    kh = tap / K;
    kw = tap - kh * K;
    off = (kh * W + kw) * C + c;
  }
  __device__ __forceinline__ void step(int n, int C, int K, int W) {
    k += n;
    c += n;
    while (c >= C) {
      c -= C;
      if (++kw == K) {
        kw = 0;
        ++kh;
      }
    }
    off = (kh * W + kw) * C + c;
  }
  // whether this k reads a pixel of the image for output row ri
  __device__ __forceinline__ bool live(int4 ri, int H, int W,
                                       int Ktot) const {
    return k < Ktot && (unsigned)(ri.y + kh) < (unsigned)H &&
           (unsigned)(ri.z + kw) < (unsigned)W;
  }
};

// The C % 8 != 0 window: each input row's W*C elements at element LM (a
// 16-byte boundary), zero halo columns on both sides, rows RS elements
// apart; RS leaves room for a run read one 16-byte unit past its end.
struct WinRow {
  int lm, rs;
  __host__ __device__ WinRow(int W, int C, int pad)
      : lm((pad * C + 7) & ~7), rs((lm + (W + pad) * C + 16 + 7) & ~7) {}
};

// Copy into `win` the flattened input rows [*r_lo, *r_lo + nrows) that the
// taps of output rows [m0, m0 + 128) reach (the first row's top tap to the
// last row's bottom tap), with zero halo columns: 16-byte copies where rows
// are whole 16-byte units (the caller commits and waits), else element by
// element.  `window_rows` bounds nrows for every tile.
__device__ __forceinline__ void load_window(
    unsigned short* win, const unsigned short* xs, long long m0, long long M,
    int N, int H, int W, int C, int K, int stride, int pad, int Ho, int Wo,
    int* r_lo) {
  const WinRow wr(W, C, pad);
  const int t = threadIdx.x;
  const int hw = Ho * Wo;
  const long long last = (m0 + TILE_M < M ? m0 + TILE_M : M) - 1;
  const int n0 = (int)(m0 / hw);
  const int ho0 = (int)(m0 - (long long)n0 * hw) / Wo;
  const int n1 = (int)(last / hw);
  const int ho1 = (int)(last - (long long)n1 * hw) / Wo;
  *r_lo = n0 * H + max(0, ho0 * stride - pad);
  const int nrows =
      n1 * H + min(H - 1, ho1 * stride - pad + K - 1) + 1 - *r_lo;
  const int rowel = W * C;
  const int marg = wr.rs - rowel;  // halo and tail elements of a row
  for (int v = t; v < nrows * marg; v += CS_THREADS) {
    const int i = v / marg, q = v - i * marg;
    win[i * wr.rs + (q < wr.lm ? q : q + rowel)] = 0;
  }
  if (rowel % 8 == 0 && ((uintptr_t)xs & 15) == 0) {
    const int units = rowel / 8;
    const unsigned wdst = smem_addr(win);
    for (int v = t; v < nrows * units; v += CS_THREADS) {
      const int i = v / units, u = v - i * units;
      cp16(wdst + (unsigned)(i * wr.rs + wr.lm + 8 * u) * 2,
           xs + (long long)(*r_lo + i) * rowel + 8 * u, 16);
    }
  } else {
    for (int v = t; v < nrows * rowel; v += CS_THREADS) {
      const int i = v / rowel, e = v - i * rowel;
      win[i * wr.rs + wr.lm + e] = xs[(long long)(*r_lo + i) * rowel + e];
    }
  }
}

// One 16-byte unit of A for C % 8 != 0: the 8 values (kh, j0 .. j0 + 7) of
// output row ri, where the reduction runs kh by kh and each kh's K*C (kw,
// c) values are padded with zero weights to KCP.  Values past K*C are the
// zero padding (`kc_tail`).  a_unit_window reads the rows kernel's window:
// 5 words, realigned by byte_perm where the run starts on an odd element.
// a_unit_gather, the im2col kernel's, gathers the 8 values from x.
__device__ __forceinline__ uint4 kc_tail(unsigned (&pr)[4], int j0, int KC) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = j0 + 2 * q;
    if (j >= KC) pr[q] = 0u;
    else if (j + 1 >= KC) pr[q] &= 0xFFFFu;
  }
  return make_uint4(pr[0], pr[1], pr[2], pr[3]);
}

__device__ __forceinline__ uint4 a_unit_window(int4 ri, int kh, int j0,
                                               int K, int KC, int H, int C,
                                               const unsigned short* win,
                                               const WinRow& wr, int r_lo) {
  unsigned pr[4] = {0u, 0u, 0u, 0u};
  if (kh < K && (unsigned)(ri.y + kh) < (unsigned)H) {
    const int o = (ri.w + kh - r_lo) * wr.rs + wr.lm + ri.z * C + j0;
    const unsigned wp = smem_addr(win) + (o >> 1) * 4;
    unsigned wv[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) wv[q] = lds32(wp + 4 * q);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      pr[q] = (o & 1) ? __byte_perm(wv[q], wv[q + 1], 0x5432) : wv[q];
  }
  return kc_tail(pr, j0, KC);
}

__device__ __forceinline__ uint4 a_unit_gather(int4 ri, int kh, int j0,
                                               int K, int KC, int H, int W,
                                               int C,
                                               const unsigned short* xs) {
  unsigned pr[4] = {0u, 0u, 0u, 0u};
  if (kh < K && (unsigned)(ri.y + kh) < (unsigned)H) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = j0 + e, kw = j / C;
      const int wi = ri.z + kw;
      if (j < KC && (unsigned)wi < (unsigned)W)
        pr[e >> 1] |=
            (unsigned)xs[((long long)(ri.w + kh) * W + wi) * C + j - kw * C]
            << (16 * (e & 1));
    }
  }
  return kc_tail(pr, j0, KC);
}

// The products of one 64-deep chunk, A [128][64] at a_st and B [64][BN] at
// b_st (both 128-byte swizzled, B's 64-column halves 8 KB apart): warpgroup
// warp / 4 owns rows 64 (warp / 4) .., every column, and leaves LAG groups
// in flight.  acc[j][e] is row 16 warp + g + 8 (e / 2), column 8 j + 2 tig
// + e % 2 (g = lane / 4, tig = lane % 4).
template <int BN, int LAG>
__device__ __forceinline__ void chunk_product(float (&acc)[BN / 8][4],
                                              unsigned a_st, unsigned b_st) {
  const unsigned a_wg = a_st + (threadIdx.x >> 7) * (64 * 128);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < HK / 16; ++ks)
    Wgmma<BN>::mma(acc, sw128_desc(a_wg + 32 * ks, 1, 1024 >> 4),
                   sw128_desc(b_st + 2048 * ks, (HK * 128) >> 4, 1024 >> 4));
  wgmma_commit();
  wgmma_wait<LAG>();
}

// The epilogue of the tile at rows m0 (partial-sum row mt), columns f0:
// out rounded once into the staged tile stg [128][BN + 8] and stored in
// 16-byte runs (VB) or element by element; the partial sums from the
// unrounded accumulators, per thread, then the lanes that share a column
// (xor 4, 8, 16), then the 8 warps in order, through red [2][8][BN].
// Every warp must be done with whatever stg and red overlay.
template <int BN, bool VB>
__device__ __forceinline__ void tile_epilogue(
    const float (&acc)[BN / 8][4], unsigned short* stg, float* red,
    long long m0, long long M, long long mt, int f0, int F,
    __nv_bfloat16* __restrict__ out, float* __restrict__ psum,
    float* __restrict__ psumsq) {
  constexpr int SLD = BN + 8;  // staged row, bf16 (16-byte aligned rows)
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(stg + (16 * warp + g + 8 * h) * SLD +
                                         col) =
          __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = acc[j][e] + acc[j][2 + e];
      float q = fmaf(acc[j][2 + e], acc[j][2 + e], acc[j][e] * acc[j][e]);
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (g == 0) {
        red[warp * BN + col + e] = s;
        red[(8 + warp) * BN + col + e] = q;
      }
    }
  }
  __syncthreads();
  if (t < BN && f0 + t < F) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += red[i * BN + t];
      q += red[(8 + i) * BN + t];
    }
    psum[mt * F + f0 + t] = s;
    psumsq[mt * F + f0 + t] = q;
  }
  if constexpr (VB) {
    constexpr int UPR = BN / 8;
#pragma unroll
    for (int j = 0; j < TILE_M * UPR / CS_THREADS; ++j) {
      const int v = t + CS_THREADS * j;
      const int r = v / UPR, u = v % UPR;
      const long long m = m0 + r;
      const int f = f0 + 8 * u;
      if (m < M && f < F)
        *reinterpret_cast<uint4*>(out + m * F + f) =
            *reinterpret_cast<const uint4*>(stg + r * SLD + 8 * u);
    }
  } else {
    unsigned short* os = reinterpret_cast<unsigned short*>(out);
    for (int v = t; v < TILE_M * BN; v += CS_THREADS) {
      const int r = v / BN, n = v % BN;
      const long long m = m0 + r;
      if (m < M && f0 + n < F) os[m * F + f0 + n] = stg[r * SLD + n];
    }
  }
}

// B chunk ch [64][BN] (rows k0 .. k0 + 63 of the padded reduction, w's
// row src_row(k) or zeros; columns f0 ..) into the swizzled tile at bst:
// 16-byte copies (VB) or element by element (no commit).
template <int BN, bool VB, typename SrcRow>
__device__ __forceinline__ void load_b_chunk(unsigned bst, unsigned char* bp,
                                             const unsigned short* ws,
                                             int k0, int f0, int F,
                                             SrcRow src_row) {
  const int t = threadIdx.x;
  if constexpr (VB) {
    constexpr int UPR = BN / 8;  // 16-byte units in a row of B
#pragma unroll
    for (int j = 0; j < HK * UPR / CS_THREADS; ++j) {
      const int v = t + CS_THREADS * j;
      const int kr = v / UPR, un = v % UPR;
      const int k = src_row(k0 + kr), f = f0 + 8 * un;
      const bool live = k >= 0 && f < F;
      cp16(bst + (un >> 3) * (HK * 128) + swz(kr, un & 7),
           live ? ws + (long long)k * F + f : ws, live ? 16 : 0);
    }
  } else {
    for (int v = t; v < HK * BN; v += CS_THREADS) {
      const int kr = v / BN, n = v % BN;
      const int k = src_row(k0 + kr), f = f0 + n;
      *reinterpret_cast<unsigned short*>(bp + (n >> 6) * (HK * 128) +
                                         swz(kr, (n >> 3) & 7) + (n & 7) * 2) =
          (k >= 0 && f < F) ? ws[(long long)k * F + f] : (unsigned short)0;
    }
  }
}

// Shared-memory plan of the im2col kernel (bytes from a 1024-aligned base):
// the ring of STAGES x (A [128][64] + B [64][BN]), then the 128 rows'
// origins.  After the loop the ring holds the rounded out tile [128][BN +
// 8] and, from RED_OFF, the partial sums.  Two blocks fit an SM.
template <int BN, bool VA>
struct HCfg {
  static constexpr int STAGES = (VA && BN == 64) ? 4 : 3;
  static constexpr int A_BYTES = TILE_M * 128;
  static constexpr int B_BYTES = HK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int ROWS_OFF = RING;
  static constexpr int SMEM = RING + TILE_M * 16;
  static constexpr int RED_OFF = 36864;
  static_assert(TILE_M * (BN + 8) * 2 <= RED_OFF, "staged out overlaps");
  static_assert(RED_OFF + 2 * 8 * BN * 4 <= RING, "partial sums overflow");
};

// The im2col kernel: one 128-row tile a block, the chunks of A and B
// through the ring.  C % 8 != 0 (VA false) builds A's units by gathers
// from x, kh by kh.
template <int BN, bool VA, bool VB, int LAG>
__global__ void __launch_bounds__(CS_THREADS, 2)
conv_stats_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ psum, float* __restrict__ psumsq,
                       int N, int H, int W, int C, int F, int K, int stride,
                       int pad, int Ho, int Wo) {
  using Cfg = HCfg<BN, VA>;
  constexpr int STAGES = Cfg::STAGES;
  // LAG wgmma groups stay in flight across the barrier, so AHEAD chunks of
  // copies run ahead of the products
  static_assert(LAG == 0 || VA, "a lag needs the ring");
  constexpr int AHEAD = STAGES - 1 - LAG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const unsigned sbase = smem_addr(smem);
  int4* rows = reinterpret_cast<int4*>(smem + Cfg::ROWS_OFF);
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* ws = reinterpret_cast<const unsigned short*>(w);

  const int t = threadIdx.x;
  const long long M = (long long)N * Ho * Wo;
  const int Ktot = K * K * C;
  const int nF = (F + BN - 1) / BN;
  const long long mt = blockIdx.x / nF;
  const int f0 = (int)(blockIdx.x - mt * nF) * BN;
  const long long m0 = mt * TILE_M;
  // C % 8 != 0: the reduction runs kh by kh, each kh's K*C (kw, c) values
  // padded with zero weights to KCP, a whole number of 16-byte units
  const int KC = K * C;
  const int KCP = (KC + 7) & ~7;
  const int nch = ((VA ? Ktot : K * KCP) + HK - 1) / HK;

  fill_rows(rows, m0, M, H, W, C, Ho, Wo, stride, pad);
  __syncthreads();  // the row origins

  // A (C % 8 == 0): this thread's 16-byte unit t % 8 of rows t / 8 + 32 i
  Tap ta;
  if constexpr (VA) ta.start(8 * (t & 7), C, K, W);

  auto load_a = [&](int ch) {
    if (ch < nch) {
      const int slot = ch % STAGES;
      const unsigned st = sbase + slot * Cfg::STAGE;
      if constexpr (VA) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (t >> 3) + 32 * i;
          const int4 ri = rows[r];
          const bool live = ta.live(ri, H, W, Ktot);
          cp16(st + swz(r, t & 7), live ? xs + (ri.x + ta.off) : xs,
               live ? 16 : 0);
        }
        ta.step(HK, C, K, W);
      } else {
        const int kp = ch * HK + 8 * (t & 7);
        const int kh = kp / KCP, j0 = kp - kh * KCP;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = (t >> 3) + 32 * i;
          *reinterpret_cast<uint4*>(smem + slot * Cfg::STAGE +
                                    swz(r, t & 7)) =
              a_unit_gather(rows[r], kh, j0, K, KC, H, W, C, xs);
        }
      }
    }
  };
  // B row kr of chunk ch holds w's row src_row(k0 + kr), or zeros
  auto src_row = [&](int kp) {
    if constexpr (VA) return kp < Ktot ? kp : -1;
    const int kh = kp / KCP, j = kp - kh * KCP;
    return kh < K && j < KC ? kh * KC + j : -1;
  };
  auto load_b = [&](int ch) {
    if (ch < nch) {
      const int slot = ch % STAGES;
      load_b_chunk<BN, VB>(sbase + slot * Cfg::STAGE + Cfg::A_BYTES,
                           smem + slot * Cfg::STAGE + Cfg::A_BYTES, ws,
                           ch * HK, f0, F, src_row);
    }
  };
  // one copy group a chunk (an empty one past the last keeps the count)
  auto load = [&](int ch) {
    load_a(ch);
    load_b(ch);
    cp_commit();
  };

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

#pragma unroll 1
  for (int ch = 0; ch < AHEAD; ++ch) load(ch);
#pragma unroll 1
  for (int ch = 0; ch < nch; ++ch) {
    cp_wait<AHEAD - 1>();  // chunk ch's copies, this thread's
    fence_async_smem();
    __syncthreads();  // everyone's; and chunk ch - 1 - LAG's stage is free
    load(ch + AHEAD);
    const unsigned st = sbase + (ch % STAGES) * Cfg::STAGE;
    chunk_product<BN, LAG>(acc, st, st + Cfg::A_BYTES);
  }
  wgmma_wait<0>();
  cp_wait<0>();
  __syncthreads();  // every warp is done with the ring
  tile_epilogue<BN, VB>(acc, reinterpret_cast<unsigned short*>(smem),
                        reinterpret_cast<float*>(smem + Cfg::RED_OFF), m0, M,
                        mt, f0, F, out, psum, psumsq);
}

// The C % 8 != 0 kernel where all of w's chunks fit beside the windows (the
// stem): BN 64; each block walks the tiles blockIdx.x + j gridDim.x (a
// multiple of the F tiles, so its F tile stays) with every chunk of B
// resident, copied once.  For each tile it builds all of A's chunks from the
// window, starts copying the next tile's window into the other buffer, and
// runs the products and the epilogue under that copy.
constexpr int ROWS_NCH_MAX = 6;  // B chunks a block keeps: 48 KB

// Shared memory: A's chunks (after the products, the staged out tile), B's
// chunks, the rows' origins, the partial sums, two windows.
struct RowsCfg {
  static constexpr int A_BYTES = TILE_M * 128;  // a chunk of A
  static constexpr int B_BYTES = HK * 64 * 2;   // a chunk of B
  static constexpr int STG_BYTES = TILE_M * (64 + 8) * 2;
  static __host__ __device__ int b_off(int nch) {
    return nch * A_BYTES > STG_BYTES ? nch * A_BYTES : STG_BYTES;
  }
  static __host__ __device__ int rows_off(int nch) {
    return b_off(nch) + nch * B_BYTES;
  }
  static __host__ __device__ int red_off(int nch) {
    return rows_off(nch) + TILE_M * 16;
  }
  static __host__ __device__ int win_off(int nch) {
    return red_off(nch) + 2 * 8 * 64 * 4;
  }
  // the plan for nch chunks and windows of win_elems bf16, 1024-aligned
  static __host__ __device__ int bytes(int nch, int win_elems) {
    return win_off(nch) + 2 * win_elems * 2;
  }
};

template <bool VB>
__global__ void __launch_bounds__(CS_THREADS, 2)
conv_stats_bf16_rows_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ psum,
                            float* __restrict__ psumsq, int N, int H, int W,
                            int C, int F, int K, int stride, int pad, int Ho,
                            int Wo, int win_rows, int n_tiles) {
  constexpr int BN = 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const unsigned sbase = smem_addr(smem);
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  const unsigned short* ws = reinterpret_cast<const unsigned short*>(w);

  const int t = threadIdx.x;
  const long long M = (long long)N * Ho * Wo;
  const int nF = (F + BN - 1) / BN;
  const int f0 = (int)(blockIdx.x % nF) * BN;
  const int KC = K * C;
  const int KCP = (KC + 7) & ~7;
  const int nch = (K * KCP + HK - 1) / HK;
  const WinRow wr(W, C, pad);
  const int win_elems = win_rows * wr.rs;
  int4* rows = reinterpret_cast<int4*>(smem + RowsCfg::rows_off(nch));
  float* red = reinterpret_cast<float*>(smem + RowsCfg::red_off(nch));
  unsigned short* wins =
      reinterpret_cast<unsigned short*>(smem + RowsCfg::win_off(nch));
  const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  auto tile_mt = [&](int j) {
    return (long long)(blockIdx.x + (long long)j * gridDim.x) / nF;
  };

  // every chunk of B, and the first tile's window
  auto src_row = [&](int kp) {
    const int kh = kp / KCP, j = kp - kh * KCP;
    return kh < K && j < KC ? kh * KC + j : -1;
  };
  for (int ch = 0; ch < nch; ++ch)
    load_b_chunk<BN, VB>(sbase + RowsCfg::b_off(nch) + ch * RowsCfg::B_BYTES,
                         smem + RowsCfg::b_off(nch) + ch * RowsCfg::B_BYTES,
                         ws, ch * HK, f0, F, src_row);
  int r_lo = 0, r_lo_next = 0;
  load_window(wins, xs, tile_mt(0) * TILE_M, M, N, H, W, C, K, stride, pad,
              Ho, Wo, &r_lo);
  cp_commit();

  float acc[BN / 8][4];
#pragma unroll 1
  for (int j = 0; j < my_tiles; ++j) {
    const long long mt = tile_mt(j);
    const long long m0 = mt * TILE_M;
    fill_rows(rows, m0, M, H, W, C, Ho, Wo, stride, pad);
    cp_wait<0>();     // this tile's window (and, at first, B)
    __syncthreads();  // the rows, the window; the last epilogue is done
    const unsigned short* win = wins + (j & 1) * win_elems;
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
      const int kp = ch * HK + 8 * (t & 7);
      const int kh = kp / KCP, j0 = kp - kh * KCP;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (t >> 3) + 32 * i;
        *reinterpret_cast<uint4*>(smem + ch * RowsCfg::A_BYTES +
                                  swz(r, t & 7)) =
            a_unit_window(rows[r], kh, j0, K, KC, H, C, win, wr, r_lo);
      }
    }
    __syncthreads();  // A; and every read of the other window is done
    if (j + 1 < my_tiles) {
      load_window(wins + ((j + 1) & 1) * win_elems, xs,
                  tile_mt(j + 1) * TILE_M, M, N, H, W, C, K, stride, pad, Ho,
                  Wo, &r_lo_next);
      cp_commit();
    }
    fence_async_smem();
    __syncthreads();  // A visible to the products
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
    // every chunk is resident: the products of all of them in flight
    // before one wait
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch)
      chunk_product<BN, ROWS_NCH_MAX>(
          acc, sbase + ch * RowsCfg::A_BYTES,
          sbase + RowsCfg::b_off(nch) + ch * RowsCfg::B_BYTES);
    wgmma_wait<0>();
    __syncthreads();  // every warp is done with A
    tile_epilogue<BN, VB>(acc, reinterpret_cast<unsigned short*>(smem), red,
                          m0, M, mt, f0, F, out, psum, psumsq);
    r_lo = r_lo_next;
  }
}

// Shared-memory plan of the fp32 kernel: the ring of F_STAGES x (A
// [128][FAS], B [16][BN]), then the 128 rows' origins.  After the loop the
// ring holds the partial sums.
template <int BN>
struct FCfg {
  static constexpr int A_BYTES = TILE_M * FAS * 4;
  static constexpr int B_BYTES = FK * BN * 4;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = F_STAGES * STAGE;
  static constexpr int SMEM = RING + TILE_M * 16;
  static_assert(2 * 8 * BN * 4 <= RING, "partial sums overflow");
};

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int BN, bool VA, bool VB>
__global__ void __launch_bounds__(CS_THREADS, 2)
conv_stats_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ w, float* __restrict__ out,
                      float* __restrict__ psum, float* __restrict__ psumsq,
                      int N, int H, int W, int C, int F, int K, int stride,
                      int pad, int Ho, int Wo) {
  using Cfg = FCfg<BN>;
  extern __shared__ __align__(16) unsigned char smem_f[];
  const unsigned sbase = smem_addr(smem_f);
  int4* rows = reinterpret_cast<int4*>(smem_f + Cfg::RING);

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const long long M = (long long)N * Ho * Wo;
  const int Ktot = K * K * C;
  const int nF = (F + BN - 1) / BN;
  const long long mt = blockIdx.x / nF;
  const int f0 = (int)(blockIdx.x - mt * nF) * BN;
  const long long m0 = mt * TILE_M;
  const int nch = (Ktot + FK - 1) / FK;

  fill_rows(rows, m0, M, H, W, C, Ho, Wo, stride, pad);
  __syncthreads();

  // VA: this thread's 4-channel unit t % 4 of rows t / 4 + 64 i; otherwise
  // k's 8 (t % 2) .. + 7 of row t / 2, one 4-byte copy each
  Tap ta;
  ta.start(VA ? 4 * (t & 3) : 8 * (t & 1), C, K, W);

  auto load = [&](int ch) {
    if (ch < nch) {
      const unsigned st = sbase + (ch % F_STAGES) * Cfg::STAGE;
      if constexpr (VA) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = (t >> 2) + 64 * i;
          const int4 ri = rows[r];
          const bool live = ta.live(ri, H, W, Ktot);
          cp16(st + (r * FAS + 4 * (t & 3)) * 4,
               live ? x + (ri.x + ta.off) : x, live ? 16 : 0);
        }
        ta.step(FK, C, K, W);
      } else {
        const int r = t >> 1;
        const int4 ri = rows[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool live = ta.live(ri, H, W, Ktot);
          cp4(st + (r * FAS + 8 * (t & 1) + j) * 4,
              live ? x + (ri.x + ta.off) : x, live);
          ta.step(1, C, K, W);
        }
        ta.step(FK - 8, C, K, W);
      }
      const int k0 = ch * FK;
      const unsigned bst = st + Cfg::A_BYTES;
      if constexpr (VB) {
        constexpr int UPR = BN / 4;  // 16-byte units in a row of B
#pragma unroll
        for (int j = 0; j < (FK * UPR + CS_THREADS - 1) / CS_THREADS; ++j) {
          const int v = t + CS_THREADS * j;
          const int kr = v / UPR, un = v % UPR;
          const int k = k0 + kr, f = f0 + 4 * un;
          const bool live = k < Ktot && f < F;
          cp16(bst + (kr * BN + 4 * un) * 4,
               live ? w + (long long)k * F + f : w, live ? 16 : 0);
        }
      } else {
        for (int v = t; v < FK * BN; v += CS_THREADS) {
          const int kr = v / BN, n = v % BN;
          const int k = k0 + kr, f = f0 + n;
          const bool live = k < Ktot && f < F;
          cp4(bst + (kr * BN + n) * 4, live ? w + (long long)k * F + f : w,
              live);
        }
      }
    }
    cp_commit();
  };

  // thread (ty, tx) = (t / 16, t % 16): rows ty + 16 i (i < 8), columns
  // 4 tx .. + 3 and, at BN 128, 64 + 4 tx .. + 3
  constexpr int NC = BN / 16;
  const int tx = t & 15, ty = t >> 4;
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  auto compute = [&](int stage) {
    const float* As =
        reinterpret_cast<const float*>(smem_f + stage * Cfg::STAGE);
    const float* Bs = As + Cfg::A_BYTES / 4;
#pragma unroll
    for (int kq = 0; kq < FK / 4; ++kq) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * FAS +
                                                4 * kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* brow = Bs + (4 * kq + kk) * BN + 4 * tx;
        float b[NC];
        const float4 b0 = *reinterpret_cast<const float4*>(brow);
        b[0] = b0.x;
        b[1] = b0.y;
        b[2] = b0.z;
        b[3] = b0.w;
        if constexpr (NC == 8) {
          const float4 b1 = *reinterpret_cast<const float4*>(brow + 64);
          b[4] = b1.x;
          b[5] = b1.y;
          b[6] = b1.z;
          b[7] = b1.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = lane_of(a[i], kk);
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  };

#pragma unroll 1
  for (int s = 0; s < F_STAGES - 1; ++s) load(s);
#pragma unroll 1
  for (int ch = 0; ch < nch; ++ch) {
    cp_wait<F_STAGES - 2>();
    __syncthreads();
    load(ch + F_STAGES - 1);
    compute(ch % F_STAGES);
  }
  cp_wait<0>();
  __syncthreads();

  // epilogue: the partial sums per thread (rows in order), then the two
  // row groups of the warp (xor 16), then the eight warps in order; out
  // in 16-byte stores where F % 4 == 0
  float* red = reinterpret_cast<float*>(smem_f);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += acc[i][j];
      q = fmaf(acc[i][j], acc[i][j], q);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    q += __shfl_xor_sync(0xffffffffu, q, 16);
    if (lane < 16) {
      const int col = 4 * tx + (j & 3) + 64 * (j >> 2);
      red[warp * BN + col] = s;
      red[(8 + warp) * BN + col] = q;
    }
  }
  __syncthreads();
  if (t < BN && f0 + t < F) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += red[i * BN + t];
      q += red[(8 + i) * BN + t];
    }
    psum[mt * F + f0 + t] = s;
    psumsq[mt * F + f0 + t] = q;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
    float* row = out + m * F;
#pragma unroll
    for (int h = 0; h < NC / 4; ++h) {
      const int f = f0 + 4 * tx + 64 * h;
      if constexpr (VB) {
        if (f < F)
          *reinterpret_cast<float4*>(row + f) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (f + e < F) row[f + e] = acc[i][4 * h + e];
      }
    }
  }
}

// The reduction of the [T, F] partial rows, in a fixed order and with no
// atomics, in two passes where T > SEG.  First, block (32 channels, 8 row
// lanes) of grid (ceil(F / 32), ceil(T / SEG)) sums segment g's rows g SEG
// .. + SEG - 1 per channel (lane y rows y, y + 8, ...; then the 8 lanes in
// order) and writes the two sums over the segment's first row.  Then
// stats_reduce_kernel sums those rows (SEG rows apart).  A trace counts
// both as conv_stats by name (`conv_stats`, `stats_reduce_kernel`).  With
// the 32 channel lanes of one block alone (one block a 32 channels), the
// stem's 25088 partial rows took 0.19 ms on the card, a fifth of the conv.
constexpr int SEG = 256;

__global__ void __launch_bounds__(256)
conv_stats_segments_kernel(float* __restrict__ psum,
                           float* __restrict__ psumsq, int T, int F) {
  __shared__ float s_s[8][33];
  __shared__ float s_q[8][33];
  const int col = threadIdx.x;
  const int lane = threadIdx.y;
  const int f = blockIdx.x * 32 + col;
  const long long r0 = (long long)blockIdx.y * SEG;
  const int n = (int)(T - r0 < SEG ? T - r0 : SEG);
  float s = 0.f, q = 0.f;
  if (f < F) {
    for (int r = lane; r < n; r += 8) {
      s += psum[(r0 + r) * F + f];
      q += psumsq[(r0 + r) * F + f];
    }
  }
  s_s[lane][col] = s;
  s_q[lane][col] = q;
  __syncthreads();
  if (lane == 0 && f < F) {
    s = 0.f;
    q = 0.f;
    for (int i = 0; i < 8; ++i) {
      s += s_s[i][col];
      q += s_q[i][col];
    }
    psum[r0 * F + f] = s;
    psumsq[r0 * F + f] = q;
  }
}

// Sums T rows of psum / psumsq per channel, `stride` elements apart: block
// (32 channels) x (32 row lanes); each lane walks every 32nd row, then lane
// 0 adds the 32 lanes.
__global__ void __launch_bounds__(1024)
stats_reduce_kernel(const float* __restrict__ psum,
                    const float* __restrict__ psumsq, float* __restrict__ sum,
                    float* __restrict__ sumsq, int T, int F,
                    long long stride) {
  __shared__ float s_s[32][33];
  __shared__ float s_q[32][33];
  const int col = threadIdx.x;
  const int lane = threadIdx.y;
  const int f = blockIdx.x * 32 + col;
  float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
  if (f < F) {
    int r = lane;
    for (; r + 32 < T; r += 64) {
      s0 += psum[r * stride + f];
      q0 += psumsq[r * stride + f];
      s1 += psum[(r + 32) * stride + f];
      q1 += psumsq[(r + 32) * stride + f];
    }
    if (r < T) {
      s0 += psum[r * stride + f];
      q0 += psumsq[r * stride + f];
    }
  }
  s_s[lane][col] = s0 + s1;
  s_q[lane][col] = q0 + q1;
  __syncthreads();
  if (lane == 0 && f < F) {
    float s = 0.f, q = 0.f;
    for (int i = 0; i < 32; ++i) {
      s += s_s[i][col];
      q += s_q[i][col];
    }
    sum[f] = s;
    sumsq[f] = q;
  }
}

__device__ __forceinline__ float bn_one(float o, float mean, float inv,
                                        float gamma, float beta) {
  return (o - mean) * inv * gamma + beta;
}

// relu that keeps a NaN a NaN, as torch.relu and jnp.maximum do
__device__ __forceinline__ float relu_nan(float v) { return v < 0.f ? 0.f : v; }

template <typename T>
__global__ void bn_epilogue_vec4_kernel(
    const T* __restrict__ out, const float* __restrict__ mean,
    const float* __restrict__ inv, const float* __restrict__ gamma,
    const float* __restrict__ beta, const T* __restrict__ z,
    T* __restrict__ y, long long n4, int F, int relu) {
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n4;
       v += (long long)gridDim.x * blockDim.x) {
    const int f = (int)((v * 4) % F);
    const float4 o = Elem<T>::load4(out + v * 4);
    float4 r;
    r.x = bn_one(o.x, __ldg(mean + f), __ldg(inv + f), __ldg(gamma + f),
                 __ldg(beta + f));
    r.y = bn_one(o.y, __ldg(mean + f + 1), __ldg(inv + f + 1),
                 __ldg(gamma + f + 1), __ldg(beta + f + 1));
    r.z = bn_one(o.z, __ldg(mean + f + 2), __ldg(inv + f + 2),
                 __ldg(gamma + f + 2), __ldg(beta + f + 2));
    r.w = bn_one(o.w, __ldg(mean + f + 3), __ldg(inv + f + 3),
                 __ldg(gamma + f + 3), __ldg(beta + f + 3));
    if (z != nullptr) {
      const float4 zz = Elem<T>::load4(z + v * 4);
      r.x += zz.x;
      r.y += zz.y;
      r.z += zz.z;
      r.w += zz.w;
    }
    if (relu) {
      r.x = relu_nan(r.x);
      r.y = relu_nan(r.y);
      r.z = relu_nan(r.z);
      r.w = relu_nan(r.w);
    }
    Elem<T>::store4(y + v * 4, r);
  }
}

template <typename T>
__global__ void bn_epilogue_kernel(const T* __restrict__ out,
                                   const float* __restrict__ mean,
                                   const float* __restrict__ inv,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   const T* __restrict__ z, T* __restrict__ y,
                                   long long n, int F, int relu) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int f = (int)(i % F);
    float r = bn_one(Elem<T>::load(out + i), __ldg(mean + f), __ldg(inv + f),
                     __ldg(gamma + f), __ldg(beta + f));
    if (z != nullptr) r += Elem<T>::load(z + i);
    if (relu) r = relu_nan(r);
    Elem<T>::store(y + i, r);
  }
}

int epilogue_blocks(long long items) {
  const long long cap = 132LL * 16;  // enough resident blocks for 132 SMs
  long long b = (items + 255) / 256;
  if (b > cap) b = cap;
  return (int)(b < 1 ? 1 : b);
}

// Raise a kernel's dynamic shared-memory cap to `bytes` once per device
// (`done` is the instantiation's own mask of devices).  A refused request
// also sets the last error: it is cleared here and returned, so the launch
// is never made.
template <typename Kern>
int allow_smem(Kern kern, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(done & bit)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    done |= bit;
  }
  return 0;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Input rows of the rows kernel's window a 128-row block may need, or 0
// where they would pass WIN_MAX_BYTES: its rows span at most Q =
// ceil(127 / Wo) output-row steps, so at most Q s + K input rows of one
// image, or Q s + 2K - 2p - 1 across two (the halos overlap), else (Q / Ho
// + 2) images.
int window_rows(int N, int H, int W, int C, int K, int stride, int pad,
                int Ho, int Wo) {
  const long long Q = (TILE_M - 1 + Wo - 1) / Wo;
  const long long two = 2LL * K - 2LL * pad - 1;
  long long rows = Q < Ho ? Q * stride + (two > K ? two : K)
                          : (Q / Ho + 2) * (long long)H;
  if (rows > (long long)N * H) rows = (long long)N * H;
  return rows * WinRow(W, C, pad).rs * 2 <= WIN_MAX_BYTES ? (int)rows : 0;
}

// The grid of a kernel that walks several tiles a block: as many blocks
// as fit the card at once (`bytes` of shared memory each), rounded down to
// a multiple of the nF F tiles, or one block a tile where there are fewer
template <typename Kern>
int persistent_grid(Kern kern, int bytes, long long n_tiles, int nF,
                    int* grid) {
  static int sms[64] = {0};
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && sms[dev & 63] == 0)
    err = cudaDeviceGetAttribute(&sms[dev & 63],
                                 cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        CS_THREADS, bytes);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1 || n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long slots = (long long)per_sm * sms[dev & 63];
  long long g = n_tiles <= slots ? n_tiles : slots / nF * nF;
  if (g < nF) g = nF;
  *grid = (int)g;
  return 0;
}

template <int BN, bool VA, bool VB, int LAG>
int launch_conv_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                     __nv_bfloat16* out, float* psum, float* psumsq, int N,
                     int H, int W, int C, int F, int K, int stride, int pad,
                     int Ho, int Wo, long long tiles, cudaStream_t s) {
  constexpr int BYTES = 1024 + HCfg<BN, VA>::SMEM;  // alignment slack
  static unsigned long long done = 0;
  auto kern = conv_stats_bf16_kernel<BN, VA, VB, LAG>;
  int err = allow_smem(kern, BYTES, done);
  if (err) return err;
  const long long blocks = tiles * ((F + BN - 1) / BN);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, CS_THREADS, BYTES, s>>>(
      x, w, out, psum, psumsq, N, H, W, C, F, K, stride, pad, Ho, Wo);
  return (int)cudaGetLastError();
}

template <int BN, bool VA, bool VB>
int launch_conv_f32(const float* x, const float* w, float* out, float* psum,
                    float* psumsq, int N, int H, int W, int C, int F, int K,
                    int stride, int pad, int Ho, int Wo, long long tiles,
                    cudaStream_t s) {
  static unsigned long long done = 0;
  auto kern = conv_stats_f32_kernel<BN, VA, VB>;
  int err = allow_smem(kern, FCfg<BN>::SMEM, done);
  if (err) return err;
  const long long blocks = tiles * ((F + BN - 1) / BN);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, CS_THREADS, FCfg<BN>::SMEM, s>>>(
      x, w, out, psum, psumsq, N, H, W, C, F, K, stride, pad, Ho, Wo);
  return (int)cudaGetLastError();
}

template <bool VB>
int launch_conv_bf16_rows(const __nv_bfloat16* x, const __nv_bfloat16* w,
                          __nv_bfloat16* out, float* psum, float* psumsq,
                          int N, int H, int W, int C, int F, int K,
                          int stride, int pad, int Ho, int Wo, long long tiles,
                          int win, int bytes, cudaStream_t s) {
  static unsigned long long done = 0;
  auto kern = conv_stats_bf16_rows_kernel<VB>;
  int err = allow_smem(kern, 232448, done);
  if (err) return err;
  const int nF = (F + 63) / 64;
  int grid = 0;
  err = persistent_grid(kern, bytes, tiles * nF, nF, &grid);
  if (err) return err;
  kern<<<grid, CS_THREADS, bytes, s>>>(x, w, out, psum, psumsq, N, H, W, C, F,
                                       K, stride, pad, Ho, Wo, win,
                                       (int)(tiles * nF));
  return (int)cudaGetLastError();
}

// The bf16 conv; *tiles is its count of partial-sum rows
int conv_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
              __nv_bfloat16* out, float* psum, float* psumsq, int N, int H,
              int W, int C, int F, int K, int stride, int pad, int Ho, int Wo,
              long long* tiles, cudaStream_t s) {
  *tiles = ((long long)N * Ho * Wo + TILE_M - 1) / TILE_M;
  const bool va = C % 8 == 0 && aligned16(x);
  const bool vb = F % 8 == 0 && aligned16(w) && aligned16(out);
  // wgmma keeps a group in flight across the barrier at BN 64 (a 4-stage
  // ring) and, at BN 128, for K > 1: there it gained 2-8% at ResNet-50's
  // 3x3 convs, and lost 1-10% at its 1x1 convs
  if (va && vb && F > 64 && K > 1)
    return launch_conv_bf16<128, true, true, 1>(x, w, out, psum, psumsq, N, H,
                                                W, C, F, K, stride, pad, Ho,
                                                Wo, *tiles, s);
  if (va && vb && F > 64)
    return launch_conv_bf16<128, true, true, 0>(x, w, out, psum, psumsq, N, H,
                                                W, C, F, K, stride, pad, Ho,
                                                Wo, *tiles, s);
  if (va && vb)
    return launch_conv_bf16<64, true, true, 1>(x, w, out, psum, psumsq, N, H,
                                               W, C, F, K, stride, pad, Ho,
                                               Wo, *tiles, s);
  if (!va) {  // the rows kernel where B's chunks and two windows fit
    const int nch = (K * ((K * C + 7) & ~7) + HK - 1) / HK;
    const int win = window_rows(N, H, W, C, K, stride, pad, Ho, Wo);
    const int bytes =
        1024 + RowsCfg::bytes(nch, win * WinRow(W, C, pad).rs);
    if (nch <= ROWS_NCH_MAX && win > 0 && bytes <= 232448)
      return vb ? launch_conv_bf16_rows<true>(x, w, out, psum, psumsq, N, H,
                                              W, C, F, K, stride, pad, Ho, Wo,
                                              *tiles, win, bytes, s)
                : launch_conv_bf16_rows<false>(x, w, out, psum, psumsq, N, H,
                                               W, C, F, K, stride, pad, Ho,
                                               Wo, *tiles, win, bytes, s);
  }
  return vb ? launch_conv_bf16<64, false, true, 0>(x, w, out, psum, psumsq, N,
                                                   H, W, C, F, K, stride, pad,
                                                   Ho, Wo, *tiles, s)
            : launch_conv_bf16<64, false, false, 0>(x, w, out, psum, psumsq,
                                                    N, H, W, C, F, K, stride,
                                                    pad, Ho, Wo, *tiles, s);
}

int conv_f32(const float* x, const float* w, float* out, float* psum,
             float* psumsq, int N, int H, int W, int C, int F, int K,
             int stride, int pad, int Ho, int Wo, long long tiles,
             cudaStream_t s) {
  const bool va = C % 4 == 0 && aligned16(x);
  const bool vb = F % 4 == 0 && aligned16(w) && aligned16(out);
  if (va && vb && F > 64)
    return launch_conv_f32<128, true, true>(x, w, out, psum, psumsq, N, H, W,
                                            C, F, K, stride, pad, Ho, Wo,
                                            tiles, s);
  if (va && vb)
    return launch_conv_f32<64, true, true>(x, w, out, psum, psumsq, N, H, W,
                                           C, F, K, stride, pad, Ho, Wo,
                                           tiles, s);
  if (vb)
    return launch_conv_f32<64, false, true>(x, w, out, psum, psumsq, N, H, W,
                                            C, F, K, stride, pad, Ho, Wo,
                                            tiles, s);
  return launch_conv_f32<64, false, false>(x, w, out, psum, psumsq, N, H, W,
                                           C, F, K, stride, pad, Ho, Wo,
                                           tiles, s);
}

// The conv kernel of the dtype, then the fixed-order reduction of its
// partial-sum rows
template <typename T>
int conv_stats(const T* x, const T* w, T* out, float* psum, float* psumsq,
               float* sum, float* sumsq, int N, int H, int W, int C, int F,
               int K, int stride, int pad, int Ho, int Wo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = (long long)N * Ho * Wo;
  // element offsets into x (from a padded origin) are ints in the kernels
  if ((long long)N * (H + 2 * pad) * (W + 2 * pad) * C >= INT_MAX ||
      M >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  long long tiles = (M + TILE_M - 1) / TILE_M;
  int err;
  if constexpr (sizeof(T) == 4) {
    err = conv_f32(x, w, out, psum, psumsq, N, H, W, C, F, K, stride, pad, Ho,
                   Wo, tiles, s);
  } else {
    err = conv_bf16(x, w, out, psum, psumsq, N, H, W, C, F, K, stride, pad,
                    Ho, Wo, &tiles, s);
  }
  if (err) return err;
  long long rows = tiles, row_stride = F;
  if (tiles > SEG) {
    rows = (tiles + SEG - 1) / SEG;
    row_stride = (long long)SEG * F;
    const dim3 grid((F + 31) / 32, (unsigned)rows);
    conv_stats_segments_kernel<<<grid, dim3(32, 8), 0, s>>>(psum, psumsq,
                                                            (int)tiles, F);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  stats_reduce_kernel<<<(F + 31) / 32, dim3(32, 32), 0, s>>>(
      psum, psumsq, sum, sumsq, (int)rows, F, row_stride);
  return (int)cudaGetLastError();
}

template <typename T>
int bn_epilogue(const T* out, const float* mean, const float* inv,
                const float* gamma, const float* beta, const T* z, T* y,
                long long M, int F, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = M * F;
  const unsigned long long addr =
      (unsigned long long)out | (unsigned long long)y | (unsigned long long)z;
  if (F % 4 == 0 && (addr & (4 * sizeof(T) - 1)) == 0) {
    bn_epilogue_vec4_kernel<T><<<epilogue_blocks(n / 4), 256, 0, s>>>(
        out, mean, inv, gamma, beta, z, y, n / 4, F, relu);
  } else {
    bn_epilogue_kernel<T><<<epilogue_blocks(n), 256, 0, s>>>(
        out, mean, inv, gamma, beta, z, y, n, F, relu);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x [N, H, W, C], w [K, K, C, F], out [N, Ho, Wo, F] (all contiguous, all
// fp32 or all bf16); psum, psumsq fp32 scratch of at least
// [ceil(N*Ho*Wo / 128), F]; sum, sumsq [F] fp32.
extern "C" int conv_stats_f32(const float* x, const float* w, float* out,
                              float* psum, float* psumsq, float* sum,
                              float* sumsq, int N, int H, int W, int C, int F,
                              int K, int stride, int pad, int Ho, int Wo,
                              void* stream) {
  return conv_stats<float>(x, w, out, psum, psumsq, sum, sumsq, N, H, W, C, F,
                           K, stride, pad, Ho, Wo, stream);
}

extern "C" int conv_stats_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                               __nv_bfloat16* out, float* psum, float* psumsq,
                               float* sum, float* sumsq, int N, int H, int W,
                               int C, int F, int K, int stride, int pad,
                               int Ho, int Wo, void* stream) {
  return conv_stats<__nv_bfloat16>(x, w, out, psum, psumsq, sum, sumsq, N, H,
                                   W, C, F, K, stride, pad, Ho, Wo, stream);
}

// out, z (nullable), y [M, F] contiguous, all fp32 or all bf16; mean, inv,
// gamma, beta [F] fp32.
extern "C" int bn_epilogue_f32(const float* out, const float* mean,
                               const float* inv, const float* gamma,
                               const float* beta, const float* z, float* y,
                               long long M, int F, int relu, void* stream) {
  return bn_epilogue<float>(out, mean, inv, gamma, beta, z, y, M, F, relu,
                            stream);
}

extern "C" int bn_epilogue_bf16(const __nv_bfloat16* out, const float* mean,
                                const float* inv, const float* gamma,
                                const float* beta, const __nv_bfloat16* z,
                                __nv_bfloat16* y, long long M, int F,
                                int relu, void* stream) {
  return bn_epilogue<__nv_bfloat16>(out, mean, inv, gamma, beta, z, y, M, F,
                                    relu, stream);
}
