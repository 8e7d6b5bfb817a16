// corpus.cu — the two kernels of the program linter's known-bad corpus, fp32,
// for sm_90a, and the card's shared-memory limit for one block.
//
// The corpus programs (paddle_tpu_torch/analysis/corpus.py) exist to be
// flagged by the linter; these kernels are what they launch, so a flagged
// program can be run on the card and its verdict held against what the card
// accepts.
//
// ---------------------------------------------------------------------------
// corpus_add_f32
//
// Replaces: paddle_tpu/analysis/corpus.py, the pallas_call of
// `_broadcast_lse_operand` at line 37 (body `_add_kernel`): out = x + b over
// two arrays of one shape, [512, 128] fp32 in the corpus program.  The hazard
// that program carries lives in the operand b (an lse vector broadcast and
// materialised to full size before the call), not in the kernel.
//
// Design.  One elementwise pass, one thread per element, or per float4 when
// n is a multiple of 4 and the three pointers are 16-byte aligned; a ragged
// last block is masked.  What bounds it: bytes (two reads and one write of 4
// bytes an element, one add).
//
// ---------------------------------------------------------------------------
// corpus_scale_f32
//
// Replaces: paddle_tpu/analysis/corpus.py, the pallas_call of
// `_vmem_overflow` at line 177 (body `_scale_kernel`): out = 2 * x over a grid
// of n_blocks blocks of [rows, cols] fp32 ([2, 4096, 4096] in the corpus
// program), each block held whole in VMEM by its BlockSpec.
//
// Design.  The counterpart of the BlockSpec is a buffer of tile_rows x cols
// floats in dynamic shared memory, which is what VMEM is on the TPU: the
// caller passes the bytes it requests (the wrapper takes them from
// `corpus_scale_smem_bytes`, the function the linter prices the launch
// with), and the entry asks for exactly that much with
// cudaFuncSetAttribute(cudaFuncAttributeMaxDynamicSharedMemorySize).  Past
// the card's opt-in limit (232448 bytes a block on an H100) that call
// refuses, and the entry returns its cudaError_t without launching: the
// corpus program's whole-block tile (4096 x 4096 floats, 64 MiB) is such a
// launch.  The grid is (n_blocks, grid_y), grid_y from the wrapper's
// `corpus_scale_grid`: at most one block an SM, and block (x, y) walks
// tiles y, y + grid_y, ... of matrix x, holding its buffer for the whole
// walk.  What bounds it: bytes (one read and one write of 4 bytes an
// element).
//   - Rows of 16-byte multiples (cols % 4 == 0) on 16-byte aligned x and
//     out stream through the buffer (`corpus_scale_stream_kernel`).  Its
//     first 128 bytes hold eight mbarriers; the rest is eight slots.  A
//     tile's rows are contiguous, so each tile is cut into equal chunks of
//     at most a slot (128-byte multiples but the last), and the block's
//     chunks pass through the slots in turn: one thread moves a chunk in
//     with cp.async.bulk global -> shared, completing on the slot's
//     mbarrier (expect_tx: the chunk's bytes); every thread waits on it,
//     doubles its part in place and fences the async proxy; after a
//     barrier the same thread stores the chunk with cp.async.bulk shared ->
//     global and commits a bulk group, then waits (wait_group.read) until
//     the previous chunk's store has read its slot and refills that slot
//     with the chunk eight past that one.  So seven chunks' loads are in
//     flight while one is doubled and stored.  The earlier design loaded a
//     whole tile, then synchronized, then stored it, one block an SM at 128
//     KB, so an SM's loads and stores never overlapped.
//   - Other rows (cols % 4 != 0, or unaligned pointers), and buffers too
//     small for eight 128-byte slots, take `corpus_scale_elem_kernel`: one
//     float a thread into the buffer, a barrier, doubled out.  This routes
//     by shape, as the float4 path of corpus_add does; nothing falls back.
//
// ---------------------------------------------------------------------------
// corpus_smem_optin
//
// Writes cudaDevAttrMaxSharedMemoryPerBlockOptin of the current device: the
// most dynamic shared memory one block may ask for, the budget the linter's
// shared-memory-overflow detector prices against.
//
// Every entry returns a cudaError_t as an int (0 on success).  A refused
// cudaFuncSetAttribute also records its error as the thread's last error,
// which the next cudaGetLastError() — another entry's after its launch, or
// PyTorch's own check after one of its kernels — would report as its own;
// the refusal path clears it before returning the code.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int ADD_THREADS = 256;
constexpr int SCALE_THREADS = 1024;

__global__ void corpus_add_kernel(const float* __restrict__ x,
                                  const float* __restrict__ b,
                                  float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + b[i];
}

__global__ void corpus_add_vec_kernel(const float4* __restrict__ x,
                                      const float4* __restrict__ b,
                                      float4* __restrict__ out, long long n4) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    const float4 u = x[i], v = b[i];
    out[i] = make_float4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w);
  }
}

// The stream kernel's ring: SLOTS mbarriers in the buffer's first
// HEADER bytes, then SLOTS slots of a multiple of ALIGN bytes each
constexpr int SLOTS = 8;
constexpr long long ALIGN = 128;
constexpr long long HEADER = 128;
constexpr int STREAM_THREADS = 256;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// bytes (a 16-byte multiple) global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// bytes shared -> global, in the thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, unsigned src,
                                           unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

// One block's walk: its tiles (blockIdx.y, + gridDim.y, ...) of matrix
// blockIdx.x, each cut into chunks of `chunk` bytes (the last one shorter).
struct Walk {
  long long row_bytes;
  int rows, tile_rows, tiles;
  unsigned chunk;
  int tile;        // tile index, or past `tiles` when the walk is done
  long long off;   // byte offset in the tile
  __device__ long long tile_bytes() const {
    return (long long)min(tile_rows, rows - tile * tile_rows) * row_bytes;
  }
  __device__ bool live() const { return tile < tiles; }
  __device__ unsigned bytes() const {
    return (unsigned)min((long long)chunk, tile_bytes() - off);
  }
  // byte offset of the chunk in the matrix
  __device__ long long at() const {
    return (long long)tile * tile_rows * row_bytes + off;
  }
  __device__ void next() {
    off += chunk;
    if (off >= tile_bytes()) {
      off = 0;
      tile += gridDim.y;
    }
  }
};

__global__ void __launch_bounds__(STREAM_THREADS)
corpus_scale_stream_kernel(const float* __restrict__ x,
                           float* __restrict__ out, int rows, int cols,
                           int tile_rows, long long buf_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned bars = smem_u32(smem);
  unsigned char* slots = smem + HEADER;
  const long long row_bytes = (long long)cols * sizeof(float);
  const long long max_chunk = (buf_bytes - HEADER) / SLOTS / ALIGN * ALIGN;
  // a full tile in equal chunks of at most a slot, each an ALIGN multiple
  // (the last of a tile a 16-byte one)
  const long long full = (long long)tile_rows * row_bytes;
  const long long per_tile = (full + max_chunk - 1) / max_chunk;
  const unsigned chunk = (unsigned)(((full + per_tile - 1) / per_tile +
                                     ALIGN - 1) / ALIGN * ALIGN);
  const char* src = reinterpret_cast<const char*>(x) +
                    (long long)blockIdx.x * rows * row_bytes;
  char* dst = reinterpret_cast<char*>(out) +
              (long long)blockIdx.x * rows * row_bytes;
  const int tiles = (rows + tile_rows - 1) / tile_rows;
  Walk c{row_bytes, rows, tile_rows, tiles, chunk, (int)blockIdx.y, 0};
  Walk p = c;  // the loads' cursor, thread 0's

  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < SLOTS && p.live(); ++s, p.next()) {
      mbar_expect_tx(bars + 8 * s, p.bytes());
      bulk_load(smem_u32(slots + (long long)s * chunk), src + p.at(),
                p.bytes(), bars + 8 * s);
    }
  }
  __syncthreads();

  for (int n = 0; c.live(); ++n, c.next()) {
    const int s = n % SLOTS;
    mbar_wait(bars + 8 * s, (n / SLOTS) & 1);
    float4* v = reinterpret_cast<float4*>(slots + (long long)s * chunk);
    const unsigned n4 = c.bytes() / 16;
    for (unsigned i = threadIdx.x; i < n4; i += STREAM_THREADS) {
      const float4 a = v[i];
      v[i] = make_float4(2.f * a.x, 2.f * a.y, 2.f * a.z, 2.f * a.w);
    }
    // the doubled values, written by the generic proxy, are read by the
    // bulk store (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(dst + c.at(), smem_u32(v), c.bytes());
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (n > 0 && p.live()) {
        // chunk n - 1's store has read its slot: refill it
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        const int r = (n - 1) % SLOTS;
        mbar_expect_tx(bars + 8 * r, p.bytes());
        bulk_load(smem_u32(slots + (long long)r * chunk), src + p.at(),
                  p.bytes(), bars + 8 * r);
        p.next();
      }
    }
  }
  // the buffer stays allocated until every store has completed
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__global__ void corpus_scale_elem_kernel(const float* __restrict__ x,
                                         float* __restrict__ out, int rows,
                                         int cols, int tile_rows) {
  extern __shared__ float tile[];
  const int tiles = (rows + tile_rows - 1) / tile_rows;
  for (int ti = blockIdx.y; ti < tiles; ti += gridDim.y) {
    const int r0 = ti * tile_rows;
    const int nr = min(tile_rows, rows - r0);
    const long long off =
        ((long long)blockIdx.x * rows + r0) * (long long)cols;
    const long long count = (long long)nr * cols;
    for (long long i = threadIdx.x; i < count; i += blockDim.x)
      tile[i] = x[off + i];
    __syncthreads();
    for (long long i = threadIdx.x; i < count; i += blockDim.x)
      out[off + i] = 2.f * tile[i];
    __syncthreads();  // the tile is read before the next one overwrites it
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Clears the refusal from the thread's last error and hands its code back.
int refused(cudaError_t err) {
  cudaGetLastError();
  return (int)err;
}

template <typename Kernel, typename... Args>
int launch_scale(Kernel kernel, int n_blocks, int grid_y, int threads,
                 long long smem_bytes, cudaStream_t stream, Args... args) {
  if (smem_bytes > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return refused(err);
  kernel<<<dim3(n_blocks, grid_y), threads, (size_t)smem_bytes, stream>>>(
      args...);
  return (int)cudaGetLastError();
}

}  // namespace

// x, b, out: n contiguous floats each.
extern "C" int corpus_add_f32(const float* x, const float* b, float* out,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n % 4 == 0 && aligned16(x) && aligned16(b) && aligned16(out)) {
    const long long n4 = n / 4;
    corpus_add_vec_kernel<<<(unsigned)((n4 + ADD_THREADS - 1) / ADD_THREADS),
                            ADD_THREADS, 0, st>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(b),
        reinterpret_cast<float4*>(out), n4);
  } else {
    corpus_add_kernel<<<(unsigned)((n + ADD_THREADS - 1) / ADD_THREADS),
                        ADD_THREADS, 0, st>>>(x, b, out, n);
  }
  return (int)cudaGetLastError();
}

// x, out: [n_blocks, rows, cols] contiguous floats.  smem_bytes is the
// dynamic shared memory the launch requests; it must hold a tile of
// tile_rows x cols floats.  grid_y: blocks a matrix, 1 to the tile count.
extern "C" int corpus_scale_f32(const float* x, float* out, int n_blocks,
                                int rows, int cols, int tile_rows, int grid_y,
                                long long smem_bytes, void* stream) {
  if (tile_rows < 1 ||
      smem_bytes < (long long)tile_rows * cols * (long long)sizeof(float))
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0 || rows == 0 || cols == 0) return 0;
  if (grid_y < 1 || grid_y > (rows + tile_rows - 1) / tile_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (cols % 4 == 0 && aligned16(x) && aligned16(out) &&
      smem_bytes >= HEADER + SLOTS * ALIGN)
    return launch_scale(corpus_scale_stream_kernel, n_blocks, grid_y,
                        STREAM_THREADS, smem_bytes, st, x, out, rows, cols,
                        tile_rows, smem_bytes);
  return launch_scale(corpus_scale_elem_kernel, n_blocks, grid_y,
                      SCALE_THREADS, smem_bytes, st, x, out, rows, cols,
                      tile_rows);
}

extern "C" int corpus_smem_optin(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return refused(err);
  err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return err == cudaSuccess ? 0 : refused(err);
}
