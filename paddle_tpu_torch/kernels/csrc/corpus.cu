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
// Design.  The counterpart of the BlockSpec is a tile of tile_rows x cols
// floats staged in dynamic shared memory, which is what VMEM is on the TPU.
// The grid is (n_blocks, ceil(rows / tile_rows)); each block of 1024 threads
// loads its tile (float4 when cols is a multiple of 4), synchronizes,
// multiplies by 2 and writes the tile out; the last tile of a block may be
// ragged.  The caller passes the dynamic shared memory it requests (the
// wrapper takes it from `corpus_scale_smem_bytes`, the function the linter
// prices the launch with), and the entry asks for exactly that much with
// cudaFuncSetAttribute(cudaFuncAttributeMaxDynamicSharedMemorySize).  Past
// the card's opt-in limit (232448 bytes a block on an H100) that call
// refuses, and the entry returns its cudaError_t without launching: the
// corpus program's whole-block tile (4096 x 4096 floats, 64 MiB) is such a
// launch.  What bounds it: bytes (one read and one write of 4 bytes an
// element); the staging through shared memory and one block per SM at large
// tiles keep it off that bound, which is the hazard's price, not a goal.
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

template <bool VEC>
__global__ void corpus_scale_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int rows,
                                    int cols, int tile_rows) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const int r0 = blockIdx.y * tile_rows;
  const int nr = min(tile_rows, rows - r0);
  const long long off =
      ((long long)blockIdx.x * rows + r0) * (long long)cols;
  const long long count = (long long)nr * cols;
  if (VEC) {
    const float4* src = reinterpret_cast<const float4*>(x + off);
    for (long long i = threadIdx.x; i < count / 4; i += blockDim.x)
      smem4[i] = src[i];
  } else {
    for (long long i = threadIdx.x; i < count; i += blockDim.x)
      tile[i] = x[off + i];
  }
  __syncthreads();
  if (VEC) {
    float4* dst = reinterpret_cast<float4*>(out + off);
    for (long long i = threadIdx.x; i < count / 4; i += blockDim.x) {
      const float4 v = smem4[i];
      dst[i] = make_float4(2.f * v.x, 2.f * v.y, 2.f * v.z, 2.f * v.w);
    }
  } else {
    for (long long i = threadIdx.x; i < count; i += blockDim.x)
      out[off + i] = 2.f * tile[i];
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

template <bool VEC>
int launch_scale(const float* x, float* out, int n_blocks, int rows, int cols,
                 int tile_rows, long long smem_bytes, cudaStream_t stream) {
  if (smem_bytes > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      corpus_scale_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return refused(err);
  const dim3 grid(n_blocks, (rows + tile_rows - 1) / tile_rows);
  corpus_scale_kernel<VEC><<<grid, SCALE_THREADS, (size_t)smem_bytes,
                             stream>>>(x, out, rows, cols, tile_rows);
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
// tile_rows x cols floats.
extern "C" int corpus_scale_f32(const float* x, float* out, int n_blocks,
                                int rows, int cols, int tile_rows,
                                long long smem_bytes, void* stream) {
  if (tile_rows < 1 ||
      smem_bytes < (long long)tile_rows * cols * (long long)sizeof(float))
    return (int)cudaErrorInvalidValue;
  if (n_blocks == 0 || rows == 0 || cols == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (cols % 4 == 0 && aligned16(x) && aligned16(out))
    return launch_scale<true>(x, out, n_blocks, rows, cols, tile_rows,
                              smem_bytes, st);
  return launch_scale<false>(x, out, n_blocks, rows, cols, tile_rows,
                             smem_bytes, st);
}

extern "C" int corpus_smem_optin(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return refused(err);
  err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return err == cudaSuccess ? 0 : refused(err);
}
