// Tiled matrix product for Hopper (sm_90a): kernel K3.  Built by
// kernels/build.py into a shared library with a plain C interface and bound
// with ctypes (matmul.py).
//
// K3 `matmul_launch` replaces the Pallas TPU kernel
// repro/kernels/matmul/matmul.py::matmul / _matmul_kernel: out = x @ y with
// an f32 accumulator, cast once to x's dtype at the end; x and y are f32 or
// bf16.  The Pallas grid walks K as a sequential third axis and carries the
// accumulator in VMEM scratch from one K step to the next.  Here each block
// owns a 64 x 64 output tile and loops over K itself, so the accumulator
// stays in registers for the whole reduction.
//
// Row-slice invariance, bitwise.  Every output element is reduced in one
// fixed order: k = 0, 1, ..., K-1, one fused multiply-add each
// (acc = fma(x[m][k], y[k][n], acc)), in f32 on the CUDA cores (no TF32, no
// tensor cores).  That order does not depend on M, on the row offset or on
// N: there is no split-K, no atomics, and one compiled tile.  So rows
// [lo, hi) of a product and the product of rows [lo, hi) of x are equal bit
// for bit, which is what the TDA's 2-row grains rely on.  The ragged M, N
// and K edges are masked inside the kernel: out-of-range loads read 0 and
// out-of-range outputs are not written.  The K tail adds fma(0, 0, acc)
// terms, the same ones for every row, so they change no comparison between
// row slices of one product.
//
// What bounds it on the card.  On the path each grain is (2, n) @ (n, n) in
// f32: it reads all of y (4 n^2 bytes) and does 4 n^2 flops, one flop per
// byte against the card's f32 ridge of about 20 (67 TFLOP/s over 3.35 TB/s),
// so a grain is bound by bytes: about 1.2 us at n = 1000 and 20 us at
// n = 4096 (y is 64 MB there, more than the 50 MB L2).  The full square
// product (1000^3) is bound by operations.  What this simple design does
// about it: each block streams its 64-column panel of y through shared
// memory once, in 32-deep K tiles, double buffered so that the global loads
// of the next tile are in flight while the current one is multiplied; a warp
// whose rows all lie past M skips the multiply-adds, so at M = 2 one warp of
// eight computes and the block's time is the panel's load.  Only
// ceil(n / 64) blocks stream y at M = 2 (16 at n = 1000, 64 at n = 4096),
// fewer than the 132 SMs, and each waits on a load per K tile: that, not the
// bytes, is what limits a grain.  A tile shaped for M = 2, wider loads and
// TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // output rows a block holds
constexpr int kBN = 64;        // output columns a block holds
constexpr int kBK = 32;        // K depth of one shared-memory tile
constexpr int kThreads = 256;  // 16 x 16; each thread owns 4 x 4 outputs
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kLoads = kBM * kBK / kThreads;   // x (and y) elements per thread

static_assert(kBM * kBK == kBK * kBN, "x and y tiles hold as many elements");
static_assert(kLoads * kThreads == kBM * kBK, "tile loads divide evenly");

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Global -> registers: the x tile (kBM x kBK) and the y tile (kBK x kBN)
// starting at K offset k0.  Consecutive threads read consecutive addresses;
// anything past M, N or K reads 0.
template <typename T>
__device__ __forceinline__ void load_tiles(const T* __restrict__ x,
                                           const T* __restrict__ y, int M,
                                           int N, int K, int m0, int n0,
                                           int k0, int tid, float (&ra)[kLoads],
                                           float (&rb)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = tid + i * kThreads;
    const int am = m0 + e / kBK, ak = k0 + e % kBK;
    ra[i] = (am < M && ak < K) ? to_f32(x[(size_t)am * K + ak]) : 0.f;
    const int bk = k0 + e / kBN, bn = n0 + e % kBN;
    rb[i] = (bk < K && bn < N) ? to_f32(y[(size_t)bk * N + bn]) : 0.f;
  }
}

// Registers -> shared memory.  The x tile's rows are padded to kBK + 1 so
// that the two rows a warp reads at once fall in different banks.
__device__ __forceinline__ void store_tiles(float (*As)[kBK + 1],
                                            float (*Bs)[kBN], int tid,
                                            const float (&ra)[kLoads],
                                            const float (&rb)[kLoads]) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int e = tid + i * kThreads;
    As[e / kBK][e % kBK] = ra[i];
    Bs[e / kBN][e % kBN] = rb[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  T* __restrict__ out, int M, int N, int K) {
  __shared__ float As[2][kBM][kBK + 1];
  __shared__ float Bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int n_k = (K + kBK - 1) / kBK;
  // This thread's rows are m0 + ty + 16 i; a warp holds two values of ty,
  // so the test below is uniform across the warp.
  const bool active = m0 + ty < M;

  float ra[kLoads], rb[kLoads];
  load_tiles(x, y, M, N, K, m0, n0, 0, tid, ra, rb);
  store_tiles(As[0], Bs[0], tid, ra, rb);
  __syncthreads();

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_k; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < n_k;
    if (more) load_tiles(x, y, M, N, K, m0, n0, (t + 1) * kBK, tid, ra, rb);
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[kTM], b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = As[cur][ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = Bs[cur][kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
      }
    }
    // The other buffer was last read before the previous barrier, so it
    // can take the next tile now; one barrier per K tile.
    if (more) store_tiles(As[cur ^ 1], Bs[cur ^ 1], tid, ra, rb);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) out[(size_t)row * N + col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* y, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K), y (K, N), out (M, N): row-major, contiguous, one dtype
// (0 f32, 1 bf16).  Returns the CUDA error of the launch (0 on success).
int matmul_launch(const void* x, const void* y, void* out, int M, int N,
                  int K, int dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch<float>(x, y, out, M, N, K, st);
    case kBF16: return launch<__nv_bfloat16>(x, y, out, M, N, K, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
