// Tiled matrix product for Hopper (sm_90a): kernel K3.  Built by
// kernels/build.py into a shared library with a plain C interface and bound
// with ctypes (matmul.py).
//
// K3 `matmul_launch` replaces the Pallas TPU kernel
// repro/kernels/matmul/matmul.py::matmul / _matmul_kernel: out = x @ y with
// an f32 accumulator, cast once to x's dtype at the end; x and y are f32 or
// bf16.  The Pallas grid walks K as a sequential third axis and carries the
// accumulator in VMEM scratch from one K step to the next.  Here each block
// owns an output tile (two shapes, below) and loops over K itself, so the
// accumulator stays in registers for the whole reduction.
//
// Row-slice invariance, bitwise.  Every output element is reduced in one
// fixed order: k = 0, 1, ..., K-1, one fused multiply-add each
// (acc = fma(x[m][k], y[k][n], acc)), in f32 on the CUDA cores (no TF32, no
// tensor cores).  That order does not depend on M, on the row offset or on
// N: there is no split-K and no atomics, and both compiled tiles (below)
// run the same chain.  So rows [lo, hi) of a product and the product of
// rows [lo, hi) of x are equal bit for bit, whichever tile computed each,
// which is what the TDA's 2-row grains rely on.  The ragged M, N
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
// product (1000^3) is bound by operations.
//
// Two compiled tiles, chosen by M in `matmul_launch`; both run the same
// chain per output element, so which one ran never shows in the bits:
//   * M <= 16 (the TDA's 2-row grains, 3 at the halo rows):
//     `matmul_strip_kernel`.  A block owns a strip of 8 output columns and
//     all M rows, one thread per (row, column) chain: 125 blocks at
//     n = 1000, 512 at n = 4096, so the whole card streams y.  y's 8-column
//     panel and x's rows pass through an 8-stage shared-memory ring of
//     32-deep K tiles filled by 16-byte `cp.async` copies (each thread's
//     pieces fixed at the start, so a tile costs a thread two copies), up to
//     six K tiles in flight while two are multiplied, behind one barrier a
//     pair.  Rows that are not 16-byte aligned (N or K not a multiple of
//     16 bytes, or an unaligned base) are staged by plain loads instead, and
//     the ragged N and K edges read 0.  The chain's own latency (about 4
//     cycles a k: 2.3 us at K = 1000, 9.5 us at K = 4096) stays below the
//     time y's bytes take at n = 4096 (20 us), so the fixed order is not
//     what limits it.
//   * M > 16: `matmul_kernel`, a 64 x 64 output tile a block, streaming its
//     64-column panel of y through shared memory once in 32-deep K tiles,
//     double buffered; a warp whose rows all lie past M skips the
//     multiply-adds.  It serves the 1000-square checks, off the main path.
// Both tiles take K in 32-deep steps with the tail read as 0, so both add
// the same fma(0, 0, acc) tail terms.

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

// ------------------------------------------------- M <= 16: column strips
constexpr int kSM = 16;                // rows the strip tile takes
constexpr int kSN = 8;                 // output columns a strip block holds
constexpr int kStages = 8;             // K tiles of the ring
constexpr int kStripThreads = kSM * kSN;   // one output chain a thread

static_assert(kStripThreads % 32 == 0, "whole warps");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero fill when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// K tile at k0 (rows k0 .. k0 + kBK - 1 of y's 8-column panel, the same
// columns of x's M rows) into ring stage (Ys, Xs) by plain loads and
// stores, for rows that do not start on a 16-byte boundary; past K, N or M
// reads 0.
template <typename T>
__device__ __forceinline__ void stage_strip_plain(T (*Ys)[kSN], T (*Xs)[kBK],
                                                 const T* __restrict__ x,
                                                 const T* __restrict__ y,
                                                 int M, int N, int K, int n0,
                                                 int k0) {
  for (int i = threadIdx.x; i < kBK * kSN; i += kStripThreads) {
    const int r = i / kSN, c = i % kSN;
    const bool ok = k0 + r < K && n0 + c < N;
    Ys[r][c] = ok ? y[(size_t)(k0 + r) * N + n0 + c] : from_f32<T>(0.f);
  }
  for (int i = threadIdx.x; i < M * kBK; i += kStripThreads) {
    const int r = i / kBK, c = i % kBK;
    Xs[r][c] = k0 + c < K ? x[(size_t)r * K + k0 + c] : from_f32<T>(0.f);
  }
}

// Grid (ceil(N / kSN)), kStripThreads threads; thread (m = tid / kSN,
// column n0 + tid % kSN) owns one output element and runs its chain
// acc = fma(x[m][k], y[k][n], acc), k = 0 .. K-1, as `matmul_kernel` does.
// K tiles go through the ring in pairs, one barrier a pair.
template <typename T>
__global__ void __launch_bounds__(kStripThreads)
    matmul_strip_kernel(const T* __restrict__ x, const T* __restrict__ y,
                        T* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) T Ys[kStages][kBK][kSN];
  __shared__ __align__(16) T Xs[kStages][kSM][kBK];

  constexpr int kVec = 16 / sizeof(T);           // elements a 16-byte piece
  constexpr int kYP = kSN / kVec, kXP = kBK / kVec;   // pieces a row
  static_assert(kBK * kYP <= kStripThreads && kSM * kXP <= kStripThreads,
                "one piece of y and one of x a thread");
  const int tid = threadIdx.x;
  const int m = tid / kSN, col = blockIdx.x * kSN + tid % kSN;
  const int n0 = blockIdx.x * kSN;
  const int n_k = (K + kBK - 1) / kBK;
  // Whole 16-byte pieces by cp.async when every row starts on a 16-byte
  // boundary (each piece then lies wholly inside or outside N and K).
  const bool vec = N % kVec == 0 && K % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  // This thread's pieces of every K tile: y row yr, columns yc ..; x row
  // xr, columns xc .. (relative to the tile).
  const int yr = tid / kYP, yc = (tid % kYP) * kVec;
  const int xr = tid / kXP, xc = (tid % kXP) * kVec;
  const bool y_mine = yr < kBK, y_in_n = n0 + yc < N, x_mine = xr < M;
  const T* y_row = y + (size_t)yr * N + n0 + yc;
  const T* x_row = x + (size_t)xr * K + xc;

  auto issue = [&](int t) {          // K tile t into stage t % kStages
    if (t < n_k) {
      const int st = t % kStages, k0 = t * kBK;
      if (vec) {
        if (y_mine) {
          const bool ok = y_in_n && k0 + yr < K;
          cp_async16(&Ys[st][yr][yc], ok ? y_row + (size_t)k0 * N : y, ok);
        }
        if (x_mine) {
          const bool ok = k0 + xc < K;
          cp_async16(&Xs[st][xr][xc], ok ? x_row + k0 : x, ok);
        }
      } else {
        stage_strip_plain(Ys[st], Xs[st], x, y, M, N, K, n0, k0);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < kStages - 2; ++t) issue(t);
  // Rows of a warp: m = 4 w .. 4 w + 3, so the test is uniform across a
  // warp whenever M is a multiple of 4, and at M = 2 half of warp 0 runs.
  const bool active = m < M;
  float acc = 0.f;
  for (int t = 0; t < n_k; t += 2) {
    cp_async_wait<kStages - 4>();    // tiles t and t + 1 are in
    __syncthreads();
    // The two stages refilled here were read at the previous pair, before
    // the barrier.
    issue(t + kStages - 2);
    issue(t + kStages - 1);
    if (active) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (t + h >= n_k) break;
        const T* xr_s = Xs[(t + h) % kStages][m];
        const T* yc_s = &Ys[(t + h) % kStages][0][tid % kSN];
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk)
          acc = __fmaf_rn(to_f32(xr_s[kk]), to_f32(yc_s[kk * kSN]), acc);
      }
    }
  }
  if (active && col < N) out[(size_t)m * N + col] = from_f32<T>(acc);
}

template <typename T>
cudaError_t launch(const void* x, const void* y, void* out, int M, int N,
                   int K, cudaStream_t stream) {
  if (M <= kSM) {
    matmul_strip_kernel<T><<<(N + kSN - 1) / kSN, kStripThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(y),
        static_cast<T*>(out), M, N, K);
    return cudaGetLastError();
  }
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
