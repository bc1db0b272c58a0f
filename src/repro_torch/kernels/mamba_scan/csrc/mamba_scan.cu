// Mamba-2 SSD chunked scan for Hopper (sm_90a): kernel K5.
// Built by kernels/build.py into a shared library with a plain C interface
// and bound with ctypes (mamba_scan.py).
//
// `ssd_scan` replaces the Pallas TPU kernel
// repro/kernels/mamba_scan/mamba_scan.py::ssd_scan / _ssd_kernel.  Per
// (B*H) row, from zero state, chunk after chunk in order:
//   cum    = inclusive prefix sum of la over the chunk, taken in f64 and
//            rounded to f32
//   y_i    = sum_{j <= i} (C_i . B_j) exp(min(cum_i - cum_j, 0)) xdt_j
//            + exp(cum_i) (C_i . h)
//   h      = exp(cum_last) h + sum_j (xdt_j exp(cum_last - cum_j)) (x) B_j
// with y in xdt's dtype and the final (P, N) state in f32.  Inputs are read
// in their dtype (f32 or bf16) and everything is computed in f32.
//
// What bounds it on the card: at the serving path's shape (80 heads, P 64,
// one group of N 128, S 512 in chunks of 256, bf16) the function moves
// 13.5 MB (xdt and y 5.2 MB each, the f32 state 2.6 MB) and needs 2.0 GFLOP
// (the causal half of each chunk's Gram once per group, its decayed
// product with xdt, the inter-chunk term and the state update per head),
// so its bound is bytes: about 0.004 ms at 3.35 TB/s.  This kernel forms
// the Gram once per head and P tile (160 times): 5.5 GFLOP of FMAs.
// This first version does the arithmetic with f32 FMAs out of shared memory
// on the CUDA cores, so its own limit is the CUDA-core FMA rate and the
// shared-memory reads feeding it; it is meant to be right first (the tensor
// cores are later work).  What the design does about it:
//   * The TPU kernel forms a chunk's whole (c, c) Gram in VMEM; at c = 256
//     that is 256 KB in f32, more than an SM's shared memory.  Here a block
//     walks 64-row query tiles and, inside each, the 64-row key tiles up to
//     the diagonal (tiles above it are never loaded), forming one 64 x 64
//     score tile at a time in shared memory.
//   * One block per (B*H row) would give 80 blocks for 132 SMs.  Row p of
//     the state depends only on column p of xdt, so a block owns a
//     (row, 32-column P tile): 160 blocks at the path's shape, two resident
//     on each SM.  Each P tile forms the score tiles again.
//   * With one group the reference's kernel route repeats B and C once per
//     head in device memory.  Here a block reads its group's row
//     (row / rep) directly, so B and C are never repeated.
//   * The state never leaves shared memory between chunks; the chunk axis
//     (the TPU grid's sequential axis) is a loop inside the block.  The new
//     state's sum is taken in registers while the last query tile walks the
//     key tiles, which it loads anyway.
//   * Every exp argument is <= 0 for la <= 0 (the reference clamps the
//     intra-chunk one; cum_last - cum_j and cum_i are <= 0 because the
//     prefix sum of non-positive terms does not increase), so extreme decay
//     underflows to 0 and stays finite.
//   * The decays are exp of differences of prefix sums that reach the
//     thousands at the path's shape (la = dt A down to about -50 a step),
//     where one f32 ulp is about 2.4e-4: prefix sums taken in two f32 orders
//     move a decay by that much relative, and 64 layers carry it past the
//     f32 tolerance.  So the prefix sum is taken in f64 (a sequential loop
//     of one thread, 256 adds) and rounded once, as the plain versions take
//     it (torch's cumsum of f64, which its CPU cumsum of f32 matches), and
//     every route sees the same f32 cum and the same exp arguments.
//   * A last chunk shorter than `chunk` (S not divisible by it) is masked:
//     rows past its end read 0 and are not written, which computes what the
//     reference's padding with la = 0 and xdt = 0 does.
// Every output element is owned by one thread and summed in a fixed order
// (no atomics), so two runs give the same bits.  Row strides of N+1, 33 and
// 65 floats keep the shared-memory reads free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTI = 64;        // query rows of a tile
constexpr int kTJ = 64;        // key rows of a tile
constexpr int kTP = 32;        // P columns (state rows) a block owns
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kMaxN = 128;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Bytes of dynamic shared memory for state width n and chunk length chunk.
size_t smem_bytes(int n, int chunk) {
  const int ns = n + 1;
  const size_t floats = (size_t)kTI * ns          // C tile
                        + (size_t)kTJ * ns        // B tile
                        + (size_t)kTJ * (kTP + 1) // xdt tile
                        + (size_t)kTI * (kTJ + 1) // score tile
                        + (size_t)kTP * ns        // state
                        + 3 * (size_t)round_up(chunk, kTJ);  // cum, e^cum, w
  return floats * sizeof(float);
}

// Stage rows [r0, r0 + n_rows) of the chunk (absolute rows c0 + r) of a
// (S, width) matrix, columns [col0, col0 + cols), into shared memory with
// row stride `stride`; rows at or past `valid` and columns at or past
// `width` read 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int n_rows, int valid, int col0,
                                      int cols, int width, int stride) {
  for (int idx = threadIdx.x; idx < n_rows * cols; idx += kThreads) {
    const int r = idx / cols, c = idx % cols;
    float v = 0.f;
    if (r < valid && col0 + c < width)
      v = to_f32(src[(size_t)(row0 + r) * width + col0 + c]);
    dst[r * stride + c] = v;
  }
}

// Grid (B*H, ceil(P / kTP)).  Thread t = (tx = t % 16, ty = t / 16) owns:
//   score tile entries (ty + 16 r, tx + 16 c), r, c < 4;
//   output entries (query ty + 16 r, column tx + 16 c), r < 4, c < 2;
//   state entries (column ty + 16 a, state index tx + 16 b), a < 2, b < NB.
template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ xdt, const float* __restrict__ la,
                const T* __restrict__ bmat, const T* __restrict__ cmat,
                T* __restrict__ y, float* __restrict__ state, int S, int P,
                int N, int chunk, int rep) {
  extern __shared__ float smem[];
  const int ns = N + 1;
  constexpr int xs = kTP + 1, ss = kTJ + 1;
  float* Cs = smem;
  float* Bs = Cs + kTI * ns;
  float* Xs = Bs + kTJ * ns;
  float* Ss = Xs + kTJ * xs;
  float* Hs = Ss + kTI * ss;
  float* cum = Hs + kTP * ns;
  const int cpad = round_up(chunk, kTJ);
  float* ecum = cum + cpad;     // exp(cum_i), 0 past the chunk's end
  float* wlast = ecum + cpad;   // exp(cum_last - cum_j), 0 past the end

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row = blockIdx.x;          // b * H + h
  const int grow = row / rep;          // b * G + h / rep
  const int p0 = blockIdx.y * kTP;
  const T* xp = xdt + (size_t)row * S * P;
  const float* lp = la + (size_t)row * S;
  const T* bp = bmat + (size_t)grow * S * N;
  const T* cp = cmat + (size_t)grow * S * N;

  for (int idx = tid; idx < kTP * ns; idx += kThreads) Hs[idx] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int clen = min(chunk, S - c0);
    for (int i = tid; i < clen; i += kThreads) cum[i] = lp[c0 + i];
    __syncthreads();
    if (tid == 0) {     // the prefix sum, in index order, in f64
      double run = 0.0;
      for (int i = 0; i < clen; ++i) {
        run += (double)cum[i];
        cum[i] = (float)run;
      }
    }
    __syncthreads();
    const float last = cum[clen - 1];
    for (int i = tid; i < cpad; i += kThreads) {
      const bool in = i < clen;
      ecum[i] = in ? expf(cum[i]) : 0.f;
      wlast[i] = in ? expf(last - cum[i]) : 0.f;
    }
    float hc[2][NB];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) hc[a][b] = 0.f;

    for (int i0 = 0; i0 < clen; i0 += kTI) {
      const bool final_tile = i0 + kTI >= clen;
      stage<T>(Cs, cp, c0 + i0, kTI, clen - i0, 0, N, N, ns);
      float acc[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.f;

      for (int j0 = 0; j0 <= i0; j0 += kTJ) {
        __syncthreads();               // tiles of the last step are read
        stage<T>(Bs, bp, c0 + j0, kTJ, clen - j0, 0, N, N, ns);
        stage<T>(Xs, xp, c0 + j0, kTJ, clen - j0, p0, kTP, P, xs);
        __syncthreads();
        // Scores of this (query tile, key tile): (C_i . B_j) * decay, j <= i.
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * ns + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * ns + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            float sv = 0.f;
            if (j <= i && i < clen)
              sv = g[r][c] * expf(fminf(cum[i] - cum[j], 0.f));
            Ss[(ty + 16 * r) * ss + tx + 16 * c] = sv;
          }
        }
        __syncthreads();
        // Intra-chunk term: acc += S_tile @ xdt_tile.
        for (int j = 0; j < kTJ; ++j) {
          const float x0 = Xs[j * xs + tx], x1 = Xs[j * xs + tx + 16];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float sv = Ss[(ty + 16 * r) * ss + j];
            acc[r][0] = fmaf(sv, x0, acc[r][0]);
            acc[r][1] = fmaf(sv, x1, acc[r][1]);
          }
        }
        // The last query tile sees every key tile: the state's new sum.
        if (final_tile) {
          for (int j = 0; j < kTJ; ++j) {
            const float w = wlast[j0 + j];
            const float xw0 = Xs[j * xs + ty] * w;
            const float xw1 = Xs[j * xs + ty + 16] * w;
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              const int n = tx + 16 * b;
              const float bv = n < N ? Bs[j * ns + n] : 0.f;
              hc[0][b] = fmaf(xw0, bv, hc[0][b]);
              hc[1][b] = fmaf(xw1, bv, hc[1][b]);
            }
          }
        }
      }
      // Inter-chunk term from the state entering the chunk, then y.
      float dot[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) dot[r][0] = dot[r][1] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float h0 = Hs[tx * ns + n], h1 = Hs[(tx + 16) * ns + n];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float cv = Cs[(ty + 16 * r) * ns + n];
          dot[r][0] = fmaf(cv, h0, dot[r][0]);
          dot[r][1] = fmaf(cv, h1, dot[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= clen) continue;
        const float e = ecum[i];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int p = p0 + tx + 16 * c;
          if (p < P)
            y[((size_t)row * S + c0 + i) * P + p] =
                from_f32<T>(acc[r][c] + e * dot[r][c]);
        }
      }
      __syncthreads();                 // Cs and Hs are read
    }
    const float decay = expf(last);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int n = tx + 16 * b;
        if (n < N) {
          float* h = Hs + (ty + 16 * a) * ns + n;
          *h = decay * *h + hc[a][b];
        }
      }
    __syncthreads();
  }
  for (int idx = tid; idx < kTP * N; idx += kThreads) {
    const int pl = idx / N, n = idx % N;
    if (p0 + pl < P)
      state[((size_t)row * P + p0 + pl) * N + n] = Hs[pl * ns + n];
  }
}

template <typename T, int NB>
cudaError_t launch(const void* xdt, const float* la, const void* b,
                   const void* c, void* y, float* state, int bh, int s,
                   int p, int n, int chunk, int rep, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (p + kTP - 1) / kTP);
  ssd_scan_kernel<T, NB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xdt), la, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), state, s, p, n, chunk,
      rep);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* xdt, const float* la, const void* b,
                       const void* c, void* y, float* state, int bh, int s,
                       int p, int n, int chunk, int rep,
                       cudaStream_t stream) {
  if (n <= 16)
    return launch<T, 1>(xdt, la, b, c, y, state, bh, s, p, n, chunk, rep,
                        stream);
  if (n <= 32)
    return launch<T, 2>(xdt, la, b, c, y, state, bh, s, p, n, chunk, rep,
                        stream);
  if (n <= 64)
    return launch<T, 4>(xdt, la, b, c, y, state, bh, s, p, n, chunk, rep,
                        stream);
  return launch<T, 8>(xdt, la, b, c, y, state, bh, s, p, n, chunk, rep,
                      stream);
}

}  // namespace

extern "C" {

// xdt (bh, s, p) and y (bh, s, p) in one dtype (0 f32, 1 bf16); la (bh, s)
// f32; b, c (bh / rep, s, n) in xdt's dtype, the row of head row r being
// r / rep; state (bh, p, n) f32.  All contiguous.  Returns the CUDA error
// of the launch (0 on success).
int ssd_scan(const void* xdt, const float* la, const void* b, const void* c,
             void* y, float* state, int bh, int s, int p, int n, int chunk,
             int rep, int dtype, void* stream) {
  if (bh < 1 || s < 1 || p < 1 || n < 1 || n > kMaxN || chunk < 1 ||
      rep < 1 || bh % rep)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_n<float>(xdt, la, b, c, y, state, bh, s, p, n, chunk,
                               rep, st);
    case kBF16:
      return dispatch_n<__nv_bfloat16>(xdt, la, b, c, y, state, bh, s, p, n,
                                       chunk, rep, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
