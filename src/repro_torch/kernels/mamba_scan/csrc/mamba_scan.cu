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
// with y in xdt's dtype and the final (P, N) state in f32.
//
// What bounds it on the card: at the serving path's shape (80 heads, P 64,
// one group of N 128, S 512 in chunks of 256, bf16) the function moves
// 13.5 MB (xdt and y 5.2 MB each, the f32 state 2.6 MB) and needs 2.0 GFLOP
// (the causal half of each chunk's Gram once per group, its decayed
// product with xdt, the inter-chunk term and the state update per head),
// so its bound is bytes: about 0.004 ms at 3.35 TB/s.
//
// Two kernels, chosen by dtype:
//   * bf16 (the serve path): `ssd_scan_mma_kernel`, the four products on
//     the tensor cores; its design is noted where it is defined, below.
//   * f32 (the f32 model check, with TF32 off): `ssd_scan_kernel`, below,
//     f32 FMAs out of shared memory on the CUDA cores.  It forms the Gram
//     once per head and P tile (160 times at the path's shape: 5.5 GFLOP
//     of FMAs), so its own limit is the CUDA-core FMA rate and the
//     shared-memory reads feeding it.  What its design does about it:
//     - The TPU kernel forms a chunk's whole (c, c) Gram in VMEM; at
//       c = 256 that is 256 KB in f32, more than an SM's shared memory.
//       Here a block walks 64-row query tiles and, inside each, the 64-row
//       key tiles up to the diagonal (tiles above it are never loaded),
//       forming one 64 x 64 score tile at a time in shared memory.
//     - One block per (B*H row) would give 80 blocks for 132 SMs.  Row p of
//       the state depends only on column p of xdt, so a block owns a
//       (row, 32-column P tile): 160 blocks at the path's shape, two
//       resident on each SM.  Each P tile forms the score tiles again.
//     - The state never leaves shared memory between chunks.  The new
//       state's sum is taken in registers while the last query tile walks
//       the key tiles, which it loads anyway.  Row strides of N+1, 33 and
//       65 floats keep the shared-memory reads free of bank conflicts.
// Both kernels:
//   * The chunk axis (the TPU grid's sequential axis) is a loop inside the
//     block, which carries the state.
//   * With one group the reference's kernel route repeats B and C once per
//     head in device memory.  Here a block reads its group's row
//     (row / rep) directly, so B and C are never repeated.
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
//   * Every output element is owned by one thread and summed in a fixed
//     order (no atomics), so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The bf16 tile helpers (cp.async, ldmatrix, mma.sync, hi + lo splits),
// shared with K1 and K4.
#include "mma_tiles.cuh"

namespace {

constexpr int kTI = 64;        // query rows of a tile
constexpr int kTJ = 64;        // key rows of a tile
constexpr int kTP = 32;        // P columns (state rows) a block owns
constexpr int kScanThreads = 256;  // 16 x 16 threads
constexpr int kMaxN = 128;

enum DType { kF32 = 0, kBF16 = 1 };

// `ssd_scan_kernel` is written for an input type T; f32 is the one it is
// built for (bf16 takes `ssd_scan_mma_kernel`).
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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
  for (int idx = threadIdx.x; idx < n_rows * cols; idx += kScanThreads) {
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
__global__ void __launch_bounds__(kScanThreads)
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

  for (int idx = tid; idx < kTP * ns; idx += kScanThreads) Hs[idx] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int clen = min(chunk, S - c0);
    for (int i = tid; i < clen; i += kScanThreads) cum[i] = lp[c0 + i];
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
    for (int i = tid; i < cpad; i += kScanThreads) {
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
  for (int idx = tid; idx < kTP * N; idx += kScanThreads) {
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
  ssd_scan_kernel<T, NB><<<grid, kScanThreads, smem, stream>>>(
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

// ------------------------------------------------------------------------
// bf16: `ssd_scan_mma_kernel`, the four products on the tensor cores.
//
// Grid (B*H, ceil(P / kPT)), kMmaThreads = 8 warps.  A block owns one head
// row and 64 P columns (all of them at the path's P = 64: 80 blocks), and
// walks the chunks in order.  In a chunk it walks super tiles of 128 query
// rows (warp w owns rows 16 w .. 16 w + 15 of one), and in each the 64-key
// tiles up to its last row, double buffered by cp.async:
//   G = C B^T          A = C (ldmatrix), B = the B tile (ldmatrix)
//   y += S xdt         S = G (.) exp(min(cum_i - cum_j, 0)), masked, from
//                      the accumulators as hi + lo bf16 A fragments;
//                      B = the xdt tile (ldmatrix.trans)
//   y  = exp(cum_i) C h0^T, first    B = h0 in shared memory, hi + lo
//   h += (xdt (.) w)^T B              in the last super tile, which sees
//                      every key tile: A = xdt^T (ldmatrix.trans of the xdt
//                      tile) times w in registers, hi + lo; B = the B tile
//                      (ldmatrix.trans); warp w owns state rows
//                      16 (w % 4) .. + 15 and half of N, in registers for
//                      the whole scan.
// All products are bf16 x bf16 -> f32 (`mma.sync.m16n8k16`), each hi and
// lo pair issued eight products apart so the tensor pipe has independent
// work.  B, C and xdt arrive in bf16, so the Gram's operands and xdt are
// exact; the three f32 operands (S, xdt w and h0) enter as hi + lo bf16
// terms, since each rounded once misses the bf16 tolerance at the path's
// shape (the CPU model in tests/test_torch_mamba_scan.py shows each), and a
// third term for h0 changes nothing there.  The decays inside a chunk are
// 2^x by the SFU alone (`ex2.approx`, about 2^-22 relative), of the f32
// exponent (cum_i - cum_j) log2(e); the prefix sum is the f32 kernel's
// (f64, index order, one thread, rounded once), so every route sees the
// same cum.
//
// What bounds it: at the path's shape it is the warps' issue of the
// products, the decays and the chunk's serial prefix sum, on 80 of the 132
// SMs at 228 registers a thread (one block an SM).  Prefetching the next
// super tile's C across tiles, and carrying the next chunk's prefix sum in
// warp 0's idle steps, each took it to 255 registers with spills and ran
// slower.  The Gram does not depend on the head, but a block forms it for
// its own head: sharing it across a group's heads would take one block per
// group (a single block at the path's shape), or a pass through device
// memory of 256 x 256 f32 tiles per chunk; formed again here on the tensor
// cores it is about a third of the block's products.  Whole P in a block
// keeps the Gram to once per head (with 32-column P tiles it would be
// twice, on 160 blocks, more than the 132 SMs take at once).
// ------------------------------------------------------------------------

constexpr int kMmaThreads = 256;   // 8 warps
constexpr int kQT = 128;           // query rows of a super tile (16 a warp)
constexpr int kKT = 64;            // keys of a key tile
constexpr int kPT = 64;            // P columns a block owns
constexpr int kSP = kPT + 8;       // row stride (bf16) of the xdt tiles

// Row stride (bf16) of the C, B and h0 tiles for a padded width of 16 NB.
__host__ __device__ constexpr int mma_row_stride(int nb) { return 16 * nb + 8; }

size_t mma_smem_bytes(int nb, int chunk) {
  const size_t sn = mma_row_stride(nb);
  const size_t halves = kQT * sn            // C super tile
                        + 2 * kKT * sn      // B tiles, two buffers
                        + 2 * kKT * kSP     // xdt tiles, two buffers
                        + 2 * kPT * sn;     // h0, hi and lo
  return 2 * halves + 3 * sizeof(float) * round_up(chunk, kQT);
}

// Rows [0, rows) of a tile of row stride `stride` (bf16) from the rows of a
// row-major matrix of leading dimension `ld` starting at `src`, columns
// [col0, col0 + cols) of it; rows at or past `valid` and columns at or past
// `width` read 0.  With ld a multiple of 8 each 16-byte piece lies wholly
// inside or outside `width` and goes by cp.async (the wrapper checks the
// base is 16-byte aligned); else plain loads and stores.
__device__ __forceinline__ void stage_bf16(bf16* dst, int stride,
                                           const bf16* src, int ld, int rows,
                                           int valid, int col0, int cols,
                                           int width) {
  if (ld % 8 == 0) {
    const int pieces = cols / 8;
    for (int i = threadIdx.x; i < rows * pieces; i += kMmaThreads) {
      const int r = i / pieces, c = (i % pieces) * 8;
      const bool ok = r < valid && col0 + c < width;
      cp_async16(smem_addr(dst + r * stride + c),
                 ok ? src + (size_t)r * ld + col0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kMmaThreads) {
      const int r = i / cols, c = i % cols;
      const bool ok = r < valid && col0 + c < width;
      dst[r * stride + c] =
          ok ? src[(size_t)r * ld + col0 + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// 2^x by the SFU alone (ex2.approx.ftz: relative error about 2^-22, results
// below 2^-126 flushed to 0), for the decays of the bf16 kernel.
__device__ __forceinline__ float ex2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int NB>
__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_scan_mma_kernel(const bf16* __restrict__ xdt, const float* __restrict__ la,
                    const bf16* __restrict__ bmat,
                    const bf16* __restrict__ cmat, bf16* __restrict__ y,
                    float* __restrict__ state, int S, int P, int N, int chunk,
                    int rep) {
  static_assert(NB % 2 == 0, "a warp holds NB / 2 pairs of state n-tiles");
  constexpr int NP = 16 * NB;                 // N padded
  constexpr int SN = mma_row_stride(NB);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = Cs + kQT * SN;
  bf16* Xs = Bs + 2 * kKT * SN;
  bf16* Hh = Xs + 2 * kKT * kSP;
  bf16* Hl = Hh + kPT * SN;
  float* cum = reinterpret_cast<float*>(Hl + kPT * SN);
  const int cpad = round_up(chunk, kQT);
  float* ecum = cum + cpad;     // exp(cum_i), 0 past the chunk's end
  float* wlast = ecum + cpad;   // exp(cum_last - cum_j), 0 past the end

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row = blockIdx.x;          // b * H + h
  const int grow = row / rep;          // b * G + h / rep
  const int p0 = blockIdx.y * kPT;
  const bf16* xp = xdt + (size_t)row * S * P;
  const float* lp = la + (size_t)row * S;
  const bf16* bp = bmat + (size_t)grow * S * N;
  const bf16* cp = cmat + (size_t)grow * S * N;
  // The state: warp w holds rows hp0 + (g, g + 8) of each 16, columns
  // hn0 + 8 j + (2 t4, 2 t4 + 1), j < NB.
  const int hp0 = (warp % 4) * 16, hn0 = (warp / 4) * (NP / 2);
  float h[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) h[j][e] = 0.f;

  // C rows of the super tile at i0 and the first key tile, one group.
  auto stage_super = [&](int c0, int clen, int i0) {
    stage_bf16(Cs, SN, cp + (size_t)(c0 + i0) * N, N, kQT, clen - i0, 0, NP,
               N);
    stage_bf16(Bs, SN, bp + (size_t)c0 * N, N, kKT, clen, 0, NP, N);
    stage_bf16(Xs, kSP, xp + (size_t)c0 * P, P, kKT, clen, p0, kPT, P);
    cp_async_commit();
  };

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int clen = min(chunk, S - c0);
    stage_super(c0, clen, 0);
    for (int i = tid; i < clen; i += kMmaThreads) cum[i] = lp[c0 + i];
    if (c0 > 0) {       // the state entering the chunk, as hi + lo bf16
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint32_t hi, lo;
          split_bf16(h[j][2 * i], h[j][2 * i + 1], hi, lo);
          const int off = (hp0 + g + 8 * i) * SN + hn0 + 8 * j + 2 * t4;
          *reinterpret_cast<uint32_t*>(Hh + off) = hi;
          *reinterpret_cast<uint32_t*>(Hl + off) = lo;
        }
    }
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
    for (int i = tid; i < cpad; i += kMmaThreads) {
      const bool in = i < clen;
      ecum[i] = in ? expf(cum[i]) : 0.f;
      wlast[i] = in ? expf(last - cum[i]) : 0.f;
    }
    const float decay = expf(last);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[j][e] *= decay;

    for (int i0 = 0; i0 < clen; i0 += kQT) {
      if (i0 > 0) stage_super(c0, clen, i0);
      const bool final_tile = i0 + kQT >= clen;
      const int n_kt = (min(i0 + kQT, clen) + kKT - 1) / kKT;
      const int r0 = i0 + warp * 16;          // this warp's first query row
      const int ia = r0 + g, ib = ia + 8;     // this lane's rows
      const bool live = r0 < clen;
      float acc[kPT / 8][4];
#pragma unroll
      for (int j = 0; j < kPT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

      for (int t = 0; t < n_kt; ++t) {
        const int j0 = t * kKT;
        const bf16* Bt = Bs + (t & 1) * kKT * SN;
        const bf16* Xt = Xs + (t & 1) * kKT * kSP;
        cp_async_wait<0>();
        __syncthreads();              // tile t in; tile t - 1 consumed
        if (t + 1 < n_kt) {
          const int nb = ((t + 1) & 1);
          stage_bf16(Bs + nb * kKT * SN, SN, bp + (size_t)(c0 + j0 + kKT) * N,
                     N, kKT, clen - j0 - kKT, 0, NP, N);
          stage_bf16(Xs + nb * kKT * kSP, kSP,
                     xp + (size_t)(c0 + j0 + kKT) * P, P, kKT,
                     clen - j0 - kKT, p0, kPT, P);
          cp_async_commit();
        }
        if (t == 0 && live && c0 > 0) {
          // Inter-chunk term first: acc = exp(cum_i) (C_i . h0).
#pragma unroll
          for (int ks = 0; ks < NB; ++ks) {
            uint32_t a[4];
            ldsm_x4(a, frag_a_addr<SN>(Cs, warp * 16, ks * 16, lane));
#pragma unroll
            for (int part = 0; part < 2; ++part) {   // h0's hi, then lo
              uint32_t b[kPT / 16][4];
#pragma unroll
              for (int np = 0; np < kPT / 16; ++np)
                ldsm_x4(b[np], frag_b_addr<SN>(part ? Hl : Hh, np * 16,
                                               ks * 16, lane));
#pragma unroll
              for (int np = 0; np < kPT / 16; ++np) {
                mma_bf16(acc[2 * np], a, b[np][0], b[np][1]);
                mma_bf16(acc[2 * np + 1], a, b[np][2], b[np][3]);
              }
            }
          }
          const float ea = ecum[ia], eb = ecum[ib];
#pragma unroll
          for (int j = 0; j < kPT / 8; ++j) {
            acc[j][0] *= ea;
            acc[j][1] *= ea;
            acc[j][2] *= eb;
            acc[j][3] *= eb;
          }
        }
        if (live && j0 <= r0 + 15) {
          // Scores of the warp's 16 rows and this tile's 64 keys.
          float sc[kKT / 8][4];
#pragma unroll
          for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < NB; ++ks) {
            uint32_t a[4];
            ldsm_x4(a, frag_a_addr<SN>(Cs, warp * 16, ks * 16, lane));
#pragma unroll
            for (int np = 0; np < kKT / 16; ++np) {
              uint32_t b[4];
              ldsm_x4(b, frag_b_addr<SN>(Bt, np * 16, ks * 16, lane));
              mma_bf16(sc[2 * np], a, b[0], b[1]);
              mma_bf16(sc[2 * np + 1], a, b[2], b[3]);
            }
          }
          const float ca = cum[min(ia, clen - 1)], cb = cum[min(ib, clen - 1)];
#pragma unroll
          for (int j = 0; j < kKT / 8; ++j) {
            const int k0j = j0 + j * 8 + 2 * t4;
            const float2 ck = *reinterpret_cast<const float2*>(cum + k0j);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kj = k0j + (e & 1);
              const int qi = e < 2 ? ia : ib;
              const float d = ex2_fast(fminf((e < 2 ? ca : cb) -
                                             (e & 1 ? ck.y : ck.x), 0.f) *
                                       kLog2e);
              sc[j][e] = kj <= qi && qi < clen ? sc[j][e] * d : 0.f;
            }
          }
          // acc += S xdt, S as hi + lo.
#pragma unroll
          for (int kk = 0; kk < kKT / 16; ++kk) {
            uint32_t sh[4], sl[4];
            acc_to_a_split(sc[2 * kk], sc[2 * kk + 1], sh, sl);
            uint32_t b[kPT / 16][4];
#pragma unroll
            for (int dp = 0; dp < kPT / 16; ++dp)
              ldsm_x4_trans(b[dp], frag_a_addr<kSP>(Xt, kk * 16, dp * 16,
                                                    lane));
#pragma unroll
            for (int dp = 0; dp < kPT / 16; ++dp) {
              mma_bf16(acc[2 * dp], sh, b[dp][0], b[dp][1]);
              mma_bf16(acc[2 * dp + 1], sh, b[dp][2], b[dp][3]);
            }
#pragma unroll
            for (int dp = 0; dp < kPT / 16; ++dp) {
              mma_bf16(acc[2 * dp], sl, b[dp][0], b[dp][1]);
              mma_bf16(acc[2 * dp + 1], sl, b[dp][2], b[dp][3]);
            }
          }
        }
        if (final_tile) {
          // h += (xdt w)^T B over this tile's 64 keys: the A fragments of
          // xdt^T (ldmatrix.trans of the xdt tile), scaled by w in
          // registers and split into hi + lo.
#pragma unroll
          for (int kk = 0; kk < kKT / 16; ++kk) {
            uint32_t ax[4], ah[4], al[4];
            ldsm_x4_trans(ax, frag_b_addr<kSP>(Xt, kk * 16, hp0, lane));
            const float2 w0 = *reinterpret_cast<const float2*>(
                wlast + j0 + kk * 16 + 2 * t4);
            const float2 w1 = *reinterpret_cast<const float2*>(
                wlast + j0 + kk * 16 + 8 + 2 * t4);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float2 xv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&ax[r]));
              const float2 w = r < 2 ? w0 : w1;
              split_bf16(xv.x * w.x, xv.y * w.y, ah[r], al[r]);
            }
            uint32_t b[NB / 2][4];
#pragma unroll
            for (int dp = 0; dp < NB / 2; ++dp)
              ldsm_x4_trans(b[dp], frag_a_addr<SN>(Bt, kk * 16,
                                                   hn0 + dp * 16, lane));
#pragma unroll
            for (int dp = 0; dp < NB / 2; ++dp) {
              mma_bf16(h[2 * dp], ah, b[dp][0], b[dp][1]);
              mma_bf16(h[2 * dp + 1], ah, b[dp][2], b[dp][3]);
            }
#pragma unroll
            for (int dp = 0; dp < NB / 2; ++dp) {
              mma_bf16(h[2 * dp], al, b[dp][0], b[dp][1]);
              mma_bf16(h[2 * dp + 1], al, b[dp][2], b[dp][3]);
            }
          }
        }
      }
      if (live) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qi = ia + 8 * i;
          if (qi >= clen) continue;
          bf16* yr = y + ((size_t)row * S + c0 + qi) * P;
#pragma unroll
          for (int j = 0; j < kPT / 8; ++j) {
            const int p = p0 + j * 8 + 2 * t4;
            if (p < P) yr[p] = __float2bfloat16_rn(acc[j][2 * i]);
            if (p + 1 < P) yr[p + 1] = __float2bfloat16_rn(acc[j][2 * i + 1]);
          }
        }
      }
      __syncthreads();                // C, the tiles and cum are read
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + hp0 + g + 8 * (e >> 1);
      const int n = hn0 + 8 * j + 2 * t4 + (e & 1);
      if (p < P && n < N) state[((size_t)row * P + p) * N + n] = h[j][e];
    }
}

template <int NB>
cudaError_t launch_mma(const void* xdt, const float* la, const void* b,
                       const void* c, void* y, float* state, int bh, int s,
                       int p, int n, int chunk, int rep, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(NB, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_mma_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(bh, (p + kPT - 1) / kPT);
  ssd_scan_mma_kernel<NB><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(xdt), la, static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<bf16*>(y), state, s, p, n,
      chunk, rep);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* xdt, const float* la, const void* b,
                         const void* c, void* y, float* state, int bh, int s,
                         int p, int n, int chunk, int rep,
                         cudaStream_t stream) {
  if (n <= 32)
    return launch_mma<2>(xdt, la, b, c, y, state, bh, s, p, n, chunk, rep,
                         stream);
  if (n <= 64)
    return launch_mma<4>(xdt, la, b, c, y, state, bh, s, p, n, chunk, rep,
                         stream);
  return launch_mma<8>(xdt, la, b, c, y, state, bh, s, p, n, chunk, rep,
                       stream);
}

int mma_nb(int n) { return n <= 32 ? 2 : n <= 64 ? 4 : 8; }

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
      if (reinterpret_cast<uintptr_t>(xdt) % 16 ||
          reinterpret_cast<uintptr_t>(b) % 16 ||
          reinterpret_cast<uintptr_t>(c) % 16)
        return cudaErrorMisalignedAddress;
      return dispatch_mma(xdt, la, b, c, y, state, bh, s, p, n, chunk, rep,
                          st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Bytes of dynamic shared memory the kernel of `dtype` takes at state width
// n and chunk length chunk.
long long ssd_scan_smem_bytes(int dtype, int n, int chunk) {
  if (n < 1 || n > kMaxN || chunk < 1) return -1;
  return (long long)(dtype == kBF16 ? mma_smem_bytes(mma_nb(n), chunk)
                                    : smem_bytes(n, chunk));
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
