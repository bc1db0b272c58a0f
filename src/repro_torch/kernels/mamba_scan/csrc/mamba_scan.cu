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
// with y in xdt's dtype and the final (P, N) state in f32.  `ssd_scan_bwd`
// is its gradient, which the reference's kernel has not (its design is
// noted where its kernels are defined, after the forward's).
//
// What bounds it on the card: at the serving path's shape (80 heads, P 64,
// one group of N 128, S 512 in chunks of 256, bf16) the function moves
// 13.5 MB (xdt and y 5.2 MB each, the f32 state 2.6 MB) and needs 1.7 GFLOP
// (the causal half of each chunk's Gram once per group, its decayed
// product with xdt and the state update per head; the inter-chunk term per
// head after the first chunk), so its bound is bytes: about 0.004 ms at
// 3.35 TB/s.
//
// Two kernels, chosen by dtype:
//   * bf16 (the serve path): `ssd_scan_mma_kernel`, the four products on
//     the tensor cores; its design is noted where it is defined, below.
//   * f32 (the f32 model check, with TF32 off): `ssd_scan_f32_kernel`,
//     the four products as f32 FMAs on the CUDA cores; its design is noted
//     where it is defined, below.
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
//   * The first chunk skips the inter-chunk term: the state entering it is
//     exactly 0.
//   * Every output element is owned by one thread and summed in a fixed
//     order (no atomics), so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The tile helpers (cp.async, ldmatrix, mma.sync, hi + lo splits), shared
// with K1 and K4: the bf16 kernel's, and the f32 kernel's copies.
#include "mma_tiles.cuh"

namespace {

constexpr int kMaxN = 128;

enum DType { kF32 = 0, kBF16 = 1 };

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ------------------------------------------------------------------------
// f32: `ssd_scan_f32_kernel`, the four products as f32 FMAs.
//
// Why not the tensor cores: as three TF32 products each (hi = tf32(x),
// lo = tf32(x - hi); lo hi + hi lo + hi hi), the products keep about 21
// bits of each operand, and where la reaches -50 a step small outputs are
// sums of terms in the thousands: the CPU model in
// tests/test_torch_mamba_scan.py misses the reference's Pallas kernel by
// more than the f32 tolerance there (S = 300, chunk 256), and one TF32
// product misses it at the serving path's shape, where the FMA chains hold
// both.  So each output is one chain of fmaf in ascending k from 0, in the
// order the kernel this one replaced summed it:
//   G_ij = C_i . B_j over n;  S_ij = G_ij * expf(fminf(cum_i - cum_j, 0)),
//   0 above the diagonal and past the chunk's end;
//   acc_i = S_i . xdt over the chunk's keys (64-key tiles in order);
//   y_i = fmaf(expf(cum_i), C_i . h0, acc_i) after the first chunk, acc_i
//   in it;  hc = (xdt * w)^T B over the keys, w = expf(cum_last - cum_j),
//   xdt * w rounded to f32;  h = fmaf(expf(cum_last), h, hc).
//
// What bounds it: at phase 13's shape of chip_smoke.py (80 heads of P 64,
// one group of N 128, S 128 in one chunk, f32) the block's FMAs:
// 3.4 M a head row (the Gram's three 64 x 64 tiles up to the diagonal,
// 1.57 M, formed whole; their product with xdt, 0.79 M; the state update,
// 1.05 M), 272 M in all: 0.008 ms at the card's 67 TFLOP/s, 0.013 ms on 80
// SMs at 128 FMAs a clock.  What the design does about it:
//   * Grid (B*H, ceil(P / 64)): a block owns one head row and 64 P columns
//     (all of them at the path's P = 64: 80 blocks, one an SM at 189,696 B
//     of shared memory at chunk 256, and 52 of 132 SMs idle).  Splitting P
//     into two tiles of 32 would fill more SMs but form each chunk's Gram
//     twice: 160 blocks at one an SM run in two waves, 2.5 M FMAs a block,
//     so the slowest SM does 5.0 M against 3.4 M.
//   * 16 x 16 threads.  Each forms a 4 x 4 block of the 64 x 64 score tile
//     (rows ty + 16 r, keys tx + 16 c) and a 4 x 4 block of the output
//     (rows ty + 16 r, P columns 4 tx .. 4 tx + 3), and owns 4 P columns x
//     N / 16 state columns of the state.  Every product is a register
//     outer product fed 16 bytes at a time from shared memory: 8 reads of
//     16 bytes for 64 FMAs (Gram, S xdt, C h0), 3 for 32 (state).  Rows of
//     C and B are padded to N + 4 floats, so the 8 rows a quarter warp
//     reads at once fall in distinct banks; the rest read one row at once.
//   * B and xdt arrive by cp.async into two buffers, the next key tile's
//     (or the next query tile's first) in flight while this one is used;
//     C's next query tile is staged as soon as the Gram has read this one.
//     Inputs off a 16-byte boundary, or with P or N not a multiple of 4,
//     are staged by plain loads, chosen at launch.
//   * Warp 0 takes the chunk's prefix sum (f64, index order, one thread)
//     while warps 1-7 stage its first tiles; its lanes widen la to f64 and
//     round the sums back, so the one thread's chain is its adds alone.
//   * The state stays in shared memory, transposed (N rows of P), where the
//     next chunk's inter-chunk term reads it; the chunk's new sum stays in
//     registers until the chunk's end.
//   * Tiles above the diagonal are never loaded.
// What holds it there (scripts/k5_f32_timeline.py, an H100 at 700 W): the
// shared-memory reads.  A warp's 16-byte read takes four of the SM's cycles
// (128 bytes a cycle) however many of its lanes share an address, so 8 such
// reads for 64 FMAs a lane ask twice the cycles of the FMAs: the Gram of a
// 64 x 64 tile takes about 11,000 cycles, its product with xdt 3,700, the
// state update 7,600, where their FMAs take 4,100, 2,000 and 4,100 (a
// warp instruction a cycle on each of 4 schedulers).  Larger
// register blocks (8 x 8) would halve the reads but take a 128 x 128 tile
// at this block size, past the shared memory.
constexpr int kF32Threads = 256;         // 16 x 16
constexpr int kF32TI = 64;               // query rows of a tile
constexpr int kF32TJ = 64;               // keys of a key tile
constexpr int kF32PT = 64;               // P columns a block owns
constexpr int kF32CP = kF32PT / 16;      // P columns a thread owns
constexpr int kF32SX = kF32PT + 4;       // row stride of the xdt tiles and h
constexpr int kF32SS = kF32TJ + 4;       // row stride of the score tile
static_assert(kF32TI == kF32TJ, "a query tile sees the key tiles up to it");

// Bytes of dynamic shared memory at padded state width np and chunk length
// chunk: C (one query tile), B and xdt (two key tiles each), the scores,
// the state, a key tile's w and the chunk's cum.
size_t f32_smem_bytes(int np, int chunk) {
  const size_t sf = np + 4;
  const size_t floats = kF32TI * sf + 2 * kF32TJ * sf + 2 * kF32TJ * kF32SX
                        + kF32TI * kF32SS + (size_t)np * kF32SX + kF32TJ
                        + round_up(chunk, kF32TJ);
  return floats * sizeof(float);
}

// Rows [0, ROWS) of a tile of row stride `stride` (floats) from the rows of
// a row-major f32 matrix of leading dimension `ld` starting at `src`,
// columns [col0, col0 + COLS) of it, by thread t of nt; rows at or past
// `valid` and columns at or past `width` read 0.  With a 16-byte aligned
// base and ld a multiple of 4, each 16-byte piece lies wholly inside or
// outside `width` and goes by cp.async; else plain loads and stores.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_f32(float* dst, int stride,
                                          const float* src, int ld, int valid,
                                          int col0, int width, bool aligned,
                                          int t, int nt) {
  if (aligned && ld % 4 == 0) {
    constexpr int kPieces = COLS / 4;
    for (int i = t; i < ROWS * kPieces; i += nt) {
      const int r = i / kPieces, c = (i % kPieces) * 4;
      const bool ok = r < valid && col0 + c < width;
      cp_async16(smem_addr(dst + r * stride + c),
                 ok ? src + (size_t)r * ld + col0 + c : src, ok);
    }
  } else {
    for (int i = t; i < ROWS * COLS; i += nt) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r < valid && col0 + c < width;
      dst[r * stride + c] = ok ? src[(size_t)r * ld + col0 + c] : 0.f;
    }
  }
}

// W consecutive floats of shared memory, 16 bytes at a time (8 for W = 2).
template <int W>
__device__ __forceinline__ void load_row(float (&d)[W], const float* p) {
  static_assert(W == 2 || W % 4 == 0, "rows are read 8 or 16 bytes a time");
  if constexpr (W == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    d[0] = x.x;
    d[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      d[i] = x.x;
      d[i + 1] = x.y;
      d[i + 2] = x.z;
      d[i + 3] = x.w;
    }
  }
}

// W consecutive floats to device memory, 16 bytes at a time (8 for W = 2).
template <int W>
__device__ __forceinline__ void store_row(float* p, const float (&d)[W]) {
  static_assert(W == 2 || W % 4 == 0, "rows are written 8 or 16 bytes a time");
  if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(d[i], d[i + 1], d[i + 2], d[i + 3]);
  }
}

// out[r][q] += sum over k < 4 (in order) of a[r][k] * b[k][q]: one step of
// four k of a register outer product, each output's FMAs in ascending k.
template <int R, int Q>
__device__ __forceinline__ void fma4(float (&out)[R][Q], const float (&a)[R][4],
                                     const float (&b)[4][Q]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < Q; ++q) out[r][q] = fmaf(a[r][k], b[k][q], out[r][q]);
}

// cum[0, n) = the inclusive prefix sum of la[0, n), taken in f64 in index
// order by one thread and rounded to f32 once, by warp 0 (`scratch`: room
// for kPrefixPiece doubles).  Its lanes widen la to f64 and round the sums
// back, so the one thread's chain is its f64 adds alone.
constexpr int kPrefixPiece = 512;

__device__ __forceinline__ void prefix_sum_f64(float* cum, const float* la,
                                               int n, double* scratch) {
  const int lane = threadIdx.x;
  double run = 0.0;
  for (int i0 = 0; i0 < n; i0 += kPrefixPiece) {
    const int len = min(kPrefixPiece, n - i0);
    for (int i = lane; i < len; i += 32) scratch[i] = (double)la[i0 + i];
    __syncwarp();
    if (lane == 0) {
      int i = 0;
      for (; i + 8 <= len; i += 8) {
        double v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = scratch[i + e];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          run += v[e];
          v[e] = run;
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) scratch[i + e] = v[e];
      }
      for (; i < len; ++i) {
        run += scratch[i];
        scratch[i] = run;
      }
    }
    __syncwarp();
    for (int i = lane; i < len; i += 32) cum[i0 + i] = (float)scratch[i];
    __syncwarp();
  }
}

// Grid (B*H, ceil(P / kF32PT)); NP is N padded to 32, 64 or 128.
template <int NP>
__global__ void __launch_bounds__(kF32Threads, 1)
ssd_scan_f32_kernel(const float* __restrict__ xdt, const float* __restrict__ la,
                    const float* __restrict__ bmat,
                    const float* __restrict__ cmat, float* __restrict__ y,
                    float* __restrict__ state, int S, int P, int N, int chunk,
                    int rep, int aligned) {
  constexpr int SF = NP + 4;            // row stride of the C and B tiles
  constexpr int CP = kF32CP;
  constexpr int NV = NP / 16;           // state columns a thread owns
  extern __shared__ __align__(16) float smf[];
  float* Cs = smf;                           // kF32TI x SF
  float* Bs = Cs + kF32TI * SF;              // 2 x kF32TJ x SF
  float* Xs = Bs + 2 * kF32TJ * SF;          // 2 x kF32TJ x kF32SX
  float* Ss = Xs + 2 * kF32TJ * kF32SX;      // kF32TI x kF32SS
  float* Hs = Ss + kF32TI * kF32SS;          // the state: NP rows n of P
  float* wl = Hs + NP * kF32SX;              // w of a key tile's keys
  float* cum = wl + kF32TJ;                  // the chunk's cum

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row = blockIdx.x;          // b * H + h
  const int grow = row / rep;          // b * G + h / rep
  const int p0 = blockIdx.y * kF32PT;
  const float* xp = xdt + (size_t)row * S * P;
  const float* lp = la + (size_t)row * S;
  const float* bp = bmat + (size_t)grow * S * N;
  const float* cp = cmat + (size_t)grow * S * N;
  // This thread's state: hs[v * kF32SX + q] is (P column p0 + CP tx + q,
  // state column NV ty + v).
  float* hs = Hs + ty * NV * kF32SX + tx * CP;

  // B and xdt rows [j0, j0 + kF32TJ) of the chunk at c0 into buffer buf;
  // C rows [i0, i0 + kF32TI); by thread t of nt.
  auto stage_keys = [&](int c0, int clen, int j0, int buf, int t, int nt) {
    stage_f32<kF32TJ, NP>(Bs + buf * kF32TJ * SF, SF,
                          bp + (size_t)(c0 + j0) * N, N, clen - j0, 0, N,
                          aligned, t, nt);
    stage_f32<kF32TJ, kF32PT>(Xs + buf * kF32TJ * kF32SX, kF32SX,
                              xp + (size_t)(c0 + j0) * P, P, clen - j0, p0, P,
                              aligned, t, nt);
  };
  auto stage_queries = [&](int c0, int clen, int i0, int t, int nt) {
    stage_f32<kF32TI, NP>(Cs, SF, cp + (size_t)(c0 + i0) * N, N, clen - i0,
                          0, N, aligned, t, nt);
  };

  // Warp 0 takes each chunk's prefix sum from its start, while warps 1-7
  // stage the chunk's first tiles (and zero the state); the score tile is
  // free until the first Gram, so it lends its room.
  constexpr int kStagers = kF32Threads - 32;
  if (tid >= 32)
    for (int i = tid - 32; i < NP * kF32SX; i += kStagers) Hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int clen = min(chunk, S - c0);
    if (tid < 32) {
      prefix_sum_f64(cum, lp + c0, clen, reinterpret_cast<double*>(Ss));
    } else {
      stage_queries(c0, clen, 0, tid - 32, kStagers);
      stage_keys(c0, clen, 0, 0, tid - 32, kStagers);
    }
    cp_async_commit();
    float hc[CP][NV];                  // this chunk's (xdt w)^T B
#pragma unroll
    for (int q = 0; q < CP; ++q)
#pragma unroll
      for (int v = 0; v < NV; ++v) hc[q][v] = 0.f;

    int step = 0;                      // (query tile, key tile) steps
    for (int i0 = 0; i0 < clen; i0 += kF32TI) {
      const bool final_tile = i0 + kF32TI >= clen;
      float acc[4][CP], dot[4][CP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) acc[r][q] = dot[r][q] = 0.f;

      for (int j0 = 0; j0 <= i0; j0 += kF32TJ, ++step) {
        const float* Bt = Bs + (step & 1) * kF32TJ * SF;
        const float* Xt = Xs + (step & 1) * kF32TJ * kF32SX;
        cp_async_wait<0>();
        __syncthreads();     // this step's tiles and cum in; the last step's
                             // reads done
        if (j0 < i0)         // the next key tile, or the next query tile's
          stage_keys(c0, clen, j0 + kF32TJ, (step + 1) & 1, tid,   // first
                     kF32Threads);
        else if (!final_tile)
          stage_keys(c0, clen, 0, (step + 1) & 1, tid, kF32Threads);
        cp_async_commit();
        if (final_tile && tid < kF32TJ) {
          const int j = j0 + tid;
          wl[tid] = j < clen ? expf(cum[clen - 1] - cum[j]) : 0.f;
        }
        if (j0 == 0 && c0 > 0) {
          // The inter-chunk term's product C h0^T.
#pragma unroll 2
          for (int n = 0; n < NP; n += 4) {
            float cv[4][4], hv[4][CP];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              load_row(cv[r], Cs + (ty + 16 * r) * SF + n);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              load_row(hv[k], Hs + (n + k) * kF32SX + tx * CP);
            fma4(dot, cv, hv);
          }
        }
        // Scores of this (query tile, key tile): (C_i . B_j) * decay.
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
#pragma unroll 1
        for (int n = 0; n < NP; n += 4) {
          float cv[4][4], bv[4][4], bt[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            load_row(cv[r], Cs + (ty + 16 * r) * SF + n);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            load_row(bv[c], Bt + (tx + 16 * c) * SF + n);
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int c = 0; c < 4; ++c) bt[k][c] = bv[c][k];
          fma4(g, cv, bt);
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
            Ss[(ty + 16 * r) * kF32SS + tx + 16 * c] = sv;
          }
        }
        __syncthreads();     // the scores and w written; C read
        if (j0 == i0 && !final_tile) {
          stage_queries(c0, clen, i0 + kF32TI, tid, kF32Threads);
          cp_async_commit();
        }
        // Intra-chunk term: acc += S_tile xdt_tile.
#pragma unroll 2
        for (int j = 0; j < kF32TJ; j += 4) {
          float sv[4][4], xv[4][CP];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            load_row(sv[r], Ss + (ty + 16 * r) * kF32SS + j);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            load_row(xv[k], Xt + (j + k) * kF32SX + tx * CP);
          fma4(acc, sv, xv);
        }
        // The last query tile sees every key tile: the state's new sum.
        if (final_tile) {
#pragma unroll 2
          for (int j = 0; j < kF32TJ; ++j) {
            const float w = wl[j];
            float xv[CP], bv[NV];
            load_row(xv, Xt + j * kF32SX + tx * CP);
            load_row(bv, Bt + j * SF + ty * NV);
#pragma unroll
            for (int q = 0; q < CP; ++q) {
              const float xw = xv[q] * w;
#pragma unroll
              for (int v = 0; v < NV; ++v) hc[q][v] = fmaf(xw, bv[v], hc[q][v]);
            }
          }
        }
      }
      // y, with the inter-chunk term after the first chunk.
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= clen) continue;
        float out[CP];
        const float e = c0 > 0 ? expf(cum[i]) : 0.f;
#pragma unroll
        for (int q = 0; q < CP; ++q)
          out[q] = c0 > 0 ? fmaf(e, dot[r][q], acc[r][q]) : acc[r][q];
        const int pc = p0 + tx * CP;
        float* yr = y + ((size_t)row * S + c0 + i) * P + pc;
        if (P % CP == 0 && pc < P) {
          store_row(yr, out);
        } else {
#pragma unroll
          for (int q = 0; q < CP; ++q)
            if (pc + q < P) yr[q] = out[q];
        }
      }
    }
    // h = exp(cum_last) h + hc, each thread its own entries.
    const float decay = expf(cum[clen - 1]);
#pragma unroll
    for (int q = 0; q < CP; ++q)
#pragma unroll
      for (int v = 0; v < NV; ++v)
        hs[v * kF32SX + q] = fmaf(decay, hs[v * kF32SX + q], hc[q][v]);
    __syncthreads();         // the state, cum and the tiles are read
  }
  // The final state from its transposed copy: a warp writes 8 rows of P,
  // 4 threads a row, four consecutive n a thread at a time (16 bytes where
  // N allows), so its reads of the copy fall at most two to a bank.
  static_assert(kF32PT == 8 * (kF32Threads / 32), "8 rows of P a warp");
  const int pl = 8 * (tid / 32) + (tid % 32) / 4;
  if (p0 + pl < P) {
    float* dst = state + ((size_t)row * P + p0 + pl) * N;
    for (int n = 4 * (tid % 4); n < N; n += 16) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = Hs[(n + e) * kF32SX + pl];
      if (N % 4 == 0) {
        store_row(dst + n, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < N) dst[n + e] = v[e];
      }
    }
  }
}

template <int NP>
cudaError_t launch_f32(const void* xdt, const float* la, const void* b,
                       const void* c, void* y, float* state, int bh, int s,
                       int p, int n, int chunk, int rep, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(NP, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_f32_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int aligned = (reinterpret_cast<uintptr_t>(xdt) |
                       reinterpret_cast<uintptr_t>(b) |
                       reinterpret_cast<uintptr_t>(c)) % 16 == 0;
  dim3 grid(bh, (p + kF32PT - 1) / kF32PT);
  ssd_scan_f32_kernel<NP><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(xdt), la, static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<float*>(y), state, s, p, n,
      chunk, rep, aligned);
  return cudaGetLastError();
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
// base is 16-byte aligned); else plain loads and stores.  By the NT threads
// of the block.
template <int NT = kMmaThreads>
__device__ __forceinline__ void stage_bf16(bf16* dst, int stride,
                                           const bf16* src, int ld, int rows,
                                           int valid, int col0, int cols,
                                           int width) {
  if (ld % 8 == 0) {
    const int pieces = cols / 8;
    for (int i = threadIdx.x; i < rows * pieces; i += NT) {
      const int r = i / pieces, c = (i % pieces) * 8;
      const bool ok = r < valid && col0 + c < width;
      cp_async16(smem_addr(dst + r * stride + c),
                 ok ? src + (size_t)r * ld + col0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += NT) {
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

// ------------------------------------------------------------------------
// Backward: five kernels a call, in order `ssd_bwd_sums_*`,
// `ssd_bwd_pass_kernel`, `ssd_bwd_local_*`, `ssd_bwd_dla_kernel` and
// `ssd_bwd_reduce_kernel` (`*`: `mma_kernel<NB>` for bf16 inputs, on the
// tensor cores; `kernel<NP>` for f32, f32 FMAs on the CUDA cores).
//
// Replaces no Pallas kernel: the reference's kernel route has no VJP
// (jax.grad through repro/kernels/mamba_scan/ops.py::ssd with
// use_pallas=True fails), and its models train through the plain route
// (ssd_chunked_grouped) under jax.grad.  This is that gradient of K5's
// function, written out per chunk; ref.py::ssd_scan_bwd_plain lists its
// terms and is what it is held against.  Inputs xdt, B, C and dy in one
// dtype (bf16 or f32), la f32; dxdt in the inputs' dtype, dla f32, dB and
// dC per group in the inputs' dtype.
//
// Design: the chunked SSD algorithm of the Mamba-2 paper (chunk states,
// state passing, chunk-local terms), applied to the gradient, so no block
// walks the chunks in order.  Per chunk z of length L, W_ij = e^{cum_i -
// cum_j} (j <= i), w_j = e^{cum_L - cum_j}, E = (C B^T) . W . (dY X^T):
//   1. `ssd_bwd_sums_*`, grid (B*H, chunks, 2): the chunk's prefix sum of
//      la (f64, index order, one thread, rounded once: every route's cum),
//      into the workspace; the chunk's own state sum hc = (x . w)^T B (all
//      chunks but the last; blocks of side 0) and its dy-side sum gc =
//      (dy . e^{cum})^T C (all but the first; side 1), (64, NP) f32 each.
//   2. `ssd_bwd_pass_kernel`, grid (B*H, 1024-entry tiles of the state):
//      the short serial chains, entry by entry, in place over hc and gc:
//      h_in(z+1) = e^{cum_L(z)} h_in(z) + hc_z from 0, and dh(z-1) =
//      e^{cum_L(z)} dh(z) + gc_z from dstate (or 0); and each tile's f32
//      part of <dh(z), h_in(z)>.
//   3. `ssd_bwd_local_*`, grid (B*H, chunks, 64-row tiles): 1280 blocks at
//      the training shape, where the last design ran 80.  Block (z, t) takes
//      tile t first as keys j against the query tiles i >= j: dx_j and dB_j
//      (per head), the state terms w_j dh B_j and w_j dh^T x_j, r_j =
//      w_j x_j . dh B_j, and every E tile with j in t, formed once: its
//      column sums (over i, for dcum_j) and its row sums (over j in t, for
//      dcum_i) both leave the block as f64 sums, the rows' per (i, key
//      tile).  (In bf16 the key role takes the query tiles twice, dx and
//      E's sums, then dB, so that no pass holds both dx's and dB's
//      accumulators.)  Then tile t as queries i against the key tiles j <=
//      i: dC_i (per head, from dY X^T again, not the Gram) and the entering
//      state's terms e^{cum_i} h_in^T dy_i and its dot with C_i.  The key
//      role of tile t has nt - t tile pairs and the query role t + 1, so
//      the blocks differ by little; the heaviest (t = 0) are launched
//      first.
//   4. `ssd_bwd_dla_kernel`, grid (B*H, chunks): dcum from the partials in a
//      fixed order in f64, then its suffix sum in f64, rounded once.  The E
//      and r terms sum to 0 over a chunk, and the suffix sum cancels them
//      exactly only if each enters both its sums with one f32 value (in f32
//      the last design's dla missed by 2.8e-3 against a 1e-4 tolerance):
//      each E_ij and r_j is formed once, in one block.
//   5. `ssd_bwd_reduce_kernel`: dB and dC summed over a group's rep heads
//      in head order and rounded once (the model: flash_attention.cu's
//      `flash_dkdv_reduce_kernel`).
// No atomics: every output and partial is owned by one thread and summed
// in a fixed order, so two runs give the same bits.  The workspace
// (bwd_layout) holds cum, the state slots, the partials and dB's and dC's
// per-head sums: about 104 MB at the training shape.
//
// bf16 (`ssd_bwd_sums_mma_kernel`, `ssd_bwd_local_mma_kernel`): every
// product is `mma.sync.m16n8k16` bf16 x bf16 -> f32 from the tile helpers
// the forward uses; B, C, xdt and dy arrive in bf16, so the Gram, dY X^T
// and the tiles they multiply are exact; the f32 operands (the decayed
// scores G . W and dY X^T . W, x . w, dy . e^{cum}, dh and h_in) enter as
// hi + lo bf16 terms: each rounded once misses the bf16 tolerance (the CPU
// model in tests/test_torch_mamba_scan_bwd.py shows each).  Tiles arrive by
// cp.async, the next in flight while this one is used.  The local kernel
// has 4 warps, each 16 rows of the 64-row tile, and two blocks an SM (255
// registers, 84,992 B at N 128); a tile pair is taken in two halves of 32
// columns.  W is 2^x by the SFU (`ex2.approx`), as in the forward.
// f32 (`ssd_bwd_sums_kernel`, `ssd_bwd_local_kernel`): the same grid, each
// product an f32 FMA chain on the CUDA cores in 4 x 4 register blocks fed
// 16 bytes at a time from shared memory (tile_dot, rows_times, outer_acc):
// TF32 products miss the f32 tolerance, as the forward's do.
//
// What bounds it: at the training shape (80 heads of P 64, one group of N
// 128, S 1024 in chunks of 256, bf16) the function moves about 33 MB and
// needs about 14 GFLOP (chip_smoke.py's k5_bwd_bound_ms counts both), so
// at the tensor cores' bf16 rate its bound is operations, about 0.013 ms.
// This design forms the Gram once per head (its bound counts it once per
// group), dY X^T three times, and the hi + lo terms double the products
// they enter: about 38 GFLOP issued as mma.sync, and it writes and reads
// dB's and dC's per-head sums (84 MB) to sum them over the group.  On an
// H100 at 700 W it takes 0.39-0.41 ms there (2.08 ms one block a head row
// before; PERF.md), 0.30 of it the local kernel, about 130 TFLOP/s of
// mma.sync; the f32 route 0.94 ms, its local kernel 0.79, where the
// shared-memory reads of its FMA chains take most of the cycles, as in the
// f32 forward (scripts/k5_bwd_timeline.py prints each kernel's phases).
// ------------------------------------------------------------------------

constexpr int kBwdThreads = 256;      // 16 x 16 (f32 kernels) or 8 warps
constexpr int kBwdT = 64;             // rows of a tile (keys or queries)
constexpr int kBwdP = 64;             // P columns the kernels hold (padded)
constexpr int kBwdSX = kBwdP + 4;     // row stride of the f32 P-wide tiles
constexpr int kBwdSS = kBwdT + 4;     // row stride of the f32 score tiles
constexpr int kLocThreads = 128;      // the bf16 local kernel: 4 warps
constexpr int kPassThreads = 256;     // state passing: 4 entries a thread
constexpr int kPassTile = 4 * kPassThreads;
constexpr int kDlaThreads = 128;
static_assert(kBwdP == 4 * 16, "an f32 thread owns 4 P columns of 64");

// The workspace, carved by bwd_layout.  Per head row r and chunk position
// (row-major (r, s)): erow[(r, s), t] the sum over the keys of tile t of
// E at query s; ecol the sum over the queries of E at key s; cum, r and
// inter (e^{cum_i} C_i . h_in^T dy_i).  dotp[(r, z), tile]: a state tile's
// part of <dh(z), h_in(z)>.  hs and gs: (r, nc - 1, kBwdP, NP) state slots,
// hs[z] hc_z then h_in(z + 1), gs[z] gc_{z+1} then dh(z).  db_part and
// dc_part: (r, s, n) per head.
struct BwdWork {
  double* erow;
  double* ecol;
  float* cum;
  float* r;
  float* inter;
  float* dotp;
  float* hs;
  float* gs;
  float* db_part;
  float* dc_part;
};

// Floats of the workspace from `base` (16-byte aligned; null only counts),
// each array starting on a 16-byte boundary.
size_t bwd_layout(float* base, int bh, int s, int n, int chunk,
                  BwdWork* w) {
  const size_t nc = (s + chunk - 1) / chunk;
  const size_t nt = (chunk + kBwdT - 1) / kBwdT;
  const size_t np = 16 * mma_nb(n);
  const size_t rows = (size_t)bh * s;
  size_t off = 0;
  auto take = [&](size_t floats) {
    float* at = base ? base + off : nullptr;
    off += (floats + 3) / 4 * 4;
    return at;
  };
  BwdWork v;
  v.erow = reinterpret_cast<double*>(take(2 * rows * nt));
  v.ecol = reinterpret_cast<double*>(take(2 * rows));
  v.cum = take(rows);
  v.r = take(rows);
  v.inter = take(rows);
  v.dotp = take((size_t)bh * nc * (kBwdP * np / kPassTile));
  v.hs = take((size_t)bh * (nc - 1) * kBwdP * np);
  v.gs = take((size_t)bh * (nc - 1) * kBwdP * np);
  v.db_part = take(rows * n);
  v.dc_part = take(rows * n);
  if (w) *w = v;
  return off;
}

__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The state slot of head row `row`, chunk z's dh (z < nc - 1: gs[z]; the
// last chunk's: dstate, or null where it is 0) or h_in (z > 0: hs[z - 1];
// null for the first chunk), and how to read it: the row stride and the
// rows and columns that hold it (past them it reads 0).
struct StateRef {
  const float* p;
  int ld, rows, cols;
};

__device__ __forceinline__ StateRef dh_ref(const BwdWork& ws,
                                           const float* dstate, int row,
                                           int z, int nc, int np, int P,
                                           int N) {
  if (z + 1 < nc)
    return {ws.gs + ((size_t)row * (nc - 1) + z) * kBwdP * np, np, kBwdP, np};
  if (dstate != nullptr) return {dstate + (size_t)row * P * N, N, P, N};
  return {nullptr, 0, 0, 0};
}

__device__ __forceinline__ StateRef hin_ref(const BwdWork& ws, int row,
                                            int z, int nc, int np) {
  if (z == 0) return {nullptr, 0, 0, 0};
  return {ws.hs + ((size_t)row * (nc - 1) + z - 1) * kBwdP * np, np, kBwdP,
          np};
}

__device__ __forceinline__ float state_at(const StateRef& st, int p, int n) {
  return p < st.rows && n < st.cols ? st.p[(size_t)p * st.ld + n] : 0.f;
}

// Whether `st` is kBwdP x NP floats, contiguous and 16-byte aligned (a
// workspace slot, or a dstate of that width): then the f32 kernel reads it
// 16 bytes a time, several reads in flight a thread, where a loop of
// scalar loads waited out each load's latency (16 % of that kernel's
// cycles at the training shape, scripts/k5_bwd_timeline.py).
template <int NP>
__device__ __forceinline__ bool state_dense(const StateRef& st) {
  return st.ld == NP && st.rows == kBwdP && st.cols == NP &&
         reinterpret_cast<uintptr_t>(st.p) % 16 == 0;
}

// f(e, v) for each 16 bytes v of a dense state (e its first entry), by the
// NT threads of the block, each with its reads in flight in batches.
template <int NP, int NT, typename F>
__device__ __forceinline__ void for_state_vec4(const StateRef& st, F f) {
  constexpr int kPer = kBwdP * NP / 4 / NT;      // float4 reads a thread
  constexpr int kBatch = kPer < 8 ? kPer : 8;
  static_assert(kPer * NT * 4 == kBwdP * NP && kPer % kBatch == 0,
                "whole batches of reads");
  const float4* src = reinterpret_cast<const float4*>(st.p);
#pragma unroll
  for (int b = 0; b < kPer; b += kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) v[k] = src[(b + k) * NT + threadIdx.x];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) f(4 * ((b + k) * NT + threadIdx.x), v[k]);
  }
}

// W consecutive floats of device memory from `dst`, 16 or 8 bytes at a time
// where `vec`, else one at a time, those at or past `lim` left out.
template <int W>
__device__ __forceinline__ void store_cols(float* dst, const float (&v)[W],
                                           int col, int lim, bool vec) {
  if (vec && col + W <= lim) {
    store_row(dst, v);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e)
      if (col + e < lim) dst[e] = v[e];
  }
}

// ------------------------------------------------------- 1. chunk sums
// Grid (B*H, chunks, 2): side 0 forms hc = (x . w)^T B (all chunks but the
// last) and writes cum, side 1 gc = (dy . e^{cum})^T C (all but the first);
// each takes the chunk's prefix sum.
// f32: 16 x 16 threads; thread (tx, ty) owns P columns 4 tx .. + 3 and N
// columns NV ty .. + NV - 1 of its side's sum (outer_acc).
template <int NP>
size_t sums_f32_smem_bytes(int chunk) {
  const size_t sf = NP + 4, cpad = round_up(chunk, kBwdT);
  return sizeof(float) * (2 * kBwdT * sf + 2 * kBwdT * kBwdSX + 2 * cpad)
         + sizeof(double) * kPrefixPiece;
}

// out[q][v] += sum over the tile's kBwdT rows k of (X[k][p0 + q] w_k)
// Y[k][n0 + v]: a (P, N) block of X^T diag(w) Y as rank-1 updates.
template <int NV>
__device__ __forceinline__ void outer_acc(float (&out)[4][NV], const float* X,
                                          int sx, const float* Y, int sy,
                                          const float* w, int p0, int n0) {
#pragma unroll 2
  for (int k = 0; k < kBwdT; ++k) {
    float xv[4], yv[NV];
    load_row(xv, X + k * sx + p0);
    load_row(yv, Y + k * sy + n0);
    const float wk = w[k];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float xw = xv[q] * wk;
#pragma unroll
      for (int v = 0; v < NV; ++v) out[q][v] = fmaf(xw, yv[v], out[q][v]);
    }
  }
}

// The chunk's cum into shared memory (warp 0, f64, as the forward), and
// into the workspace on side 0; the side's weights: w_j = e^{cum_L - cum_j}
// (side 0) or e^{cum_i} (side 1), 0 past the chunk's end.
__device__ __forceinline__ void chunk_cum(float* cum, float* wv,
                                          double* scratch, const float* lp,
                                          float* cum_out, int clen, int cpad,
                                          int side) {
  if (threadIdx.x < 32) prefix_sum_f64(cum, lp, clen, scratch);
  __syncthreads();
  const float last = cum[clen - 1];
  for (int i = threadIdx.x; i < cpad; i += blockDim.x) {
    const bool in = i < clen;
    if (in && side == 0) cum_out[i] = cum[i];
    wv[i] = in ? expf(side == 0 ? last - cum[i] : cum[i]) : 0.f;
  }
}

template <int NP>
__global__ void __launch_bounds__(kBwdThreads, 2)
ssd_bwd_sums_kernel(const float* __restrict__ xdt, const float* __restrict__ la,
                    const float* __restrict__ bmat,
                    const float* __restrict__ cmat,
                    const float* __restrict__ dy, BwdWork ws, int S, int P,
                    int N, int chunk, int rep, int aligned) {
  constexpr int T = kBwdT, SX = kBwdSX, SF = NP + 4, NV = NP / 16;
  extern __shared__ __align__(16) float sms[];
  float* As = sms;                      // xdt or dy: 2 x T x SX
  float* Bs = As + 2 * T * SX;          // B or C: 2 x T x SF
  const int cpad = round_up(chunk, T);
  float* cum = Bs + 2 * T * SF;
  float* wv = cum + cpad;
  double* scratch = reinterpret_cast<double*>(wv + cpad);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row = blockIdx.x, z = blockIdx.y, nc = gridDim.y;
  const int side = blockIdx.z;
  const int c0 = z * chunk, clen = min(chunk, S - c0);
  const size_t pos0 = (size_t)row * S + c0;
  const bool want = side == 0 ? z + 1 < nc : z > 0;
  const float* ap = (side == 0 ? xdt : dy) + pos0 * P;
  const float* bp = (side == 0 ? bmat : cmat) + ((size_t)(row / rep) * S + c0)
                    * N;
  auto stage = [&](int j0, int buf) {
    if (want) {
      stage_f32<T, kBwdP>(As + buf * T * SX, SX, ap + (size_t)j0 * P, P,
                          clen - j0, 0, P, aligned, tid, kBwdThreads);
      stage_f32<T, NP>(Bs + buf * T * SF, SF, bp + (size_t)j0 * N, N,
                       clen - j0, 0, N, aligned, tid, kBwdThreads);
    }
    cp_async_commit();
  };
  stage(0, 0);
  chunk_cum(cum, wv, scratch, la + pos0, ws.cum + pos0, clen, cpad, side);
  if (!want) return;
  const int hp = 4 * tx, hn = NV * ty;
  float acc[4][NV];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[q][v] = 0.f;
  const int n_kt = (clen + T - 1) / T;
  for (int t = 0; t < n_kt; ++t) {
    cp_async_wait<0>();
    __syncthreads();                    // tile t in; tile t - 1 read
    if (t + 1 < n_kt) stage((t + 1) * T, (t + 1) & 1);
    const int b = t & 1;
    outer_acc(acc, As + b * T * SX, SX, Bs + b * T * SF, SF, wv + t * T, hp,
              hn);
  }
  float* dst = (side == 0 ? ws.hs + ((size_t)row * (nc - 1) + z) * kBwdP * NP
                          : ws.gs + ((size_t)row * (nc - 1) + z - 1) * kBwdP
                                        * NP);
#pragma unroll
  for (int q = 0; q < 4; ++q) store_row(dst + (hp + q) * NP + hn, acc[q]);
}

// bf16: 8 warps; warp w forms rows 16 (w % 4) .. + 15 and N columns (w / 4)
// NP / 2 .. + NP / 2 - 1 of its side's sum, A = the xdt (or dy) tile read
// transposed (ldmatrix.trans), scaled by the weights and split into hi +
// lo in registers, B = the B (or C) tile.
template <int NB>
size_t sums_mma_smem_bytes(int chunk) {
  const size_t sn = mma_row_stride(NB), cpad = round_up(chunk, kBwdT);
  return 2 * (2 * kBwdT * (sn + kSP)) + sizeof(float) * 2 * cpad
         + sizeof(double) * kPrefixPiece;
}

template <int NB>
__global__ void __launch_bounds__(kBwdThreads, 2)
ssd_bwd_sums_mma_kernel(const bf16* __restrict__ xdt,
                        const float* __restrict__ la,
                        const bf16* __restrict__ bmat,
                        const bf16* __restrict__ cmat,
                        const bf16* __restrict__ dy, BwdWork ws, int S, int P,
                        int N, int chunk, int rep) {
  constexpr int NP = 16 * NB, SN = mma_row_stride(NB), T = kBwdT;
  constexpr int DP = NB / 2;           // 16-column blocks a warp forms
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);   // xdt or dy: 2 x T x kSP
  bf16* Bs = As + 2 * T * kSP;                     // B or C: 2 x T x SN
  const int cpad = round_up(chunk, T);
  float* cum = reinterpret_cast<float*>(Bs + 2 * T * SN);
  float* wv = cum + cpad;
  double* scratch = reinterpret_cast<double*>(wv + cpad);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row = blockIdx.x, z = blockIdx.y, nc = gridDim.y;
  const int side = blockIdx.z;
  const int c0 = z * chunk, clen = min(chunk, S - c0);
  const size_t pos0 = (size_t)row * S + c0;
  const bool want = side == 0 ? z + 1 < nc : z > 0;
  const bf16* ap = (side == 0 ? xdt : dy) + pos0 * P;
  const bf16* bp = (side == 0 ? bmat : cmat) + ((size_t)(row / rep) * S + c0)
                   * N;
  auto stage = [&](int j0, int buf) {
    if (want) {
      stage_bf16(As + buf * T * kSP, kSP, ap + (size_t)j0 * P, P, T,
                 clen - j0, 0, kBwdP, P);
      stage_bf16(Bs + buf * T * SN, SN, bp + (size_t)j0 * N, N, T, clen - j0,
                 0, NP, N);
    }
    cp_async_commit();
  };
  stage(0, 0);
  chunk_cum(cum, wv, scratch, la + pos0, ws.cum + pos0, clen, cpad, side);
  if (!want) return;
  const int hp0 = (warp % 4) * 16, hn0 = (warp / 4) * (NP / 2);
  float acc[2 * DP][4];
#pragma unroll
  for (int j = 0; j < 2 * DP; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int n_kt = (clen + T - 1) / T;
  for (int t = 0; t < n_kt; ++t) {
    cp_async_wait<0>();
    __syncthreads();                    // tile t in; tile t - 1 read
    if (t + 1 < n_kt) stage((t + 1) * T, (t + 1) & 1);
    const bf16* At = As + (t & 1) * T * kSP;
    const bf16* Bt = Bs + (t & 1) * T * SN;
    const float* wt = wv + t * T;
#pragma unroll
    for (int kk = 0; kk < T / 16; ++kk) {
      uint32_t ax[4], ah[4], al[4];
      ldsm_x4_trans(ax, frag_b_addr<kSP>(At, kk * 16, hp0, lane));
      const float2 w0 = *reinterpret_cast<const float2*>(wt + kk * 16 + 2 * t4);
      const float2 w1 =
          *reinterpret_cast<const float2*>(wt + kk * 16 + 8 + 2 * t4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ax[r]));
        const float2 w = r < 2 ? w0 : w1;
        split_bf16(xv.x * w.x, xv.y * w.y, ah[r], al[r]);
      }
      uint32_t b[DP][4];
#pragma unroll
      for (int dp = 0; dp < DP; ++dp)
        ldsm_x4_trans(b[dp], frag_a_addr<SN>(Bt, kk * 16, hn0 + dp * 16,
                                             lane));
#pragma unroll
      for (int dp = 0; dp < DP; ++dp) {
        mma_bf16(acc[2 * dp], ah, b[dp][0], b[dp][1]);
        mma_bf16(acc[2 * dp + 1], ah, b[dp][2], b[dp][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DP; ++dp) {
        mma_bf16(acc[2 * dp], al, b[dp][0], b[dp][1]);
        mma_bf16(acc[2 * dp + 1], al, b[dp][2], b[dp][3]);
      }
    }
  }
  float* dst = (side == 0 ? ws.hs + ((size_t)row * (nc - 1) + z) * kBwdP * NP
                          : ws.gs + ((size_t)row * (nc - 1) + z - 1) * kBwdP
                                        * NP);
#pragma unroll
  for (int j = 0; j < 2 * DP; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(dst + (hp0 + g + 8 * i) * NP + hn0 + j * 8
                                 + 2 * t4) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
}

// ---------------------------------------------------- 2. state passing
// Grid (B*H, kBwdP NP / kPassTile); thread t owns entries 4 t .. 4 t + 3 of
// the block's tile of the (kBwdP, NP) state.
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_pass_kernel(const float* __restrict__ dstate, BwdWork ws, int S,
                    int P, int N, int np, int chunk) {
  __shared__ float red[kPassThreads / 32];
  const int row = blockIdx.x, tile = blockIdx.y, tid = threadIdx.x;
  const int nc = (S + chunk - 1) / chunk;
  const int e0 = tile * kPassTile + 4 * tid;
  const size_t slot = (size_t)kBwdP * np;
  float* hs = ws.hs + (size_t)row * (nc - 1) * slot + e0;
  float* gs = ws.gs + (size_t)row * (nc - 1) * slot + e0;
  const float* cum = ws.cum + (size_t)row * S;
  auto decay = [&](int z) { return expf(cum[min(z * chunk + chunk, S) - 1]); };
  float h[4] = {0.f, 0.f, 0.f, 0.f};
  for (int z = 0; z + 1 < nc; ++z) {          // h_in(z + 1) over hc_z
    const float d = decay(z);
    float v[4];
    load_row(v, hs + z * slot);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = fmaf(d, h[k], v[k]);
    store_row(hs + z * slot, h);
  }
  float dh[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = (e0 + k) / np, n = (e0 + k) % np;
    dh[k] = dstate != nullptr && p < P && n < N
                ? dstate[((size_t)row * P + p) * N + n] : 0.f;
  }
  for (int z = nc - 1; z >= 1; --z) {         // dh(z - 1) over gc_z
    float hv[4];
    load_row(hv, hs + (z - 1) * slot);        // h_in(z)
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) dot = fmaf(dh[k], hv[k], dot);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (tid % 32 == 0) red[tid / 32] = dot;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.f;
      for (int w = 0; w < kPassThreads / 32; ++w) tot += red[w];
      ws.dotp[((size_t)row * nc + z) * gridDim.y + tile] = tot;
    }
    const float d = decay(z);
    float gv[4];
    load_row(gv, gs + (z - 1) * slot);
#pragma unroll
    for (int k = 0; k < 4; ++k) dh[k] = fmaf(d, dh[k], gv[k]);
    store_row(gs + (z - 1) * slot, dh);
    __syncthreads();                          // red read
  }
}

// ------------------------------------------------ 3. chunk-local terms
// f32: 16 x 16 threads, the last design's products (tile_dot, rows_times) on
// the new grid.

// out[r][c] = sum over k < K of A[(ty + 16 r) sa + k] * B[(tx + 16 c) sb + k]:
// a 4 x 4 block of the 64 x 64 product of two row-major tiles, each row read
// 16 bytes at a time, the sum in ascending k.
template <int K>
__device__ __forceinline__ void tile_dot(float (&out)[4][4], const float* A,
                                         int sa, const float* B, int sb,
                                         int tx, int ty) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[r][c] = 0.f;
#pragma unroll 1
  for (int k = 0; k < K; k += 4) {
    float av[4][4], bv[4][4], bt[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) load_row(av[r], A + (ty + 16 * r) * sa + k);
#pragma unroll
    for (int c = 0; c < 4; ++c) load_row(bv[c], B + (tx + 16 * c) * sb + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) bt[kk][c] = bv[c][kk];
    fma4(out, av, bt);
  }
}

// out[r][q] += sum over k < K of A[(ty + 16 r) sa + k] * M[k sm + q0 + q]:
// rows ty + 16 r of a row-major tile times a row-major matrix, this
// thread's QW consecutive columns from q0.
template <int K, int QW>
__device__ __forceinline__ void rows_times(float (&out)[4][QW],
                                           const float* A, int sa,
                                           const float* M, int sm, int q0,
                                           int ty) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float av[4][4], mv[4][QW];
#pragma unroll
    for (int r = 0; r < 4; ++r) load_row(av[r], A + (ty + 16 * r) * sa + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) load_row(mv[kk], M + (k + kk) * sm + q0);
    fma4(out, av, mv);
  }
}

// The sum over the 16 lanes of a half warp (the tx of one ty).
template <typename V>
__device__ __forceinline__ V half_warp_sum(V v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int NP>
size_t local_f32_smem_bytes(int chunk) {
  const size_t sf = NP + 4;
  return sizeof(float) * (3 * kBwdT * sf + 3 * kBwdT * kBwdSX
                          + 2 * kBwdT * kBwdSS + round_up(chunk, kBwdT))
         + sizeof(double) * 2 * (kBwdThreads / 32) * kBwdT;
}

template <int NP>
__global__ void __launch_bounds__(kBwdThreads, 1)
ssd_bwd_local_kernel(const float* __restrict__ xdt,
                     const float* __restrict__ bmat,
                     const float* __restrict__ cmat,
                     const float* __restrict__ dy,
                     const float* __restrict__ dstate,
                     float* __restrict__ dxdt, BwdWork ws, int S, int P,
                     int N, int chunk, int rep, int aligned) {
  constexpr int T = kBwdT, SX = kBwdSX, SS = kBwdSS, SF = NP + 4;
  constexpr int NV = NP / 16;              // N columns a thread owns
  constexpr int NW = kBwdThreads / 32;
  extern __shared__ __align__(16) float sml[];
  float* Fn = sml;                         // this tile's B or C: T x SF
  float* Fp = Fn + T * SF;                 // its xdt or dy: T x SX
  float* Ln = Fp + T * SX;                 // the other tiles': 2 x T x SF
  float* Lp = Ln + 2 * T * SF;             // 2 x T x SX
  float* Ss = Lp + 2 * T * SX;             // T x SS
  float* Qs = Ss + T * SS;                 // T x SS
  float* cum = Qs + T * SS;
  const int cpad = round_up(chunk, T);
  double* red = reinterpret_cast<double*>(cum + cpad);   // 2 x NW x T
  // A state [p][n] (T x SF) and dh^T [n][p] (NP x SX), over Ln and Lp.
  float* Ht = Ln + T * SF;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int row = blockIdx.x, z = blockIdx.y, nc = gridDim.y, t = blockIdx.z;
  const int c0 = z * chunk, clen = min(chunk, S - c0);
  const int nt = (clen + T - 1) / T, ntmax = (chunk + T - 1) / T;
  if (t >= nt) return;                     // a short last chunk
  const int t0 = t * T;
  const size_t pos0 = (size_t)row * S + c0;
  const float* xp = xdt + pos0 * P;
  const float* yp = dy + pos0 * P;
  const float* bp = bmat + ((size_t)(row / rep) * S + c0) * N;
  const float* cp = cmat + ((size_t)(row / rep) * S + c0) * N;
  auto stage_n = [&](float* dst, const float* src, int r0) {
    stage_f32<T, NP>(dst, SF, src + (size_t)r0 * N, N, clen - r0, 0, N,
                     aligned, tid, kBwdThreads);
  };
  auto stage_p = [&](float* dst, const float* src, int r0) {
    stage_f32<T, kBwdP>(dst, SX, src + (size_t)r0 * P, P, clen - r0, 0, P,
                        aligned, tid, kBwdThreads);
  };
  // The warps' sums over their rows of E at each query column, in order.
  auto flush_rows = [&](int buf, int i0) {
    if (tid < T && i0 + tid < clen) {
      const double* rp = red + buf * NW * T + tid;
      double v = rp[0];
      for (int w = 1; w < NW; ++w) v += rp[w * T];
      ws.erow[(pos0 + i0 + tid) * ntmax + t] = v;
    }
  };

  // ---- Keys: rows j of tile t against the query tiles i >= j.
  stage_n(Fn, bp, t0);
  stage_p(Fp, xp, t0);
  stage_n(Ln, cp, t0);
  stage_p(Lp, yp, t0);
  cp_async_commit();
  for (int i = tid; i < cpad; i += kBwdThreads)
    cum[i] = i < clen ? ws.cum[pos0 + i] : 0.f;
  float dx[4][4], dbv[4][NV];
  double ekey[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    ekey[r] = 0.0;
#pragma unroll
    for (int q = 0; q < 4; ++q) dx[r][q] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) dbv[r][v] = 0.f;
  }
  int k = 0;
  for (; t + k < nt; ++k) {
    const int i0 = (t + k) * T, b = k & 1;
    const float* Ct = Ln + b * T * SF;
    const float* Yt = Lp + b * T * SX;
    cp_async_wait<0>();
    __syncthreads();         // this query tile in; the last pair's reads done
    if (k > 0) flush_rows((k - 1) & 1, i0 - T);
    if (t + k + 1 < nt) {
      stage_n(Ln + (b ^ 1) * T * SF, cp, i0 + T);
      stage_p(Lp + (b ^ 1) * T * SX, yp, i0 + T);
    }
    cp_async_commit();
    float gm[4][4], mm[4][4];
    tile_dot<NP>(gm, Fn, SF, Ct, SF, tx, ty);       // B_j . C_i
    tile_dot<kBwdP>(mm, Fp, SX, Yt, SX, tx, ty);    // x_j . dy_i
    double qc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = t0 + ty + 16 * r, i = i0 + tx + 16 * c;
        const bool in = j <= i && i < clen;
        const float w = in ? expf(fminf(cum[i] - cum[j], 0.f)) : 0.f;
        const float sv = gm[r][c] * w;
        const double e = (double)(sv * mm[r][c]);
        ekey[r] += e;
        qc[c] += e;
        Ss[(ty + 16 * r) * SS + tx + 16 * c] = sv;
        Qs[(ty + 16 * r) * SS + tx + 16 * c] = mm[r][c] * w;
      }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      qc[c] += __shfl_xor_sync(0xffffffffu, qc[c], 16);   // the ty pair
      if (lane < 16) red[(b * NW + warp) * T + tx + 16 * c] = qc[c];
    }
    __syncthreads();
    rows_times<T, 4>(dx, Ss, SS, Yt, SX, 4 * tx, ty);
    rows_times<T, NV>(dbv, Qs, SS, Ct, SF, NV * tx, ty);
  }
  cp_async_wait<0>();
  __syncthreads();           // the last pair's rows in red; its reads done
  flush_rows((k - 1) & 1, (t + k - 1) * T);
  // The state terms: v_j = dh B_j, t_j = dh^T x_j, r_j = w_j x_j . v_j.
  const StateRef dh = dh_ref(ws, dstate, row, z, nc, NP, P, N);
  float rj[4] = {0.f, 0.f, 0.f, 0.f};
  if (dh.p != nullptr) {
    if (state_dense<NP>(dh)) {
      for_state_vec4<NP, kBwdThreads>(dh, [&](int e, float4 v) {
        const int p = e / NP, n = e % NP;
        *reinterpret_cast<float4*>(Ln + p * SF + n) = v;
        Ht[n * SX + p] = v.x;
        Ht[(n + 1) * SX + p] = v.y;
        Ht[(n + 2) * SX + p] = v.z;
        Ht[(n + 3) * SX + p] = v.w;
      });
    } else {
      for (int i = tid; i < kBwdP * NP; i += kBwdThreads) {
        const int p = i / NP, n = i % NP;
        const float v = state_at(dh, p, n);
        Ln[p * SF + n] = v;
        Ht[n * SX + p] = v;
      }
    }
    __syncthreads();
    float v[4][4], tt[4][NV];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[r][q] = 0.f;
#pragma unroll
      for (int e = 0; e < NV; ++e) tt[r][e] = 0.f;
    }
    rows_times<NP, 4>(v, Fn, SF, Ht, SX, 4 * tx, ty);
    rows_times<kBwdP, NV>(tt, Fp, SX, Ln, SF, NV * tx, ty);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jl = ty + 16 * r, j = t0 + jl;
      const float w = j < clen ? expf(cum[clen - 1] - cum[j]) : 0.f;
      float xv[4];
      load_row(xv, Fp + jl * SX + 4 * tx);
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) part = fmaf(xv[q], v[r][q], part);
      rj[r] = w * half_warp_sum(part);
#pragma unroll
      for (int q = 0; q < 4; ++q) dx[r][q] = fmaf(w, v[r][q], dx[r][q]);
#pragma unroll
      for (int e = 0; e < NV; ++e) dbv[r][e] = fmaf(w, tt[r][e], dbv[r][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = t0 + ty + 16 * r;
    const double e = half_warp_sum(ekey[r]);
    if (j >= clen) continue;
    if (tx == 0) {
      ws.ecol[pos0 + j] = e;
      ws.r[pos0 + j] = rj[r];
    }
    store_cols(dxdt + (pos0 + j) * P + 4 * tx, dx[r], 4 * tx, P, P % 4 == 0);
    store_cols(ws.db_part + (pos0 + j) * N + NV * tx, dbv[r], NV * tx, N,
               N % 4 == 0);
  }

  // ---- Queries: rows i of tile t against the key tiles j <= i.
  __syncthreads();           // the key role's reads done
  stage_n(Fn, cp, t0);
  stage_p(Fp, yp, t0);
  stage_n(Ln, bp, 0);
  stage_p(Lp, xp, 0);
  cp_async_commit();
  float dcv[4][NV];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < NV; ++e) dcv[r][e] = 0.f;
  for (int jt = 0; jt <= t; ++jt) {
    const int j0 = jt * T, b = jt & 1;
    const float* Bt = Ln + b * T * SF;
    const float* Xt = Lp + b * T * SX;
    cp_async_wait<0>();
    __syncthreads();         // this key tile in; the last one's reads done
    if (jt < t) {
      stage_n(Ln + (b ^ 1) * T * SF, bp, j0 + T);
      stage_p(Lp + (b ^ 1) * T * SX, xp, j0 + T);
    }
    cp_async_commit();
    float mm[4][4];
    tile_dot<kBwdP>(mm, Fp, SX, Xt, SX, tx, ty);    // dy_i . x_j
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = t0 + ty + 16 * r, j = j0 + tx + 16 * c;
        const bool in = j <= i && i < clen;
        const float w = in ? expf(fminf(cum[i] - cum[j], 0.f)) : 0.f;
        Qs[(ty + 16 * r) * SS + tx + 16 * c] = mm[r][c] * w;
      }
    __syncthreads();
    rows_times<T, NV>(dcv, Qs, SS, Bt, SF, NV * tx, ty);
  }
  // The entering state's terms: u_i = h_in^T dy_i.
  const StateRef hin = hin_ref(ws, row, z, nc, NP);
  float inter[4] = {0.f, 0.f, 0.f, 0.f};
  if (hin.p != nullptr) {
    cp_async_wait<0>();
    __syncthreads();         // the loop's reads done
    for_state_vec4<NP, kBwdThreads>(hin, [&](int e, float4 v) {
      *reinterpret_cast<float4*>(Ln + (e / NP) * SF + e % NP) = v;
    });
    __syncthreads();
    float u[4][NV];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < NV; ++e) u[r][e] = 0.f;
    rows_times<kBwdP, NV>(u, Fp, SX, Ln, SF, NV * tx, ty);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = ty + 16 * r, i = t0 + il;
      const float ei = i < clen ? expf(cum[i]) : 0.f;
      float cv[NV];
      load_row(cv, Fn + il * SF + NV * tx);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < NV; ++e) part = fmaf(cv[e], u[r][e], part);
      inter[r] = ei * half_warp_sum(part);
#pragma unroll
      for (int e = 0; e < NV; ++e) dcv[r][e] = fmaf(ei, u[r][e], dcv[r][e]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = t0 + ty + 16 * r;
    if (i >= clen) continue;
    if (tx == 0) ws.inter[pos0 + i] = inter[r];
    store_cols(ws.dc_part + (pos0 + i) * N + NV * tx, dcv[r], NV * tx, N,
               N % 4 == 0);
  }
}

// bf16: 4 warps, warp w rows 16 w .. 16 w + 15 of the tile (the M of every
// product), lane (g, t4) rows g and g + 8, columns 2 t4 and 2 t4 + 1 of each
// 8-column n-tile; two blocks an SM.
template <int NB>
size_t local_mma_smem_bytes(int chunk) {
  const size_t sn = mma_row_stride(NB);
  return 2 * 3 * kBwdT * (sn + kSP) + sizeof(float) * round_up(chunk, kBwdT)
         + sizeof(double) * 2 * (kLocThreads / 32) * kBwdT;
}

// The state at `st` (kBwdP rows of NP columns; 0 where it holds none) as
// hi and lo bf16 tiles of row stride SN.
// (Read 16 bytes at a time, as the f32 kernel reads a state, this kernel
// ran 3 % slower at the training shape: it sits at 255 registers.)
template <int NP, int SN>
__device__ __forceinline__ void load_state_split(bf16* hi, bf16* lo,
                                                 const StateRef& st) {
  for (int i = threadIdx.x; i < kBwdP * NP / 2; i += blockDim.x) {
    const int p = i / (NP / 2), n = 2 * (i % (NP / 2));
    uint32_t h, l;
    split_bf16(state_at(st, p, n), state_at(st, p, n + 1), h, l);
    *reinterpret_cast<uint32_t*>(hi + p * SN + n) = h;
    *reinterpret_cast<uint32_t*>(lo + p * SN + n) = l;
  }
}

// The sums over the 8 lanes of a t4 group (lanes t4, t4 + 4, ..., the g of
// rows g, g + 8) of v[0 .. 8), by halving exchanges: lane g returns the
// sum of v[g].  Each sum is formed by one lane in one order.
__device__ __forceinline__ double lane_sums8(const double (&v)[8], int g) {
  double u[4], w[2];
  const bool b2 = g & 4, b1 = g & 2, b0 = g & 1;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    u[q] = (b2 ? v[q + 4] : v[q])
           + __shfl_xor_sync(0xffffffffu, b2 ? v[q] : v[q + 4], 16);
#pragma unroll
  for (int q = 0; q < 2; ++q)
    w[q] = (b1 ? u[q + 2] : u[q])
           + __shfl_xor_sync(0xffffffffu, b1 ? u[q] : u[q + 2], 8);
  return (b0 ? w[1] : w[0]) + __shfl_xor_sync(0xffffffffu, b0 ? w[0] : w[1], 4);
}

// The sum over the 4 lanes of a quad (the t4 of one g).
template <typename V>
__device__ __forceinline__ V quad_sum(V v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// acc[2 dp + (0, 1)] += (hi + lo) times two n-tiles of `b`, for dp < DP:
// the B fragments of DP 16-column blocks, two at a time, hi products before
// lo so an accumulator's two are four products apart.
template <int DP, typename BAddr>
__device__ __forceinline__ void mma_split_rows(float (*acc)[4],
                                               const uint32_t (&hi)[4],
                                               const uint32_t (&lo)[4],
                                               BAddr baddr) {
#pragma unroll
  for (int dp = 0; dp < DP; dp += 2) {
    uint32_t b[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) ldsm_x4_trans(b[u], baddr(dp + u));
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mma_bf16(acc[2 * (dp + u)], hi, b[u][0], b[u][1]);
      mma_bf16(acc[2 * (dp + u) + 1], hi, b[u][2], b[u][3]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      mma_bf16(acc[2 * (dp + u)], lo, b[u][0], b[u][1]);
      mma_bf16(acc[2 * (dp + u) + 1], lo, b[u][2], b[u][3]);
    }
  }
}

// m (16 rows from 16 w of the A tile, 32 columns from c0 of the B tile's
// rows) = A B^T over kBwdP columns: X_J dY_I^T in the key role, dY_I X_J^T
// in the query role; m is zeroed first.
template <int SP>
__device__ __forceinline__ void xdy_t(float (&m)[4][4], const bf16* A,
                                      const bf16* B, int warp, int c0,
                                      int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kBwdP / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, frag_a_addr<SP>(A, warp * 16, ks * 16, lane));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, frag_b_addr<SP>(B, c0 + np * 16, ks * 16, lane));
      mma_bf16(m[2 * np], a, bf[0], bf[1]);
      mma_bf16(m[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(kLocThreads, 2)
ssd_bwd_local_mma_kernel(const bf16* __restrict__ xdt,
                         const bf16* __restrict__ bmat,
                         const bf16* __restrict__ cmat,
                         const bf16* __restrict__ dy,
                         const float* __restrict__ dstate,
                         bf16* __restrict__ dxdt, BwdWork ws, int S, int P,
                         int N, int chunk, int rep) {
  static_assert(NB % 2 == 0, "N is taken in halves of 16-column pairs");
  constexpr int NP = 16 * NB, SN = mma_row_stride(NB), SP = kSP, T = kBwdT;
  constexpr int NW = kLocThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Fn = reinterpret_cast<bf16*>(smem_raw);   // this tile's B or C
  bf16* Fp = Fn + T * SN;                          // its xdt or dy
  bf16* Ln = Fp + T * SP;                          // the others': 2 buffers
  bf16* Lp = Ln + 2 * T * SN;                      // 2 buffers
  float* cum = reinterpret_cast<float*>(Lp + 2 * T * SP);
  const int cpad = round_up(chunk, T);
  double* red = reinterpret_cast<double*>(cum + cpad);   // 2 x NW x T
  bf16* Sh = Ln;                 // a state's hi and lo, over the Ln buffers
  bf16* Sl = Ln + T * SN;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row = blockIdx.x, z = blockIdx.y, nc = gridDim.y, t = blockIdx.z;
  const int c0 = z * chunk, clen = min(chunk, S - c0);
  const int nt = (clen + T - 1) / T, ntmax = (chunk + T - 1) / T;
  if (t >= nt) return;                     // a short last chunk
  const int t0 = t * T;
  const size_t pos0 = (size_t)row * S + c0;
  const bf16* xp = xdt + pos0 * P;
  const bf16* yp = dy + pos0 * P;
  const bf16* bp = bmat + ((size_t)(row / rep) * S + c0) * N;
  const bf16* cp = cmat + ((size_t)(row / rep) * S + c0) * N;
  auto stage_n = [&](bf16* dst, const bf16* src, int r0) {
    stage_bf16<kLocThreads>(dst, SN, src + (size_t)r0 * N, N, T, clen - r0,
                            0, NP, N);
  };
  auto stage_p = [&](bf16* dst, const bf16* src, int r0) {
    stage_bf16<kLocThreads>(dst, SP, src + (size_t)r0 * P, P, T, clen - r0,
                            0, kBwdP, P);
  };
  auto flush_rows = [&](int buf, int i0) {
    if (tid < T && i0 + tid < clen) {
      const double* rp = red + buf * NW * T + tid;
      double v = rp[0];
      for (int w = 1; w < NW; ++w) v += rp[w * T];
      ws.erow[(pos0 + i0 + tid) * ntmax + t] = v;
    }
  };
  const int ra = t0 + warp * 16 + g, rb = ra + 8;   // this lane's rows

  // ---- Keys: rows j of tile t against the query tiles i >= j, in two
  // passes over those tiles, so that no pass holds both dx's and dB's
  // accumulators (with both, and the pair's products, the kernel spilled
  // at 255 registers): the first forms G^T and M^T (E's sums, dx and the
  // state term of dx), the second M^T again (dB and its state term).
  stage_n(Fn, bp, t0);
  stage_p(Fp, xp, t0);
  stage_n(Ln, cp, t0);
  stage_p(Lp, yp, t0);
  cp_async_commit();
  for (int i = tid; i < cpad; i += kLocThreads)
    cum[i] = i < clen ? ws.cum[pos0 + i] : 0.f;
  float dx[kBwdP / 8][4];
#pragma unroll
  for (int j = 0; j < kBwdP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dx[j][e] = 0.f;
  double ekey[2] = {0.0, 0.0};
  int k = 0;
  for (; t + k < nt; ++k) {
    const int i0 = (t + k) * T, b = k & 1;
    const bf16* Ct = Ln + b * T * SN;
    const bf16* Yt = Lp + b * T * SP;
    cp_async_wait<0>();
    __syncthreads();         // this query tile in; the last pair's reads done
    if (k > 0) flush_rows((k - 1) & 1, i0 - T);
    if (t + k + 1 < nt) {
      stage_n(Ln + (b ^ 1) * T * SN, cp, i0 + T);
      stage_p(Lp + (b ^ 1) * T * SP, yp, i0 + T);
    }
    cp_async_commit();
    const float ca = cum[min(ra, clen - 1)], cb = cum[min(rb, clen - 1)];
    double* rq = red + (b * NW + warp) * T;
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {          // query columns 32 h .. + 31
      const int ic = 32 * h;
      if (k == 0 && ic + 31 < warp * 16) {  // wholly above the diagonal
        rq[ic + (g / 2) * 8 + 2 * t4 + (g & 1)] = 0.0;
        continue;
      }
      float s[4][4], m[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < NB; ++ks) {     // G^T = B_J C_I^T
        uint32_t a[4];
        ldsm_x4(a, frag_a_addr<SN>(Fn, warp * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, frag_b_addr<SN>(Ct, ic + np * 16, ks * 16, lane));
          mma_bf16(s[2 * np], a, bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
        }
      }
      xdy_t<SP>(m, Fp, Yt, warp, ic, lane);  // M^T = X_J dY_I^T
      // Decay and mask; E = (G W) M once, into both its sums.
      double qv[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + ic + j * 8 + 2 * t4;
        const float2 ci = *reinterpret_cast<const float2*>(cum + i);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ie = i + (e & 1), je = e < 2 ? ra : rb;
          const bool in = je <= ie && ie < clen;
          const float d = ex2_fast(
              fminf((e & 1 ? ci.y : ci.x) - (e < 2 ? ca : cb), 0.f) * kLog2e);
          const float sv = in ? s[j][e] * d : 0.f;
          const float ev = sv * m[j][e];
          s[j][e] = sv;
          ekey[e >> 1] += (double)ev;
          if (e < 2) qv[2 * j + e] = (double)ev;
          else qv[2 * j + e - 2] += (double)ev;
        }
      }
      rq[ic + (g / 2) * 8 + 2 * t4 + (g & 1)] = lane_sums8(qv, g);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {     // dx += S^T dY_I
        uint32_t sh[4], sl[4];
        acc_to_a_split(s[2 * kk], s[2 * kk + 1], sh, sl);
        mma_split_rows<kBwdP / 16>(dx, sh, sl, [&](int dp) {
          return frag_a_addr<SP>(Yt, ic + kk * 16, dp * 16, lane);
        });
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();           // the last pair's rows in red; its reads done
  flush_rows((k - 1) & 1, (t + k - 1) * T);
  // The state terms with dh: v_j = dh B_j (dx), r_j = w_j x_j . v_j.
  const StateRef dh = dh_ref(ws, dstate, row, z, nc, NP, P, N);
  const float wa = ra < clen ? expf(cum[clen - 1] - cum[ra]) : 0.f;
  const float wb = rb < clen ? expf(cum[clen - 1] - cum[rb]) : 0.f;
  float r_a = 0.f, r_b = 0.f;
  if (dh.p != nullptr) {
    load_state_split<NP, SN>(Sh, Sl, dh);
    __syncthreads();
    float v[kBwdP / 8][4];
#pragma unroll
    for (int j = 0; j < kBwdP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NB; ++ks) {       // v = B_J dh^T, dh as hi + lo
      uint32_t a[4];
      ldsm_x4(a, frag_a_addr<SN>(Fn, warp * 16, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < kBwdP / 16; ++np) {
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, frag_b_addr<SN>(Sh, np * 16, ks * 16, lane));
        ldsm_x4(bl, frag_b_addr<SN>(Sl, np * 16, ks * 16, lane));
        mma_bf16(v[2 * np], a, bh[0], bh[1]);
        mma_bf16(v[2 * np + 1], a, bh[2], bh[3]);
        mma_bf16(v[2 * np], a, bl[0], bl[1]);
        mma_bf16(v[2 * np + 1], a, bl[2], bl[3]);
      }
    }
    float pa = 0.f, pb = 0.f;
#pragma unroll
    for (int j = 0; j < kBwdP / 8; ++j) {
      const int p = j * 8 + 2 * t4;
      const float2 xa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          Fp + (warp * 16 + g) * SP + p));
      const float2 xb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          Fp + (warp * 16 + g + 8) * SP + p));
      pa = fmaf(xa.x, v[j][0], pa);
      pa = fmaf(xa.y, v[j][1], pa);
      pb = fmaf(xb.x, v[j][2], pb);
      pb = fmaf(xb.y, v[j][3], pb);
      dx[j][0] = fmaf(wa, v[j][0], dx[j][0]);
      dx[j][1] = fmaf(wa, v[j][1], dx[j][1]);
      dx[j][2] = fmaf(wb, v[j][2], dx[j][2]);
      dx[j][3] = fmaf(wb, v[j][3], dx[j][3]);
    }
    r_a = wa * quad_sum(pa);
    r_b = wb * quad_sum(pb);
  }
  {
    const double ea = quad_sum(ekey[0]), eb = quad_sum(ekey[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = i ? rb : ra;
      if (j >= clen) continue;
      if (t4 == 0) {
        ws.ecol[pos0 + j] = i ? eb : ea;
        ws.r[pos0 + j] = i ? r_b : r_a;
      }
      bf16* dxr = dxdt + (pos0 + j) * P;
#pragma unroll
      for (int jj = 0; jj < kBwdP / 8; ++jj) {
        const int p = jj * 8 + 2 * t4;
        if (P % 2 == 0 && p + 1 < P) {
          *reinterpret_cast<__nv_bfloat162*>(dxr + p) =
              __floats2bfloat162_rn(dx[jj][2 * i], dx[jj][2 * i + 1]);
        } else {
          if (p < P) dxr[p] = __float2bfloat16_rn(dx[jj][2 * i]);
          if (p + 1 < P) dxr[p + 1] = __float2bfloat16_rn(dx[jj][2 * i + 1]);
        }
      }
    }
  }
  // Second pass: dB, from its state term t_j = dh^T x_j (while dh is in
  // shared memory) and Q^T C_I over the query tiles.
  float db[2 * NB][4];
#pragma unroll
  for (int j = 0; j < 2 * NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[j][e] = 0.f;
  if (dh.p != nullptr) {
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {        // t = X_J dh, half of N at once
      float tt[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tt[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kBwdP / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, frag_a_addr<SP>(Fp, warp * 16, ks * 16, lane));
#pragma unroll
        for (int dp = 0; dp < NB / 2; ++dp) {
          uint32_t bh[4], bl[4];
          const int n0 = nh * (NP / 2) + dp * 16;
          ldsm_x4_trans(bh, frag_a_addr<SN>(Sh, ks * 16, n0, lane));
          ldsm_x4_trans(bl, frag_a_addr<SN>(Sl, ks * 16, n0, lane));
          mma_bf16(tt[2 * dp], a, bh[0], bh[1]);
          mma_bf16(tt[2 * dp + 1], a, bh[2], bh[3]);
          mma_bf16(tt[2 * dp], a, bl[0], bl[1]);
          mma_bf16(tt[2 * dp + 1], a, bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float* d = db[nh * NB + j];
        d[0] = wa * tt[j][0];
        d[1] = wa * tt[j][1];
        d[2] = wb * tt[j][2];
        d[3] = wb * tt[j][3];
      }
    }
  }
  __syncthreads();           // the state's reads done: its room is staged
  stage_n(Ln, cp, t0);
  stage_p(Lp, yp, t0);
  cp_async_commit();
  for (k = 0; t + k < nt; ++k) {
    const int i0 = (t + k) * T, b = k & 1;
    const bf16* Ct = Ln + b * T * SN;
    const bf16* Yt = Lp + b * T * SP;
    cp_async_wait<0>();
    __syncthreads();         // this query tile in; the last pair's reads done
    if (t + k + 1 < nt) {
      stage_n(Ln + (b ^ 1) * T * SN, cp, i0 + T);
      stage_p(Lp + (b ^ 1) * T * SP, yp, i0 + T);
    }
    cp_async_commit();
    const float ca = cum[min(ra, clen - 1)], cb = cum[min(rb, clen - 1)];
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {          // query columns 32 h .. + 31
      const int ic = 32 * h;
      if (k == 0 && ic + 31 < warp * 16) continue;   // above the diagonal
      float m[4][4];
      xdy_t<SP>(m, Fp, Yt, warp, ic, lane);  // M^T = X_J dY_I^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = i0 + ic + j * 8 + 2 * t4;
        const float2 ci = *reinterpret_cast<const float2*>(cum + i);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ie = i + (e & 1), je = e < 2 ? ra : rb;
          const bool in = je <= ie && ie < clen;
          const float d = ex2_fast(
              fminf((e & 1 ? ci.y : ci.x) - (e < 2 ? ca : cb), 0.f) * kLog2e);
          m[j][e] = in ? m[j][e] * d : 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {     // dB += Q^T C_I
        uint32_t qh[4], ql[4];
        acc_to_a_split(m[2 * kk], m[2 * kk + 1], qh, ql);
        mma_split_rows<NB>(db, qh, ql, [&](int dp) {
          return frag_a_addr<SN>(Ct, ic + kk * 16, dp * 16, lane);
        });
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = i ? rb : ra;
    if (j >= clen) continue;
    float* dbr = ws.db_part + (pos0 + j) * N;
#pragma unroll
    for (int jj = 0; jj < 2 * NB; ++jj) {
      const int n = jj * 8 + 2 * t4;
      if (N % 2 == 0 && n + 1 < N) {
        *reinterpret_cast<float2*>(dbr + n) =
            make_float2(db[jj][2 * i], db[jj][2 * i + 1]);
      } else {
        if (n < N) dbr[n] = db[jj][2 * i];
        if (n + 1 < N) dbr[n + 1] = db[jj][2 * i + 1];
      }
    }
  }

  // ---- Queries: rows i of tile t against the key tiles j <= i.
  __syncthreads();           // the key role's reads done
  stage_n(Fn, cp, t0);
  stage_p(Fp, yp, t0);
  stage_n(Ln, bp, 0);
  stage_p(Lp, xp, 0);
  cp_async_commit();
  float dc[2 * NB][4];
#pragma unroll
  for (int j = 0; j < 2 * NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dc[j][e] = 0.f;
  const float ca = cum[min(ra, clen - 1)], cb = cum[min(rb, clen - 1)];
  for (int jt = 0; jt <= t; ++jt) {
    const int j0 = jt * T, b = jt & 1;
    const bf16* Bt = Ln + b * T * SN;
    const bf16* Xt = Lp + b * T * SP;
    cp_async_wait<0>();
    __syncthreads();         // this key tile in; the last one's reads done
    if (jt < t) {
      stage_n(Ln + (b ^ 1) * T * SN, bp, j0 + T);
      stage_p(Lp + (b ^ 1) * T * SP, xp, j0 + T);
    }
    cp_async_commit();
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {          // key columns 32 h .. + 31
      const int jc = 32 * h;
      if (jt == t && jc > warp * 16 + 15) continue;   // above the diagonal
      float m[4][4];
      xdy_t<SP>(m, Fp, Xt, warp, jc, lane);  // M = dY_I X_J^T
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = j0 + jc + j * 8 + 2 * t4;
        const float2 cj = *reinterpret_cast<const float2*>(cum + jj);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int je = jj + (e & 1), ie = e < 2 ? ra : rb;
          const bool in = je <= ie && ie < clen;
          const float d = ex2_fast(
              fminf((e < 2 ? ca : cb) - (e & 1 ? cj.y : cj.x), 0.f) * kLog2e);
          m[j][e] = in ? m[j][e] * d : 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {     // dC += Q B_J
        uint32_t qh[4], ql[4];
        acc_to_a_split(m[2 * kk], m[2 * kk + 1], qh, ql);
        mma_split_rows<NB>(dc, qh, ql, [&](int dp) {
          return frag_a_addr<SN>(Bt, jc + kk * 16, dp * 16, lane);
        });
      }
    }
  }
  // The entering state's terms: u_i = h_in^T dy_i, inter_i = e^{cum_i}
  // C_i . u_i.
  const StateRef hin = hin_ref(ws, row, z, nc, NP);
  float in_a = 0.f, in_b = 0.f;
  if (hin.p != nullptr) {
    cp_async_wait<0>();
    __syncthreads();         // the loop's reads done
    load_state_split<NP, SN>(Sh, Sl, hin);
    __syncthreads();
    const float ea = ra < clen ? expf(cum[ra]) : 0.f;
    const float eb = rb < clen ? expf(cum[rb]) : 0.f;
    float pa = 0.f, pb = 0.f;
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {
      float u[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) u[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kBwdP / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, frag_a_addr<SP>(Fp, warp * 16, ks * 16, lane));
#pragma unroll
        for (int dp = 0; dp < NB / 2; ++dp) {
          uint32_t bh[4], bl[4];
          const int n0 = nh * (NP / 2) + dp * 16;
          ldsm_x4_trans(bh, frag_a_addr<SN>(Sh, ks * 16, n0, lane));
          ldsm_x4_trans(bl, frag_a_addr<SN>(Sl, ks * 16, n0, lane));
          mma_bf16(u[2 * dp], a, bh[0], bh[1]);
          mma_bf16(u[2 * dp + 1], a, bh[2], bh[3]);
          mma_bf16(u[2 * dp], a, bl[0], bl[1]);
          mma_bf16(u[2 * dp + 1], a, bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int n = nh * (NP / 2) + j * 8 + 2 * t4;
        const float2 xa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            Fn + (warp * 16 + g) * SN + n));
        const float2 xb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            Fn + (warp * 16 + g + 8) * SN + n));
        pa = fmaf(xa.x, u[j][0], pa);
        pa = fmaf(xa.y, u[j][1], pa);
        pb = fmaf(xb.x, u[j][2], pb);
        pb = fmaf(xb.y, u[j][3], pb);
        float* d = dc[nh * NB + j];
        d[0] = fmaf(ea, u[j][0], d[0]);
        d[1] = fmaf(ea, u[j][1], d[1]);
        d[2] = fmaf(eb, u[j][2], d[2]);
        d[3] = fmaf(eb, u[j][3], d[3]);
      }
    }
    in_a = ea * quad_sum(pa);
    in_b = eb * quad_sum(pb);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = i ? rb : ra;
    if (q >= clen) continue;
    if (t4 == 0) ws.inter[pos0 + q] = i ? in_b : in_a;
    float* dcr = ws.dc_part + (pos0 + q) * N;
#pragma unroll
    for (int jj = 0; jj < 2 * NB; ++jj) {
      const int n = jj * 8 + 2 * t4;
      if (N % 2 == 0 && n + 1 < N) {
        *reinterpret_cast<float2*>(dcr + n) =
            make_float2(dc[jj][2 * i], dc[jj][2 * i + 1]);
      } else {
        if (n < N) dcr[n] = dc[jj][2 * i];
        if (n + 1 < N) dcr[n + 1] = dc[jj][2 * i + 1];
      }
    }
  }
}

// ------------------------------------------------------------- 4. dla
// Grid (B*H, chunks).  dcum_i = (sum over the key tiles J <= i's of erow)
// - ecol_i + inter_i - r_i, in f64; dcum_L += e^{cum_L} <dh, h_in> (its
// tiles' f32 parts in order) + sum_j r_j (f64, index order); dla is the
// suffix sum of dcum, in f64 by one thread in index order, rounded once.
__global__ void __launch_bounds__(kDlaThreads)
ssd_bwd_dla_kernel(float* __restrict__ dla, BwdWork ws, int S, int chunk,
                   int ntiles) {
  extern __shared__ double dcum[];
  const int row = blockIdx.x, z = blockIdx.y, nc = gridDim.y;
  const int c0 = z * chunk, clen = min(chunk, S - c0);
  const int ntmax = (chunk + kBwdT - 1) / kBwdT;
  const size_t pos0 = (size_t)row * S + c0;
  for (int i = threadIdx.x; i < clen; i += kDlaThreads) {
    const double* er = ws.erow + (pos0 + i) * ntmax;
    double e = er[0];
    for (int j = 1; j <= i / kBwdT; ++j) e += er[j];
    dcum[i] = e - ws.ecol[pos0 + i] + (double)ws.inter[pos0 + i]
              - (double)ws.r[pos0 + i];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  double rs = 0.0;
  for (int j = 0; j < clen; ++j) rs += (double)ws.r[pos0 + j];
  float dot = 0.f;
  if (z > 0)
    for (int tl = 0; tl < ntiles; ++tl)
      dot += ws.dotp[((size_t)row * nc + z) * ntiles + tl];
  const float el = expf(ws.cum[pos0 + clen - 1]);
  dcum[clen - 1] += (double)(el * dot) + rs;
  double run = 0.0;
  for (int i = clen - 1; i >= 0; --i) {
    run += dcum[i];
    dla[pos0 + i] = (float)run;
  }
}

// ---------------------------------------------------------- 5. reduce
// db[e] = the sum over h = 0 .. rep-1 of db_part[(g rep + h) S N + off] for
// e = g S N + off, the heads in ascending order, rounded once to TO; the
// same for dc.
template <typename TO>
__global__ void __launch_bounds__(256)
ssd_bwd_reduce_kernel(const float* __restrict__ db_part,
                      const float* __restrict__ dc_part, TO* __restrict__ db,
                      TO* __restrict__ dc, size_t elems, size_t row_elems,
                      int rep) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < elems;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t g = e / row_elems, off = e % row_elems;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < rep; ++h) {
      const size_t src = (g * rep + h) * row_elems + off;
      sb += db_part[src];
      sc += dc_part[src];
    }
    narrow(db + e, sb);
    narrow(dc + e, sc);
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// The five launches for padded state width 16 NB, inputs of type TI.
template <int NB, typename TI>
cudaError_t launch_bwd(const void* xdt, const float* la, const void* b,
                       const void* c, const void* dy, const float* dstate,
                       void* dxdt, float* dla, void* db, void* dc, float* wsp,
                       int bh, int s, int p, int n, int chunk, int rep,
                       cudaStream_t st) {
  constexpr int NP = 16 * NB;
  constexpr bool kBf16 = std::is_same<TI, bf16>::value;
  BwdWork ws;
  bwd_layout(wsp, bh, s, n, chunk, &ws);
  const int nc = (s + chunk - 1) / chunk, nt = (chunk + kBwdT - 1) / kBwdT;
  const TI* xt = static_cast<const TI*>(xdt);
  const TI* bt = static_cast<const TI*>(b);
  const TI* ct = static_cast<const TI*>(c);
  const TI* yt = static_cast<const TI*>(dy);
  cudaError_t err;
  // 1. cum and the chunks' state sums.
  if constexpr (kBf16) {
    const size_t smem = sums_mma_smem_bytes<NB>(chunk);
    if ((err = set_smem(ssd_bwd_sums_mma_kernel<NB>, smem))) return err;
    ssd_bwd_sums_mma_kernel<NB><<<dim3(bh, nc, 2), kBwdThreads, smem, st>>>(
        xt, la, bt, ct, yt, ws, s, p, n, chunk, rep);
  } else {
    const int aligned = (reinterpret_cast<uintptr_t>(xdt) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) |
                         reinterpret_cast<uintptr_t>(dy)) % 16 == 0;
    const size_t smem = sums_f32_smem_bytes<NP>(chunk);
    if ((err = set_smem(ssd_bwd_sums_kernel<NP>, smem))) return err;
    ssd_bwd_sums_kernel<NP><<<dim3(bh, nc, 2), kBwdThreads, smem, st>>>(
        xt, la, bt, ct, yt, ws, s, p, n, chunk, rep, aligned);
  }
  if ((err = cudaGetLastError())) return err;
  // 2. State passing.
  const int ptiles = kBwdP * NP / kPassTile;
  if (nc > 1) {
    ssd_bwd_pass_kernel<<<dim3(bh, ptiles), kPassThreads, 0, st>>>(
        dstate, ws, s, p, n, NP, chunk);
    if ((err = cudaGetLastError())) return err;
  }
  // 3. The chunk-local terms.
  if constexpr (kBf16) {
    const size_t smem = local_mma_smem_bytes<NB>(chunk);
    if ((err = set_smem(ssd_bwd_local_mma_kernel<NB>, smem))) return err;
    ssd_bwd_local_mma_kernel<NB><<<dim3(bh, nc, nt), kLocThreads, smem, st>>>(
        xt, bt, ct, yt, dstate, static_cast<TI*>(dxdt), ws, s, p, n, chunk,
        rep);
  } else {
    const int aligned = (reinterpret_cast<uintptr_t>(xdt) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) |
                         reinterpret_cast<uintptr_t>(dy)) % 16 == 0;
    const size_t smem = local_f32_smem_bytes<NP>(chunk);
    if ((err = set_smem(ssd_bwd_local_kernel<NP>, smem))) return err;
    ssd_bwd_local_kernel<NP><<<dim3(bh, nc, nt), kBwdThreads, smem, st>>>(
        xt, bt, ct, yt, dstate, static_cast<TI*>(dxdt), ws, s, p, n, chunk,
        rep, aligned);
  }
  if ((err = cudaGetLastError())) return err;
  // 4. dla.
  const size_t dsmem = sizeof(double) * chunk;
  if ((err = set_smem(ssd_bwd_dla_kernel, dsmem))) return err;
  ssd_bwd_dla_kernel<<<dim3(bh, nc), kDlaThreads, dsmem, st>>>(
      dla, ws, s, chunk, ptiles);
  if ((err = cudaGetLastError())) return err;
  // 5. dB and dC over each group's heads.
  const size_t elems = (size_t)(bh / rep) * s * n;
  const size_t want = (elems + 255) / 256;
  const int blocks = (int)(want < 1056 ? want : 1056);
  ssd_bwd_reduce_kernel<TI><<<blocks, 256, 0, st>>>(
      ws.db_part, ws.dc_part, static_cast<TI*>(db), static_cast<TI*>(dc),
      elems, (size_t)s * n, rep);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t dispatch_bwd(const void* xdt, const float* la, const void* b,
                         const void* c, const void* dy, const float* dstate,
                         void* dxdt, float* dla, void* db, void* dc, float* ws,
                         int bh, int s, int p, int n, int chunk, int rep,
                         cudaStream_t st) {
  switch (mma_nb(n)) {
    case 2:
      return launch_bwd<2, TI>(xdt, la, b, c, dy, dstate, dxdt, dla, db, dc,
                               ws, bh, s, p, n, chunk, rep, st);
    case 4:
      return launch_bwd<4, TI>(xdt, la, b, c, dy, dstate, dxdt, dla, db, dc,
                               ws, bh, s, p, n, chunk, rep, st);
    default:
      return launch_bwd<8, TI>(xdt, la, b, c, dy, dstate, dxdt, dla, db, dc,
                               ws, bh, s, p, n, chunk, rep, st);
  }
}

// Bytes of dynamic shared memory of a backward kernel (0 sums f32, 1 sums
// bf16, 2 local f32, 3 local bf16, 4 dla) at padded state width 16 nb and
// chunk length chunk.
size_t bwd_smem_bytes(int kernel, int nb, int chunk) {
  switch (kernel) {
    case 0:
      return nb == 2 ? sums_f32_smem_bytes<32>(chunk)
             : nb == 4 ? sums_f32_smem_bytes<64>(chunk)
                       : sums_f32_smem_bytes<128>(chunk);
    case 1:
      return nb == 2 ? sums_mma_smem_bytes<2>(chunk)
             : nb == 4 ? sums_mma_smem_bytes<4>(chunk)
                       : sums_mma_smem_bytes<8>(chunk);
    case 2:
      return nb == 2 ? local_f32_smem_bytes<32>(chunk)
             : nb == 4 ? local_f32_smem_bytes<64>(chunk)
                       : local_f32_smem_bytes<128>(chunk);
    case 3:
      return nb == 2 ? local_mma_smem_bytes<2>(chunk)
             : nb == 4 ? local_mma_smem_bytes<4>(chunk)
                       : local_mma_smem_bytes<8>(chunk);
    default:
      return sizeof(double) * chunk;
  }
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
      switch (mma_nb(n)) {
        case 2:
          return launch_f32<32>(xdt, la, b, c, y, state, bh, s, p, n, chunk,
                                rep, st);
        case 4:
          return launch_f32<64>(xdt, la, b, c, y, state, bh, s, p, n, chunk,
                                rep, st);
        default:
          return launch_f32<128>(xdt, la, b, c, y, state, bh, s, p, n, chunk,
                                 rep, st);
      }
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
                                    : f32_smem_bytes(16 * mma_nb(n), chunk));
}

// The backward.  xdt, dy and dxdt (bh, s, p), b, c, db and dc (bh / rep,
// s, n), all in one dtype (0 f32, 1 bf16; bf16 inputs 16-byte aligned); la
// and dla (bh, s) f32; dstate (bh, p, n) f32 or null (a zero gradient of
// the final state); workspace ssd_scan_bwd_workspace_floats(bh, s, n,
// chunk) floats, 16-byte aligned.  All contiguous.  Returns the CUDA error
// of the launches (0 on success).
int ssd_scan_bwd(const void* xdt, const float* la, const void* b,
                 const void* c, const void* dy, const float* dstate,
                 void* dxdt, float* dla, void* db, void* dc, float* workspace,
                 int bh, int s, int p, int n, int chunk, int rep, int dtype,
                 void* stream) {
  if (bh < 1 || s < 1 || p < 1 || p > kBwdP || n < 1 || n > kMaxN ||
      chunk < 1 || rep < 1 || bh % rep)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(workspace) % 16)
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_bwd<float>(xdt, la, b, c, dy, dstate, dxdt, dla, db, dc,
                                 workspace, bh, s, p, n, chunk, rep, st);
    case kBF16:
      if ((reinterpret_cast<uintptr_t>(xdt) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(dy)) %
          16)
        return cudaErrorMisalignedAddress;
      return dispatch_bwd<bf16>(xdt, la, b, c, dy, dstate, dxdt, dla, db, dc,
                                workspace, bh, s, p, n, chunk, rep, st);
    default:
      return cudaErrorInvalidValue;
  }
}

long long ssd_scan_bwd_workspace_floats(int bh, int s, int n, int chunk) {
  if (bh < 1 || s < 1 || n < 1 || n > kMaxN || chunk < 1) return -1;
  return (long long)bwd_layout(nullptr, bh, s, n, chunk, nullptr);
}

// Bytes of dynamic shared memory of backward kernel `kernel` (0
// ssd_bwd_sums_kernel, 1 ssd_bwd_sums_mma_kernel, 2 ssd_bwd_local_kernel, 3
// ssd_bwd_local_mma_kernel, 4 ssd_bwd_dla_kernel) at state width n and
// chunk length chunk.
long long ssd_scan_bwd_smem_bytes(int kernel, int n, int chunk) {
  if (kernel < 0 || kernel > 4 || n < 1 || n > kMaxN || chunk < 1) return -1;
  return (long long)bwd_smem_bytes(kernel, mma_nb(n), chunk);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
