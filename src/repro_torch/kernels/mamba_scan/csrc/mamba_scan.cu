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

// ------------------------------------------------------------------------
// Backward: `ssd_scan_bwd_kernel`, then `ssd_bwd_reduce_kernel`.
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
// Design (a simple one: f32 FMAs on the CUDA cores): one block per head row
// (grid BH), 16 x 16 threads, tiles of 64 rows staged by plain loads and
// widened to f32 (so no alignment is asked of the inputs), P up to 64
// (padded with zeros to 64), N padded to 32, 64 or 128.
//   * Pass 0 runs the forward's state chain over the chunks and writes the
//     state entering each chunk to a workspace (BH, n_chunks, 64, NP) f32
//     (10.5 MB at the training shape); the forward kernels stay untouched.
//   * Then the chunks in reverse, with dh, the gradient of the state
//     leaving the chunk, in shared memory both as [p][n] and as [n][p]:
//     pass A, per key tile J (its rows j), over the query tiles I >= J:
//     G^T = B_J C_I^T and M^T = X_J dY_I^T, decayed and masked; dx_J +=
//     (G^T W^T) dY_I and dB_J += (W^T M^T) C_I in registers, the column
//     sums of E; then the state terms w_j dh B_j (dx), w_j dh^T x_j (dB)
//     and x_j . (w_j dh B_j) (dcum).  dx goes out in the inputs' dtype, dB
//     per head in f32 to the workspace.  Pass B, per query tile I, over the
//     key tiles J <= I: dC_I += (W M) B_J, the row sums of E, then the
//     entering state's terms e^{cum_i} h_in^T dy_i (dC) and its dot with
//     C_i (dcum); dC per head in f32.  Pass C: dh_in = e^{cum_L} dh +
//     sum_i e^{cum_i} dy_i (x) C_i.  dcum is summed in f64 from the f32
//     terms, and dla is its suffix sum over the chunk, taken in f64 by one
//     thread in index order and rounded once, as the forward takes its
//     prefix sum: the sum of a chunk's E terms is 0, and in f32 a chunk's
//     first dla values were left with the rounding of the sum's terms
//     (2.8e-3 against a 1e-4 tolerance at the training shape).
//   * Every output element is owned by one thread and summed in a fixed
//     order (no atomics), so two runs give the same bits;
//     `ssd_bwd_reduce_kernel` then sums each group's rep heads of dB and dC
//     in head order and rounds once (the model: flash_attention.cu's
//     `flash_dkdv_reduce_kernel`).
// What bounds it: at the training shape (80 heads of P 64, one group of N
// 128, S 1024 in chunks of 256, bf16) the function moves about 33 MB and
// needs about 14 GFLOP (chip_smoke.py's k5_bwd_bound_ms counts both), so
// at the tensor cores' bf16 rate its bound is operations, about 0.014 ms.
// This kernel runs every product as f32 FMAs on 80 of the 132 SMs (one
// block a head row), reads its operands from shared memory 16 bytes at a
// time as the f32 forward does, and forms each chunk's Gram once per head
// and twice (passes A and B), so it is far from that bound: the tensor
// cores, cp.async staging and more blocks than head rows are later work.
// ------------------------------------------------------------------------

constexpr int kBwdThreads = 256;      // 16 x 16
constexpr int kBwdT = 64;             // rows of a tile (keys or queries)
constexpr int kBwdP = 64;             // P columns the block holds (padded)
constexpr int kBwdSX = kBwdP + 4;     // row stride of the P-wide tiles
constexpr int kBwdSS = kBwdT + 4;     // row stride of the score tiles
static_assert(kBwdP == 4 * 16, "a thread owns 4 P columns of 64");

// Floats of the union that holds dh^T (NP rows of P) in pass A and the
// entering state (64 rows of N) in passes B and C.
__host__ __device__ constexpr int bwd_union_floats(int np) {
  return np * kBwdSX > kBwdP * (np + 4) ? np * kBwdSX : kBwdP * (np + 4);
}

// Bytes of dynamic shared memory at padded state width np and chunk length
// chunk: the C and B tiles, the xdt and dy tiles, two score tiles, dh, the
// union, four f32 arrays and one f64 array of the chunk's positions and a
// block reduction.
size_t bwd_smem_bytes(int np, int chunk) {
  const size_t sf = np + 4, cpad = round_up(chunk, kBwdT);
  const size_t floats = 2 * kBwdT * sf + 2 * kBwdT * kBwdSX
                        + 2 * kBwdT * kBwdSS + kBwdP * sf
                        + bwd_union_floats(np) + 6 * cpad + 32;
  return floats * sizeof(float);
}

// Floats of the workspace: the entering states, then dB's and dC's
// partials per head.
size_t bwd_workspace_floats(int bh, int s, int n, int chunk) {
  const size_t nc = (s + chunk - 1) / chunk;
  return (size_t)bh * nc * kBwdP * (16 * mma_nb(n)) + 2 * (size_t)bh * s * n;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows [0, ROWS) and columns [0, COLS) of an f32 tile of row stride
// `stride` from the rows of a row-major matrix of leading dimension `ld`
// starting at `src`, widened to f32; rows at or past `valid` and columns at
// or past `width` read 0.
template <int ROWS, int COLS, typename TI>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const TI* src, int ld, int valid,
                                          int width) {
  for (int i = threadIdx.x; i < ROWS * COLS; i += kBwdThreads) {
    const int r = i / COLS, c = i % COLS;
    dst[r * stride + c] =
        r < valid && c < width ? widen(src[(size_t)r * ld + c]) : 0.f;
  }
}

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

// The sum over the 16 lanes of a half warp (the tx of one ty).
template <typename V>
__device__ __forceinline__ V half_warp_sum(V v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Grid (B*H); NP is N padded to 32, 64 or 128; TI the inputs' dtype.
template <int NP, typename TI>
__global__ void __launch_bounds__(kBwdThreads, 1)
ssd_scan_bwd_kernel(const TI* __restrict__ xdt, const float* __restrict__ la,
                    const TI* __restrict__ bmat, const TI* __restrict__ cmat,
                    const TI* __restrict__ dy,
                    const float* __restrict__ dstate, TI* __restrict__ dxdt,
                    float* __restrict__ dla, float* __restrict__ db_part,
                    float* __restrict__ dc_part, float* __restrict__ h_ws,
                    int S, int P, int N, int chunk, int rep) {
  constexpr int T = kBwdT, SX = kBwdSX, SS = kBwdSS, SF = NP + 4;
  constexpr int NV = NP / 16;              // N columns a thread owns
  extern __shared__ __align__(16) float smb[];
  float* Cs = smb;                         // T x SF
  float* Bs = Cs + T * SF;                 // T x SF
  float* Xs = Bs + T * SF;                 // T x SX
  float* Ys = Xs + T * SX;                 // T x SX: dy
  float* Ss = Ys + T * SX;                 // T x SS
  float* Qs = Ss + T * SS;                 // T x SS
  float* DH = Qs + T * SS;                 // kBwdP x SF: dh[p][n]
  float* Un = DH + kBwdP * SF;             // dh^T [n][p], or h_in [p][n]
  const int cpad = round_up(chunk, T);
  float* cum = Un + bwd_union_floats(NP);
  float* ecum = cum + cpad;                // e^{cum_i}, 0 past the end
  float* wl = ecum + cpad;                 // e^{cum_L - cum_j}, 0 past it
  float* rr = wl + cpad;                   // x_j . (w_j dh B_j)
  // dcum in f64: each E_ij enters row i's sum and column j's with one f32
  // value, and each r_j position j and L, so the suffix sum cancels them
  // exactly where they cancel (a chunk's first positions).
  double* dcum = reinterpret_cast<double*>(rr + cpad);
  float* red = rr + 3 * cpad;              // a block reduction's 8 warps

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row = blockIdx.x;              // b * H + h
  const int grow = row / rep;              // b * G + h / rep
  const int nc = (S + chunk - 1) / chunk;
  const TI* xp = xdt + (size_t)row * S * P;
  const TI* yp = dy + (size_t)row * S * P;
  const float* lp = la + (size_t)row * S;
  const TI* bp = bmat + (size_t)grow * S * N;
  const TI* cp = cmat + (size_t)grow * S * N;
  float* ws = h_ws + (size_t)row * nc * kBwdP * NP;
  // This thread's (P, N) entries: p in [hp, hp + 4), n in [hn, hn + NV).
  const int hp = 4 * tx, hn = NV * ty;

  // The chunk's cum (warp 0, f64, as the forward), e^cum and w; dcum = 0.
  auto chunk_terms = [&](int c0, int clen) {
    __syncthreads();                       // Ss and the arrays are free
    if (tid < 32)
      prefix_sum_f64(cum, lp + c0, clen, reinterpret_cast<double*>(Ss));
    __syncthreads();
    const float last = cum[clen - 1];
    for (int i = tid; i < cpad; i += kBwdThreads) {
      const bool in = i < clen;
      ecum[i] = in ? expf(cum[i]) : 0.f;
      wl[i] = in ? expf(last - cum[i]) : 0.f;
      dcum[i] = 0.0;
    }
    __syncthreads();
  };
  auto stage_keys = [&](int at, int valid) {      // B and xdt rows
    load_tile<T, NP>(Bs, SF, bp + (size_t)at * N, N, valid, N);
    load_tile<T, kBwdP>(Xs, SX, xp + (size_t)at * P, P, valid, P);
  };
  auto stage_queries = [&](int at, int valid) {   // C and dy rows
    load_tile<T, NP>(Cs, SF, cp + (size_t)at * N, N, valid, N);
    load_tile<T, kBwdP>(Ys, SX, yp + (size_t)at * P, P, valid, P);
  };

  // Pass 0: the state entering each chunk, into the workspace.
  {
    float h[4][NV];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < NV; ++v) h[q][v] = 0.f;
    for (int z = 0; z < nc; ++z) {
      float* wz = ws + (size_t)z * kBwdP * NP;
#pragma unroll
      for (int q = 0; q < 4; ++q) store_row(wz + (hp + q) * NP + hn, h[q]);
      if (z == nc - 1) break;
      const int c0 = z * chunk, clen = min(chunk, S - c0);
      chunk_terms(c0, clen);
      float hc[4][NV];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int v = 0; v < NV; ++v) hc[q][v] = 0.f;
      for (int j0 = 0; j0 < clen; j0 += T) {
        __syncthreads();
        stage_keys(c0 + j0, clen - j0);
        __syncthreads();
        outer_acc(hc, Xs, SX, Bs, SF, wl + j0, hp, hn);
      }
      const float decay = ecum[clen - 1];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int v = 0; v < NV; ++v) h[q][v] = fmaf(decay, h[q][v], hc[q][v]);
    }
  }

  // dh of the last chunk: dstate, or 0.
  __syncthreads();
  for (int i = tid; i < kBwdP * NP; i += kBwdThreads) {
    const int p = i / NP, n = i % NP;
    const float v = dstate != nullptr && p < P && n < N
                        ? dstate[((size_t)row * P + p) * N + n] : 0.f;
    DH[p * SF + n] = v;
    Un[n * SX + p] = v;
  }

  for (int z = nc - 1; z >= 0; --z) {
    const int c0 = z * chunk, clen = min(chunk, S - c0);
    chunk_terms(c0, clen);

    // Pass A: per key tile, dx and dB (intra-chunk and state terms).
    for (int j0 = 0; j0 < clen; j0 += T) {
      __syncthreads();                     // the last tile's reads done
      stage_keys(c0 + j0, clen - j0);
      float dx[4][4], dbv[4][NV];
      double erow[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        erow[r] = 0.0;
#pragma unroll
        for (int q = 0; q < 4; ++q) dx[r][q] = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v) dbv[r][v] = 0.f;
      }
      for (int i0 = j0; i0 < clen; i0 += T) {
        __syncthreads();                   // C, dy and the scores are free
        stage_queries(c0 + i0, clen - i0);
        __syncthreads();
        float g[4][4], m[4][4];
        tile_dot<NP>(g, Bs, SF, Cs, SF, tx, ty);       // B_j . C_i
        tile_dot<kBwdP>(m, Xs, SX, Ys, SX, tx, ty);    // x_j . dy_i
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + ty + 16 * r, i = i0 + tx + 16 * c;
            const float w = j <= i && i < clen
                                ? expf(fminf(cum[i] - cum[j], 0.f)) : 0.f;
            const float sv = g[r][c] * w;
            erow[r] += (double)(sv * m[r][c]);
            Ss[(ty + 16 * r) * SS + tx + 16 * c] = sv;
            Qs[(ty + 16 * r) * SS + tx + 16 * c] = m[r][c] * w;
          }
        __syncthreads();
        rows_times<T, 4>(dx, Ss, SS, Ys, SX, 4 * tx, ty);
        rows_times<T, NV>(dbv, Qs, SS, Cs, SF, NV * tx, ty);
      }
      // The state terms: v_j = dh B_j and t_j = dh^T x_j.
      float v[4][4], t[4][NV];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v[r][q] = 0.f;
#pragma unroll
        for (int k = 0; k < NV; ++k) t[r][k] = 0.f;
      }
      rows_times<NP, 4>(v, Bs, SF, Un, SX, 4 * tx, ty);
      rows_times<kBwdP, NV>(t, Xs, SX, DH, SF, NV * tx, ty);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int jl = ty + 16 * r, j = j0 + jl;
        const float w = wl[j];
        float xv[4];
        load_row(xv, Xs + jl * SX + 4 * tx);
        float part = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) part = fmaf(xv[q], v[r][q], part);
        const float rj = w * half_warp_sum(part);
        const double e = half_warp_sum(erow[r]);
        if (tx == 0 && j < clen) {
          dcum[j] -= e + (double)rj;
          rr[j] = rj;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) dx[r][q] = fmaf(w, v[r][q], dx[r][q]);
#pragma unroll
        for (int k = 0; k < NV; ++k) dbv[r][k] = fmaf(w, t[r][k], dbv[r][k]);
        if (j < clen) {
          TI* dxr = dxdt + ((size_t)row * S + c0 + j) * P;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (4 * tx + q < P) narrow(dxr + 4 * tx + q, dx[r][q]);
          float* dbr = db_part + ((size_t)row * S + c0 + j) * N;
#pragma unroll
          for (int k = 0; k < NV; ++k)
            if (NV * tx + k < N) dbr[NV * tx + k] = dbv[r][k];
        }
      }
    }

    // Pass B: per query tile, dC (intra-chunk and entering-state terms).
    __syncthreads();                       // pass A's reads of dh^T done
    const float* wz = ws + (size_t)z * kBwdP * NP;
    for (int i = tid; i < kBwdP * NP; i += kBwdThreads)
      Un[(i / NP) * SF + i % NP] = wz[i];
    for (int i0 = 0; i0 < clen; i0 += T) {
      __syncthreads();
      stage_queries(c0 + i0, clen - i0);
      float dcv[4][NV];
      double erow[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        erow[r] = 0.0;
#pragma unroll
        for (int k = 0; k < NV; ++k) dcv[r][k] = 0.f;
      }
      for (int j0 = 0; j0 <= i0; j0 += T) {
        __syncthreads();                   // B, xdt and the scores are free
        stage_keys(c0 + j0, clen - j0);
        __syncthreads();
        float g[4][4], m[4][4];
        tile_dot<NP>(g, Cs, SF, Bs, SF, tx, ty);       // C_i . B_j
        tile_dot<kBwdP>(m, Ys, SX, Xs, SX, tx, ty);    // dy_i . x_j
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = i0 + ty + 16 * r, j = j0 + tx + 16 * c;
            const float w = j <= i && i < clen
                                ? expf(fminf(cum[i] - cum[j], 0.f)) : 0.f;
            const float sv = g[r][c] * w;
            erow[r] += (double)(sv * m[r][c]);
            Qs[(ty + 16 * r) * SS + tx + 16 * c] = m[r][c] * w;
          }
        __syncthreads();
        rows_times<T, NV>(dcv, Qs, SS, Bs, SF, NV * tx, ty);
      }
      // u_i = h_in^T dy_i.
      float u[4][NV];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < NV; ++k) u[r][k] = 0.f;
      rows_times<kBwdP, NV>(u, Ys, SX, Un, SF, NV * tx, ty);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int il = ty + 16 * r, i = i0 + il;
        const float ei = ecum[i];
        float cv[NV];
        load_row(cv, Cs + il * SF + NV * tx);
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < NV; ++k) part = fmaf(cv[k], u[r][k], part);
        const float inter = ei * half_warp_sum(part);
        const double e = half_warp_sum(erow[r]);
        if (tx == 0 && i < clen) dcum[i] += e + (double)inter;
#pragma unroll
        for (int k = 0; k < NV; ++k) dcv[r][k] = fmaf(ei, u[r][k], dcv[r][k]);
        if (i < clen) {
          float* dcr = dc_part + ((size_t)row * S + c0 + i) * N;
#pragma unroll
          for (int k = 0; k < NV; ++k)
            if (NV * tx + k < N) dcr[NV * tx + k] = dcv[r][k];
        }
      }
    }

    // Pass C: sum_i e^{cum_i} dy_i (x) C_i, for the entering state's dh.
    float dhn[4][NV];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < NV; ++v) dhn[q][v] = 0.f;
    if (z > 0)
      for (int i0 = 0; i0 < clen; i0 += T) {
        __syncthreads();
        stage_queries(c0 + i0, clen - i0);
        __syncthreads();
        outer_acc(dhn, Ys, SX, Cs, SF, ecum + i0, hp, hn);
      }

    // dcum_L += e^{cum_L} <dh, h_in> + sum_j x_j . (w_j dh B_j); then dla.
    float dot = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < NV; ++v)
        dot = fmaf(DH[(hp + q) * SF + hn + v], Un[(hp + q) * SF + hn + v], dot);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (tid % 32 == 0) red[tid / 32] = dot;
    __syncthreads();                       // dcum, rr and red complete
    const float el = ecum[clen - 1];
    if (tid == 0) {
      float tot = 0.f;
      double rs = 0.0;
      for (int w = 0; w < kBwdThreads / 32; ++w) tot += red[w];
      for (int j = 0; j < clen; ++j) rs += (double)rr[j];
      dcum[clen - 1] += (double)(el * tot) + rs;
      double run = 0.0;
      for (int i = clen - 1; i >= 0; --i) {
        run += dcum[i];
        dla[(size_t)row * S + c0 + i] = (float)run;
      }
    }
    if (z > 0) {
      // dh <- e^{cum_L} dh + the sum; dh^T over h_in's room.
      float nv[4][NV];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int v = 0; v < NV; ++v)
          nv[q][v] = fmaf(el, DH[(hp + q) * SF + hn + v], dhn[q][v]);
      __syncthreads();                     // every read of dh and h_in done
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          DH[(hp + q) * SF + hn + v] = nv[q][v];
          Un[(hn + v) * SX + hp + q] = nv[q][v];
        }
    }
  }
}

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

template <int NP, typename TI>
cudaError_t launch_bwd(const void* xdt, const float* la, const void* b,
                       const void* c, const void* dy, const float* dstate,
                       void* dxdt, float* dla, void* db, void* dc, float* ws,
                       int bh, int s, int p, int n, int chunk, int rep,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(NP, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd_kernel<NP, TI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const size_t nc = (s + chunk - 1) / chunk;
  float* db_part = ws + (size_t)bh * nc * kBwdP * NP;
  float* dc_part = db_part + (size_t)bh * s * n;
  ssd_scan_bwd_kernel<NP, TI><<<bh, kBwdThreads, smem, stream>>>(
      static_cast<const TI*>(xdt), la, static_cast<const TI*>(b),
      static_cast<const TI*>(c), static_cast<const TI*>(dy), dstate,
      static_cast<TI*>(dxdt), dla, db_part, dc_part, ws, s, p, n, chunk, rep);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t elems = (size_t)(bh / rep) * s * n;
  const size_t want = (elems + 255) / 256;
  const int blocks = (int)(want < 1056 ? want : 1056);
  ssd_bwd_reduce_kernel<TI><<<blocks, 256, 0, stream>>>(
      db_part, dc_part, static_cast<TI*>(db), static_cast<TI*>(dc), elems,
      (size_t)s * n, rep);
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
      return launch_bwd<32, TI>(xdt, la, b, c, dy, dstate, dxdt, dla, db, dc,
                                ws, bh, s, p, n, chunk, rep, st);
    case 4:
      return launch_bwd<64, TI>(xdt, la, b, c, dy, dstate, dxdt, dla, db, dc,
                                ws, bh, s, p, n, chunk, rep, st);
    default:
      return launch_bwd<128, TI>(xdt, la, b, c, dy, dstate, dxdt, dla, db,
                                 dc, ws, bh, s, p, n, chunk, rep, st);
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
// s, n), all in one dtype (0 f32, 1 bf16); la and dla (bh, s) f32; dstate
// (bh, p, n) f32 or null (a zero gradient of the final state); workspace
// ssd_scan_bwd_workspace_floats(bh, s, n, chunk) floats, 16-byte aligned.
// All contiguous.  Returns the CUDA error of the launches (0 on success).
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
      return dispatch_bwd<bf16>(xdt, la, b, c, dy, dstate, dxdt, dla, db, dc,
                                workspace, bh, s, p, n, chunk, rep, st);
    default:
      return cudaErrorInvalidValue;
  }
}

long long ssd_scan_bwd_workspace_floats(int bh, int s, int n, int chunk) {
  if (bh < 1 || s < 1 || n < 1 || n > kMaxN || chunk < 1) return -1;
  return (long long)bwd_workspace_floats(bh, s, n, chunk);
}

// Bytes of dynamic shared memory the backward takes at state width n and
// chunk length chunk.
long long ssd_scan_bwd_smem_bytes(int n, int chunk) {
  if (n < 1 || n > kMaxN || chunk < 1) return -1;
  return (long long)bwd_smem_bytes(16 * mma_nb(n), chunk);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
