// f32 attention on Hopper's CUDA cores, shared by K4 (flash_attention.cu)
// and K1 (../../prefill/csrc/prefill.cu): the f32 score chain by which every
// f32 kernel of K4 computes its scores, the f32 staging helpers, and the
// body of the f32 online-softmax forward, which each file wraps in a
// `__global__` kernel of its own name (`flash_fwd_f32_kernel`,
// `prefill_flash_f32_kernel`), so the profiler and the `-Xptxas -v` report
// tell the two apart.  kernels/build.py hashes this header with the sources
// that include it and puts its directory on the include path.
//
// The forward's arithmetic is fixed, because K4's f32 backward recomputes
// P = exp(s - lse) from the forward's log-sum-exp, and at the x30 logits
// (scores near 900) one rounding more or less in s or lse takes dV past the
// gradient tolerance (tests/test_torch_flash_attention.py):
//   - q is staged as q * scale, rounded once to f32;
//   - each score is `score_chain`'s: one fmaf a head-dim element in
//     ascending order from 0 (read 4 at a time from 16-byte rows, which
//     leaves the order as it is);
//   - masked scores are kNegInf; the key tile is 64 keys, where the running
//     max and sum are rescaled; p = expf(s - m_new), alpha =
//     expf(m_old - m_new);
//   - each tile's row sum is taken in ascending key order from 0, then
//     l = l * alpha + sum;
//   - O: acc *= alpha, then one fmaf a key in ascending order;
//   - out = acc / fmaxf(l, 1e-30), lse = m + logf(fmaxf(l, 1e-30)).
// Only the row max, which is exact, is free to be reduced in any order.
//
// What bounds it: the two products (scores and P V) are 4 D f32
// operations a visible (query, key) pair, on the CUDA cores (TF32 would
// move the scores, and the bits of out that the backward's row term reads);
// at the training path's shape (16 q heads, 2 KV heads, D = 128, S = 1024,
// causal) that is 0.064 ms at 67 TFLOP/s, against 0.004 ms for the bytes.
// So the design keeps the FMA pipes fed:
//   - 8 warps a block, one block of 64 query rows an SM at D = 128 (186,624
//     B of shared memory), two warps a scheduler; each lane holds 4 rows x 4
//     keys of the score tile (keys tx + 16 j, tx = lane % 16) and 4 rows x
//     D/16 columns of the output (VV-wide runs at VV tx + 16 VV c), so both
//     products are register-blocked outer products read 16 bytes at a time
//     from shared memory;
//   - rows padded to D + 4 floats, so those reads are free of bank
//     conflicts; K and V staged by `cp.async` into two buffers each, the
//     next tile's copy in flight while this one is used;
//   - the row max by shuffles over the 16 lanes that hold a row, and expf by
//     the lanes that hold the scores; P goes to shared memory once, where
//     two warps take each row's series sum while the others start P V;
//   - causal tiles past the diagonal never loaded, the mask applied only to
//     tiles that cross the diagonal or the ragged edge, and the heaviest
//     causal tiles (the last query tiles) launched first.

#pragma once

#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tiles.cuh"   // smem_addr, cp_async*, kThreads, kNegInf

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// Row stride, in floats, of an f32 tile in shared memory: rows of 16-byte
// multiples for `cp.async` and float4 reads; the extra 4 floats put the
// rows an `mma` fragment reads (8 rows x 4 columns, or 4 rows x 8 columns),
// and the rows the forward's lanes read at once, in distinct banks.
template <int D>
__device__ __forceinline__ constexpr int f32_stride() { return D + 4; }

// Stage rows [r0, r0 + ROWS) of a (rows, D) f32 matrix into a shared tile
// of row stride D + 4 with cp.async, NT threads a block; rows at or past
// `valid` read 0.
template <int ROWS, int D, int NT = kThreads>
__device__ __forceinline__ void stage_f32_async(float* dst, const float* src,
                                                int r0, int valid) {
  constexpr int kChunks = D / 4;                  // 16-byte chunks a row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += NT) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    const bool ok = r0 + r < valid;
    cp_async16(smem_addr(dst + r * f32_stride<D>() + col),
               src + (size_t)(ok ? r0 + r : 0) * D + col, ok);
  }
}

// Rows [0, ROWS) of a staged f32 tile times `mul`, in place: q * scale
// rounded to f32.
template <int ROWS, int D, int NT = kThreads>
__device__ __forceinline__ void scale_tile(float* t, float mul) {
  constexpr int kChunks = D / 4;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += NT) {
    float4* p = reinterpret_cast<float4*>(t + (c / kChunks) * f32_stride<D>() +
                                          (c % kChunks) * 4);
    float4 x = *p;
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    *p = x;
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(float (&dst)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  } else if constexpr (VEC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    dst[0] = x.x;
    dst[1] = x.y;
  } else {
    static_assert(VEC == 1, "VEC is 1, 2 or 4");
    dst[0] = *p;
  }
}

// The f32 score chain, one definition for every f32 kernel of K4 and K1,
// so that the backward recomputes the forward's scores bit for bit:
// s[i][j] = the sum over d = 0 .. D-1, in ascending order, one fmaf each
// from 0, of row(i)[d] * col(j)[d], where one side is q * scale rounded to
// f32 (as staged) and the other k.  fmaf(a, b, c) is fmaf(b, a, c), so the
// dK/dV kernel, with k as its rows, gets the same bits.  `row(i)` and
// `col(j)` give shared-memory rows; VEC is the width of the reads (1, or 4
// on 16-byte aligned rows), which leaves the chain's order as it is.
template <int D, int VEC, int NR, int NC, typename Row, typename Col>
__device__ __forceinline__ void score_chain(float (&s)[NR][NC], Row row,
                                            Col col) {
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; d += VEC) {
    float rv[NR][VEC], cv[NC][VEC];
#pragma unroll
    for (int i = 0; i < NR; ++i) load_vec<VEC>(rv[i], row(i) + d);
#pragma unroll
    for (int j = 0; j < NC; ++j) load_vec<VEC>(cv[j], col(j) + d);
#pragma unroll
    for (int x = 0; x < VEC; ++x)
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j)
          s[i][j] = fmaf(rv[i][x], cv[j][x], s[i][j]);
  }
}

// ------------------------------------------------------------- forward
constexpr int kFwdThreads = 256;   // 8 warps a block
constexpr int kFwdBQ = 64;         // query rows a block holds (4 a lane)
constexpr int kFwdBK = 64;         // keys a K/V tile holds
constexpr int kFwdPS = kFwdBK + 4; // row stride of the P tile, in floats

template <int D>
constexpr size_t fwd_f32_smem_bytes() {
  // Q (kFwdBQ rows) | K, V (2 buffers of kFwdBK rows each) | P |
  // alpha, then l (kFwdBQ), f32
  return sizeof(float) * ((kFwdBQ + 4 * kFwdBK) * (D + 4) +
                          kFwdBQ * kFwdPS + kFwdBQ);
}

// Stage rows [r0, r0 + ROWS) of a (rows, D) matrix of T into a shared f32
// tile of row stride D + 4; rows at or past `valid` read 0.  f32 from a
// 16-byte aligned matrix by `cp.async`; otherwise (f16, or an f32 view that
// starts off a 16-byte boundary) by plain loads, widened exactly.
template <int ROWS, int D, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int r0,
                                           int valid, int async_copy) {
  if constexpr (std::is_same<T, float>::value) {
    if (async_copy) {
      stage_f32_async<ROWS, D, kFwdThreads>(dst, src, r0, valid);
      return;
    }
  }
  constexpr int kChunks = D / 4;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kFwdThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < valid) {
      const T* p = src + (size_t)(r0 + r) * D + col;
      x = make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
    }
    *reinterpret_cast<float4*>(dst + r * f32_stride<D>() + col) = x;
  }
}

// acc[i][.] += p[i] * (this lane's columns of V row `vr`), one fmaf each.
template <int D, int VV, int NV>
__device__ __forceinline__ void pv_key(float (&acc)[4][VV * NV],
                                       const float (&p)[4], const float* vr,
                                       int tx) {
  float vv[NV][VV];
#pragma unroll
  for (int c = 0; c < NV; ++c) load_vec<VV>(vv[c], vr + VV * tx + 16 * VV * c);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VV; ++e)
        acc[i][c * VV + e] = fmaf(p[i], vv[c][e], acc[i][c * VV + e]);
}

// The forward's body, for a grid (B*Hq, ceil(Sq / kFwdBQ)) of kFwdThreads
// threads with fwd_f32_smem_bytes<D>() of dynamic shared memory at `smem`
// (16-byte aligned).  Query tile gridDim.y - 1 - blockIdx.y, so the causal
// tiles with the most keys start first.  Lane `lane` of warp w holds query
// rows r0 .. r0 + 3, r0 = 4 (2 w + lane / 16), of the tile; with
// tx = lane % 16, keys tx + 16 j (j < 4) of each score tile and columns
// VV tx + 16 VV c + e (c < D / 16 / VV, e < VV) of the output.  Threads
// 0 .. 63 (warps 0 and 1) each keep one row's sum l.  `out` is in T;
// `out32` (the output in f32) and `lse` (each row's log-sum-exp) are
// written when not NULL.  `async_copy`: q, k and v are f32 and 16-byte
// aligned, and are staged by `cp.async`.
template <typename T, int D>
__device__ __forceinline__ void attention_fwd_f32(
    float* smem, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ out32,
    float* __restrict__ lse, int Sq, int Skv, int group, float scale,
    int causal, int async_copy) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int SF = f32_stride<D>();
  constexpr int DJ = D / 16;                      // output columns a lane
  constexpr int VV = DJ < 4 ? DJ : 4;             // width of its V reads
  constexpr int NV = DJ / VV;                     // V reads a key
  float* Qs = smem;
  float* Ks = Qs + kFwdBQ * SF;                   // 2 buffers
  float* Vs = Ks + 2 * kFwdBK * SF;               // 2 buffers
  float* Ps = Vs + 2 * kFwdBK * SF;
  float* a_s = Ps + kFwdBQ * kFwdPS;              // alpha per row; l at the end

  const int tid = threadIdx.x, lane = tid % 32;
  const int tx = lane % 16;
  const int r0 = (tid / 32 * 2 + lane / 16) * 4;  // this lane's rows r0 .. +3
  const int row_q = blockIdx.x;                   // b * Hq + h
  const int row_kv = row_q / group;               // b * Hkv + h / group
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdBQ;
  const T* kp = k + (size_t)row_kv * Skv * D;
  const T* vp = v + (size_t)row_kv * Skv * D;
  // Causal: no key past the tile's last valid query row is visible.
  const int k_end = causal ? min(Skv, min(q0 + kFwdBQ, Sq)) : Skv;
  const int n_kt = (k_end + kFwdBK - 1) / kFwdBK;

  stage_rows<kFwdBQ, D>(Qs, q + (size_t)row_q * Sq * D, q0, Sq, async_copy);
  stage_rows<kFwdBK, D>(Ks, kp, 0, Skv, async_copy);
  stage_rows<kFwdBK, D>(Vs, vp, 0, Skv, async_copy);
  cp_async_commit();

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  float m[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
  float l = 0.f;                                  // row tid's sum (tid < 64)

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kFwdBK;
    const int kn = min(kFwdBK, Skv - k0);         // valid keys in this tile
    const float* Kt = Ks + (t & 1) * kFwdBK * SF;
    const float* Vt = Vs + (t & 1) * kFwdBK * SF;
    if (t + 1 < n_kt) {                           // prefetch the next tile
      const int nb = ((t + 1) & 1) * kFwdBK * SF;
      stage_rows<kFwdBK, D>(Ks + nb, kp, k0 + kFwdBK, Skv, async_copy);
      stage_rows<kFwdBK, D>(Vs + nb, vp, k0 + kFwdBK, Skv, async_copy);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      scale_tile<kFwdBQ, D, kFwdThreads>(Qs, scale);
      __syncthreads();
    }

    float s[4][4];
    score_chain<D, 4>(s, [&](int i) { return Qs + (r0 + i) * SF; },
                      [&](int j) { return Kt + (tx + 16 * j) * SF; });
    if (k0 + kFwdBK > Skv || (causal && k0 + kFwdBK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (c >= kn || (causal && q0 + r0 + i < k0 + c)) s[i][j] = kNegInf;
        }
    }

    // The new row max over the row's 16 lanes, alpha, and P into shared
    // memory.
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      alpha[i] = expf(m[i] - mx);
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(r0 + i) * kFwdPS + tx + 16 * j] = expf(s[i][j] - mx);
      if (tx == 0) a_s[r0 + i] = alpha[i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha[i];
    }
    __syncthreads();

    // Row tid's sum, in ascending key order from 0 (warps 0 and 1).
    if (tid < kFwdBQ) {
      const float4* pr = reinterpret_cast<const float4*>(Ps + tid * kFwdPS);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kFwdBK / 4; ++c) {
        const float4 p = pr[c];
        sum += p.x;
        sum += p.y;
        sum += p.z;
        sum += p.w;
      }
      l = l * a_s[tid] + sum;
    }

    // O += P V over this tile's valid keys, in ascending order.
    const float* Pr = Ps + r0 * kFwdPS;
    int kk = 0;
#pragma unroll 2
    for (; kk + 4 <= kn; kk += 4) {
      float pk[4][4];                             // pk[x][i]: row r0 + i, key kk + x
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(Pr + i * kFwdPS + kk);
        pk[0][i] = p4.x;
        pk[1][i] = p4.y;
        pk[2][i] = p4.z;
        pk[3][i] = p4.w;
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pv_key<D, VV, NV>(acc, pk[x], Vt + (kk + x) * SF, tx);
    }
    for (; kk < kn; ++kk) {                       // the ragged edge
      const float p[4] = {Pr[kk], Pr[kFwdPS + kk], Pr[2 * kFwdPS + kk],
                          Pr[3 * kFwdPS + kk]};
      pv_key<D, VV, NV>(acc, p, Vt + kk * SF, tx);
    }
    __syncthreads();                              // this buffer consumed
  }

  if (tid < kFwdBQ) a_s[tid] = l;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + r0 + i;
    if (qi >= Sq) continue;
    const float lf = fmaxf(a_s[r0 + i], 1e-30f);
    const size_t base = ((size_t)row_q * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VV; ++e) {
        const size_t off = base + VV * tx + 16 * VV * c + e;
        const float o = acc[i][c * VV + e] / lf;
        out[off] = from_f32<T>(o);
        if (out32 != nullptr) out32[off] = o;
      }
    if (lse != nullptr && tx == 0)
      lse[(size_t)row_q * Sq + qi] = m[i] + logf(lf);
  }
}

}  // namespace
