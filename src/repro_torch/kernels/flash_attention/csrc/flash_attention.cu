// Flash attention for Hopper (sm_90a): the forward (K4) and its backward.
// Built by kernels/build.py into a shared library with a plain C interface
// and bound with ctypes (flash_attention.py).
//
// `flash_attention_fwd` replaces the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention /
// _flash_kernel: online-softmax attention, causal or not, Sq may differ from
// Skv, the causal mask is top-left aligned (query i sees key j iff i >= j,
// both counted from 0), GQA by dividing the q-head row by `group` (K/V are
// never repeated), f32 scores and accumulator, the scores scaled by
// 1/sqrt(D) in f32, masked scores -1e30 (not -inf), the row sum floored at
// 1e-30, out in q's dtype.  Beside `out` it writes each query row's
// log-sum-exp (f32, (B*Hq, Sq), natural log of the scaled scores) for the
// backward; the TPU kernel keeps its row statistics in VMEM only.
//
// The reference has no backward kernel (JAX differentiates its plain path).
// On the card the training path may not fall back to the plain version, so
// the backward is two entry points here:
//   `flash_attention_bwd_dq`   one block per (q-head row, 64-query tile):
//                              D_i = rowsum(dO_i * O_i) (written out for the
//                              second kernel), then dQ over the K/V tiles;
//   `flash_attention_bwd_dkdv` one block per (q-head row, 64-key tile),
//                              over the q tiles in ascending order, then
//                              the sum over the group's q heads in head
//                              order (below).
// Both recompute P = exp(s - lse) from q, k and the saved log-sum-exp with
// the forward's mask.  The row term takes the forward's output before its
// rounding to bf16 (the forward writes an f32 copy for it), as autograd
// through the plain version does: with the rounded output, bf16 gradients
// at large logits drift by several ulps.  No floating-point atomics: every
// output element is owned by one thread and summed in a fixed order, so a
// grain's gradient is the same bits every time it runs (the HDP combine
// relies on that).
//
// What bounds them on the card: at the training path's shapes (16 q heads,
// 2 KV heads, D = 128, S = 1024 in bf16) the least time of the forward is
// about 0.004 ms, by bf16 tensor-core operations (4 D per visible
// (query, key) pair, 8.4 M pairs); the backward needs 2.5x the operations.
//
// bf16 inputs take tensor-core kernels (`flash_fwd_mma_kernel`,
// `flash_dq_mma_kernel`, `flash_dkdv_mma_kernel`), FA2-style on
// `mma.sync.m16n8k16` with bf16 operands and f32 accumulators; the tile
// helpers and the forward's body are in mma_tiles.cuh, which K1's
// prefill.cu shares:
//   - each warp owns 16 rows of the block's tile (forward and dQ: query
//     rows of a 64-query tile; dK/dV: key rows of a 64-key tile), so every
//     product (S = Q K^T and O += P V; S = Q K^T, dP = dO V^T and
//     dQ += dS K; S^T = K Q^T, dP^T = V dO^T, dV += P^T dO and
//     dK += dS^T Q) keeps that warp's rows as its M and needs nothing from
//     another warp: a score tile's accumulator fragment is, element for
//     element, the A fragment of the product that follows, so P, dS, P^T
//     and dS^T never leave registers;
//   - the forward keeps its Q fragments in registers for the whole loop;
//     the dQ kernel reads Q's and dO's again for each K/V tile (beside dQ's,
//     S's and dP's accumulators, 64 f32 each at D = 128, they would not fit
//     in 255 registers); the online softmax is in registers, its row max
//     and sum reduced over the 4 threads of a row by shuffles;
//   - tiles stay bf16 in shared memory, rows padded by 16 bytes so that
//     `ldmatrix` reads are free of bank conflicts (`.trans` where the
//     product wants the tile's columns: V in P V, K in dS K, and Q and dO
//     in the dK/dV products), staged by `cp.async` 16 bytes a thread into
//     two buffers, so the next tile's load overlaps this tile's products;
//   - the scale is applied to the f32 scores (never to a bf16 q: at the
//     x30-logit case scores near 900 would move by tenths);
//   - P (forward), dS (dQ), P^T and dS^T (dK/dV) enter their products as
//     two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), which keeps 16
//     bits of each (a second product with the same B fragments): with P
//     rounded once, the output that feeds the dQ kernel's row term moves dQ
//     past the bf16 tolerance at the x30 logits, dS rounded once does the
//     same to dQ at the x30 logits with GQA, dS^T rounded once to dK
//     (tests/test_torch_flash_attention.py models them), and with P^T
//     rounded once dV at the training path's shape used most of it;
//   - the dQ kernel's row term Drow = rowsum(dO * O) is summed by one thread
//     a row in ascending head-dim order, as the f32 dQ kernel sums it, so
//     dK/dV gets the same bits from either;
//   - dK/dV without atomics and with enough blocks for 132 SMs: one block
//     per (q-head row, 64-key tile), 8x the blocks of one per KV head at
//     group 8.  Each block writes its head's f32 partial dK and dV into
//     scratch; `flash_dkdv_reduce_kernel` sums the group's partials in head
//     order and rounds once (group 1 writes its result directly);
//   - causal tiles past the diagonal are never loaded, the mask is applied
//     only to tiles that cross the diagonal or the ragged edge, and the
//     heaviest causal tiles (forward and dQ: the last query tiles; dK/dV:
//     the first key tiles) are launched first.
// f32 inputs: the forward (`flash_fwd_f32_kernel`) wraps the f32 body in
// f32_tiles.cuh, which K1's f32 and f16 prefill wraps too: both products
// (scores and P V) as f32 FMAs on the CUDA cores, 8 warps a block of 64
// query rows, each lane a 4 x 4 block of the score tile and a 4 x D/16
// block of the output, read 16 bytes at a time from rows padded to D + 4
// floats; K/V staged by `cp.async` into two buffers; the row max by
// shuffles, P through shared memory for P V and each row's series sum; the
// heaviest causal tiles first.  Its arithmetic, listed at the top of that
// header, is the one the backward's P = exp(s - lse) rests on, and
// `test_flash_attention_f32_forward_keeps_its_bits` holds its bits.  The
// backward (`flash_dq_tf32_kernel`, `flash_dkdv_tf32_kernel`, then
// `flash_dkdv_reduce_kernel<float>` for group > 1) has the bf16 kernels'
// grids and warp layout, and runs its products on the tensor cores as
// three TF32 products each (`mma.sync.m16n8k8`, hi = tf32(x) and
// lo = tf32(x - hi) of every operand: lo hi + hi lo + hi hi).  TF32 itself
// stays off (`allow_tf32` False): one TF32 product misses the f32
// gradient tolerance by orders of magnitude, three fit it.  The scores
// are not such a product: at the x30 logits (scores near 900) three TF32
// products move a score by about 1e-4, P no longer matches the forward's
// log-sum-exp, and dV misses the tolerance.  So every f32 kernel computes
// its scores with one function, `score_chain` (q * scale rounded to f32,
// then one fmaf per head-dim element in ascending order, as
// `ref.py::scores_ref` does), on the CUDA cores, each backward lane at the
// positions its accumulator fragments own; the backward's scores are the
// forward's bit for bit.  tests/test_torch_flash_attention.py models this
// arithmetic against the reference.  What bounds the f32 backward: the
// score chain (2 D operations a visible pair, at 67 TFLOP/s) and the
// products (three times 4 D or 6 D, at 495 TFLOP/s) can run at once, so
// the chain's FMAs set the least time.  The TPU grid's sequential axis
// becomes an in-block loop.  Ragged Sq / Skv edges are masked (loads read
// 0, stores skipped) where the Pallas wrapper halves its blocks until they
// divide S.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "f32_tiles.cuh"   // score_chain, the f32 forward; mma_tiles.cuh

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

// ------------------------------------------------------------ forward, f32
// Grid (B*Hq, ceil(Sq / kFwdBQ)); see attention_fwd_f32 in f32_tiles.cuh.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ out32, float* __restrict__ lse,
                     int Sq, int Skv, int group, float scale, int causal,
                     int async_copy) {
  extern __shared__ __align__(16) float smf[];
  attention_fwd_f32<float, D>(smf, q, k, v, out, out32, lse, Sq, Skv, group,
                              scale, causal, async_copy);
}

// ------------------------------------------------ f32 backward: TF32 x 3
// The products run on the tensor cores as `mma.sync.m16n8k8` with TF32
// operands and f32 accumulators, each as three products (lo hi, hi lo,
// hi hi) of the operands' terms hi = tf32(x) and lo = tf32(x - hi), which
// keep about 21 bits of each operand; the scores stay on the CUDA cores,
// computed by `score_chain` as the forward computes them.  Each warp owns
// 16 rows of the block's tile, the M of every product.  In TF32 an
// accumulator fragment is not the next product's A fragment as it is in
// bf16 (lane (g, t) holds columns 2t, 2t + 1 of rows g, g + 8; an A
// fragment columns t, t + 4): the second product instead takes its k
// index in the order k = t <-> 2t, k = t + 4 <-> 2t + 1, in its A fragment
// (straight from the accumulator's registers) and in its B fragment (read
// from shared memory at those rows), which sums the same 8 terms.  So P,
// dS, P^T and dS^T never leave registers, at no cost.
constexpr int kTfBQ = 64;      // dQ: query rows a block holds (16 a warp)
constexpr int kTfBK = 64;      // dQ: keys a K/V tile holds
constexpr int kTfKB = 64;      // dK/dV: keys a block owns (16 a warp)
constexpr int kTfQS = 64;      // dK/dV: queries a step takes

// x rounded to nearest, ties away from zero, to 10 mantissa bits, as
// `cvt.rna.tf32.f32` rounds a finite x, by two integer ops on its bits
// (half an ulp added to the magnitude, the low 13 bits cleared), which on
// the card ran faster than the `cvt`.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as two TF32 terms: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c (16x8 f32) += a (16x8 TF32, row-major fragment) * b (8x8 TF32).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b as three TF32 products, the small terms first.
__device__ __forceinline__ void mma_tf32x3(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// The A fragment's terms of rows r, r + 8 and columns c, c + 4 of a
// row-major f32 tile (`p` at (r, c), row stride SF).
template <int SF>
__device__ __forceinline__ void frag_a_tf32(const float* p, uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * SF], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * SF + 4], hi[3], lo[3]);
}

// The A fragment's terms of an accumulator fragment pair taken in the
// permuted k order: k = t is column 2t (c[0], c[2] for rows g, g + 8),
// k = t + 4 column 2t + 1 (c[1], c[3]).
__device__ __forceinline__ void acc_to_a_tf32(const float (&c)[4],
                                              uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// The terms of the B fragment (k x n = 8 x 8) b0 = p[0], b1 = p[off1]:
// `p` at row n = g, column k = t of a tile whose rows are n (off1 = 4), or
// at row k = 2t, column n = g of a tile whose rows are k in the permuted
// order (off1 = one row).
__device__ __forceinline__ void frag_b_tf32(const float* p, int off1,
                                            uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[off1], hi[1], lo[1]);
}

// ------------------------------------------------------- f32 backward: dQ
template <int D>
constexpr size_t dq_tf32_smem_bytes() {
  // q * scale, dO (kTfBQ rows) | K, V (2 buffers of kTfBK rows each) |
  // lse, Drow (kTfBQ each)
  return sizeof(float) * ((2 * kTfBQ + 4 * kTfBK) * (D + 4) + 2 * kTfBQ);
}

// Grid (B*Hq, ceil(Sq / kTfBQ)), query tile gridDim.y - 1 - blockIdx.y (the
// causal tiles with the most keys start first); warp w owns query rows
// q0 + 16 w .. q0 + 16 w + 15, lane (g, t) rows g and g + 8 of them.  Per
// K/V tile of 64 keys: s by `score_chain` at the lane's accumulator
// positions (keys 8 j + 2 t, 8 j + 2 t + 1), dP = dO V^T, P = exp(s - lse)
// under the forward's mask, dS = P (dP - Drow), dQ += dS K; after the last
// tile dQ x scale.  With s = (q * scale) . k that is
// dQ = scale * sum_j dS_ij k_j, over the K/V tiles in ascending order.
// Drow_i = sum_d dO_id O_id by one thread a row in ascending d with fmaf
// (the dK/dV kernel's input, written to `drow`).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ out32,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ drow,
                     float* __restrict__ dq, int Sq, int Skv, int group,
                     float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int SF = f32_stride<D>();
  constexpr int NT = kTfBK / 8;                   // score n-tiles (keys)
  constexpr int DT = D / 8;                       // dQ n-tiles
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;
  float* dOs = Qs + kTfBQ * SF;
  float* Ks = dOs + kTfBQ * SF;                   // 2 buffers
  float* Vs = Ks + 2 * kTfBK * SF;                // 2 buffers
  float* lse_s = Vs + 2 * kTfBK * SF;
  float* d_s = lse_s + kTfBQ;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wr = warp * 16 + g;                   // this lane's rows wr, wr + 8
  const int row_q = blockIdx.x;
  const int row_kv = row_q / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTfBQ;
  const size_t qoff = (size_t)row_q * Sq * D;
  const float* kp = k + (size_t)row_kv * Skv * D;
  const float* vp = v + (size_t)row_kv * Skv * D;
  const int k_end = causal ? min(Skv, min(q0 + kTfBQ, Sq)) : Skv;
  const int n_kt = (k_end + kTfBK - 1) / kTfBK;

  stage_f32_async<kTfBQ, D>(Qs, q + qoff, q0, Sq);
  stage_f32_async<kTfBQ, D>(dOs, dout + qoff, q0, Sq);
  stage_f32_async<kTfBK, D>(Ks, kp, 0, Skv);
  stage_f32_async<kTfBK, D>(Vs, vp, 0, Skv);
  cp_async_commit();

  // The row terms, from device memory while the copies run.  Rows past Sq
  // keep 0 (their dO is 0, so their dS is 0, and they are not stored).
  if (threadIdx.x < kTfBQ) {
    const int qi = q0 + threadIdx.x;
    float acc = 0.f, l = 0.f;
    if (qi < Sq) {
      const float4* gr =
          reinterpret_cast<const float4*>(dout + qoff + (size_t)qi * D);
      const float4* orow =
          reinterpret_cast<const float4*>(out32 + qoff + (size_t)qi * D);
#pragma unroll 4
      for (int c = 0; c < D / 4; ++c) {
        const float4 a = gr[c], o = orow[c];
        acc = fmaf(a.x, o.x, acc);
        acc = fmaf(a.y, o.y, acc);
        acc = fmaf(a.z, o.z, acc);
        acc = fmaf(a.w, o.w, acc);
      }
      drow[(size_t)row_q * Sq + qi] = acc;
      l = lse[(size_t)row_q * Sq + qi];
    }
    d_s[threadIdx.x] = acc;
    lse_s[threadIdx.x] = l;
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float lse_r[2], d_r[2];

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kTfBK;
    const float* Kt = Ks + (t & 1) * kTfBK * SF;
    const float* Vt = Vs + (t & 1) * kTfBK * SF;
    if (t + 1 < n_kt) {                           // prefetch the next tile
      const int nb = ((t + 1) & 1) * kTfBK * SF;
      stage_f32_async<kTfBK, D>(Ks + nb, kp, k0 + kTfBK, Skv);
      stage_f32_async<kTfBK, D>(Vs + nb, vp, k0 + kTfBK, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      scale_tile<kTfBQ, D>(Qs, scale);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse_r[i] = lse_s[wr + 8 * i];
        d_r[i] = d_s[wr + 8 * i];
      }
    }

    // s at the lane's accumulator positions: s[i][2 j + c] is row
    // wr + 8 i, key k0 + 8 j + 2 t + c.
    float s[2][2 * NT];
    score_chain<D, 4>(
        s, [&](int i) { return Qs + (wr + 8 * i) * SF; },
        [&](int j) { return Kt + (8 * (j >> 1) + 2 * t4 + (j & 1)) * SF; });

    // dP = dO V^T, 16 rows x 64 keys a warp.
    float dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < D / 8; ++ks) {
      uint32_t ah[4], al[4];
      frag_a_tf32<SF>(dOs + wr * SF + ks * 8 + t4, ah, al);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh[2], bl[2];
        frag_b_tf32(Vt + (8 * j + g) * SF + ks * 8 + t4, 4, bh, bl);
        mma_tf32x3(dp[j], ah, al, bh, bl);
      }
    }

    // dS = P (dP - Drow), P = exp(s - lse), 0 where the forward masked
    // (only tiles that cross the diagonal or the edge); into dp.
    const bool edge = k0 + kTfBK > Skv || (causal && k0 + kTfBK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
        const int qi = q0 + wr + 8 * i;
        const bool ok = !edge || (kj < Skv && (!causal || kj <= qi));
        const float p = ok ? expf(s[i][2 * j + (e & 1)] - lse_r[i]) : 0.f;
        dp[j][e] = p * (dp[j][e] - d_r[i]);
      }

    // dQ += dS K: dS's A fragments from dp in the permuted k order, K's B
    // fragments from rows k0 + 8 kk + 2 t and + 1.
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ah[4], al[4];
      acc_to_a_tf32(dp[kk], ah, al);
      const float* kb = Kt + (8 * kk + 2 * t4) * SF + g;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        uint32_t bh[2], bl[2];
        frag_b_tf32(kb + 8 * n, SF, bh, bl);
        mma_tf32x3(acc[n], ah, al, bh, bl);
      }
    }
    __syncthreads();                              // this buffer consumed
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + wr + 8 * i;
    if (qi >= Sq) continue;
    float* dst = dq + qoff + (size_t)qi * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

// ---------------------------------------------------- f32 backward: dK/dV
template <int D>
constexpr size_t dkdv_tf32_smem_bytes() {
  // K, V (kTfKB rows) | q * scale, dO (2 buffers of kTfQS rows each) |
  // lse, Drow (2 buffers of kTfQS each)
  return sizeof(float) * ((2 * kTfKB + 4 * kTfQS) * (D + 4) + 4 * kTfQS);
}

// Grid (B*Hq, ceil(Skv / kTfKB)); key tile blockIdx.y, so the causal tiles
// with the most queries start first.  Warp w owns keys k0 + 16 w ..
// k0 + 16 w + 15, lane (g, t) keys g and g + 8 of them, the M of every
// product.  Steps of 64 queries: each step reads and splits the warp's V
// fragments again, and shorter steps (16 queries, two blocks an SM) were
// slower on the card.  Per step: s^T by `score_chain` (k as its rows:
// the same bits as the forward's q-side chain), dP^T = V dO^T, P^T and
// dS^T = P^T (dP^T - Drow) under the forward's mask, dV += P^T dO and
// dK += dS^T (q * scale).  The block's q-head row contributes
// dV_h = sum_i P_ij dO_i and dK_h = sum_i dS_ij q_i scale over the steps in
// ascending order; with group 1 that is the result, else it goes to the
// f32 partials (dk_part, dv_part, (B*Hq, Skv, D)) that
// `flash_dkdv_reduce_kernel` sums in head order.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkdv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ drow,
                       float* __restrict__ dk_part,
                       float* __restrict__ dv_part, float* __restrict__ dk,
                       float* __restrict__ dv, int Sq, int Skv, int group,
                       float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int SF = f32_stride<D>();
  constexpr int NT = kTfQS / 8;                   // score n-tiles (queries)
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) float smf[];
  float* Ks = smf;
  float* Vs = Ks + kTfKB * SF;
  float* Qs = Vs + kTfKB * SF;                    // 2 buffers
  float* dOs = Qs + 2 * kTfQS * SF;               // 2 buffers
  float* lse_s = dOs + 2 * kTfQS * SF;            // 2 buffers
  float* d_s = lse_s + 2 * kTfQS;                 // 2 buffers

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wr = warp * 16 + g;                   // this lane's keys wr, wr + 8
  const int row_q = blockIdx.x;
  const int row_kv = row_q / group;
  const int k0 = blockIdx.y * kTfKB;
  const size_t kvoff = (size_t)row_kv * Skv * D;
  const float* qp = q + (size_t)row_q * Sq * D;
  const float* dop = dout + (size_t)row_q * Sq * D;
  const float* lp = lse + (size_t)row_q * Sq;
  const float* rp = drow + (size_t)row_q * Sq;
  // Causal: query rows before the block's first key see none of its keys.
  const int q_start = causal ? (k0 / kTfQS) * kTfQS : 0;
  const int n_steps = q_start < Sq ? (Sq - q_start + kTfQS - 1) / kTfQS : 0;

  auto stage_q = [&](int buf, int qs) {
    stage_f32_async<kTfQS, D>(Qs + buf * kTfQS * SF, qp, qs, Sq);
    stage_f32_async<kTfQS, D>(dOs + buf * kTfQS * SF, dop, qs, Sq);
    const int i = threadIdx.x % kTfQS, qi = qs + i;
    if (threadIdx.x < kTfQS)
      cp_async4(smem_addr(lse_s + buf * kTfQS + i), lp + (qi < Sq ? qi : 0),
                qi < Sq);
    else if (threadIdx.x < 2 * kTfQS)
      cp_async4(smem_addr(d_s + buf * kTfQS + i), rp + (qi < Sq ? qi : 0),
                qi < Sq);
  };

  stage_f32_async<kTfKB, D>(Ks, k + kvoff, k0, Skv);
  stage_f32_async<kTfKB, D>(Vs, v + kvoff, k0, Skv);
  if (n_steps > 0) stage_q(0, q_start);
  cp_async_commit();

  float ak[DT][4], av[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[j][e] = av[j][e] = 0.f;

  for (int it = 0; it < n_steps; ++it) {
    const int q0 = q_start + it * kTfQS;
    const int buf = it & 1;
    float* Qt = Qs + buf * kTfQS * SF;
    const float* dOt = dOs + buf * kTfQS * SF;
    const float* lt = lse_s + buf * kTfQS;
    const float* dt = d_s + buf * kTfQS;
    if (it + 1 < n_steps) {
      stage_q(buf ^ 1, q0 + kTfQS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    scale_tile<kTfQS, D>(Qt, scale);
    __syncthreads();

    // s^T at the lane's accumulator positions: s[i][2 j + c] is key
    // k0 + wr + 8 i, query q0 + 8 j + 2 t + c.
    float s[2][2 * NT];
    score_chain<D, 4>(
        s, [&](int i) { return Ks + (wr + 8 * i) * SF; },
        [&](int j) { return Qt + (8 * (j >> 1) + 2 * t4 + (j & 1)) * SF; });

    // dP^T = V dO^T, 16 keys x 64 queries a warp.
    float pd[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pd[j][e] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < D / 8; ++ks) {
      uint32_t ah[4], al[4];
      frag_a_tf32<SF>(Vs + wr * SF + ks * 8 + t4, ah, al);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh[2], bl[2];
        frag_b_tf32(dOt + (8 * j + g) * SF + ks * 8 + t4, 4, bh, bl);
        mma_tf32x3(pd[j], ah, al, bh, bl);
      }
    }

    // P^T = exp(s - lse) under the forward's mask, into the score
    // accumulator layout; dS^T = P^T (dP^T - Drow), into pd.
    float pt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        const int qi = q0 + c;
        const int kj = k0 + wr + 8 * (e >> 1);
        const bool ok = qi < Sq && (!causal || qi >= kj);
        const float p = ok ? expf(s[e >> 1][2 * j + (e & 1)] - lt[c]) : 0.f;
        pt[j][e] = p;
        pd[j][e] = p * (pd[j][e] - dt[c]);
      }

    // dV += P^T dO, then dK += dS^T (q * scale), the A fragments from pt
    // and pd in the permuted k order, the B fragments from query rows
    // q0 + 8 kk + 2 t and + 1.
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ah[4], al[4];
      acc_to_a_tf32(pt[kk], ah, al);
      const float* gb = dOt + (8 * kk + 2 * t4) * SF + g;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        uint32_t bh[2], bl[2];
        frag_b_tf32(gb + 8 * n, SF, bh, bl);
        mma_tf32x3(av[n], ah, al, bh, bl);
      }
      acc_to_a_tf32(pd[kk], ah, al);
      const float* qb = Qt + (8 * kk + 2 * t4) * SF + g;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        uint32_t bh[2], bl[2];
        frag_b_tf32(qb + 8 * n, SF, bh, bl);
        mma_tf32x3(ak[n], ah, al, bh, bl);
      }
    }
    __syncthreads();                              // this buffer consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + wr + 8 * i;
    if (kj >= Skv) continue;
    const size_t base = (group == 1 ? kvoff + (size_t)kj * D
                                    : ((size_t)row_q * Skv + kj) * D) +
                        2 * t4;
    float* kd = group == 1 ? dk : dk_part;
    float* vd = group == 1 ? dv : dv_part;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      *reinterpret_cast<float2*>(kd + base + 8 * n) =
          make_float2(ak[n][2 * i], ak[n][2 * i + 1]);
      *reinterpret_cast<float2*>(vd + base + 8 * n) =
          make_float2(av[n][2 * i], av[n][2 * i + 1]);
    }
  }
}

// ============================================= bf16 on the tensor cores
// The tile helpers and the forward's body are in mma_tiles.cuh.
constexpr int kDkvBK = 64;     // keys a dK/dV block owns (16 a warp)
constexpr int kDkvBQ = 32;     // queries a dK/dV step takes

// ---------------------------------------------------------- forward, bf16
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ out32, float* __restrict__ lse,
                     int Sq, int Skv, int group, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attention_fwd_mma<D>(smem_raw, q, k, v, out, out32, lse, Sq, Skv, group,
                       scale, causal);
}

// --------------------------------------------------------------- dQ, bf16
template <int D>
constexpr size_t dq_mma_smem_bytes() {
  // Q, dO (kMmaBQ rows) | K, V (2 buffers of kMmaBK rows each), bf16 |
  // lse (in log2 units), Drow (kMmaBQ each), f32
  return sizeof(bf16) * (2 * kMmaBQ + 4 * kMmaBK) * (D + 8) +
         sizeof(float) * 2 * kMmaBQ;
}

// Grid (B*Hq, ceil(Sq / kMmaBQ)), the forward's: query tile gridDim.y - 1 -
// blockIdx.y, warp w owns query rows q0 + 16 w .. q0 + 16 w + 15, the M of
// all three products.  Per K/V tile: S = Q K^T and dP = dO V^T (16 rows x
// 64 keys a warp, Q's and dO's A fragments read again by `ldmatrix` for
// every tile: kept, they would not fit in registers beside dQ's, S's and
// dP's accumulators), P = exp(S scale - lse) under the forward's mask,
// dS = P (dP - Drow), then dQ += dS K with dS as hi + lo bf16 A fragments
// straight from the accumulators and K read by `ldmatrix.trans`, as V in
// the forward's P V.  After the last tile dQ x scale, rounded once.
// Drow_i = sum_d dO_id O_id is summed by one thread a row in ascending d
// with fmaf, the CUDA-core kernel's order, so the dK/dV kernel gets the
// same bits from either; written to `drow`.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const float* __restrict__ out32,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ drow,
                    bf16* __restrict__ dq, int Sq, int Skv, int group,
                    float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int S = row_stride<D>();
  constexpr int KS = D / 16;
  constexpr int NT = kMmaBK / 8;                  // score n-tiles (keys)
  constexpr int DT = D / 8;                       // dQ n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kMmaBQ * S;
  bf16* Ks = dOs + kMmaBQ * S;                    // 2 buffers
  bf16* Vs = Ks + 2 * kMmaBK * S;                 // 2 buffers
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * kMmaBK * S);
  float* d_s = lse_s + kMmaBQ;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row_q = blockIdx.x;
  const int row_kv = row_q / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;
  const int r0 = q0 + warp * 16 + g;              // this lane's rows r0, r0 + 8
  const size_t qoff = (size_t)row_q * Sq * D;
  const bf16* kp = k + (size_t)row_kv * Skv * D;
  const bf16* vp = v + (size_t)row_kv * Skv * D;
  const int k_end = causal ? min(Skv, min(q0 + kMmaBQ, Sq)) : Skv;
  const int n_kt = (k_end + kMmaBK - 1) / kMmaBK;

  stage_async<kMmaBQ, D>(Qs, q + qoff, q0, Sq);
  stage_async<kMmaBQ, D>(dOs, dout + qoff, q0, Sq);
  stage_async<kMmaBK, D>(Ks, kp, 0, Skv);
  stage_async<kMmaBK, D>(Vs, vp, 0, Skv);
  cp_async_commit();

  // The row terms, from device memory while the copies run: Drow, and lse
  // in log2 units for exp2.  Rows past Sq keep 0 (their dO is 0, so their
  // dS is 0, and they are not stored).
  if (threadIdx.x < kMmaBQ) {
    const int qi = q0 + threadIdx.x;
    float acc = 0.f, l2 = 0.f;
    if (qi < Sq) {
      const uint4* gr = reinterpret_cast<const uint4*>(dout + qoff +
                                                       (size_t)qi * D);
      const float4* orow = reinterpret_cast<const float4*>(out32 + qoff +
                                                           (size_t)qi * D);
      // 8 bf16 of dO a 16-byte load, each widened exactly (its bits are
      // the top half of the f32's), element 0 in the low half of word 0.
#pragma unroll 4
      for (int c = 0; c < D / 8; ++c) {
        const uint4 gv = gr[c];
        const float4 oa = orow[2 * c], ob = orow[2 * c + 1];
        acc = fmaf(__uint_as_float(gv.x << 16), oa.x, acc);
        acc = fmaf(__uint_as_float(gv.x & 0xffff0000u), oa.y, acc);
        acc = fmaf(__uint_as_float(gv.y << 16), oa.z, acc);
        acc = fmaf(__uint_as_float(gv.y & 0xffff0000u), oa.w, acc);
        acc = fmaf(__uint_as_float(gv.z << 16), ob.x, acc);
        acc = fmaf(__uint_as_float(gv.z & 0xffff0000u), ob.y, acc);
        acc = fmaf(__uint_as_float(gv.w << 16), ob.z, acc);
        acc = fmaf(__uint_as_float(gv.w & 0xffff0000u), ob.w, acc);
      }
      drow[(size_t)row_q * Sq + qi] = acc;
      l2 = lse[(size_t)row_q * Sq + qi] * kLog2e;
    }
    d_s[threadIdx.x] = acc;
    lse_s[threadIdx.x] = l2;
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float lse_r[2], d_r[2];
  const float sl2 = scale * kLog2e;

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kMmaBK;
    const bf16* Kt = Ks + (t & 1) * kMmaBK * S;
    const bf16* Vt = Vs + (t & 1) * kMmaBK * S;
    if (t + 1 < n_kt) {                           // prefetch the next tile
      const int nb = ((t + 1) & 1) * kMmaBK * S;
      stage_async<kMmaBK, D>(Ks + nb, kp, k0 + kMmaBK, Skv);
      stage_async<kMmaBK, D>(Vs + nb, vp, k0 + kMmaBK, Skv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lse_r[i] = lse_s[warp * 16 + g + 8 * i];
        d_r[i] = d_s[warp * 16 + g + 8 * i];
      }
    }

    // S = Q K^T and dP = dO V^T, 16 rows x 64 keys a warp.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], ga[4];
      ldsm_x4(qa, frag_a_addr<S>(Qs, warp * 16, ks * 16, lane));
      ldsm_x4(ga, frag_a_addr<S>(dOs, warp * 16, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, frag_b_addr<S>(Kt, np * 16, ks * 16, lane));
        mma_bf16(s[2 * np], qa, b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
        ldsm_x4(b, frag_b_addr<S>(Vt, np * 16, ks * 16, lane));
        mma_bf16(dp[2 * np], ga, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], ga, b[2], b[3]);
      }
    }
    // dS = P (dP - Drow), P = exp2(S scale log2(e) - lse log2(e)), 0 where
    // the forward masked (only tiles that cross the diagonal or the edge).
    const bool edge = k0 + kMmaBK > Skv || (causal && k0 + kMmaBK - 1 > q0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + j * 8 + 2 * t4 + (e & 1);
        const int qi = r0 + (e >> 1) * 8;
        const bool ok = !edge || (kj < Skv && (!causal || kj <= qi));
        const float p =
            ok ? exp2f(fmaf(s[j][e], sl2, -lse_r[e >> 1])) : 0.f;
        s[j][e] = p * (dp[j][e] - d_r[e >> 1]);
      }

    // dQ += dS K, dS as hi + lo bf16 A fragments.
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      acc_to_a_split(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, frag_a_addr<S>(Kt, kk * 16, np * 16, lane));
        mma_bf16(acc[2 * np], hi, b[0], b[1]);
        mma_bf16(acc[2 * np], lo, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
        mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();                              // this buffer consumed
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = r0 + i * 8;
    if (qi >= Sq) continue;
    const size_t base = qoff + (size_t)qi * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * i] * scale,
                                acc[j][2 * i + 1] * scale);
  }
}

// ------------------------------------------------------------ dK/dV, bf16
template <int D>
constexpr size_t dkdv_mma_smem_bytes() {
  // K, V (kDkvBK rows) | Q, dO (2 buffers of kDkvBQ rows each), bf16 |
  // lse, Drow (2 buffers of kDkvBQ), f32
  return sizeof(bf16) * (2 * kDkvBK + 4 * kDkvBQ) * (D + 8) +
         sizeof(float) * 4 * kDkvBQ;
}

// Grid (B*Hq, ceil(Skv / kDkvBK)); key tile blockIdx.y, so the causal tiles
// with the most queries start first.  Warp w owns keys k0 + 16 w ..
// k0 + 16 w + 15, the M of all four products: S^T = K Q^T and
// dP^T = V dO^T (16 keys x 32 queries), then dV += P^T dO and
// dK += dS^T Q (16 keys x D).  The block's q-head row contributes
// dV_h = sum_i P_ij dO_i and dK_h = scale * sum_i dS_ij q_i over the q
// tiles in ascending order; with group 1 that is the result (rounded to
// bf16 into dk, dv), else it goes to the f32 partials (dk_part, dv_part,
// (B*Hq, Skv, D)) that `flash_dkdv_reduce_kernel` sums.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ drow,
                      float* __restrict__ dk_part,
                      float* __restrict__ dv_part, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Sq, int Skv, int group,
                      float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int S = row_stride<D>();
  constexpr int KS = D / 16;
  constexpr int NT = kDkvBQ / 8;                  // score n-tiles (queries)
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kDkvBK * S;
  bf16* Qs = Vs + kDkvBK * S;                     // 2 buffers
  bf16* dOs = Qs + 2 * kDkvBQ * S;                // 2 buffers
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kDkvBQ * S);
  float* d_s = lse_s + 2 * kDkvBQ;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row_q = blockIdx.x;
  const int row_kv = row_q / group;
  const int k0 = blockIdx.y * kDkvBK;
  const int kr = k0 + warp * 16 + g;              // this lane's keys kr, kr + 8
  const size_t kvoff = (size_t)row_kv * Skv * D;
  const bf16* qp = q + (size_t)row_q * Sq * D;
  const bf16* dop = dout + (size_t)row_q * Sq * D;
  const float* lp = lse + (size_t)row_q * Sq;
  const float* dp = drow + (size_t)row_q * Sq;
  // Causal: query rows before the block's first key see none of its keys.
  const int q_start = causal ? (k0 / kDkvBQ) * kDkvBQ : 0;
  const int n_steps = q_start < Sq ? (Sq - q_start + kDkvBQ - 1) / kDkvBQ : 0;

  auto stage_q = [&](int buf, int qs) {
    stage_async<kDkvBQ, D>(Qs + buf * kDkvBQ * S, qp, qs, Sq);
    stage_async<kDkvBQ, D>(dOs + buf * kDkvBQ * S, dop, qs, Sq);
    const int i = threadIdx.x % kDkvBQ, qi = qs + i;
    if (threadIdx.x < kDkvBQ)
      cp_async4(smem_addr(lse_s + buf * kDkvBQ + i), lp + (qi < Sq ? qi : 0),
                qi < Sq);
    else if (threadIdx.x < 2 * kDkvBQ)
      cp_async4(smem_addr(d_s + buf * kDkvBQ + i), dp + (qi < Sq ? qi : 0),
                qi < Sq);
  };

  stage_async<kDkvBK, D>(Ks, k + kvoff, k0, Skv);
  stage_async<kDkvBK, D>(Vs, v + kvoff, k0, Skv);
  if (n_steps > 0) stage_q(0, q_start);
  cp_async_commit();

  float ak[DT][4], av[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[j][e] = av[j][e] = 0.f;

  for (int it = 0; it < n_steps; ++it) {
    const int q0 = q_start + it * kDkvBQ;
    const int buf = it & 1;
    const bf16* Qt = Qs + buf * kDkvBQ * S;
    const bf16* dOt = dOs + buf * kDkvBQ * S;
    if (it + 1 < n_steps) {
      stage_q(buf ^ 1, q0 + kDkvBQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries a warp.
    float s[NT][4], pd[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = pd[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, frag_a_addr<S>(Ks, warp * 16, ks * 16, lane));
      ldsm_x4(va, frag_a_addr<S>(Vs, warp * 16, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, frag_b_addr<S>(Qt, np * 16, ks * 16, lane));
        mma_bf16(s[2 * np], ka, b[0], b[1]);
        mma_bf16(s[2 * np + 1], ka, b[2], b[3]);
        ldsm_x4(b, frag_b_addr<S>(dOt, np * 16, ks * 16, lane));
        mma_bf16(pd[2 * np], va, b[0], b[1]);
        mma_bf16(pd[2 * np + 1], va, b[2], b[3]);
      }
    }
    // P^T = exp(s scale - lse) under the forward's mask; dS^T = P^T (dP^T -
    // Drow).
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1);
        const int qi = q0 + c;
        const int kj = kr + (e >> 1) * 8;
        const bool ok = qi < Sq && (!causal || qi >= kj);
        const float p =
            ok ? expf(fmaf(s[j][e], scale, -lse_s[buf * kDkvBQ + c])) : 0.f;
        s[j][e] = p;
        pd[j][e] = p * (pd[j][e] - d_s[buf * kDkvBQ + c]);
      }

    // dV += P^T dO, then dK += dS^T Q, each A as hi + lo (one pair live at
    // a time: the accumulators hold 4 D registers a lane).
#pragma unroll
    for (int kk = 0; kk < kDkvBQ / 16; ++kk) {
      uint32_t hi[4], lo[4];
      acc_to_a_split(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, frag_a_addr<S>(dOt, kk * 16, np * 16, lane));
        mma_bf16(av[2 * np], hi, b[0], b[1]);
        mma_bf16(av[2 * np], lo, b[0], b[1]);
        mma_bf16(av[2 * np + 1], hi, b[2], b[3]);
        mma_bf16(av[2 * np + 1], lo, b[2], b[3]);
      }
      acc_to_a_split(pd[2 * kk], pd[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, frag_a_addr<S>(Qt, kk * 16, np * 16, lane));
        mma_bf16(ak[2 * np], hi, b[0], b[1]);
        mma_bf16(ak[2 * np], lo, b[0], b[1]);
        mma_bf16(ak[2 * np + 1], hi, b[2], b[3]);
        mma_bf16(ak[2 * np + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();                              // this buffer consumed
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = kr + i * 8;
    if (kj >= Skv) continue;
    const size_t col = 2 * t4;
    if (group == 1) {
      const size_t base = kvoff + (size_t)kj * D + col;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + j * 8) =
            __floats2bfloat162_rn(ak[j][2 * i] * scale,
                                  ak[j][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + j * 8) =
            __floats2bfloat162_rn(av[j][2 * i], av[j][2 * i + 1]);
      }
    } else {
      const size_t base = ((size_t)row_q * Skv + kj) * D + col;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        *reinterpret_cast<float2*>(dk_part + base + j * 8) =
            make_float2(ak[j][2 * i] * scale, ak[j][2 * i + 1] * scale);
        *reinterpret_cast<float2*>(dv_part + base + j * 8) =
            make_float2(av[j][2 * i], av[j][2 * i + 1]);
      }
    }
  }
}

// dk[r] = the sum over h = 0 .. group-1 of dk_part[r * group + h], the
// heads in ascending order, rounded once to T (bf16 or f32), and the same
// for dv: 4 elements a thread.
template <typename T>
__global__ void __launch_bounds__(256)
flash_dkdv_reduce_kernel(const float* __restrict__ dk_part,
                         const float* __restrict__ dv_part,
                         T* __restrict__ dk, T* __restrict__ dv, int rows_kv,
                         int row_elems, int group) {
  const size_t n4 = (size_t)rows_kv * row_elems / 4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = 4 * i;
    const size_t r = e / row_elems, off = e % row_elems;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int h = 0; h < group; ++h) {
      const size_t src = (r * group + h) * row_elems + off;
      const float4 a = *reinterpret_cast<const float4*>(dk_part + src);
      const float4 b = *reinterpret_cast<const float4*>(dv_part + src);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += b.x; sv.y += b.y; sv.z += b.z; sv.w += b.w;
    }
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(dk + e) = sk;
      *reinterpret_cast<float4*>(dv + e) = sv;
    } else {
      __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + e);
      __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + e);
      k2[0] = __floats2bfloat162_rn(sk.x, sk.y);
      k2[1] = __floats2bfloat162_rn(sk.z, sk.w);
      v2[0] = __floats2bfloat162_rn(sv.x, sv.y);
      v2[1] = __floats2bfloat162_rn(sv.z, sv.w);
    }
  }
}

// ---------------------------------------------------------------- launchers
// Above 48 KB of dynamic shared memory needs the opt-in, which is kept per
// device: set it on every launch (a host-side attribute write).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  float* out32;
  const void* dout;
  void* o0;
  void* o1;
  void* o2;
  float* lse;
  float* drow;
  float* part;      // dK/dV, group > 1: the per-head f32 partials
  int bh, sq, skv, group, causal;
  float scale;
  cudaStream_t stream;
};

enum Which { kFwd = 0, kDq = 1, kDkdv = 2 };

// The tensor-core kernels' grids put the tile index in y.
constexpr int kMaxGridY = 65535;

template <int D>
cudaError_t launch_fwd_mma(const Args& a) {
  constexpr size_t smem = fwd_mma_smem_bytes<D>();
  const int n_qt = (a.sq + kMmaBQ - 1) / kMmaBQ;
  if (n_qt > kMaxGridY) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_mma_kernel<D><<<dim3(a.bh, n_qt), kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o0), a.out32, a.lse,
      a.sq, a.skv, a.group, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_mma(const Args& a) {
  constexpr size_t smem = dq_mma_smem_bytes<D>();
  const int n_qt = (a.sq + kMmaBQ - 1) / kMmaBQ;
  if (n_qt > kMaxGridY) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_dq_mma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_dq_mma_kernel<D><<<dim3(a.bh, n_qt), kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.out32,
      static_cast<const bf16*>(a.dout), a.lse, a.drow,
      static_cast<bf16*>(a.o0), a.sq, a.skv, a.group, a.scale, a.causal);
  return cudaGetLastError();
}

// The f32 forward (f32_tiles.cuh's body): q, k and v staged by cp.async
// when all three start on a 16-byte boundary, else by plain loads.
template <int D>
cudaError_t launch_fwd_f32(const Args& a) {
  constexpr size_t smem = fwd_f32_smem_bytes<D>();
  const int n_qt = (a.sq + kFwdBQ - 1) / kFwdBQ;
  if (n_qt > kMaxGridY) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int aligned = ((reinterpret_cast<uintptr_t>(a.q) |
                        reinterpret_cast<uintptr_t>(a.k) |
                        reinterpret_cast<uintptr_t>(a.v)) % 16) == 0;
  flash_fwd_f32_kernel<D><<<dim3(a.bh, n_qt), kFwdThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o0), a.out32,
      a.lse, a.sq, a.skv, a.group, a.scale, a.causal, aligned);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tf32(const Args& a) {
  constexpr size_t smem = dq_tf32_smem_bytes<D>();
  const int n_qt = (a.sq + kTfBQ - 1) / kTfBQ;
  if (n_qt > kMaxGridY) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_dq_tf32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_dq_tf32_kernel<D><<<dim3(a.bh, n_qt), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.out32,
      static_cast<const float*>(a.dout), a.lse, a.drow,
      static_cast<float*>(a.o0), a.sq, a.skv, a.group, a.scale, a.causal);
  return cudaGetLastError();
}

// The dK/dV kernel of the dtype (bf16: tensor-core bf16; f32: TF32 x 3),
// then (group > 1) the reduction of its per-head partials.
template <typename T, int D>
cudaError_t launch_dkdv(const Args& a) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int kb = kBf16 ? kDkvBK : kTfKB;
  constexpr size_t smem =
      kBf16 ? dkdv_mma_smem_bytes<D>() : dkdv_tf32_smem_bytes<D>();
  const int n_kt = (a.skv + kb - 1) / kb;
  if (n_kt > kMaxGridY || (a.group > 1 && a.part == nullptr))
    return cudaErrorInvalidValue;
  float* dk_part = a.part;
  float* dv_part = a.part == nullptr ? nullptr
                                     : a.part + (size_t)a.bh * a.skv * D;
  T* dk = static_cast<T*>(a.o1);
  T* dv = static_cast<T*>(a.o2);
  const dim3 grid(a.bh, n_kt);
  cudaError_t err;
  if constexpr (kBf16) {
    err = allow_smem(flash_dkdv_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_dkdv_mma_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        a.lse, a.drow, dk_part, dv_part, dk, dv, a.sq, a.skv, a.group,
        a.scale, a.causal);
  } else {
    err = allow_smem(flash_dkdv_tf32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    flash_dkdv_tf32_kernel<D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        a.lse, a.drow, dk_part, dv_part, dk, dv, a.sq, a.skv, a.group,
        a.scale, a.causal);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || a.group == 1) return err;
  const int rows_kv = a.bh / a.group;
  const size_t n4 = (size_t)rows_kv * a.skv * D / 4;
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  flash_dkdv_reduce_kernel<T><<<blocks, 256, 0, a.stream>>>(
      dk_part, dv_part, dk, dv, rows_kv, a.skv * D, a.group);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(int which, const Args& a) {
  if (which == kDkdv) return launch_dkdv<T, D>(a);
  if constexpr (std::is_same<T, bf16>::value) {
    if (which == kFwd) return launch_fwd_mma<D>(a);
    return launch_dq_mma<D>(a);
  } else {
    if (which == kFwd) return launch_fwd_f32<D>(a);
    return launch_dq_tf32<D>(a);
  }
}

template <typename T>
cudaError_t dispatch_head_dim(int which, int d, const Args& a) {
  switch (d) {
    case 16: return launch<T, 16>(which, a);
    case 32: return launch<T, 32>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 128: return launch<T, 128>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int which, int d, int dtype, const Args& a) {
  if (a.bh < 1 || a.sq < 1 || a.skv < 1 || a.group < 1 || a.bh % a.group)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return dispatch_head_dim<float>(which, d, a);
    case kBF16: return dispatch_head_dim<bf16>(which, d, a);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
long long smem_bytes(int which, int dtype) {
  if (dtype == kBF16 && which == kFwd) return fwd_mma_smem_bytes<D>();
  if (dtype == kBF16 && which == kDq) return dq_mma_smem_bytes<D>();
  if (dtype == kBF16 && which == kDkdv) return dkdv_mma_smem_bytes<D>();
  if (which == kFwd) return fwd_f32_smem_bytes<D>();
  if (which == kDkdv) return dkdv_tf32_smem_bytes<D>();
  return dq_tf32_smem_bytes<D>();
}

}  // namespace

extern "C" {

// q (bh, Sq, D), k/v (bh / group, Skv, D), out (bh, Sq, D), all contiguous
// and of one dtype (0 f32, 1 bf16; bf16 pointers, and for the backward
// every input and out32, 16-byte aligned); lse
// (bh, Sq) f32.  `out32`, when not NULL, receives the output in f32 before
// its rounding to `out`'s dtype: the backward's row term rowsum(dO * O)
// takes O unrounded, as autograd through the plain version does.  Each
// entry point returns the CUDA error of its launches (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, float* out32, float* lse, int bh, int sq,
                        int skv, int d, int group, float scale, int causal,
                        int dtype, void* stream) {
  Args a{q, k, v, out32, nullptr, out, nullptr, nullptr, lse, nullptr,
         nullptr, bh, sq, skv, group, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kFwd, d, dtype, a);
}

// out32 (bh, Sq, D) f32 is the forward's output; dq (bh, Sq, D) in q's
// dtype; drow (bh, Sq) f32, written for the dK/dV kernel, which must run
// after this one on the same stream.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const float* out32, const void* dout,
                           const float* lse, float* drow, void* dq, int bh,
                           int sq, int skv, int d, int group, float scale,
                           int causal, int dtype, void* stream) {
  Args a{q, k, v, const_cast<float*>(out32), dout, dq, nullptr, nullptr,
         const_cast<float*>(lse), drow, nullptr, bh, sq, skv, group, causal,
         scale, static_cast<cudaStream_t>(stream)};
  return dispatch(kDq, d, dtype, a);
}

// dk, dv (bh / group, Skv, D) in k's dtype, from drow of the dQ kernel.
// `part` is scratch of 2 * bh * Skv * D floats for group > 1 (the per-head
// partials of dK, then dV), else unused and may be NULL.
int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* drow, void* dk, void* dv,
                             float* part, int bh, int sq, int skv, int d,
                             int group, float scale, int causal, int dtype,
                             void* stream) {
  Args a{q, k, v, nullptr, dout, nullptr, dk, dv, const_cast<float*>(lse),
         const_cast<float*>(drow), part, bh, sq, skv, group, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kDkdv, d, dtype, a);
}

// Dynamic shared memory, in bytes, of the kernel that `which` (0 forward,
// 1 dQ, 2 dK/dV) launches for head dim d and dtype; -1 if none.
long long flash_attention_smem_bytes(int which, int d, int dtype) {
  if (which < kFwd || which > kDkdv || (dtype != kF32 && dtype != kBF16))
    return -1;
  switch (d) {
    case 16: return smem_bytes<16>(which, dtype);
    case 32: return smem_bytes<32>(which, dtype);
    case 64: return smem_bytes<64>(which, dtype);
    case 128: return smem_bytes<128>(which, dtype);
    default: return -1;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
