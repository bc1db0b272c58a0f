// bf16 attention tiles on Hopper's tensor cores (`mma.sync.m16n8k16`, bf16
// operands, f32 accumulators), shared by K4 (flash_attention.cu) and K1
// (../../prefill/csrc/prefill.cu): the copy, fragment and rounding helpers,
// and the body of the online-softmax forward, which each file wraps in a
// `__global__` kernel of its own name (`flash_fwd_mma_kernel`,
// `prefill_flash_mma_kernel`), so the profiler and the `-Xptxas -v` report
// tell the two apart.  kernels/build.py hashes this header with the sources
// that include it and puts its directory on the include path.
//
// The design (each warp owns 16 rows of the block's tile, the M of every
// product; accumulator fragments reused as the next product's A fragments;
// tiles in shared memory with rows padded by 16 bytes for `ldmatrix`; the
// next K/V tile staged by `cp.async` while this one is used; the scale on
// the f32 scores; P as hi + lo bf16 terms) is explained at the top of
// flash_attention.cu.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps a block
constexpr float kNegInf = -1e30f;
constexpr int kMmaBQ = 64;     // query rows a forward / dQ block holds (16 a warp)
constexpr int kMmaBK = 64;     // keys a forward / dQ K/V tile holds
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Row stride, in bf16 elements, of a tile in shared memory: D plus 16
// bytes, so the 8 rows an `ldmatrix` reads fall in distinct bank groups.
template <int D>
__device__ __forceinline__ constexpr int row_stride() { return D + 8; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; 0 bytes read (zero fill) when
// !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row-major fragment) * b (16x8 bf16).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as one bf16 pair, x0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return bits(__floats2bfloat162_rn(x0, x1));
}

// (x0, x1) as two bf16 pairs whose sum keeps 16 bits of each:
// hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// An accumulator fragment pair (n-tiles j and j + 1 of 8 columns, 16 rows)
// is, element for element, the A fragment of 16 rows x 16 k of the next
// product: here as its hi and lo bf16 terms.
__device__ __forceinline__ void acc_to_a_split(const float (&c0)[4],
                                               const float (&c1)[4],
                                               uint32_t (&hi)[4],
                                               uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// Address of lane `lane`'s row for an x4 `ldmatrix` of a 16x16 block at
// (r0, c0) of a tile of row stride S: the A fragment (rows r0..r0+15 and
// columns c0..c0+15 in the order m16n8k16 takes them), and, with `.trans`,
// the B fragments of two n-tiles of 8 columns from a K x N tile.
template <int S>
__device__ __forceinline__ uint32_t frag_a_addr(const bf16* tile, int r0,
                                                int c0, int lane) {
  return smem_addr(tile + (r0 + (lane % 16)) * S + c0 + (lane / 16) * 8);
}

// Address for the B fragments of two n-tiles (rows n0..n0+15 of an N x K
// tile, k columns c0..c0+15): registers 0, 1 for n-tile n0, 2, 3 for n0+8.
template <int S>
__device__ __forceinline__ uint32_t frag_b_addr(const bf16* tile, int n0,
                                                int c0, int lane) {
  return smem_addr(tile + (n0 + (lane % 8) + (lane / 16) * 8) * S + c0 +
                   ((lane / 8) % 2) * 8);
}

// Stage rows [r0, r0 + ROWS) of a (rows, D) bf16 matrix into a shared tile
// of row stride D + 8 with cp.async; rows at or past `valid` read 0.
template <int ROWS, int D>
__device__ __forceinline__ void stage_async(bf16* dst, const bf16* src,
                                            int r0, int valid) {
  constexpr int kChunks = D / 8;                  // 16-byte chunks a row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = r0 + r < valid;
    cp_async16(smem_addr(dst + r * row_stride<D>() + col),
               src + (size_t)(ok ? r0 + r : 0) * D + col, ok);
  }
}

// ------------------------------------------------------------- forward
template <int D>
constexpr size_t fwd_mma_smem_bytes() {
  // Q (kMmaBQ rows) | K, V (2 buffers of kMmaBK rows each), bf16
  return sizeof(bf16) * (kMmaBQ + 4 * kMmaBK) * (D + 8);
}

// The forward's body, for a grid (B*Hq, ceil(Sq / kMmaBQ)) of kThreads
// threads with fwd_mma_smem_bytes<D>() of dynamic shared memory at `smem`.
// Query tile gridDim.y - 1 - blockIdx.y, so the causal tiles with the most
// keys start first.  Warp w owns query rows q0 + 16 w .. q0 + 16 w + 15;
// lane (g = lane / 4, t = lane % 4) holds rows g and g + 8 of them, columns
// 2 t, 2 t + 1 of every 8-column n-tile.  `out32` (the output in f32
// before its rounding) and `lse` (each row's log-sum-exp) are written when
// not NULL.
template <int D>
__device__ __forceinline__ void attention_fwd_mma(
    unsigned char* smem, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ out32,
    float* __restrict__ lse, int Sq, int Skv, int group, float scale,
    int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int S = row_stride<D>();
  constexpr int KS = D / 16;                      // k-steps over the head dim
  constexpr int NT = kMmaBK / 8;                  // score n-tiles
  constexpr int DT = D / 8;                       // output n-tiles
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kMmaBQ * S;
  bf16* Vs = Ks + 2 * kMmaBK * S;

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row_q = blockIdx.x;                   // b * Hq + h
  const int row_kv = row_q / group;               // b * Hkv + h / group
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;
  const int r0 = q0 + warp * 16 + g;              // this lane's rows r0, r0 + 8
  const bf16* kp = k + (size_t)row_kv * Skv * D;
  const bf16* vp = v + (size_t)row_kv * Skv * D;
  // Causal: no key past the tile's last valid query row is visible.
  const int k_end = causal ? min(Skv, min(q0 + kMmaBQ, Sq)) : Skv;
  const int n_kt = (k_end + kMmaBK - 1) / kMmaBK;

  stage_async<kMmaBQ, D>(Qs, q + (size_t)row_q * Sq * D, q0, Sq);
  stage_async<kMmaBK, D>(Ks, kp, 0, Skv);
  stage_async<kMmaBK, D>(Vs, vp, 0, Skv);
  cp_async_commit();

  uint32_t qf[KS][4];
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};                // row max, raw score units
  float l[2] = {0.f, 0.f};                        // this lane's row sum shares
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
      for (int ks = 0; ks < KS; ++ks)
        ldsm_x4(qf[ks], frag_a_addr<S>(Qs, warp * 16, ks * 16, lane));
    }

    // S = Q K^T (raw, unscaled), 16 rows x 64 keys a warp.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, frag_b_addr<S>(Kt, np * 16, ks * 16, lane));
        mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
      }
    }
    if (k0 + kMmaBK > Skv || (causal && k0 + kMmaBK - 1 > q0)) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qi = r0 + (e >> 1) * 8;
          if (kj >= Skv || (causal && kj > qi)) s[j][e] = kNegInf;
        }
    }

    // Online softmax in registers; a row's 4 lanes share its max by
    // shuffles, and keep their own shares of its sum until the end.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f((m[i] - mx[i]) * sl2);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[j][e] - m[e >> 1]) * sl2);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V, P as hi + lo bf16 A fragments straight from the scores.
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      acc_to_a_split(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, frag_a_addr<S>(Vt, kk * 16, dp * 16, lane));
        mma_bf16(o[2 * dp], ph, b[0], b[1]);
        mma_bf16(o[2 * dp], pl, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], ph, b[2], b[3]);
        mma_bf16(o[2 * dp + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();                              // this buffer consumed
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    const int qi = r0 + i * 8;
    if (qi >= Sq) continue;
    const size_t base = ((size_t)row_q * Sq + qi) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const float o0 = o[j][2 * i] / l[i], o1 = o[j][2 * i + 1] / l[i];
      *reinterpret_cast<__nv_bfloat162*>(out + base + j * 8) =
          __floats2bfloat162_rn(o0, o1);
      if (out32 != nullptr)
        *reinterpret_cast<float2*>(out32 + base + j * 8) = make_float2(o0, o1);
    }
    if (lse != nullptr && t4 == 0)
      lse[(size_t)row_q * Sq + qi] = m[i] * scale + logf(l[i]);
  }
}

}  // namespace
