// Flash attention for Hopper (sm_90a): the forward (K4) and its backward.
// Built by kernels/build.py into a shared library with a plain C interface
// and bound with ctypes (flash_attention.py).
//
// `flash_attention_fwd` replaces the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py::flash_attention /
// _flash_kernel: online-softmax attention, causal or not, Sq may differ from
// Skv, the causal mask is top-left aligned (query i sees key j iff i >= j,
// both counted from 0), GQA by dividing the q-head row by `group` (K/V are
// never repeated), f32 scores and accumulator, q pre-scaled by 1/sqrt(D) in
// f32, masked scores -1e30 (not -inf), the row sum floored at 1e-30, out in
// q's dtype.  Beside `out` it writes each query row's log-sum-exp (f32,
// (B*Hq, Sq)) for the backward; the TPU kernel keeps its row statistics in
// VMEM only.
//
// The reference has no backward kernel (JAX differentiates its plain path).
// On the card the training path may not fall back to the plain version, so
// the backward is two kernels here:
//   `flash_attention_bwd_dq`   one block per (q-head row, 64-query tile):
//                              D_i = rowsum(dO_i * O_i) (written out for the
//                              second kernel), then dQ over the K/V tiles;
//   `flash_attention_bwd_dkdv` one block per (kv-head row, 32-key tile):
//                              dK and dV over the group's q heads in a fixed
//                              order, and over the q tiles in ascending
//                              order.
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
// This first version does the arithmetic with f32 FMAs out of shared memory
// on the CUDA cores, so its own limit is the CUDA-core FMA rate and the
// shared-memory reads feeding it; it is far from the bound and is meant to
// be right first (the tensor cores are later work).  What the design does
// about it: each K/V tile (forward, dQ) or Q/dO tile (dK/dV) is staged once
// in shared memory and reused by every row of the block; each thread keeps
// its share of the output tile in registers, so running sums never go back
// to device memory; causal loops stop at the diagonal, so the masked half
// is never loaded.  The TPU grid's sequential axis becomes that in-block
// loop.  Ragged Sq / Skv edges are masked (loads read 0, stores skipped)
// where the Pallas wrapper halves its blocks until they divide S.
//
// Row strides of D+1 and tile+1 floats keep shared-memory reads free of
// bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows a forward / dQ block holds
constexpr int kBK = 64;        // keys a forward / dQ K/V tile holds
constexpr int kBKV = 32;       // keys a dK/dV block owns
constexpr int kThreads = 128;  // 16 x 8 threads
constexpr float kNegInf = -1e30f;

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

// Stage rows [r0, r0 + n_rows) of a (rows, D) matrix into shared memory with
// a row stride of D + 1, times `mul`; rows past `valid` read 0.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int n_rows, int valid, float mul) {
  for (int idx = threadIdx.x; idx < n_rows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = r0 + r;
    float val = 0.f;
    if (gr < valid) val = to_f32(src[(size_t)gr * D + c]) * mul;
    dst[r * (D + 1) + c] = val;
  }
}

// ------------------------------------------------------------------ forward
template <int D>
constexpr size_t fwd_smem_bytes() {
  // Q (kBQ x D+1) | K (kBK x D+1) | V (kBK x D) | P (kBQ x kBK+1) | m,l,alpha
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                          kBQ * (kBK + 1) + 3 * kBQ);
}

// Grid (ceil(Sq / kBQ), B*Hq).  Thread t = (tx = t % 16, ty = t / 16) owns
// query rows ty*8 .. ty*8+7 of the tile; for scores it owns key columns
// tx + 16 j (j < 4), for the output columns tx + 16 j (j < D/16).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ out32, float* __restrict__ lse, int Sq,
                 int Skv, int group, float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * (D + 1);
  float* Vs = Ks + kBK * (D + 1);
  float* Ps = Vs + kBK * D;
  float* m_s = Ps + kBQ * (kBK + 1);
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row_q = blockIdx.y;                 // b * Hq + h
  const int row_kv = row_q / group;             // b * Hkv + h / group
  const int q0 = blockIdx.x * kBQ;
  const T* kp = k + (size_t)row_kv * Skv * D;
  const T* vp = v + (size_t)row_kv * Skv * D;

  stage<T, D>(Qs, q + (size_t)row_q * Sq * D, q0, kBQ, Sq, scale);
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // Causal: no key past the tile's last valid query row is visible.
  const int k_end = causal ? min(Skv, min(q0 + kBQ, Sq)) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int kn = min(kBK, Skv - k0);          // valid keys in this tile
    __syncthreads();                            // previous tile consumed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      float kv = 0.f, vv = 0.f;
      if (r < kn) {
        const size_t off = (size_t)(k0 + r) * D + c;
        kv = to_f32(kp[off]);
        vv = to_f32(vp[off]);
      }
      Ks[r * (D + 1) + c] = kv;
      Vs[r * D + c] = vv;
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = Qs[(ty * 8 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = c < kn && (!causal || qi >= k0 + c);
        Ps[r * (kBK + 1) + c] = ok ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: one thread per query row.
    if (tid < kBQ) {
      float* pr = Ps + tid * (kBK + 1);
      const float m_prev = m_s[tid];
      float m_new = m_prev;
      for (int c = 0; c < kBK; ++c) m_new = fmaxf(m_new, pr[c]);
      float sum = 0.f;
      for (int c = 0; c < kBK; ++c) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float alpha = a_s[ty * 8 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    for (int kk = 0; kk < kn; ++kk) {
      float pv[8], vv[DJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = Ps[(ty * 8 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  __syncthreads();                              // l_s, m_s final for every row
  const size_t ooff = (size_t)row_q * Sq * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    const int qi = q0 + r;
    if (qi < Sq) {
      const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const size_t off = ooff + (size_t)qi * D + tx + 16 * j;
        const float o = acc[i][j] / l;
        out[off] = from_f32<T>(o);
        if (out32 != nullptr) out32[off] = o;
      }
    }
  }
  if (tid < kBQ && q0 + tid < Sq)
    lse[(size_t)row_q * Sq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

// ------------------------------------------------------------- backward: dQ
template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V (each 64 x D+1) | dS (kBQ x kBK+1) | lse, Drow
  return sizeof(float) * (2 * kBQ * (D + 1) + 2 * kBK * (D + 1) +
                          kBQ * (kBK + 1) + 2 * kBQ);
}

// Grid (ceil(Sq / kBQ), B*Hq); the thread layout of the forward.  With
// s = (q * scale) . k, P = exp(s - lse), dP = dO . v and
// dS = P * (dP - Drow): dQ = scale * sum_j dS_ij k_j, summed over the K/V
// tiles in ascending order.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ out32,
                const T* __restrict__ dout, const float* __restrict__ lse,
                float* __restrict__ drow, T* __restrict__ dq, int Sq, int Skv,
                int group, float scale, int causal) {
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBQ * (D + 1);
  float* Ks = dOs + kBQ * (D + 1);
  float* Vs = Ks + kBK * (D + 1);
  float* dSs = Vs + kBK * (D + 1);
  float* lse_s = dSs + kBQ * (kBK + 1);
  float* d_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row_q = blockIdx.y;
  const int row_kv = row_q / group;
  const int q0 = blockIdx.x * kBQ;
  const size_t qoff = (size_t)row_q * Sq * D;
  const T* kp = k + (size_t)row_kv * Skv * D;
  const T* vp = v + (size_t)row_kv * Skv * D;

  stage<T, D>(Qs, q + qoff, q0, kBQ, Sq, scale);
  stage<T, D>(dOs, dout + qoff, q0, kBQ, Sq, 1.f);
  stage<float, D>(Ks, out32 + qoff, q0, kBQ, Sq, 1.f);  // O, in K's buffer
  __syncthreads();
  if (tid < kBQ) {
    // Drow_i = sum_d dO_id O_id, in ascending d.
    float acc = 0.f;
    for (int d = 0; d < D; ++d)
      acc = fmaf(dOs[tid * (D + 1) + d], Ks[tid * (D + 1) + d], acc);
    d_s[tid] = acc;
    const int qi = q0 + tid;
    lse_s[tid] = qi < Sq ? lse[(size_t)row_q * Sq + qi] : 0.f;
    if (qi < Sq) drow[(size_t)row_q * Sq + qi] = acc;
  }

  float acc[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int k_end = causal ? min(Skv, min(q0 + kBQ, Sq)) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    const int kn = min(kBK, Skv - k0);
    __syncthreads();                            // O / previous tile consumed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      float kv = 0.f, vv = 0.f;
      if (r < kn) {
        const size_t off = (size_t)(k0 + r) * D + c;
        kv = to_f32(kp[off]);
        vv = to_f32(vp[off]);
      }
      Ks[r * (D + 1) + c] = kv;
      Vs[r * (D + 1) + c] = vv;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[8], gv[8], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        qv[i] = Qs[(ty * 8 + i) * (D + 1) + d];
        gv[i] = dOs[(ty * 8 + i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
        vv[j] = Vs[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = c < kn && (!causal || qi >= k0 + c);
        const float p = ok ? expf(s[i][j] - lse_s[r]) : 0.f;
        dSs[r * (kBK + 1) + c] = p * (dp[i][j] - d_s[r]);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < kn; ++kk) {
      float sv[8], kv[DJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) sv[i] = dSs[(ty * 8 + i) * (kBK + 1) + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[kk * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

  T* dqp = dq + qoff;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + ty * 8 + i;
    if (qi < Sq) {
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        dqp[(size_t)qi * D + tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------- backward: dK/dV
template <int D>
constexpr size_t dkdv_smem_bytes() {
  // K, V (kBKV x D+1) | Q, dO (kBQ x D+1) | P^T, dS^T (kBKV x kBQ+1) |
  // lse, Drow
  return sizeof(float) * (2 * kBKV * (D + 1) + 2 * kBQ * (D + 1) +
                          2 * kBKV * (kBQ + 1) + 2 * kBQ);
}

// Grid (ceil(Skv / kBKV), B*Hkv).  Thread t = (tx = t % 16, ty = t / 16)
// owns key rows ty*4 .. ty*4+3 of the block; for the score tile it owns
// query columns tx + 16 j (j < 4), for dK and dV the head-dim columns
// tx + 16 j (j < D/16).  dV = sum_i P_ij dO_i and dK = sum_i dS_ij q_i scale,
// summed over the group's q heads h = 0 .. group-1, then the q tiles in
// ascending order, then the rows of each tile in ascending order.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ drow,
                  T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv,
                  int group, float scale, int causal) {
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBKV * (D + 1);
  float* Qs = Vs + kBKV * (D + 1);
  float* dOs = Qs + kBQ * (D + 1);
  float* PT = dOs + kBQ * (D + 1);
  float* dST = PT + kBKV * (kBQ + 1);
  float* lse_s = dST + kBKV * (kBQ + 1);
  float* d_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row_kv = blockIdx.y;
  const int k0 = blockIdx.x * kBKV;
  const int kn = min(kBKV, Skv - k0);
  const size_t kvoff = (size_t)row_kv * Skv * D;

  stage<T, D>(Ks, k + kvoff, k0, kBKV, Skv, 1.f);
  stage<T, D>(Vs, v + kvoff, k0, kBKV, Skv, 1.f);

  float ak[4][DJ], av[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) ak[i][j] = av[i][j] = 0.f;

  // Causal: query rows before the block's first key see none of its keys.
  const int q_start = causal ? (k0 / kBQ) * kBQ : 0;
  for (int h = 0; h < group; ++h) {
    const int row_q = row_kv * group + h;
    const size_t qoff = (size_t)row_q * Sq * D;
    for (int q0 = q_start; q0 < Sq; q0 += kBQ) {
      const int qn = min(kBQ, Sq - q0);
      __syncthreads();                          // previous tile consumed
      stage<T, D>(Qs, q + qoff, q0, kBQ, Sq, scale);
      stage<T, D>(dOs, dout + qoff, q0, kBQ, Sq, 1.f);
      if (tid < kBQ) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < Sq ? lse[(size_t)row_q * Sq + qi] : 0.f;
        d_s[tid] = qi < Sq ? drow[(size_t)row_q * Sq + qi] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty * 4 + i) * (D + 1) + d];
          vv[i] = Vs[(ty * 4 + i) * (D + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * (D + 1) + d];
          gv[j] = dOs[(tx + 16 * j) * (D + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const int kj = k0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool ok = r < kn && c < qn && (!causal || q0 + c >= kj);
          const float p = ok ? expf(s[i][j] - lse_s[c]) : 0.f;
          PT[r * (kBQ + 1) + c] = p;
          dST[r * (kBQ + 1) + c] = p * (dp[i][j] - d_s[c]);
        }
      }
      __syncthreads();

      for (int c = 0; c < qn; ++c) {
        float pv[4], sv[4], gv[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = PT[(ty * 4 + i) * (kBQ + 1) + c];
          sv[i] = dST[(ty * 4 + i) * (kBQ + 1) + c];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          gv[j] = dOs[c * (D + 1) + tx + 16 * j];
          qv[j] = Qs[c * (D + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            av[i][j] = fmaf(pv[i], gv[j], av[i][j]);
            ak[i][j] = fmaf(sv[i], qv[j], ak[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r < kn) {
      const size_t off = kvoff + (size_t)(k0 + r) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dk[off + tx + 16 * j] = from_f32<T>(ak[i][j]);
        dv[off + tx + 16 * j] = from_f32<T>(av[i][j]);
      }
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
  int bh, sq, skv, group, causal;
  float scale;
  cudaStream_t stream;
};

enum Which { kFwd = 0, kDq = 1, kDkdv = 2 };

template <typename T, int D>
cudaError_t launch(int which, const Args& a) {
  cudaError_t err;
  if (which == kFwd) {
    constexpr size_t smem = fwd_smem_bytes<D>();
    err = allow_smem(flash_fwd_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.sq + kBQ - 1) / kBQ, a.bh);
    flash_fwd_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.o0), a.out32, a.lse,
        a.sq, a.skv, a.group, a.scale, a.causal);
  } else if (which == kDq) {
    constexpr size_t smem = dq_smem_bytes<D>();
    err = allow_smem(flash_dq_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.sq + kBQ - 1) / kBQ, a.bh);
    flash_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), a.out32,
        static_cast<const T*>(a.dout), a.lse, a.drow, static_cast<T*>(a.o0),
        a.sq, a.skv, a.group, a.scale, a.causal);
  } else {
    constexpr size_t smem = dkdv_smem_bytes<D>();
    err = allow_smem(flash_dkdv_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((a.skv + kBKV - 1) / kBKV, a.bh / a.group);
    flash_dkdv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.drow, static_cast<T*>(a.o1), static_cast<T*>(a.o2), a.sq, a.skv,
        a.group, a.scale, a.causal);
  }
  return cudaGetLastError();
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
    case kBF16: return dispatch_head_dim<__nv_bfloat16>(which, d, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (bh, Sq, D), k/v (bh / group, Skv, D), out (bh, Sq, D), all contiguous
// and of one dtype (0 f32, 1 bf16); lse (bh, Sq) f32.  `out32`, when not
// NULL, receives the output in f32 before its rounding to `out`'s dtype:
// the backward's row term rowsum(dO * O) takes O unrounded, as autograd
// through the plain version does.  Each entry point returns the CUDA error
// of its launch (0 on success).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, float* out32, float* lse, int bh, int sq,
                        int skv, int d, int group, float scale, int causal,
                        int dtype, void* stream) {
  Args a{q, k, v, out32, nullptr, out, nullptr, nullptr, lse, nullptr,
         bh, sq, skv, group, causal, scale,
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
         const_cast<float*>(lse), drow, bh, sq, skv, group, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kDq, d, dtype, a);
}

// dk, dv (bh / group, Skv, D) in k's dtype, from drow of the dQ kernel.
int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* drow, void* dk, void* dv, int bh,
                             int sq, int skv, int d, int group, float scale,
                             int causal, int dtype, void* stream) {
  Args a{q, k, v, nullptr, dout, nullptr, dk, dv, const_cast<float*>(lse),
         const_cast<float*>(drow), bh, sq, skv, group, causal, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch(kDkdv, d, dtype, a);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
