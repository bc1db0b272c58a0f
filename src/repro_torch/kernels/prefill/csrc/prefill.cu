// Bucketed prefill kernels for Hopper (sm_90a): causal flash attention (K1)
// and the KV cache cast (K2).  Built by kernels/build.py into a shared
// library with a plain C interface and bound with ctypes (prefill.py).
//
// K1 `prefill_flash` replaces the Pallas TPU kernel
// repro/kernels/prefill/prefill.py::prefill_flash / _prefill_kernel: always
// causal online-softmax attention over a right-padded length bucket,
// Sq == Skv == S, GQA by dividing the q-head row by `group` (K/V are never
// repeated), f32 scores and accumulator, q pre-scaled by 1/sqrt(D) in f32,
// masked scores -1e30 (not -inf), the row sum floored at 1e-30, out in q's
// dtype.
//
// What bounds it on the card: at the serve path's shapes (16 q heads, 2 KV
// heads, D = 128, S up to 512 in bf16) the least time is about a
// microsecond, and bytes (q, k, v read once, out written once) and bf16
// tensor-core operations weigh about the same there.  This first version
// does the arithmetic with plain f32 FMAs out of shared memory instead of
// the tensor cores, so its own limit is the CUDA-core FMA rate and the
// shared-memory reads feeding it; it is far from the bound and is meant to
// be right first.  What the design does about it: one block per (q-head
// row, tile of 64 query rows) gives 16 x S/64 blocks at the serve
// shapes; the loop over K/V tiles stops at the diagonal (the causal half is
// never loaded); each K/V tile is staged once in shared memory and reused by
// all 64 query rows (and the same K/V rows serve all `group` q heads from
// L2); each thread keeps an 8 x (D/16) accumulator in registers, so the
// running output never goes back to device memory.  The TPU grid's
// sequential K axis becomes that in-block loop.  S need not divide the tile
// (the bucket is not a power of two when it is clamped to max_seq): the
// ragged edge is masked, never padded.
//
// K2 `prefill_cache_cast` replaces repro/kernels/prefill/prefill.py::
// prefill_flash / _cache_kernel: K and V written once in the cache dtype
// (round to nearest even, as torch's .to()).  It is bound by bytes and is a
// grid-stride elementwise loop.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows a block holds
constexpr int kBK = 64;        // keys a K/V tile holds
constexpr int kThreads = 128;  // 16 x 8 threads; each owns 8 rows
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

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

template <int D>
constexpr size_t flash_smem_bytes() {
  // Q (kBQ x D+1) | K (kBK x D+1) | V (kBK x D) | P (kBQ x kBK+1) | m,l,alpha
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D +
                          kBQ * (kBK + 1) + 3 * kBQ);
}

// Grid (ceil(S / kBQ), B*Hq).  Thread t = (tx = t % 16, ty = t / 16) owns
// rows ty*8 .. ty*8+7 of the tile; for scores it owns columns tx + 16 j
// (j < 4), for the output columns tx + 16 j (j < D/16).  Row strides of
// D+1 and kBK+1 floats keep the shared-memory reads free of bank
// conflicts.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
prefill_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int S,
                     int group, float scale) {
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
  const T* qp = q + (size_t)row_q * S * D;
  const T* kp = k + (size_t)row_kv * S * D;
  const T* vp = v + (size_t)row_kv * S * D;
  T* op = out + (size_t)row_q * S * D;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    float val = 0.f;
    if (qi < S) val = to_f32(qp[(size_t)qi * D + c]) * scale;
    Qs[r * (D + 1) + c] = val;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // Causal: K/V tiles start at most at the tile's last valid query row.
  const int q_last = min(q0 + kBQ, S) - 1;
  for (int k0 = 0; k0 <= q_last; k0 += kBK) {
    const int kn = min(kBK, S - k0);             // valid keys in this tile
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
        const bool ok = c < kn && qi >= k0 + c;
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

  __syncthreads();                              // l_s final for every row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
    const int qi = q0 + r;
    if (qi < S) {
      const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        op[(size_t)qi * D + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
    }
  }
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* out, int bh, int S, int group, float scale,
                         cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<D>();
  // Above 48 KB of dynamic shared memory needs the opt-in, which is kept
  // per device: set it on every launch (a host-side attribute write).
  cudaError_t err = cudaFuncSetAttribute(
      prefill_flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, bh);
  prefill_flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, group, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v,
                              void* out, int bh, int S, int D, int group,
                              float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_flash<T, 16>(q, k, v, out, bh, S, group, scale, stream);
    case 32:
      return launch_flash<T, 32>(q, k, v, out, bh, S, group, scale, stream);
    case 64:
      return launch_flash<T, 64>(q, k, v, out, bh, S, group, scale, stream);
    case 128:
      return launch_flash<T, 128>(q, k, v, out, bh, S, group, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Ti, typename To>
__global__ void cache_cast_kernel(const Ti* __restrict__ k,
                                  const Ti* __restrict__ v, To* __restrict__ kc,
                                  To* __restrict__ vc, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    kc[i] = from_f32<To>(to_f32(k[i]));
    vc[i] = from_f32<To>(to_f32(v[i]));
  }
}

template <typename Ti, typename To>
cudaError_t launch_cast(const void* k, const void* v, void* kc, void* vc,
                        int64_t n, cudaStream_t stream) {
  const int threads = 256;
  const int64_t want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 4096 ? (want > 0 ? want : 1) : 4096);
  cache_cast_kernel<Ti, To><<<blocks, threads, 0, stream>>>(
      static_cast<const Ti*>(k), static_cast<const Ti*>(v),
      static_cast<To*>(kc), static_cast<To*>(vc), n);
  return cudaGetLastError();
}

template <typename Ti>
cudaError_t dispatch_cast_out(const void* k, const void* v, void* kc,
                              void* vc, int64_t n, int out_dtype,
                              cudaStream_t stream) {
  switch (out_dtype) {
    case kF32: return launch_cast<Ti, float>(k, v, kc, vc, n, stream);
    case kBF16: return launch_cast<Ti, __nv_bfloat16>(k, v, kc, vc, n, stream);
    case kF16: return launch_cast<Ti, __half>(k, v, kc, vc, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (bh, S, D), k/v (bh / group, S, D), out (bh, S, D), all contiguous and
// of one dtype (0 f32, 1 bf16, 2 f16).  Returns the CUDA error of the launch
// (0 on success).
int prefill_flash(const void* q, const void* k, const void* v, void* out,
                  int bh, int S, int D, int group, float scale, int dtype,
                  void* stream) {
  if (bh < 1 || S < 1 || group < 1 || bh % group)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return dispatch_head_dim<float>(q, k, v, out, bh, S, D, group, scale,
                                      st);
    case kBF16:
      return dispatch_head_dim<__nv_bfloat16>(q, k, v, out, bh, S, D, group,
                                              scale, st);
    case kF16:
      return dispatch_head_dim<__half>(q, k, v, out, bh, S, D, group, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// k, v -> kc, vc: n elements each, contiguous, cast in_dtype -> out_dtype.
int prefill_cache_cast(const void* k, const void* v, void* kc, void* vc,
                       int64_t n, int in_dtype, int out_dtype, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kF32:
      return dispatch_cast_out<float>(k, v, kc, vc, n, out_dtype, st);
    case kBF16:
      return dispatch_cast_out<__nv_bfloat16>(k, v, kc, vc, n, out_dtype, st);
    case kF16:
      return dispatch_cast_out<__half>(k, v, kc, vc, n, out_dtype, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
