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
// tensor-core operations weigh about the same there.
//
// bf16 (the serve path) takes `prefill_flash_mma_kernel`: K4's bf16 forward
// on the tensor cores (the body in
// ../../flash_attention/csrc/mma_tiles.cuh, design notes at the top of
// flash_attention.cu), causal with Sq == Skv == S, without the log-sum-exp
// and the f32 copy of the output that K4's backward needs.  One difference
// from the reference: it scales the f32 scores by 1/sqrt(D) instead of q
// (a bf16 q cannot take the scale without rounding; at the x30 logits
// scores near 900 would move by tenths).  At S = 512 its 16 x 8 blocks
// are one wave on 132 SMs, the heaviest causal tiles first.
//
// f32 and f16 take `prefill_flash_f32_kernel`: K4's f32 forward on the
// CUDA cores (the body in ../../flash_attention/csrc/f32_tiles.cuh, which
// lists its arithmetic and design), causal with Sq == Skv == S, without the
// log-sum-exp; f16 staged to f32 by plain loads (no path runs f16), f32 by
// `cp.async`.  Both products are plain f32 FMAs (the tensor cores take f32
// only as TF32, which the port keeps off), q pre-scaled in f32 as the
// reference does, so its output is K4's f32 `out` bit for bit; its limit
// is the CUDA-core FMA rate.
//
// In both, the TPU grid's sequential K axis becomes the in-block loop, and
// S need not divide the tile (the bucket is not a power of two when it is
// clamped to max_seq): the ragged edge is masked, never padded.
//
// K2 `prefill_cache_cast` replaces repro/kernels/prefill/prefill.py::
// prefill_flash / _cache_kernel: K and V written once in the cache dtype
// (round to nearest even, as torch's .to()).  It is bound by bytes: on the
// H100 (3.35 TB/s) at the model path's shape (k and v (2, 128, 128) f32 ->
// bf16, 393 KB) the bound is 0.00012 ms, far under a launch, and at k and v
// (2, 32768, 128) it is 0.030 ms.  So `cache_cast_kernel` is one grid-stride pass over k and v
// with 16-byte loads and 8-byte stores (four f32 in, four bf16 or f16
// out), on a grid of at most 8 blocks of 256 threads an SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "f32_tiles.cuh"   // the f32 forward, to_f32; mma_tiles.cuh

namespace {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Grid (B*Hq, ceil(S / kFwdBQ)); see attention_fwd_f32.
template <typename T, int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
prefill_flash_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, int S,
                         int group, float scale, int async_copy) {
  extern __shared__ __align__(16) float smf[];
  attention_fwd_f32<T, D>(smf, q, k, v, out, nullptr, nullptr, S, S, group,
                          scale, 1, async_copy);
}

// f32 inputs that start on a 16-byte boundary are staged by cp.async.
template <typename T, int D>
cudaError_t launch_flash_f32(const void* q, const void* k, const void* v,
                             void* out, int bh, int S, int group, float scale,
                             cudaStream_t stream) {
  constexpr size_t smem = fwd_f32_smem_bytes<D>();
  const int n_qt = (S + kFwdBQ - 1) / kFwdBQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;   // grid y
  // Above 48 KB of dynamic shared memory needs the opt-in, which is kept
  // per device: set it on every launch (a host-side attribute write).
  cudaError_t err = cudaFuncSetAttribute(
      prefill_flash_f32_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int aligned = std::is_same<T, float>::value &&
                      ((reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  prefill_flash_f32_kernel<T, D><<<dim3(bh, n_qt), kFwdThreads, smem,
                                   stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, group, scale,
      aligned);
  return cudaGetLastError();
}

// Grid (B*Hq, ceil(S / kMmaBQ)); see attention_fwd_mma.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
prefill_flash_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         int S, int group, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  attention_fwd_mma<D>(smem_raw, q, k, v, out, nullptr, nullptr, S, S, group,
                       scale, 1);
}

template <int D>
cudaError_t launch_flash_mma(const void* q, const void* k, const void* v,
                             void* out, int bh, int S, int group, float scale,
                             cudaStream_t stream) {
  constexpr size_t smem = fwd_mma_smem_bytes<D>();
  const int n_qt = (S + kMmaBQ - 1) / kMmaBQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;   // grid y
  cudaError_t err = cudaFuncSetAttribute(
      prefill_flash_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  prefill_flash_mma_kernel<D><<<dim3(bh, n_qt), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, group, scale);
  return cudaGetLastError();
}

// bf16 on the tensor cores, f32 and f16 on the CUDA cores.
template <typename T, int D>
cudaError_t launch_by_type(const void* q, const void* k, const void* v,
                           void* out, int bh, int S, int group, float scale,
                           cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value)
    return launch_flash_mma<D>(q, k, v, out, bh, S, group, scale, stream);
  else
    return launch_flash_f32<T, D>(q, k, v, out, bh, S, group, scale,
                                  stream);
}

// The dynamic shared memory a launch of the dtype's kernel asks for.
template <int D>
size_t smem_bytes(int dtype) {
  return dtype == kBF16 ? fwd_mma_smem_bytes<D>() : fwd_f32_smem_bytes<D>();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v,
                              void* out, int bh, int S, int D, int group,
                              float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_by_type<T, 16>(q, k, v, out, bh, S, group, scale, stream);
    case 32:
      return launch_by_type<T, 32>(q, k, v, out, bh, S, group, scale, stream);
    case 64:
      return launch_by_type<T, 64>(q, k, v, out, bh, S, group, scale, stream);
    case 128:
      return launch_by_type<T, 128>(q, k, v, out, bh, S, group, scale,
                                    stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Four elements of type T, as one load or store of 4 * sizeof(T) bytes.
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

// k, v -> kc, vc, n elements each.  With `vec` (every pointer aligned to
// its four-element piece) one grid-stride pass moves four elements of k and
// four of v a thread and step, 16 bytes in and 8 out for f32 -> bf16 or f16;
// the n % 4 elements past the last piece, or every element without `vec`,
// go one at a time.  Each element is rounded once (from_f32 rounds to
// nearest even, as torch's .to() does).
template <typename Ti, typename To>
__global__ void __launch_bounds__(256)
cache_cast_kernel(const Ti* __restrict__ k, const Ti* __restrict__ v,
                  To* __restrict__ kc, To* __restrict__ vc, int64_t n,
                  int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t tail = 0;
  if (vec) {
    const int64_t pieces = n / 4;
    for (int64_t i = t; i < pieces; i += stride) {
      const Vec4<Ti> a = reinterpret_cast<const Vec4<Ti>*>(k)[i];
      const Vec4<Ti> b = reinterpret_cast<const Vec4<Ti>*>(v)[i];
      Vec4<To> ac, bc;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ac.v[e] = from_f32<To>(to_f32(a.v[e]));
        bc.v[e] = from_f32<To>(to_f32(b.v[e]));
      }
      reinterpret_cast<Vec4<To>*>(kc)[i] = ac;
      reinterpret_cast<Vec4<To>*>(vc)[i] = bc;
    }
    tail = pieces * 4;
  }
  for (int64_t i = tail + t; i < n; i += stride) {
    kc[i] = from_f32<To>(to_f32(k[i]));
    vc[i] = from_f32<To>(to_f32(v[i]));
  }
}

// Blocks of 256 threads, at most 8 an SM (2048 threads, the SM's limit) on
// every SM: the grid-stride pass keeps the card's memory busy with the
// fewest blocks.
template <typename Ti, typename To>
cudaError_t launch_cast(const void* k, const void* v, void* kc, void* vc,
                        int64_t n, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int threads = 256;
  const int vec = (reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v)) % sizeof(Vec4<Ti>) == 0 &&
                  (reinterpret_cast<uintptr_t>(kc) |
                   reinterpret_cast<uintptr_t>(vc)) % sizeof(Vec4<To>) == 0;
  const int64_t items = vec ? n / 4 + n % 4 : n;
  const int64_t want = (items + threads - 1) / threads;
  const int blocks = (int)(want < 8 * sms ? (want > 0 ? want : 1) : 8 * sms);
  cache_cast_kernel<Ti, To><<<blocks, threads, 0, stream>>>(
      static_cast<const Ti*>(k), static_cast<const Ti*>(v),
      static_cast<To*>(kc), static_cast<To*>(vc), n, vec);
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
// of one dtype (0 f32, 1 bf16, 2 f16; bf16 pointers 16-byte aligned).
// Returns the CUDA error of the launch (0 on success).
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

// Dynamic shared memory of prefill_flash's kernel for head_dim d and dtype
// (codes as above), in bytes; -1 for an unsupported d or dtype.
long long prefill_smem_bytes(int d, int dtype) {
  if (dtype != kF32 && dtype != kBF16 && dtype != kF16) return -1;
  switch (d) {
    case 16: return smem_bytes<16>(dtype);
    case 32: return smem_bytes<32>(dtype);
    case 64: return smem_bytes<64>(dtype);
    case 128: return smem_bytes<128>(dtype);
    default: return -1;
  }
}

const char* prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
