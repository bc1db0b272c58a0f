// Collectives between processes that share one card, in device memory:
// the transport of the process-group backend "shared" (launch/shared_pg.py).
// Built by kernels/build.py into a shared library with a plain C interface
// and bound with ctypes.
//
// Replaces no TPU kernel.  The reference's collectives between devices of
// one host run in device memory under XLA; the port's ranks that share one
// H100 cannot form a NCCL group (NCCL takes one rank a device), so each
// group's ranks exchange through mailboxes in device memory instead.  Each
// rank cudaMallocs a mailbox of two slots, exports it with
// cudaIpcGetMemHandle, and opens its peers' with cudaIpcOpenMemHandle; two
// interprocess events a slot ("written", "read") order the ranks.
// A collective moves in chunks of one slot, the two slots in turn:
//
//   1. wait on the peers' "read" events of this slot (their last reads of
//      it, two chunks back, are done);
//   2. copy this rank's chunk into its slot (shared_gather_kernel), record
//      "written";
//   3. one handshake on the host across the group (after the record:
//      cudaStreamWaitEvent on an interprocess event waits for the record
//      issued before the call);
//   4. wait on every peer's "written";
//   5. shared_reduce_kernel or shared_gather_kernel reads the slots into
//      the output;
//   6. record "read".
//
// Every wait is a stream's wait on a peer's event (cudaStreamWaitEvent),
// so the host never waits for the card and runs ahead.  No kernel spins
// on a flag in device memory: the contexts of ranks that share a card are
// time-sliced, and a spinning kernel would burn its peers' slices.  (The
// host polling the peers' events instead measured no different on an
// H100 at 700 W, scripts/shared_pg_probe.py on both trees in turns: a
// 16 KiB all-reduce 0.65-2.47 ms at 2-8 ranks, the two overlapping at
// every size: the host's handshake sets it.)
//
// shared_reduce_kernel: sum or max over the n ranks' slots, read in rank
// order 0..n-1 and accumulated in f32 for f32, bf16 and f16 (in int64 for
// int32 and int64, exact), rounded once to the tensor's dtype.  The order
// is fixed, so every rank's result is bitwise the same, and bitwise the
// plain version's (shared_pg.py::reduce_plain: only adds, in the same
// order).  16-byte loads where every slot and the output are aligned,
// scalar loads for the tail and otherwise.
//
// shared_gather_kernel: copies up to kMaxSegs (source, destination,
// bytes) segments, one grid row each: 16-byte copies where both ends are
// aligned, 4-byte where they are to 4, bytes otherwise.  It posts a
// rank's chunk into its slot and reads the peers' segments out for
// all-gather, all-to-all and broadcast.
//
// What bounds them on the card: bytes.  A reduce of n slots of b bytes
// reads n b and writes b; a gather moves its bytes once each way.  Both do
// one add or compare per element read, far under the card's ridge.  At a
// 32 MiB slot a chunk is about 20-90 us of HBM traffic; the handshake on
// the host is of the same order, and two slots let one chunk's copies
// overlap the next chunk's handshake.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxRanks = 16;   // ranks a group, and segments a gather
constexpr int kMaxSegs = 16;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2, kI64 = 3, kI32 = 4 };

struct RankPtrs {
  const void* p[kMaxRanks];
};

struct Segments {
  const char* src[kMaxSegs];
  char* dst[kMaxSegs];
  long long bytes[kMaxSegs];
};

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int64_t> { using type = int64_t; };
template <> struct AccOf<int32_t> { using type = int64_t; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ int64_t widen(int64_t v) { return v; }
__device__ __forceinline__ int64_t widen(int32_t v) { return v; }

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half_rn(v);
}
template <typename T> __device__ __forceinline__ T narrow(int64_t v) {
  return static_cast<T>(v);
}

// torch.maximum's rule: a NaN on either side gives NaN, else the larger.
template <bool kMax>
__device__ __forceinline__ float combine(float acc, float x) {
  if (kMax) return (x != x || x > acc) ? x : acc;
  return acc + x;
}
template <bool kMax>
__device__ __forceinline__ int64_t combine(int64_t acc, int64_t x) {
  if (kMax) return x > acc ? x : acc;
  // Wrapping, as the plain version's int64 sum.
  return static_cast<int64_t>(static_cast<uint64_t>(acc) +
                              static_cast<uint64_t>(x));
}

template <typename T, bool kMax>
__global__ void __launch_bounds__(kThreads)
shared_reduce_kernel(RankPtrs src, int n, T* __restrict__ dst,
                     long long count, bool vec) {
  using Acc = typename AccOf<T>::type;
  constexpr int kV = 16 / sizeof(T);
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long head = 0;
  if (vec) {
    const long long nv = count / kV;
    for (long long i = tid; i < nv; i += stride) {
      Acc acc[kV];
      uint4 w = reinterpret_cast<const uint4*>(src.p[0])[i];
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int v = 0; v < kV; ++v) acc[v] = widen(e[v]);
      for (int r = 1; r < n; ++r) {
        uint4 x = reinterpret_cast<const uint4*>(src.p[r])[i];
        const T* f = reinterpret_cast<const T*>(&x);
#pragma unroll
        for (int v = 0; v < kV; ++v) acc[v] = combine<kMax>(acc[v], widen(f[v]));
      }
      uint4 o;
      T* g = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int v = 0; v < kV; ++v) g[v] = narrow<T>(acc[v]);
      reinterpret_cast<uint4*>(dst)[i] = o;
    }
    head = nv * kV;
  }
  for (long long i = head + tid; i < count; i += stride) {
    Acc acc = widen(static_cast<const T*>(src.p[0])[i]);
    for (int r = 1; r < n; ++r)
      acc = combine<kMax>(acc, widen(static_cast<const T*>(src.p[r])[i]));
    dst[i] = narrow<T>(acc);
  }
}

__global__ void __launch_bounds__(kThreads)
shared_gather_kernel(Segments seg) {
  const int s = blockIdx.y;
  const char* src = seg.src[s];
  char* dst = seg.dst[s];
  const long long bytes = seg.bytes[s];
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const uintptr_t ends = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst);
  long long head = 0;
  if (ends % 16 == 0) {
    const long long nv = bytes / 16;
    for (long long i = tid; i < nv; i += stride)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(src)[i];
    head = nv * 16;
  } else if (ends % 4 == 0) {
    const long long nv = bytes / 4;
    for (long long i = tid; i < nv; i += stride)
      reinterpret_cast<uint32_t*>(dst)[i] =
          reinterpret_cast<const uint32_t*>(src)[i];
    head = nv * 4;
  }
  for (long long i = head + tid; i < bytes; i += stride) dst[i] = src[i];
}

int blocks_for(long long units) {
  long long b = (units + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <typename T>
int reduce_launch(const RankPtrs& src, int n, void* dst, long long count,
                  int op, cudaStream_t st) {
  bool vec = reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  for (int r = 0; r < n; ++r)
    vec = vec && reinterpret_cast<uintptr_t>(src.p[r]) % 16 == 0;
  const long long units = vec ? count / (16 / sizeof(T)) + 16 : count;
  const int blocks = blocks_for(units);
  if (op == 1)
    shared_reduce_kernel<T, true><<<blocks, kThreads, 0, st>>>(
        src, n, static_cast<T*>(dst), count, vec);
  else
    shared_reduce_kernel<T, false><<<blocks, kThreads, 0, st>>>(
        src, n, static_cast<T*>(dst), count, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A mailbox of `bytes` on `device`, its pointer and its 64-byte IPC handle.
int shared_pg_malloc(int device, long long bytes, void** ptr, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (e != cudaSuccess) return e;
  cudaIpcMemHandle_t h;
  e = cudaIpcGetMemHandle(&h, *ptr);
  if (e != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
    return e;
  }
  memcpy(handle, &h, sizeof(h));
  return cudaSuccess;
}

int shared_pg_free(void* ptr) { return cudaFree(ptr); }

// An interprocess event (no timing) and its 64-byte IPC handle.
int shared_pg_event_create(int device, void** ev, void* handle) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaEvent_t event;
  e = cudaEventCreateWithFlags(
      &event, cudaEventInterprocess | cudaEventDisableTiming);
  if (e != cudaSuccess) return e;
  cudaIpcEventHandle_t h;
  e = cudaIpcGetEventHandle(&h, event);
  if (e != cudaSuccess) {
    cudaEventDestroy(event);
    return e;
  }
  memcpy(handle, &h, sizeof(h));
  *ev = event;
  return cudaSuccess;
}

int shared_pg_event_destroy(void* ev) {
  return cudaEventDestroy(static_cast<cudaEvent_t>(ev));
}

// A peer's mailbox, mapped into this process.
int shared_pg_open_mem(int device, const void* handle, void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int shared_pg_close_mem(void* ptr) { return cudaIpcCloseMemHandle(ptr); }

int shared_pg_open_event(const void* handle, void** ev) {
  cudaIpcEventHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaEvent_t event;
  cudaError_t e = cudaIpcOpenEventHandle(&event, h);
  if (e == cudaSuccess) *ev = event;
  return e;
}

int shared_pg_record(void* ev, void* stream) {
  return cudaEventRecord(static_cast<cudaEvent_t>(ev),
                         static_cast<cudaStream_t>(stream));
}

// The stream waits on each of the n events (null entries skipped).
int shared_pg_wait(void* const* evs, int n, void* stream) {
  for (int i = 0; i < n; ++i) {
    if (evs[i] == nullptr) continue;
    cudaError_t e = cudaStreamWaitEvent(static_cast<cudaStream_t>(stream),
                                        static_cast<cudaEvent_t>(evs[i]), 0);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// dst[0:count] = sum (op 0) or max (op 1) of srcs[0..n-1][0:count], in rank
// order; dtype 0 f32, 1 bf16, 2 f16, 3 int64, 4 int32.
int shared_pg_reduce_launch(const void* const* srcs, int n, void* dst,
                            long long count, int dtype, int op,
                            void* stream) {
  if (n < 1 || n > kMaxRanks || count < 0 || op < 0 || op > 1)
    return cudaErrorInvalidValue;
  if (count == 0) return cudaSuccess;
  RankPtrs src;
  for (int r = 0; r < kMaxRanks; ++r) src.p[r] = r < n ? srcs[r] : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return reduce_launch<float>(src, n, dst, count, op, st);
    case kBF16: return reduce_launch<__nv_bfloat16>(src, n, dst, count, op, st);
    case kF16: return reduce_launch<__half>(src, n, dst, count, op, st);
    case kI64: return reduce_launch<int64_t>(src, n, dst, count, op, st);
    case kI32: return reduce_launch<int32_t>(src, n, dst, count, op, st);
    default: return cudaErrorInvalidValue;
  }
}

// Copies n segments: dsts[i][0:bytes[i]] = srcs[i][0:bytes[i]].
int shared_pg_gather_launch(const void* const* srcs, void* const* dsts,
                            const long long* bytes, int n, void* stream) {
  if (n < 0 || n > kMaxSegs) return cudaErrorInvalidValue;
  Segments seg;
  long long most = 0;
  for (int s = 0; s < kMaxSegs; ++s) {
    seg.src[s] = s < n ? static_cast<const char*>(srcs[s]) : nullptr;
    seg.dst[s] = s < n ? static_cast<char*>(dsts[s]) : nullptr;
    seg.bytes[s] = s < n ? bytes[s] : 0;
    if (seg.bytes[s] < 0) return cudaErrorInvalidValue;
    if (seg.bytes[s] > most) most = seg.bytes[s];
  }
  if (n == 0 || most == 0) return cudaSuccess;
  dim3 grid(blocks_for(most / 16 + 16), n);
  shared_gather_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(seg);
  return cudaGetLastError();
}

const char* shared_pg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
