// Timestamp rebase of per-row timestamp arrays, in place, written for
// Hopper (sm_90a), with the shift read on the device.  Two rules:
//
//   plain:  x = max(x - shift, 0)                 (T/O's wts, rts; MVCC's
//                                                  rts0, w_floor)
//   ring:   x = x > 0 ? max(x - shift, 1) : 0     (MVCC's version rings:
//                                                  an empty slot stays 0,
//                                                  a version stays > 0)
//
// Replaces deneva_tpu/cc/timestamp.py:119 (Timestamp.on_ts_rebase) and
// deneva_tpu/cc/mvcc.py:96-102 (Mvcc.on_ts_rebase), XLA elementwise ops
// that the JAX engine runs under a lax.cond only on a tick whose timestamp
// counter passed its threshold (deneva_tpu/engine/scheduler.py:1059).  The
// port's tick reads nothing on the host, so it launches the rebase on every
// tick, with a shift that is 0 on a tick that does not rebase.  This kernel
// is that cond on the device: every thread loads the shift and returns at
// once when it is 0, so such a tick moves no row data.  Otherwise one pass
// reads and writes each array once, as int4 vectors (the arrays come from
// the caching allocator and are 16-byte aligned), with a scalar tail.
//
// The shift must be >= 0 and below 2^31 (the engine's is 0 or 2^30);
// `x > s ? x - s : 0` then equals max(x - s, 0) for every int32 x, and
// x - s does not overflow for the x > 0 that the ring rule lowers.
//
// Plain C interface, loaded through ctypes (deneva_tpu_torch/ops/rebase.py):
// the launch goes on the caller's stream, nothing synchronises, nothing
// allocates; an error code is returned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <bool kRing>
__device__ __forceinline__ int32_t lower(int32_t x, int32_t s) {
  if (kRing) return x > 0 ? (x - s > 1 ? x - s : 1) : 0;
  return x > s ? x - s : 0;
}

template <bool kRing>
__device__ __forceinline__ int4 lower4(int4 v, int32_t s) {
  return make_int4(lower<kRing>(v.x, s), lower<kRing>(v.y, s),
                   lower<kRing>(v.z, s), lower<kRing>(v.w, s));
}

template <bool kRing>
__global__ void ts_rebase_kernel(int32_t* __restrict__ a,
                                 int32_t* __restrict__ b, long long n,
                                 const long long* __restrict__ shift_p) {
  const long long shift = *shift_p;
  if (shift == 0) return;
  const int32_t s = static_cast<int32_t>(shift);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  int4* a4 = reinterpret_cast<int4*>(a);
  int4* b4 = reinterpret_cast<int4*>(b);
  for (long long i = first; i < n4; i += stride) {
    int4 x = a4[i];
    int4 y = b4[i];
    a4[i] = lower4<kRing>(x, s);
    b4[i] = lower4<kRing>(y, s);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    a[i] = lower<kRing>(a[i], s);
    b[i] = lower<kRing>(b[i], s);
  }
}

}  // namespace

extern "C" {

// Rebase a[0:n] and b[0:n] (int32, 16-byte aligned) by the int64 scalar at
// `shift`, all on the current device, with `grid` blocks of `threads`
// threads on `stream`; `ring` != 0 takes the ring rule, 0 the plain one.
int dn_ts_rebase(void* a, void* b, long long n, const void* shift, int ring,
                 int grid, int threads, void* stream) {
  auto* pa = static_cast<int32_t*>(a);
  auto* pb = static_cast<int32_t*>(b);
  auto* ps = static_cast<const long long*>(shift);
  auto st = static_cast<cudaStream_t>(stream);
  if (ring) {
    ts_rebase_kernel<true><<<grid, threads, 0, st>>>(pa, pb, n, ps);
  } else {
    ts_rebase_kernel<false><<<grid, threads, 0, st>>>(pa, pb, n, ps);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dn_ts_rebase_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
