// Timestamp rebase of basic T/O's per-row arrays, in place, written for
// Hopper (sm_90a):  x = max(x - shift, 0)  on both arrays (wts, rts), with
// the shift read on the device.
//
// Replaces deneva_tpu/cc/timestamp.py:119 (Timestamp.on_ts_rebase, two XLA
// elementwise ops), which the JAX engine runs under a lax.cond only on a
// tick whose timestamp counter passed its threshold
// (deneva_tpu/engine/scheduler.py:1059).  The port's tick reads nothing on
// the host, so it launches the rebase on every tick, with a shift that is 0
// on a tick that does not rebase.  This kernel is that cond on the device:
// every thread loads the shift and returns at once when it is 0, so such a
// tick moves no row data.  Otherwise one pass reads and writes each array
// once, as int4 vectors (the arrays come from the caching allocator and are
// 16-byte aligned), with a scalar tail.
//
// The shift must be >= 0 and below 2^31 (the engine's is 0 or 2^30);
// `x > s ? x - s : 0` then equals max(x - s, 0) for every int32 x, with no
// overflow.
//
// Plain C interface, loaded through ctypes (deneva_tpu_torch/ops/rebase.py):
// the launch goes on the caller's stream, nothing synchronises, nothing
// allocates; an error code is returned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ int32_t lower(int32_t x, int32_t s) {
  return x > s ? x - s : 0;
}

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
    a4[i] = make_int4(lower(x.x, s), lower(x.y, s), lower(x.z, s),
                      lower(x.w, s));
    b4[i] = make_int4(lower(y.x, s), lower(y.y, s), lower(y.z, s),
                      lower(y.w, s));
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    a[i] = lower(a[i], s);
    b[i] = lower(b[i], s);
  }
}

}  // namespace

extern "C" {

// Rebase a[0:n] and b[0:n] (int32, 16-byte aligned) by the int64 scalar at
// `shift`, both on the current device, with `grid` blocks of `threads`
// threads on `stream`.
int dn_ts_rebase(void* a, void* b, long long n, const void* shift, int grid,
                 int threads, void* stream) {
  ts_rebase_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(a), static_cast<int32_t*>(b), n,
      static_cast<const long long*>(shift));
  return static_cast<int>(cudaGetLastError());
}

const char* dn_ts_rebase_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
