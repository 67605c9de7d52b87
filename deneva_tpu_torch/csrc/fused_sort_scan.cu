// Fused lexicographic sort + segment scan, written for Hopper (sm_90a).
//
// Replaces the TPU kernel deneva_tpu/ops/fused.py:_pallas_sort_scan (body
// fused_sort_scan_kernel, reached through fused_sort_scan and
// maybe_fused_sort).  It computes the same function:
//   - sort n_in int32 columns of length n lexicographically by the first
//     num_keys of them, with the lane index as the final key, so the order
//     equals a stable lexicographic sort exactly;
//   - the segment-start mask of the sorted primary key (column 0);
//   - the start index: a cummax of start-masked positions.
// Lanes are padded to P = next power of two >= n with all-ones keys and
// lane indices >= n, so pad lanes sort after every real lane, even after a
// real lane whose key equals INT32_MAX.
//
// Design.  The TPU kernel holds the whole pack in VMEM; a Hopper block has
// at most 227 KB of shared memory, so the main path's pack (P = 131,072)
// crosses blocks.  The sort moves records of W = num_keys + 1 words (the
// keys, biased to order-preserving unsigned words, then the lane index)
// through a bitonic network:
//   - block_sort: each block sorts a 2048-record tile in shared memory
//     (every stride below 2048 of merge sizes up to 2048);
//   - for each larger merge size k: one global pass per stride j >= 2048
//     (global_step), then one block_merge for all strides below 2048;
//   - gather carries every column (keys and payloads) by the sorted lane;
//   - the scan epilogue: starts by comparing each lane with its neighbour
//     and a block-level cummax (starts_scan), the running maximum carried
//     across blocks (carry_scan over block maxima, then carry_apply).
//
// What bounds it on this card.  At P = 131,072 with 3 columns and 2 keys
// (W = 3) a pass over the records reads and writes 2 x 12 B x 131,072 =
// 3.1 MB; the call makes 1 block_sort + 21 global_step + 6 block_merge =
// 28 such passes (88 MB, about 26 us at 3.35 TB/s), where the function
// itself needs only its inputs read once and its outputs written once
// (n x 4 B x (2 n_in + 2) = 2.6 MB, 0.8 us).  The records (1.5 MB) stay in
// the 50 MB L2 between passes, and 32 launches per call cost more than
// the bytes at this size.  Fewer, larger passes (a multi-stride global
// step, a persistent kernel) are the known next step.
//
// Plain C interface, loaded through ctypes (deneva_tpu_torch/ops/fused.py):
// every launch goes on the caller's stream, nothing synchronises, nothing
// allocates; the first failing launch's error code is returned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;       // records per block-local bitonic stage
constexpr int kMaxCols = 24;      // MAX_OPERANDS in ops/fused.py
constexpr int kMaxKeys = 3;       // MAX_KEYS in ops/fused.py
constexpr int kMaxLanes = 1 << 23;  // packed entry-index limit (cc/twopl.py)
constexpr int kScanBlock = 1024;  // lanes per block in the scan epilogue
constexpr int kStepThreads = 256;

struct InCols { const int32_t* p[kMaxCols]; };
struct OutCols { int32_t* p[kMaxCols]; };

// signed int32 -> unsigned word with the same order
__device__ __forceinline__ uint32_t biased(int32_t v) {
  return static_cast<uint32_t>(v) ^ 0x80000000u;
}

// lower lane of compare-exchange pair t at stride j (j a power of two)
__device__ __forceinline__ int pair_lane(int t, int j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

template <int W>
__device__ __forceinline__ bool greater(const uint32_t (&a)[W],
                                        const uint32_t (&b)[W]) {
  bool gt = false, eq = true;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    gt = gt || (eq && a[w] > b[w]);
    eq = eq && (a[w] == b[w]);
  }
  return gt;
}

// Records are all distinct (the lane word), so "not greater" is "less":
// an ascending pair swaps when a > b, a descending pair when a < b.
template <int W>
__device__ __forceinline__ void cas_shared(uint32_t (*s)[kTile], int i,
                                           int p, bool asc) {
  uint32_t a[W], b[W];
#pragma unroll
  for (int w = 0; w < W; ++w) { a[w] = s[w][i]; b[w] = s[w][p]; }
  if (greater<W>(a, b) == asc) {
#pragma unroll
    for (int w = 0; w < W; ++w) { s[w][i] = b[w]; s[w][p] = a[w]; }
  }
}

// Builds the tile's records from the input columns and sorts it with every
// merge size k <= tile.  Direction follows the global lane, so the tiles
// form the bitonic sequences the larger merges expect.
template <int W>
__global__ void block_sort(InCols in, int n, int tile, uint32_t* rec,
                           int P) {
  __shared__ uint32_t s[W][kTile];
  const int base = blockIdx.x * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const int lane = base + t;
#pragma unroll
    for (int w = 0; w < W - 1; ++w)
      s[w][t] = lane < n ? biased(in.p[w][lane]) : 0xFFFFFFFFu;
    s[W - 1][t] = static_cast<uint32_t>(lane);
  }
  __syncthreads();
  const int half = tile >> 1;
  for (int k = 2; k <= tile; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = pair_lane(t, j);
        cas_shared<W>(s, i, i + j, ((base + i) & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
#pragma unroll
    for (int w = 0; w < W; ++w) rec[w * P + base + t] = s[w][t];
  }
}

// One stride j >= kTile of merge size k, in device memory.
template <int W>
__global__ void global_step(uint32_t* rec, int P, int k, int j) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (P >> 1)) return;
  const int i = pair_lane(t, j);
  const int p = i + j;
  uint32_t a[W], b[W];
#pragma unroll
  for (int w = 0; w < W; ++w) { a[w] = rec[w * P + i]; b[w] = rec[w * P + p]; }
  if (greater<W>(a, b) == ((i & k) == 0)) {
#pragma unroll
    for (int w = 0; w < W; ++w) { rec[w * P + i] = b[w]; rec[w * P + p] = a[w]; }
  }
}

// Every stride below kTile of merge size k > kTile, in shared memory.
template <int W>
__global__ void block_merge(uint32_t* rec, int P, int k) {
  __shared__ uint32_t s[W][kTile];
  const int base = blockIdx.x * kTile;
  for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
#pragma unroll
    for (int w = 0; w < W; ++w) s[w][t] = rec[w * P + base + t];
  }
  __syncthreads();
  const bool asc = (base & k) == 0;   // constant over the tile: k > kTile
  for (int j = kTile >> 1; j > 0; j >>= 1) {
    for (int t = threadIdx.x; t < (kTile >> 1); t += blockDim.x) {
      const int i = pair_lane(t, j);
      cas_shared<W>(s, i, i + j, asc);
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
#pragma unroll
    for (int w = 0; w < W; ++w) rec[w * P + base + t] = s[w][t];
  }
}

// Carries every column by the sorted lane index; the first n sorted
// records are the real lanes.
__global__ void gather(InCols in, OutCols out, int n_in, int n,
                       const uint32_t* lane) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int src = static_cast<int>(lane[i]);
  for (int c = 0; c < n_in; ++c) out.p[c][i] = in.p[c][src];
}

// Inclusive max-scan of buf[0..kScanBlock) in place (Hillis-Steele).
__device__ __forceinline__ void block_cummax(int32_t* buf) {
  for (int d = 1; d < kScanBlock; d <<= 1) {
    const int32_t other = threadIdx.x >= d ? buf[threadIdx.x - d] : 0;
    __syncthreads();
    buf[threadIdx.x] = max(buf[threadIdx.x], other);
    __syncthreads();
  }
}

// Segment starts of the sorted key, the block-local start index, and each
// block's maximum start position.
__global__ void starts_scan(const int32_t* key, int n, int32_t* starts,
                            int32_t* sidx, int32_t* block_max) {
  __shared__ int32_t buf[kScanBlock];
  const int i = blockIdx.x * kScanBlock + threadIdx.x;
  int32_t v = 0;
  if (i < n) {
    const int32_t st = (i == 0 || key[i] != key[i - 1]) ? 1 : 0;
    starts[i] = st;
    v = st ? i : 0;
  }
  buf[threadIdx.x] = v;
  __syncthreads();
  block_cummax(buf);
  if (i < n) sidx[i] = buf[threadIdx.x];
  if (threadIdx.x == kScanBlock - 1) block_max[blockIdx.x] = buf[threadIdx.x];
}

// One block: carry[b] = max(block_max[0..b)), 0 for b = 0.
__global__ void carry_scan(const int32_t* block_max, int nb, int32_t* carry) {
  __shared__ int32_t buf[kScanBlock];
  int32_t running = 0;
  for (int base = 0; base < nb; base += kScanBlock) {
    const int b = base + threadIdx.x;
    buf[threadIdx.x] = b < nb ? block_max[b] : 0;
    __syncthreads();
    block_cummax(buf);
    const int32_t before = threadIdx.x == 0 ? 0 : buf[threadIdx.x - 1];
    if (b < nb) carry[b] = max(running, before);
    running = max(running, buf[kScanBlock - 1]);
    __syncthreads();   // every thread has read buf before the next chunk
  }
}

__global__ void carry_apply(int32_t* sidx, int n, const int32_t* carry) {
  const int i = blockIdx.x * kScanBlock + threadIdx.x;
  if (i < n) sidx[i] = max(sidx[i], carry[blockIdx.x]);
}

template <int W>
cudaError_t sort_records(const InCols& in, int n, int P, uint32_t* rec,
                         cudaStream_t stream) {
  const int tile = P < kTile ? P : kTile;
  block_sort<W><<<P / tile, tile / 2, 0, stream>>>(in, n, tile, rec, P);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int k = 2 * kTile; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= kTile; j >>= 1) {
      const int pairs = P >> 1;
      global_step<W><<<(pairs + kStepThreads - 1) / kStepThreads,
                       kStepThreads, 0, stream>>>(rec, P, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    block_merge<W><<<P / kTile, kTile / 2, 0, stream>>>(rec, P, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

int scan_blocks(int n) { return (n + kScanBlock - 1) / kScanBlock; }

}  // namespace

extern "C" {

// int32 words of scratch one call needs: the records, then two arrays of
// per-block scan values.
long long dn_scratch_words(int num_keys, int n, int P) {
  return static_cast<long long>(num_keys + 1) * P + 2LL * scan_blocks(n);
}

const char* dn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ins: n_in device pointers to int32 columns of length n; outs: n_in device
// pointers receiving the sorted columns; starts, sidx: int32 outputs of
// length n; scratch: dn_scratch_words int32 words.  Returns 0 or a
// cudaError_t code.
int dn_fused_sort_scan(void* const* ins, int n_in, int num_keys, int n,
                       int P, void* const* outs, void* starts, void* sidx,
                       void* scratch, void* stream_ptr) {
  if (n_in < 1 || n_in > kMaxCols || num_keys < 1 || num_keys > kMaxKeys ||
      num_keys > n_in || n < 1 || P < 2 || P > kMaxLanes ||
      (P & (P - 1)) != 0 || P < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  InCols in{};
  OutCols out{};
  for (int c = 0; c < n_in; ++c) {
    in.p[c] = static_cast<const int32_t*>(ins[c]);
    out.p[c] = static_cast<int32_t*>(outs[c]);
  }
  uint32_t* rec = static_cast<uint32_t*>(scratch);
  cudaError_t err;
  switch (num_keys) {
    case 1: err = sort_records<2>(in, n, P, rec, stream); break;
    case 2: err = sort_records<3>(in, n, P, rec, stream); break;
    default: err = sort_records<4>(in, n, P, rec, stream); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const uint32_t* lane = rec + static_cast<long long>(num_keys) * P;
  gather<<<(n + 255) / 256, 256, 0, stream>>>(in, out, n_in, n, lane);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const int nb = scan_blocks(n);
  int32_t* block_max = reinterpret_cast<int32_t*>(
      rec + static_cast<long long>(num_keys + 1) * P);
  int32_t* carry = block_max + nb;
  int32_t* st = static_cast<int32_t*>(starts);
  int32_t* si = static_cast<int32_t*>(sidx);
  starts_scan<<<nb, kScanBlock, 0, stream>>>(out.p[0], n, st, si, block_max);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  carry_scan<<<1, kScanBlock, 0, stream>>>(block_max, nb, carry);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  carry_apply<<<nb, kScanBlock, 0, stream>>>(si, n, carry);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
