// Fused lexicographic sort + segment scan, written for Hopper (sm_90a), as
// one persistent cooperative launch per call.
//
// Replaces the TPU kernel deneva_tpu/ops/fused.py:_pallas_sort_scan (body
// fused_sort_scan_kernel, reached through fused_sort_scan and
// maybe_fused_sort).  It computes the same function:
//   - sort n_in int32 columns of length n lexicographically by the first
//     num_keys of them, with the lane index as the final key, so the order
//     equals a stable lexicographic sort exactly;
//   - the segment-start mask of the sorted primary key (column 0) shifted
//     right by `shift` (arithmetic): shift 0 is the TPU kernel's function,
//     shift 1 gives twopl.arbitrate its row segments (keykind >> 1);
//   - the start index: for each lane, the position where its segment starts
//     (a cummax of start-masked positions).
//
// What it replaces on this card.  The TPU kernel holds the whole padded
// pack in VMEM and runs a bitonic network over it.  A Hopper block has at
// most 227 KB of shared memory, so the main path's pack (81,920 lanes)
// crosses blocks.  The first port (32 launches per call) copied the
// network: it padded n to a power of two and made one device-memory pass
// per stride.  This kernel is one cooperative launch (one block of 1024
// threads per SM, the grid capped at the number of merge chunks) whose
// phases are separated by grid barriers:
//   1. tile sort: a block reads a 1024-lane tile straight from the input
//      columns as records of W = num_keys + 1 words (the keys, biased to
//      order-preserving unsigned words, then the lane index), one record
//      per thread.  Each warp sorts its 32 records with a bitonic network
//      in registers (shuffles, no block barrier); five merge-path levels in
//      shared memory double the runs up to the tile.  A short last tile is
//      filled in shared memory only, with records that sort after every
//      real one (all-ones keys, lane index >= n).
//   2. merge levels: ceil(log2(tiles)) levels over two ping-pong run
//      buffers in device memory.  A level cuts the n outputs into chunks of
//      1024; a block finds its chunk's two merge-path splits with 32-way
//      warp searches, stages the chunk's inputs in shared memory and each
//      thread merges one output.  Records are distinct (the lane word), so
//      every correct merge gives the one stable order.
//   3. the epilogue runs inside the last level (or the only tile): each
//      thread gathers every column by its sorted lane index, marks a start
//      where key >> shift differs from the record before it, and a
//      block-wide max-scan gives the start index.  Each block publishes the
//      last start of its range; after one more barrier, the positions
//      before a block's first start take the largest start published
//      before it.
//
// What bounds it.  The function must read its inputs and write its
// outputs once: n x (8 n_in + 5) bytes, 1.4 MB for the lock pack at 81,920
// lanes, 0.4 us at 3.35 TB/s.  At that size it is bound by latency
// instead: 80 tiles and 7 merge levels make 9 phases, and each phase is a
// chain of dependent steps (a grid barrier, the split search, the staging
// loads and the merge, each an L2 or shared-memory round trip), with most
// SMs idle in the tile sort.  The design keeps the
// phases few: no padding to a power of two, no pass per stride, no host
// launch between phases, and no separate epilogue pass.
//
// Plain C interface, loaded through ctypes (deneva_tpu_torch/ops/fused.py):
// the launch goes on the caller's stream, nothing synchronises, nothing
// allocates; an error code is returned.  The grid must be co-resident
// (cudaLaunchCooperativeKernel refuses it otherwise, and the caller
// raises), so a grid barrier cannot deadlock.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;    // records per tile, one per thread
constexpr int kChunk = kThreads;   // merge outputs per chunk, one per thread
constexpr int kMaxCols = 24;       // MAX_OPERANDS in ops/fused.py
constexpr int kMaxKeys = 3;        // MAX_KEYS in ops/fused.py
constexpr int kMaxLanes = 1 << 23;  // packed entry-index limit (cc/twopl.py)
constexpr int kMaxDevices = 64;

struct Params {
  const int32_t* in[kMaxCols];
  int32_t* out[kMaxCols];
  int n_in, n, shift, levels;
  uint32_t* buf[2];     // ping-pong run buffers, n records each
  uint8_t* starts;
  int32_t* sidx;
  int32_t* block_last;  // one word per block
};

template <int W>
struct Rec {
  uint32_t w[W];
};

// signed int32 -> unsigned word with the same order, and back
__device__ __forceinline__ uint32_t biased(int32_t v) {
  return static_cast<uint32_t>(v) ^ 0x80000000u;
}
__device__ __forceinline__ int32_t shifted_key(uint32_t word, int shift) {
  return static_cast<int32_t>(word ^ 0x80000000u) >> shift;
}

template <int W>
__device__ __forceinline__ bool rec_less(const Rec<W>& a,
                                         const Rec<W>& b) {
  bool lt = false, eq = true;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    lt = lt || (eq && a.w[k] < b.w[k]);
    eq = eq && (a.w[k] == b.w[k]);
  }
  return lt;
}

// a tile or a staged chunk in shared memory, one array per word
template <int W>
struct Smem {
  uint32_t w[W][kTile];
};

template <int W>
__device__ __forceinline__ Rec<W> load_s(const Smem<W>& s, int q) {
  Rec<W> r;
#pragma unroll
  for (int k = 0; k < W; ++k) r.w[k] = s.w[k][q];
  return r;
}

template <int W>
__device__ __forceinline__ void store_s(Smem<W>& s, int q, const Rec<W>& r) {
#pragma unroll
  for (int k = 0; k < W; ++k) s.w[k][q] = r.w[k];
}

// run buffers are written by other blocks before a grid barrier: read them
// through L2 (ld.global.cg), never through a possibly stale L1 line
template <int W>
__device__ __forceinline__ Rec<W> load_g(const uint32_t* buf, int i) {
  Rec<W> r;
#pragma unroll
  for (int k = 0; k < W; ++k) r.w[k] = __ldcg(buf + i * W + k);
  return r;
}

template <int W>
__device__ __forceinline__ void store_g(uint32_t* buf, int i,
                                        const Rec<W>& r) {
#pragma unroll
  for (int k = 0; k < W; ++k) buf[i * W + k] = r.w[k];
}

// Output `diag` of merge(A, B) for the sorted shared-memory runs A = [a0,
// a0 + na) and B = [b0, b0 + nb), diag < na + nb: a merge-path binary
// search for the number of A records before it, then the smaller head.
template <int W>
__device__ __forceinline__ Rec<W> merge_at(const Smem<W>& s, int a0, int na,
                                           int b0, int nb, int diag) {
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (lo < hi) {  // the first m with A[m] after B[diag - 1 - m]
    const int mid = (lo + hi) >> 1;
    if (rec_less<W>(load_s<W>(s, a0 + mid),
                    load_s<W>(s, b0 + diag - 1 - mid)))
      lo = mid + 1;
    else
      hi = mid;
  }
  const int a = lo, b = diag - lo;
  if (b >= nb) return load_s<W>(s, a0 + a);
  if (a >= na) return load_s<W>(s, b0 + b);
  const Rec<W> ra = load_s<W>(s, a0 + a), rb = load_s<W>(s, b0 + b);
  return rec_less<W>(ra, rb) ? ra : rb;
}

// Bitonic sort of a warp's 32 records, lane l holding position l, by
// shuffles: no shared memory, no block barrier.
template <int W>
__device__ __forceinline__ void warp_sort(Rec<W>& r) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      Rec<W> v;
#pragma unroll
      for (int w = 0; w < W; ++w)
        v.w[w] = __shfl_xor_sync(0xFFFFFFFFu, r.w[w], j);
      // the lower lane of an ascending pair keeps the smaller record
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      if (rec_less<W>(v, r) == keep_min) r = v;
    }
  }
}

// Small shared state of a block, beside the record tile.
struct Shared {
  int split[2];            // merge-path splits of the current chunk
  int warp_tot[kWarps];    // per-warp maxima of a block scan
  uint32_t key[kChunk];    // word 0 of each merged record of the chunk
  uint32_t before;         // word 0 of the record before the chunk
  int first_start;         // first segment start in this block's range
  int carry;               // last start before this block's range
};

// Inclusive max-scan of v over the block (v >= 0); *total gets the
// block's maximum.
__device__ __forceinline__ int block_max_scan(int v, Shared& sh,
                                              int* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v = max(v, o);
  }
  if (lane == 31) sh.warp_tot[warp] = v;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int t = sh.warp_tot[k];
    if (k < warp) before = max(before, t);
    all = max(all, t);
  }
  __syncthreads();  // warp_tot is rewritten by the next call
  *total = all;
  return max(before, v);
}

// The epilogue for one row of sorted positions: thread t holds position
// i = row + t (valid or not), word 0 and the lane index of its record, and
// word 0 of the record before it.  Gathers every column by the sorted
// lane, marks the starts of key >> shift and writes the start index, which
// `running` (the last start so far in this block's range) carries from row
// to row.  Every thread of the block calls it.
__device__ void scan_row(const Params& p, Shared& sh, int i, bool valid,
                         uint32_t key, uint32_t lane, uint32_t before,
                         int& running) {
  bool st = false;
  if (valid) {
    const int src = static_cast<int>(lane);
    // every load before any store: an output may alias an input for all
    // the compiler knows
    for (int c0 = 0; c0 < p.n_in; c0 += 4) {
      int32_t v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c0 + c < p.n_in) v[c] = __ldg(p.in[c0 + c] + src);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c0 + c < p.n_in) p.out[c0 + c][i] = v[c];
    }
    st = i == 0 ||
         shifted_key(key, p.shift) != shifted_key(before, p.shift);
    p.starts[i] = st ? 1 : 0;
  }
  const unsigned int starts = __ballot_sync(0xFFFFFFFFu, st);
  if ((threadIdx.x & 31) == 0 && starts != 0)
    atomicMin(&sh.first_start, i + __ffs(starts) - 1);
  int all;
  const int incl = block_max_scan(st ? i : 0, sh, &all);
  if (valid) p.sidx[i] = max(running, incl);
  running = max(running, all);
}

// Phase 1 for one tile: each warp sorts its 32 records in registers, then
// merge-path merges of doubling runs in shared memory up to the tile.  The
// sorted real records go to buf[0]; when the whole input is this one tile,
// the epilogue runs on them here instead.
template <int W>
__device__ void sort_tile(const Params& p, Smem<W>& s, Shared& sh, int tile,
                          int& running) {
  const int t = threadIdx.x;
  const int base = tile * kTile;
  const int len = min(kTile, p.n - base);
  Rec<W> r;
#pragma unroll
  for (int k = 0; k < W - 1; ++k)
    r.w[k] = t < len ? biased(__ldg(p.in[k] + base + t)) : 0xFFFFFFFFu;
  r.w[W - 1] = static_cast<uint32_t>(base + t);
  warp_sort<W>(r);
  store_s<W>(s, t, r);
  __syncthreads();
  for (int run = 32; run < kTile; run <<= 1) {
    const int start = t & ~(2 * run - 1);
    r = merge_at<W>(s, start, run, start + run, run, t - start);
    __syncthreads();
    store_s<W>(s, t, r);
    __syncthreads();
  }
  if (p.levels == 0) {  // the only tile: base 0, len n
    scan_row(p, sh, t, t < len, r.w[0], r.w[W - 1],
             t > 0 ? s.w[0][t - 1] : 0u, running);
  } else if (t < len) {
    store_g<W>(p.buf[0], base + t, r);
  }
  __syncthreads();  // the next tile reuses the shared memory
}

// Merge-path split on device-memory runs A = [a0, a0 + na) and B = [b0,
// b0 + nb), by one warp: the number of A records among the first `diag`
// outputs of merge(A, B).  The predicate A[m] < B[diag - 1 - m] holds on a
// prefix of [lo, hi); each round probes 32 evenly spaced points and keeps
// the one interval where it turns.
template <int W>
__device__ int warp_split(const uint32_t* src, int a0, int na, int b0,
                          int nb, int diag, int lane) {
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int m = lo + lane * step;
    const bool t = m < hi && rec_less<W>(load_g<W>(src, a0 + m),
                                         load_g<W>(src, b0 + diag - 1 - m));
    const int cnt = __popc(__ballot_sync(0xFFFFFFFFu, t));
    if (cnt == 0) return lo;
    const int next_lo = lo + (cnt - 1) * step + 1;
    hi = min(hi, lo + cnt * step);
    lo = next_lo;
  }
  const int m = lo + lane;
  const bool t = m < hi && rec_less<W>(load_g<W>(src, a0 + m),
                                       load_g<W>(src, b0 + diag - 1 - m));
  return lo + __popc(__ballot_sync(0xFFFFFFFFu, t));
}

// Phase 2, one level over this block's chunks [c_begin, c_end): runs of
// `run` records in src -> runs of 2 * run in dst.  kChunk divides 2 * run,
// so a chunk never crosses a pair of runs.  Thread t stages one input
// record of the chunk and merges output o0 + t.  The last level writes no
// records: it runs the epilogue on the merged chunk instead.
template <int W>
__device__ void merge_level(const Params& p, Smem<W>& s, Shared& sh,
                            const uint32_t* src, uint32_t* dst, int run,
                            int c_begin, int c_end, bool last,
                            int& running) {
  const int n = p.n, t = threadIdx.x, warp = t >> 5;
  for (int c = c_begin; c < c_end; ++c) {
    const int o0 = c * kChunk, o1 = min(o0 + kChunk, n);
    const int start = o0 & ~(2 * run - 1);
    const int na = min(run, n - start);
    const int b0 = start + na;
    const int nb = max(0, min(run, n - b0));
    if (warp < 2) {
      const int i = warp_split<W>(src, start, na, b0, nb,
                                  (warp == 0 ? o0 : o1) - start, t & 31);
      if ((t & 31) == 0) sh.split[warp] = i;
    }
    __syncthreads();
    const int i0 = sh.split[0], i1 = sh.split[1];
    const int j0 = o0 - start - i0, j1 = o1 - start - i1;
    const int ca = i1 - i0, total = o1 - o0;
    const bool valid = t < total;
    if (valid)
      store_s<W>(s, t, t < ca ? load_g<W>(src, start + i0 + t)
                              : load_g<W>(src, b0 + j0 + t - ca));
    if (last && t == 0 && o0 > 0) {
      // the last level is one pair (start 0): the record before o0 is the
      // larger of the last A and the last B record before the split
      const bool has_a = i0 > 0, has_b = j0 > 0;
      const Rec<W> a = has_a ? load_g<W>(src, start + i0 - 1) : Rec<W>{};
      const Rec<W> b = has_b ? load_g<W>(src, b0 + j0 - 1) : Rec<W>{};
      sh.before = (!has_b || (has_a && rec_less<W>(b, a))) ? a.w[0] : b.w[0];
    }
    __syncthreads();
    const Rec<W> r = valid ? merge_at<W>(s, 0, ca, ca, j1 - j0, t) : Rec<W>{};
    if (!last) {
      if (valid) store_g<W>(dst, o0 + t, r);
    } else {
      sh.key[t] = r.w[0];
      __syncthreads();
      scan_row(p, sh, o0 + t, valid, r.w[0], r.w[W - 1],
               t > 0 ? sh.key[t - 1] : sh.before, running);
    }
    __syncthreads();  // the next chunk reuses the shared memory
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    fused_sort_scan_kernel(const Params p) {
  __shared__ Smem<W> s;
  __shared__ Shared sh;
  cg::grid_group grid = cg::this_grid();
  const int n = p.n;

  // this block's chunks of every merge level, and its range of sorted
  // positions in the epilogue: all of them in block 0 without merge levels
  const int chunks = (n + kChunk - 1) / kChunk;
  const int per = (chunks + gridDim.x - 1) / gridDim.x;
  const int c_begin = min(chunks, static_cast<int>(blockIdx.x) * per);
  const int c_end = min(chunks, c_begin + per);
  const int lo = p.levels ? min(n, c_begin * kChunk) : (blockIdx.x ? n : 0);
  const int hi = p.levels ? min(n, c_end * kChunk) : n;
  if (threadIdx.x == 0) sh.first_start = hi;
  int running = 0;  // the last start at or before the current position

  // 1. tile sort
  const int tiles = (n + kTile - 1) / kTile;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    sort_tile<W>(p, s, sh, t, running);

  // 2. merge levels, the epilogue fused into the last
  int run = kTile;
  for (int l = 0; l < p.levels; ++l, run <<= 1) {
    grid.sync();
    merge_level<W>(p, s, sh, p.buf[l & 1], p.buf[(l + 1) & 1], run, c_begin,
                   c_end, l == p.levels - 1, running);
  }
  if (threadIdx.x == 0) p.block_last[blockIdx.x] = running;
  grid.sync();

  // 3. positions before this range's first start belong to a segment that
  // started in an earlier range: the largest start published before it
  if (threadIdx.x < 32) {
    int m = 0;
    for (int k = threadIdx.x; k < static_cast<int>(blockIdx.x); k += 32)
      m = max(m, __ldcg(p.block_last + k));
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      m = max(m, __shfl_xor_sync(0xFFFFFFFFu, m, d));
    if (threadIdx.x == 0) sh.carry = m;
  }
  __syncthreads();
  for (int i = lo + threadIdx.x; i < sh.first_start; i += kThreads)
    p.sidx[i] = sh.carry;
}

int merge_levels(int n) {
  int levels = 0;
  while ((static_cast<long long>(kTile) << levels) < n) ++levels;
  return levels;
}

int chunk_count(int n) { return (n + kChunk - 1) / kChunk; }

const void* kernel_for(int num_keys) {
  switch (num_keys) {
    case 1: return reinterpret_cast<const void*>(fused_sort_scan_kernel<2>);
    case 2: return reinterpret_cast<const void*>(fused_sort_scan_kernel<3>);
    default: return reinterpret_cast<const void*>(fused_sort_scan_kernel<4>);
  }
}

// The grid of a call: the co-resident blocks on the current device for
// the W = num_keys + 1 kernel (blocks per SM x SMs, cached per device),
// capped at the merge chunks.
cudaError_t grid_size(int num_keys, int n, int* out) {
  static int cache[kMaxDevices][kMaxKeys + 1];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int resident = dev < kMaxDevices ? cache[dev][num_keys] : 0;
  if (resident == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      dev)) != cudaSuccess)
      return err;
    if (!coop) return cudaErrorNotSupported;
    if ((err = cudaDeviceGetAttribute(
             &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel_for(num_keys), kThreads, 0)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    resident = per_sm * sms;
    if (dev < kMaxDevices) cache[dev][num_keys] = resident;
  }
  *out = resident < chunk_count(n) ? resident : chunk_count(n);
  return cudaSuccess;
}

bool valid(int n_in, int num_keys, int n) {
  return n_in >= 1 && n_in <= kMaxCols && num_keys >= 1 &&
         num_keys <= kMaxKeys && num_keys <= n_in && n >= 1 &&
         n <= kMaxLanes;
}

}  // namespace

extern "C" {

// int32 words of scratch one call needs: the two run buffers, then one
// word per block (at most one block per merge chunk).
long long dn_scratch_words(int num_keys, int n) {
  return 2LL * (num_keys + 1) * n + chunk_count(n);
}

// The launch a call of this shape makes on the current device:
// plan[0] = blocks, plan[1] = threads per block, plan[2] = records per
// tile, plan[3] = merge levels, plan[4] = outputs per merge chunk.
// Returns 0 or a cudaError_t code.
int dn_launch_plan(int num_keys, int n, int* plan) {
  if (!valid(num_keys, num_keys, n))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = grid_size(num_keys, n, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan[1] = kThreads;
  plan[2] = kTile;
  plan[3] = merge_levels(n);
  plan[4] = kChunk;
  return 0;
}

const char* dn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ins: n_in device pointers to int32 columns of length n; outs: n_in device
// pointers receiving the sorted columns; starts: uint8 output of length n
// (0/1); sidx: int32 output of length n; scratch: dn_scratch_words int32
// words.  Returns 0 or a cudaError_t code.
int dn_fused_sort_scan(void* const* ins, int n_in, int num_keys, int n,
                       int shift, void* const* outs, void* starts,
                       void* sidx, void* scratch, void* stream_ptr) {
  if (!valid(n_in, num_keys, n) || shift < 0 || shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  int grid;
  cudaError_t err = grid_size(num_keys, n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);

  Params p{};
  for (int c = 0; c < n_in; ++c) {
    p.in[c] = static_cast<const int32_t*>(ins[c]);
    p.out[c] = static_cast<int32_t*>(outs[c]);
  }
  p.n_in = n_in;
  p.n = n;
  p.shift = shift;
  p.levels = merge_levels(n);
  const long long words = static_cast<long long>(num_keys + 1) * n;
  p.buf[0] = static_cast<uint32_t*>(scratch);
  p.buf[1] = p.buf[0] + words;
  p.starts = static_cast<uint8_t*>(starts);
  p.sidx = static_cast<int32_t*>(sidx);
  p.block_last = reinterpret_cast<int32_t*>(p.buf[1] + words);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel_for(num_keys), dim3(grid),
                                    dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream_ptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
