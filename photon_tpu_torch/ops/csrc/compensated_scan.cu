// Compensated prefix scan (CS) on Hopper.
//
// Replaces photon_tpu/ops/vperm.py::_compensated_cumsum, an XLA
// associative_scan (no pl.pallas_call) that is the reduce of the xchg route's
// cumsum mode.  Over a flat float32 stream x it writes the inclusive prefix
// sums as a (hi, lo) pair of float32 streams whose sum carries about 48 bits:
// the combine of two pairs a and b is Knuth's two-sum of the high parts, its
// exact rounding error added to the low parts:
//   s = a.hi + b.hi;  z = s - a.hi;  err = (a.hi - (s - z)) + (b.hi - z);
//   (a + b) = (s, err + a.lo + b.lo)
// The error term is exact only in round-to-nearest without reassociation or
// contraction, so every operation of the combine is an explicit __fadd_rn /
// __fsub_rn: no compiler flag can fold it into a plain float32 cumsum.
//
// What bounds it: device-memory bytes.  x is read and hi and lo written, 12
// bytes an element, while the combine costs 8 adds an element.  This design
// reads x twice, 16 bytes an element.
//
// Design (three passes, a tile = 256 threads x 16 consecutive elements):
//   1. every block stages its tile through shared memory (coalesced loads),
//      each thread combines its 16 elements in order, the threads' totals are
//      scanned with warp shuffles and across the 8 warps, and the block writes
//      its tile's total;
//   2. one block scans the tile totals (each thread a run of them in order,
//      then the same block scan) into exclusive per-tile prefixes;
//   3. every block rescans its tile as in pass 1, seeds each thread with the
//      tile's prefix and the threads before it, and writes hi and lo through
//      shared memory (coalesced stores).
// The result does not depend on the launch: no atomics, no order that varies
// between runs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kScanWarps = kScanThreads / 32;

struct Pair {
  float hi;
  float lo;
};

__device__ __forceinline__ Pair combine(Pair a, Pair b) {
  const float s = __fadd_rn(a.hi, b.hi);
  const float z = __fsub_rn(s, a.hi);
  const float err = __fadd_rn(__fsub_rn(a.hi, __fsub_rn(s, z)), __fsub_rn(b.hi, z));
  return Pair{s, __fadd_rn(__fadd_rn(err, a.lo), b.lo)};
}

__device__ __forceinline__ Pair shfl_up(Pair p, int delta) {
  return Pair{__shfl_up_sync(0xffffffffu, p.hi, delta),
              __shfl_up_sync(0xffffffffu, p.lo, delta)};
}

// Padded shared-memory index: thread t's 16 consecutive elements fall in 16
// distinct banks across a warp.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Exclusive block scan of one pair a thread (nthreads = 32 * nwarps threads):
// returns the combine of the pairs of the threads before this one ({0, 0} for
// thread 0) and sets *total to the combine of all of them.
template <int kNWarps>
__device__ Pair block_exclusive(Pair v, Pair* warp_sums, Pair* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Pair inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Pair up = shfl_up(inc, d);
    if (lane >= d) inc = combine(up, inc);
  }
  Pair exc = shfl_up(inc, 1);
  if (lane == 0) exc = Pair{0.0f, 0.0f};
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Pair w = lane < kNWarps ? warp_sums[lane] : Pair{0.0f, 0.0f};
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Pair up = shfl_up(w, d);
      if (lane >= d) w = combine(up, w);
    }
    Pair wexc = shfl_up(w, 1);
    if (lane == 0) wexc = Pair{0.0f, 0.0f};
    if (lane < kNWarps) warp_sums[lane] = wexc;
    if (lane == kNWarps - 1) warp_sums[kNWarps] = w;
  }
  __syncthreads();
  *total = warp_sums[kNWarps];
  const Pair wprefix = warp_sums[warp];
  return warp > 0 ? (lane > 0 ? combine(wprefix, exc) : wprefix) : exc;
}

// Loads a tile (zeros past n) and combines this thread's 16 elements in order.
__device__ Pair load_tile(const float* __restrict__ x, int64_t n, float* tile,
                          float (&v)[kItems]) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int64_t g = base + i;
    tile[pad(i)] = g < n ? x[g] : 0.0f;
  }
  __syncthreads();
  Pair acc{0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    v[j] = tile[pad(threadIdx.x * kItems + j)];
    acc = combine(acc, Pair{v[j], 0.0f});
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads) tile_totals_kernel(
    const float* __restrict__ x, int64_t n, float* __restrict__ tot_hi,
    float* __restrict__ tot_lo) {
  __shared__ float tile[kTile + kTile / 32];
  __shared__ Pair warp_sums[kWarps + 1];
  float v[kItems];
  const Pair mine = load_tile(x, n, tile, v);
  Pair total;
  block_exclusive<kWarps>(mine, warp_sums, &total);
  if (threadIdx.x == 0) {
    tot_hi[blockIdx.x] = total.hi;
    tot_lo[blockIdx.x] = total.lo;
  }
}

__global__ void __launch_bounds__(kScanThreads) tile_prefix_kernel(
    const float* __restrict__ tot_hi, const float* __restrict__ tot_lo,
    int tiles, float* __restrict__ pre_hi, float* __restrict__ pre_lo) {
  __shared__ Pair warp_sums[kScanWarps + 1];
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int first = threadIdx.x * per;
  const int last = min(first + per, tiles);
  Pair acc{0.0f, 0.0f};
  for (int t = first; t < last; ++t) acc = combine(acc, Pair{tot_hi[t], tot_lo[t]});
  Pair total;
  Pair run = block_exclusive<kScanWarps>(acc, warp_sums, &total);
  for (int t = first; t < last; ++t) {
    pre_hi[t] = run.hi;
    pre_lo[t] = run.lo;
    run = combine(run, Pair{tot_hi[t], tot_lo[t]});
  }
}

__global__ void __launch_bounds__(kThreads) tile_scan_kernel(
    const float* __restrict__ x, int64_t n, const float* __restrict__ pre_hi,
    const float* __restrict__ pre_lo, float* __restrict__ hi,
    float* __restrict__ lo) {
  __shared__ float tile[kTile + kTile / 32];
  __shared__ float tile_lo[kTile + kTile / 32];
  __shared__ Pair warp_sums[kWarps + 1];
  float v[kItems];
  const Pair mine = load_tile(x, n, tile, v);
  Pair total;
  const Pair before = block_exclusive<kWarps>(mine, warp_sums, &total);
  const Pair seed{pre_hi[blockIdx.x], pre_lo[blockIdx.x]};
  Pair run = blockIdx.x == 0 ? before
             : (threadIdx.x == 0 ? seed : combine(seed, before));
  // Every thread has read its tile elements into registers (the block scan's
  // barriers lie between), so the tile buffer takes the hi results.
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    run = combine(run, Pair{v[j], 0.0f});
    const int i = pad(threadIdx.x * kItems + j);
    tile[i] = run.hi;
    tile_lo[i] = run.lo;
  }
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int64_t g = base + i;
    if (g < n) {
      hi[g] = tile[pad(i)];
      lo[g] = tile_lo[pad(i)];
    }
  }
}

}  // namespace

// Inclusive compensated scan of x[0, n) into hi and lo on `stream`.
// `scratch` holds 4 * ceil(n / 4096) floats.  Returns the CUDA error code
// (0 on success).
extern "C" int photon_compensated_scan(const float* x, int64_t n, float* hi,
                                       float* lo, float* scratch,
                                       void* stream_ptr) {
  if (n <= 0) return n == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles64 = (n + kTile - 1) / kTile;
  if (tiles64 > (int64_t{1} << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>(tiles64);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* tot_hi = scratch;
  float* tot_lo = scratch + tiles;
  float* pre_hi = scratch + 2 * static_cast<int64_t>(tiles);
  float* pre_lo = scratch + 3 * static_cast<int64_t>(tiles);
  tile_totals_kernel<<<tiles, kThreads, 0, stream>>>(x, n, tot_hi, tot_lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_prefix_kernel<<<1, kScanThreads, 0, stream>>>(tot_hi, tot_lo, tiles, pre_hi,
                                                      pre_lo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_scan_kernel<<<tiles, kThreads, 0, stream>>>(x, n, pre_hi, pre_lo, hi, lo);
  return static_cast<int>(cudaGetLastError());
}
