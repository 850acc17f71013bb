// Slab position-reduce on Hopper.
//
// Replaces photon_tpu/ops/pallas_gather.py::_position_reduce_kernel.  Over a
// slab-aligned layout (tiles of 128 sublanes x 128 lanes, each tile reading
// one slab of 8 positions x 128 lanes, slab_of_tile non-decreasing):
//   out[s * 8 + p, l] = sum over tiles t of slab s, sublanes r of
//                       pv[t * 128 + r, l] * [lo[t * 128 + r, l] == p]
//
// What bounds it: the pv and lo streams (8 bytes per padded entry), read
// once; the output is 1/16 of the input.  Device-memory bandwidth is the
// bound; the arithmetic (8 masked adds per entry) is far below it.
//
// Design: pass 1 runs one block per tile and one thread per lane; each thread
// keeps the 8 position sums in registers over the tile's 128 sublanes (loads
// coalesce across the lanes of a sublane) and writes a per-tile partial.
// Pass 2 runs one block per slab and one thread per (position, lane); it finds
// its slab's run of tiles by binary search in slab_of_tile and sums their
// partials in tile order.  The TPU kernel zeroes a slab's output on its first
// tile and accumulates across grid steps that run in order; CUDA blocks run in
// no order, so the cross-tile sum is a second, deterministic pass instead of
// atomics: the result does not change from run to run, and every slab is
// written, including a slab with no tiles (it gets zeros).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kPositions = 8;
constexpr int kTileSublanes = 128;
constexpr int kSlabCells = kPositions * kLanes;

__global__ void __launch_bounds__(kLanes) tile_partials_kernel(
    const float* __restrict__ pv, const int32_t* __restrict__ lo,
    float* __restrict__ tile_out) {
  const int lane = threadIdx.x;
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTileSublanes * kLanes + lane;
  float acc[kPositions];
#pragma unroll
  for (int q = 0; q < kPositions; ++q) acc[q] = 0.0f;
#pragma unroll 4
  for (int r = 0; r < kTileSublanes; ++r) {
    const float v = pv[base + r * kLanes];
    const int p = lo[base + r * kLanes];
#pragma unroll
    for (int q = 0; q < kPositions; ++q) acc[q] += (p == q) ? v : 0.0f;
  }
  float* o = tile_out + static_cast<int64_t>(blockIdx.x) * kSlabCells + lane;
#pragma unroll
  for (int q = 0; q < kPositions; ++q) o[q * kLanes] = acc[q];
}

__device__ int lower_bound(const int32_t* __restrict__ a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kSlabCells) slab_combine_kernel(
    const int32_t* __restrict__ slab_of_tile, int n_tiles,
    const float* __restrict__ tile_out, float* __restrict__ out) {
  __shared__ int range[2];
  const int s = blockIdx.x;
  if (threadIdx.x == 0) {
    range[0] = lower_bound(slab_of_tile, n_tiles, s);
    range[1] = lower_bound(slab_of_tile, n_tiles, s + 1);
  }
  __syncthreads();
  float acc = 0.0f;
  for (int t = range[0]; t < range[1]; ++t) {
    acc += tile_out[static_cast<int64_t>(t) * kSlabCells + threadIdx.x];
  }
  out[static_cast<int64_t>(s) * kSlabCells + threadIdx.x] = acc;
}

}  // namespace

// Launches both passes on `stream`.  `tile_out` is scratch of
// n_tiles * 1024 floats; `out` receives n_slabs * 1024 floats (all written).
// Returns the CUDA error code (0 on success).
extern "C" int photon_position_reduce(const int32_t* slab_of_tile,
                                      const float* pv, const int32_t* lo,
                                      int n_tiles, int n_slabs,
                                      float* tile_out, float* out,
                                      void* stream_ptr) {
  if (n_tiles < 0 || n_slabs <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_tiles > 0) {
    tile_partials_kernel<<<n_tiles, kLanes, 0, stream>>>(pv, lo, tile_out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  slab_combine_kernel<<<n_slabs, kSlabCells, 0, stream>>>(slab_of_tile, n_tiles,
                                                          tile_out, out);
  return static_cast<int>(cudaGetLastError());
}
