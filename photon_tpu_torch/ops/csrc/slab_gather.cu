// Slab gather on Hopper.
//
// Replaces photon_tpu/ops/pallas_gather.py::_gather_kernel.  Over a
// slab-aligned layout (tiles of 128 sublanes x 128 lanes, each tile reading
// one slab of 8 positions x 128 lanes of the dictionary-gathered w2d):
//   out[t * 128 + s, l] = w2d[slab_of_tile[t] * 8 + lo[t * 128 + s, l], l]
//                         * vals[t * 128 + s, l]
// It is the forward of the benes route: per-slot products w[f] * val read
// from the small slab dictionary instead of a gather over all of w.
//
// What bounds it: the lo and vals streams and the output, 12 bytes a slot,
// each touched once; each tile also loads its slab's [8, 128] block of
// w2d (4 KB a tile, from L2 for the tiles of one slab after the first).
// Device-memory bandwidth is the bound (one multiply a slot).
//
// Design: one block per tile.  The block loads its slab's 4 KB block into
// shared memory, then each thread walks one lane down a quarter of the
// tile's sublanes: lo and vals loads and the output store coalesce across
// the 128 lanes of a sublane, and the shared-memory read w_s[lo][lane]
// puts a warp's 32 consecutive lanes on 32 different banks whatever lo
// holds.  The TPU kernel does the same lookup as 16 single-vreg
// dynamic_gathers of the [8, 128] slab.  lo is a 3-bit position by the
// layout's construction; the kernel masks it to 3 bits so that no input
// can read outside the slab block.  One f32 multiply a slot, so the result
// equals the plain version bit for bit.
//
// vals come as float32 or bfloat16 (the bf16 feature storage of
// data/batch.py batch_astype; the TPU kernel reads bf16 vals and multiplies
// in f32 by promotion): the kernel is templated on the value type and
// widens each value exactly before the one f32 multiply, so the bf16 form
// too equals its plain version bit for bit, and moves 10 bytes a slot.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kPositions = 8;
constexpr int kTileSublanes = 128;
constexpr int kSlabCells = kPositions * kLanes;
constexpr int kThreads = 512;
constexpr int kRowsPerPass = kThreads / kLanes;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename V>
__global__ void __launch_bounds__(kThreads) slab_gather_kernel(
    const float* __restrict__ w2d, const int32_t* __restrict__ slab_of_tile,
    const int32_t* __restrict__ lo, const V* __restrict__ vals,
    float* __restrict__ out) {
  __shared__ float w_s[kSlabCells];
  const int64_t slab = slab_of_tile[blockIdx.x];
  const float* w = w2d + slab * kSlabCells;
  for (int i = threadIdx.x; i < kSlabCells; i += kThreads) w_s[i] = w[i];
  __syncthreads();
  const int lane = threadIdx.x % kLanes;
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * kTileSublanes * kLanes + lane;
#pragma unroll 8
  for (int r = threadIdx.x / kLanes; r < kTileSublanes; r += kRowsPerPass) {
    const int64_t i = base + static_cast<int64_t>(r) * kLanes;
    out[i] = w_s[(lo[i] & (kPositions - 1)) * kLanes + lane] * to_float(vals[i]);
  }
}

}  // namespace

// Launches the gather on `stream`.  `vals` holds float32 values, or
// bfloat16 ones when `bf16` is non-zero.  `out` receives n_tiles * 128 * 128
// floats (all written).  Returns the CUDA error code (0 on success).
extern "C" int photon_slab_gather(const float* w2d, const int32_t* slab_of_tile,
                                  const int32_t* lo, const void* vals, int bf16,
                                  int n_tiles, float* out, void* stream_ptr) {
  if (n_tiles < 0) return cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bf16) {
    slab_gather_kernel<__nv_bfloat16><<<n_tiles, kThreads, 0, stream>>>(
        w2d, slab_of_tile, lo, static_cast<const __nv_bfloat16*>(vals), out);
  } else {
    slab_gather_kernel<float><<<n_tiles, kThreads, 0, stream>>>(
        w2d, slab_of_tile, lo, static_cast<const float*>(vals), out);
  }
  return static_cast<int>(cudaGetLastError());
}
