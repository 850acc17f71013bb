// Fused sparse GLM value-and-gradient on Hopper.
//
// Replaces photon_tpu/ops/pallas_sparse.py::_kernel (the Pallas kernel that
// fuses margin, pointwise loss, loss sum and gradient scatter over a padded
// COO batch).  Per row i of ids/vals [n, k]:
//   margin_i = sum_j w[ids_ij] * vals_ij + offset_i
//   value   += weight_i * loss(margin_i, label_i)
//   grad[ids_ij] += weight_i * d1(margin_i, label_i) * vals_ij
// No regularization: the caller adds the analytic L2 term.
//
// What bounds it: the ids and vals streams (8 bytes per entry) are read once
// from device memory; w (4 bytes per feature) stays in L2 for the gather.
// The scatter is one float atomic per non-zero entry into grad, which also
// stays in L2; under skewed ids (zipf) many atomics land on the same few
// addresses and serialise there, so the kernel is bound by L2 atomic
// throughput long before device-memory bandwidth.
//
// Design: one warp per row (a grid-stride loop over rows), one lane per entry
// so a warp reads 128 contiguous bytes of ids and of vals; the margin is a
// warp butterfly sum, which leaves the same value in every lane, so each lane
// evaluates the loss itself and scatters its own entries.  Lanes of a row
// that hold the same feature (found with __match_any_sync) sum their terms
// in the warp first, and one of them issues the atomic, so a hot feature
// costs one atomic per row instead of one per occurrence.  Entries with a
// zero value or a zero coefficient are skipped: they add exactly 0, and
// skipping them keeps the pad slots (id 0, val 0) from piling atomics onto
// grad[0].  An id outside [0, d) is never dereferenced: the gather sets a
// flag instead, and the wrapper raises on it as the plain version does.
// The loss value is reduced deterministically: a fixed-order sum per
// block into a partials buffer, then one block sums the partials.  The TPU
// kernel's sequential accumulation across grid steps is not carried over:
// CUDA blocks run in parallel and in no order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSumThreads = 1024;
// Same cap as photon_tpu/core/losses.py _POISSON_MAX_EXPONENT.
constexpr float kPoissonMaxExponent = 30.0f;

enum Loss { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };

template <int LOSS>
__device__ __forceinline__ void loss_value_d1(float z, float y, float& value,
                                              float& d1) {
  if (LOSS == kLogistic) {
    // Stable log(1 + e^z) - y z, with the analytic derivative sigmoid(z) - y.
    value = fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z))) - y * z;
    d1 = 1.0f / (1.0f + expf(-z)) - y;
  } else if (LOSS == kSquared) {
    const float d = z - y;
    value = 0.5f * d * d;
    d1 = d;
  } else if (LOSS == kPoisson) {
    // e^z capped at e^30 and continued linearly past the cap.
    const float ez = expf(fminf(z, kPoissonMaxExponent));
    value = ez + ez * fmaxf(z - kPoissonMaxExponent, 0.0f) - y * z;
    d1 = ez - y;
  } else {
    // Smoothed hinge on labels {0, 1} mapped to +-1.
    const float ys = 2.0f * y - 1.0f;
    const float t = ys * z;
    value = t <= 0.0f ? 0.5f - t : (t < 1.0f ? 0.5f * (1.0f - t) * (1.0f - t) : 0.0f);
    const float dt = t <= 0.0f ? -1.0f : (t < 1.0f ? t - 1.0f : 0.0f);
    d1 = ys * dt;
  }
}

template <int LOSS>
__global__ void __launch_bounds__(kThreads) fused_value_grad_kernel(
    const float* __restrict__ w, const int32_t* __restrict__ ids,
    const float* __restrict__ vals, const float* __restrict__ label,
    const float* __restrict__ offset, const float* __restrict__ weight, int n,
    int k, int d, float* __restrict__ grad, float* __restrict__ block_value,
    int* __restrict__ bad_ids) {
  __shared__ float warp_value[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps_total = gridDim.x * kWarps;
  float acc = 0.0f;
  for (int row = blockIdx.x * kWarps + warp; row < n; row += warps_total) {
    const int64_t base = static_cast<int64_t>(row) * k;
    float m = 0.0f;
    for (int j = lane; j < k; j += 32) {
      const int id = ids[base + j];
      if (static_cast<unsigned>(id) < static_cast<unsigned>(d)) {
        m += w[id] * vals[base + j];
      } else {
        *bad_ids = 1;
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) m += __shfl_xor_sync(0xffffffffu, m, s);
    const float wt = weight[row];
    float value, d1;
    loss_value_d1<LOSS>(m + offset[row], label[row], value, d1);
    acc += wt * value;
    const float coeff = wt * d1;
    if (coeff == 0.0f) continue;  // the same in every lane
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + lane;
      const float v = j < k ? vals[base + j] : 0.0f;
      int id = v != 0.0f ? ids[base + j] : -1;
      // An id outside [0, d) was flagged by the gather: scatter nothing.
      if (static_cast<unsigned>(id) >= static_cast<unsigned>(d)) id = -1;
      float c = coeff * v;
      // Lanes holding the same feature add their terms first (in lane
      // order) and the lowest of them issues one atomic: under skewed ids
      // a row holds a hot feature many times.
      const unsigned peers = __match_any_sync(0xffffffffu, id);
      if (__any_sync(0xffffffffu, peers != (1u << lane))) {
        float sum = 0.0f;
        for (int src = 0; src < 32; ++src) {
          const float x = __shfl_sync(0xffffffffu, c, src);
          if ((peers >> src) & 1u) sum += x;
        }
        c = sum;
      }
      if (id >= 0 && lane == __ffs(peers) - 1) atomicAdd(&grad[id], c);
    }
  }
  if (lane == 0) warp_value[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < kWarps; ++i) s += warp_value[i];
    block_value[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kSumThreads) sum_partials_kernel(
    const float* __restrict__ partials, int count, float* __restrict__ out) {
  __shared__ float s[kSumThreads];
  float acc = 0.0f;
  for (int i = threadIdx.x; i < count; i += kSumThreads) acc += partials[i];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kSumThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s[threadIdx.x] += s[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = s[0];
}

}  // namespace

// Launches the fused kernel and the partials sum on `stream`.  `grad` must be
// zeroed by the caller; `partials` holds `partials_capacity` floats of
// scratch and bounds the grid.  `*bad_ids`, zeroed by the caller, becomes
// non-zero when any id lies outside [0, d); such entries are neither
// gathered nor scattered.  Returns the CUDA error code (0 on success).
extern "C" int photon_fused_value_grad(int loss, const float* w,
                                       const int32_t* ids, const float* vals,
                                       const float* label, const float* offset,
                                       const float* weight, int n, int k,
                                       int d, float* grad, float* partials,
                                       int partials_capacity, float* value,
                                       int* bad_ids, void* stream_ptr) {
  if (n <= 0 || k <= 0 || d <= 0 || partials_capacity <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int blocks = (n + kWarps - 1) / kWarps;
  if (blocks > partials_capacity) blocks = partials_capacity;
  switch (loss) {
    case kLogistic:
      fused_value_grad_kernel<kLogistic><<<blocks, kThreads, 0, stream>>>(
          w, ids, vals, label, offset, weight, n, k, d, grad, partials,
          bad_ids);
      break;
    case kSquared:
      fused_value_grad_kernel<kSquared><<<blocks, kThreads, 0, stream>>>(
          w, ids, vals, label, offset, weight, n, k, d, grad, partials,
          bad_ids);
      break;
    case kPoisson:
      fused_value_grad_kernel<kPoisson><<<blocks, kThreads, 0, stream>>>(
          w, ids, vals, label, offset, weight, n, k, d, grad, partials,
          bad_ids);
      break;
    case kSmoothedHinge:
      fused_value_grad_kernel<kSmoothedHinge><<<blocks, kThreads, 0, stream>>>(
          w, ids, vals, label, offset, weight, n, k, d, grad, partials,
          bad_ids);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, kSumThreads, 0, stream>>>(partials, blocks, value);
  return static_cast<int>(cudaGetLastError());
}
