// Fused sparse GLM value-and-gradient, and the row scatter of the fused
// route's Hessian-vector product, on Hopper.
//
// photon_fused_value_grad replaces photon_tpu/ops/pallas_sparse.py::_kernel
// (the Pallas kernel that fuses margin, pointwise loss, loss sum and
// gradient scatter over a padded COO batch).  Per row i of ids/vals [n, k]:
//   margin_i = sum_j w[ids_ij] * vals_ij + offset_i
//   value   += weight_i * loss(margin_i, label_i)
//   grad[ids_ij] += weight_i * d1(margin_i, label_i) * vals_ij
// No regularization: the caller adds the analytic L2 term.
// photon_row_scatter is the same scatter with the per-row coefficient given
// and no gather or loss, out[ids_ij] += r_i * vals_ij: the X^T r of the
// fused route's Hessian-vector product, an XLA scatter in the JAX package
// (photon_tpu/core/objective.py:420).  It keeps the float64 contract of the
// port's scatter sums (data/batch.py scatter_sum): its atomics add into a
// float64 buffer that is rounded to float32 once.
//
// What bounds them: the ids and vals streams (8 bytes per entry) are read
// once from device memory; w (4 bytes per feature) stays in L2 for the
// gather.  The scatter is one atomic per non-zero entry into L2.  On uniform
// ids the L2's rate of random atomics bounds the kernel long before
// device-memory bandwidth; under skewed ids (zipf) the atomics of the few
// hot features land on the same addresses and serialise there.
//
// Design:
// - One warp per row, one lane per entry, so a warp reads 128 contiguous
//   bytes of ids and of vals.  At k <= 32 a lane of the fused kernel keeps
//   its entry in registers from the gather to the scatter, and a warp loads
//   and gathers kGroup rows at once before it works them in order, so that
//   enough dependent loads are in flight.  The margin is a warp butterfly
//   sum, which leaves the same value in every lane, so each lane evaluates
//   the loss itself.
// - Lanes of a row that hold the same feature (__match_any_sync) sum their
//   terms in lane order, and the lowest of them adds the sum.
// - Hot features.  The wrapper builds a hot set once per ids tensor: the
//   (at most kHot) most frequent features that hold a set share of the
//   entries, their number in hot[kHot].  Each block loads it into an
//   open-addressed table in shared memory.  A leader lane whose id is hot
//   adds into its warp's private slice of kHot floats with a plain add: the
//   leaders of one warp hold distinct ids, and no other warp writes the
//   slice.  So a hot feature takes no global atomic.  Cold ids keep the
//   global atomic.  The grid is persistent (the SM count times the blocks
//   an SM holds); at its end each block sums its warps' slices in warp
//   order, in float64, into its row of a [blocks, kHot] partials buffer, and
//   the epilogue kernel sums each hot slot over the blocks in a fixed order,
//   in float64, and writes (does not add) the feature's gradient.  No cold
//   atomic lands on a hot id, so nothing is lost, and the hot features'
//   gradient is the same from run to run.  Every id goes through its slot
//   or through an atomic, whatever the set holds: a stale or empty set costs
//   speed only.  A set known to be empty takes the form without the table,
//   the slices and their shared memory.
// - Entries with a zero value or a zero coefficient are skipped: they add
//   exactly 0, and skipping them keeps the pad slots (id 0, val 0) from
//   piling atomics onto grad[0].  An id outside [0, d) is never
//   dereferenced: the kernel sets a flag instead, and the wrapper raises on
//   it as the plain version does.
// - The loss value is reduced deterministically: a fixed-order sum per
//   block into a partials buffer, then one block of the epilogue sums the
//   partials.  The TPU kernel's sequential accumulation across grid steps is
//   not carried over: CUDA blocks run in parallel and in no order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSumThreads = 1024;
constexpr int kHot = 1024;          // hot slots: ops/fused_sparse.py HOT_SLOTS
constexpr int kTableBits = 11;
constexpr int kTable = 1 << kTableBits;  // the table is at most half full
constexpr int kEpilogueSlots = 32;  // hot slots per epilogue block
static_assert(kTable == 2 * kHot, "the hot table holds twice the slots");
// Shared memory of the form with the hot table: 8 KB of keys, 4 KB of
// slots, then the warp slices, 32 KB (44 KB in all, under the 48 KB a launch
// takes without an opt-in).
constexpr int kTableBytes = kTable * (sizeof(int) + sizeof(short));
constexpr size_t kHotSmem = kTableBytes + sizeof(float) * kWarps * kHot;
// Rows a warp of the fused kernel works on at once (k <= 32): their loads
// and gathers are in flight together.
constexpr int kGroup = 4;
// Same cap as photon_tpu/core/losses.py _POISSON_MAX_EXPONENT.
constexpr float kPoissonMaxExponent = 30.0f;

enum Loss { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };
constexpr int kRowScatter = -1;  // photon_fused_grid's code for the row scatter

// A block's view of its hot state in shared memory.
struct Hot {
  int* keys;       // [kTable] a hot id, or -1 for an empty entry
  short* slots;    // [kTable] its slot in [0, n_hot)
  float* slices;   // [kWarps][kHot] one private slice per warp
  int n_hot;
};

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

__device__ __forceinline__ unsigned table_hash(int id) {
  return (static_cast<unsigned>(id) * 2654435761u) >> (32 - kTableBits);
}

// Loads the hot set (ids hot[0, n_hot), n_hot = hot[kHot]) into the
// block's table and zeroes the warp slices.  build_hot_set's ids are distinct
// and inside [0, d).
__device__ __forceinline__ void load_hot(unsigned char* smem,
                                         const int32_t* __restrict__ hot, Hot& h) {
  h.keys = reinterpret_cast<int*>(smem);
  h.slots = reinterpret_cast<short*>(smem + kTable * sizeof(int));
  h.slices = reinterpret_cast<float*>(smem + kTableBytes);
  h.n_hot = min(max(hot[kHot], 0), kHot);
  for (int i = threadIdx.x; i < kTable; i += kThreads) h.keys[i] = -1;
  for (int i = threadIdx.x; i < kWarps * kHot; i += kThreads) h.slices[i] = 0.0f;
  __syncthreads();
  for (int slot = threadIdx.x; slot < h.n_hot; slot += kThreads) {
    const int id = hot[slot];
    if (id < 0) continue;
    unsigned at = table_hash(id);
    for (;;) {
      const int prev = atomicCAS(&h.keys[at], -1, id);
      if (prev == -1) {
        h.slots[at] = static_cast<short>(slot);
        break;
      }
      at = (at + 1) & (kTable - 1);
    }
  }
  __syncthreads();
}

// The slot of a hot id, or -1 for a cold one (id >= 0).
__device__ __forceinline__ int find_hot(const Hot& h, int id) {
  unsigned at = table_hash(id);
  for (;;) {
    const int key = h.keys[at];
    if (key == id) return h.slots[at];
    if (key < 0) return -1;
    at = (at + 1) & (kTable - 1);
  }
}

// One scatter step of a warp: every lane passes its entry's id (-1: nothing
// to add) and term.  Lanes with the same id sum their terms in lane order
// and the lowest of them adds the sum: into its warp's slice when the id is
// hot, else by an atomic into out.
template <bool HOT, typename T>
__device__ __forceinline__ void scatter_warp(int id, T c, int lane, const Hot& h,
                                             float* slice, T* __restrict__ out) {
  const unsigned peers = __match_any_sync(0xffffffffu, id);
  if (__any_sync(0xffffffffu, peers != (1u << lane))) {
    if constexpr (sizeof(T) == sizeof(double)) {
      // A double takes two shuffles a step: the leader reads its peers'
      // terms from shared memory instead, in the same lane order.
      __shared__ T peer_terms[kWarps][32];
      const int w = threadIdx.x >> 5;
      peer_terms[w][lane] = c;
      __syncwarp();
      if (lane == __ffs(peers) - 1) {
        T sum = 0;
        for (unsigned m = peers; m != 0; m &= m - 1) sum += peer_terms[w][__ffs(m) - 1];
        c = sum;
      }
      __syncwarp();
    } else {
      T sum = 0;
      for (int src = 0; src < 32; ++src) {
        const T x = __shfl_sync(0xffffffffu, c, src);
        if ((peers >> src) & 1u) sum += x;
      }
      c = sum;
    }
  }
  if (id >= 0 && lane == __ffs(peers) - 1) {
    int slot = -1;
    if constexpr (HOT) slot = find_hot(h, id);
    if (slot >= 0) {
      slice[slot] += static_cast<float>(c);
    } else {
      atomicAdd(&out[id], c);
    }
  }
  // The next step's leader of a hot id may be another lane of this warp.
  if constexpr (HOT) __syncwarp();
}

// At the end of a block: each hot slot's sum over the warp slices, in warp
// order and in float64, into the block's row of the partials.
__device__ __forceinline__ void flush_hot(const Hot& h,
                                          double* __restrict__ hot_partials) {
  __syncthreads();
  double* row = hot_partials + static_cast<int64_t>(blockIdx.x) * kHot;
  for (int slot = threadIdx.x; slot < h.n_hot; slot += kThreads) {
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += h.slices[w * kHot + slot];
    row[slot] = sum;
  }
}

template <int LOSS, bool HOT>
__global__ void __launch_bounds__(kThreads) fused_value_grad_kernel(
    const float* __restrict__ w, const int32_t* __restrict__ ids,
    const float* __restrict__ vals, const float* __restrict__ label,
    const float* __restrict__ offset, const float* __restrict__ weight, int n,
    int k, int d, float* __restrict__ grad, float* __restrict__ block_value,
    int* __restrict__ bad_ids, const int32_t* __restrict__ hot,
    double* __restrict__ hot_partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_value[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int step = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  Hot h{};
  if constexpr (HOT) load_hot(smem, hot, h);
  float* slice = h.slices + warp * kHot;
  float acc = 0.0f;
  if (k <= 32) {
    // One entry a lane, in registers from the gather to the scatter; a warp
    // loads and gathers kGroup rows at once, then works them in row order.
    for (int row0 = first; row0 < n; row0 += kGroup * step) {
      int id[kGroup];
      float v[kGroup], wt[kGroup], off[kGroup], y[kGroup], m[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int row = row0 + g * step;
        id[g] = -1;
        v[g] = wt[g] = off[g] = y[g] = m[g] = 0.0f;
        if (row < n) {
          if (lane < k) {
            id[g] = ids[static_cast<int64_t>(row) * k + lane];
            v[g] = vals[static_cast<int64_t>(row) * k + lane];
          }
          wt[g] = weight[row];
          off[g] = offset[row];
          y[g] = label[row];
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (row0 + g * step < n && lane < k) {
          if (static_cast<unsigned>(id[g]) < static_cast<unsigned>(d)) {
            m[g] = w[id[g]] * v[g];
          } else {
            *bad_ids = 1;
            id[g] = -1;
          }
        }
      }
      // One copy of the scatter in the code: each step works the front row
      // and shifts the next to the front (ptxas runs out of convergence
      // barriers when the scatter is unrolled kGroup times).
#pragma unroll 1
      for (int g = 0; g < kGroup; ++g) {
        if (row0 + g * step < n) {  // the same in every lane
          float mg = m[0];
#pragma unroll
          for (int sh = 16; sh > 0; sh >>= 1) mg += __shfl_xor_sync(0xffffffffu, mg, sh);
          float value, d1;
          loss_value_d1<LOSS>(mg + off[0], y[0], value, d1);
          acc += wt[0] * value;
          const float coeff = wt[0] * d1;
          if (coeff != 0.0f) {  // the same in every lane
            scatter_warp<HOT, float>(v[0] != 0.0f ? id[0] : -1, coeff * v[0], lane, h,
                                     slice, grad);
          }
        }
#pragma unroll
        for (int j = 0; j + 1 < kGroup; ++j) {
          id[j] = id[j + 1];
          v[j] = v[j + 1];
          wt[j] = wt[j + 1];
          off[j] = off[j + 1];
          y[j] = y[j + 1];
          m[j] = m[j + 1];
        }
      }
    }
  } else {
    for (int row = first; row < n; row += step) {
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
      for (int sh = 16; sh > 0; sh >>= 1) m += __shfl_xor_sync(0xffffffffu, m, sh);
      const float wt = weight[row];
      float value, d1;
      loss_value_d1<LOSS>(m + offset[row], label[row], value, d1);
      acc += wt * value;
      const float coeff = wt * d1;
      if (coeff == 0.0f) continue;
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int j = j0 + lane;
        const float v = j < k ? vals[base + j] : 0.0f;
        int id = v != 0.0f ? ids[base + j] : -1;
        // An id outside [0, d) was flagged by the gather: scatter nothing.
        if (static_cast<unsigned>(id) >= static_cast<unsigned>(d)) id = -1;
        scatter_warp<HOT, float>(id, coeff * v, lane, h, slice, grad);
      }
    }
  }
  if (lane == 0) warp_value[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int i = 0; i < kWarps; ++i) sum += warp_value[i];
    block_value[blockIdx.x] = sum;
  }
  if constexpr (HOT) flush_hot(h, hot_partials);
}

template <bool HOT>
__global__ void __launch_bounds__(kThreads) row_scatter_kernel(
    const float* __restrict__ r, const int32_t* __restrict__ ids,
    const float* __restrict__ vals, int n, int k, int d,
    double* __restrict__ out, int* __restrict__ bad_ids,
    const int32_t* __restrict__ hot, double* __restrict__ hot_partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Hot h{};
  if constexpr (HOT) load_hot(smem, hot, h);
  float* slice = h.slices + warp * kHot;
  // No gather waits on the loads here, so one row at a time keeps enough in
  // flight (kGroup rows measured no faster).
  for (int row = blockIdx.x * kWarps + warp; row < n; row += gridDim.x * kWarps) {
    const int64_t base = static_cast<int64_t>(row) * k;
    const float coeff = r[row];
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + lane;
      int id = -1;
      float v = 0.0f;
      if (j < k) {
        id = ids[base + j];
        v = vals[base + j];
        if (static_cast<unsigned>(id) >= static_cast<unsigned>(d)) {
          *bad_ids = 1;
          id = -1;
        }
      }
      if (coeff == 0.0f) continue;  // the same in every lane
      scatter_warp<HOT, double>(v != 0.0f ? id : -1, static_cast<double>(coeff * v),
                                lane, h, slice, out);
    }
  }
  if constexpr (HOT) flush_hot(h, hot_partials);
}

// Block 0: the loss value, the fixed-order sum of the per-block partials
// (skipped when value is null).  Block 1 + b: the hot slots [32 b, 32 b +
// 32), each summed over the main kernel's blocks in a fixed order, in
// float64, and written into out32 (as float) or out64.  Launched with one
// block when there is no hot set.
__global__ void __launch_bounds__(kSumThreads) epilogue_kernel(
    const float* __restrict__ partials, int blocks, float* __restrict__ value,
    const int32_t* __restrict__ hot, const double* __restrict__ hot_partials, int d,
    float* __restrict__ out32, double* __restrict__ out64) {
  __shared__ float s[kSumThreads];
  __shared__ double part[kSumThreads / 32][kEpilogueSlots + 1];
  if (blockIdx.x == 0) {
    if (value == nullptr) return;
    float acc = 0.0f;
    for (int i = threadIdx.x; i < blocks; i += kSumThreads) acc += partials[i];
    s[threadIdx.x] = acc;
    __syncthreads();
    for (int half = kSumThreads / 2; half > 0; half >>= 1) {
      if (threadIdx.x < half) s[threadIdx.x] += s[threadIdx.x + half];
      __syncthreads();
    }
    if (threadIdx.x == 0) *value = s[0];
    return;
  }
  const int n_hot = min(max(hot[kHot], 0), kHot);
  const int base = (blockIdx.x - 1) * kEpilogueSlots;
  if (base >= n_hot) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = base + lane;
  double acc = 0.0;
  if (slot < n_hot) {
    for (int b = warp; b < blocks; b += kSumThreads / 32) {
      acc += hot_partials[static_cast<int64_t>(b) * kHot + slot];
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && slot < n_hot) {
    double sum = 0.0;
    for (int i = 0; i < kSumThreads / 32; ++i) sum += part[i][lane];
    const int id = hot[slot];
    if (static_cast<unsigned>(id) < static_cast<unsigned>(d)) {
      if (out32 != nullptr) {
        out32[id] = static_cast<float>(sum);
      } else {
        out64[id] = sum;
      }
    }
  }
}

__global__ void to_float_kernel(const double* __restrict__ in, int d,
                                float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < d;
       i += gridDim.x * blockDim.x) {
    out[i] = static_cast<float>(in[i]);
  }
}

template <typename Kernel>
cudaError_t max_blocks(Kernel kernel, size_t smem, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

template <int LOSS>
cudaError_t value_grad_blocks(bool hot, int* blocks) {
  return hot ? max_blocks(fused_value_grad_kernel<LOSS, true>, kHotSmem, blocks)
             : max_blocks(fused_value_grad_kernel<LOSS, false>, 0, blocks);
}

template <int LOSS>
void launch_value_grad(int blocks, cudaStream_t stream, const float* w,
                       const int32_t* ids, const float* vals, const float* label,
                       const float* offset, const float* weight, int n, int k,
                       int d, float* grad, float* partials, int* bad_ids,
                       const int32_t* hot, double* hot_partials) {
  if (hot != nullptr) {
    fused_value_grad_kernel<LOSS, true><<<blocks, kThreads, kHotSmem, stream>>>(
        w, ids, vals, label, offset, weight, n, k, d, grad, partials, bad_ids, hot,
        hot_partials);
  } else {
    fused_value_grad_kernel<LOSS, false><<<blocks, kThreads, 0, stream>>>(
        w, ids, vals, label, offset, weight, n, k, d, grad, partials, bad_ids, hot,
        hot_partials);
  }
}

int launch_epilogue(const float* partials, int blocks, float* value,
                    const int32_t* hot, const double* hot_partials, int d,
                    float* out32, double* out64, cudaStream_t stream) {
  const int grid = hot != nullptr ? 1 + kHot / kEpilogueSlots : 1;
  epilogue_kernel<<<grid, kSumThreads, 0, stream>>>(partials, blocks, value, hot,
                                                    hot_partials, d, out32, out64);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most blocks of the persistent grid the card holds at once for a
// kernel form: `kernel` is a loss code (the fused kernel) or -1 (the row
// scatter), `hot` picks the form with the hot table.  The wrapper takes at
// most one block per 8 rows of it and sizes the partials buffers by it.
extern "C" int photon_fused_grid(int kernel, int hot, int* blocks) {
  switch (kernel) {
    case kLogistic: return static_cast<int>(value_grad_blocks<kLogistic>(hot, blocks));
    case kSquared: return static_cast<int>(value_grad_blocks<kSquared>(hot, blocks));
    case kPoisson: return static_cast<int>(value_grad_blocks<kPoisson>(hot, blocks));
    case kSmoothedHinge:
      return static_cast<int>(value_grad_blocks<kSmoothedHinge>(hot, blocks));
    case kRowScatter:
      return static_cast<int>(
          hot ? max_blocks(row_scatter_kernel<true>, kHotSmem, blocks)
              : max_blocks(row_scatter_kernel<false>, 0, blocks));
    default:
      return cudaErrorInvalidValue;
  }
}

// Launches the fused kernel on `blocks` blocks and the epilogue on `stream`.
// `grad` must be zeroed by the caller; `partials` holds `blocks` floats of
// scratch.  `hot` is the hot set ([kHot + 1] int32: distinct ids in [0, d),
// then their number) or null for the form without it; `hot_partials` holds
// blocks * kHot doubles of scratch when `hot` is given.  `*bad_ids`, zeroed
// by the caller, becomes non-zero when any id lies outside [0, d); such
// entries are neither gathered nor scattered.  Returns the CUDA error code
// (0 on success).
extern "C" int photon_fused_value_grad(int loss, const float* w,
                                       const int32_t* ids, const float* vals,
                                       const float* label, const float* offset,
                                       const float* weight, int n, int k,
                                       int d, float* grad, float* partials,
                                       int blocks, float* value, int* bad_ids,
                                       const int32_t* hot, double* hot_partials,
                                       void* stream_ptr) {
  if (n <= 0 || k <= 0 || d <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (loss) {
    case kLogistic:
      launch_value_grad<kLogistic>(blocks, stream, w, ids, vals, label, offset, weight,
                                   n, k, d, grad, partials, bad_ids, hot, hot_partials);
      break;
    case kSquared:
      launch_value_grad<kSquared>(blocks, stream, w, ids, vals, label, offset, weight,
                                  n, k, d, grad, partials, bad_ids, hot, hot_partials);
      break;
    case kPoisson:
      launch_value_grad<kPoisson>(blocks, stream, w, ids, vals, label, offset, weight,
                                  n, k, d, grad, partials, bad_ids, hot, hot_partials);
      break;
    case kSmoothedHinge:
      launch_value_grad<kSmoothedHinge>(blocks, stream, w, ids, vals, label, offset,
                                        weight, n, k, d, grad, partials, bad_ids, hot,
                                        hot_partials);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_epilogue(partials, blocks, value, hot, hot_partials, d, grad, nullptr,
                         stream);
}

// Launches the row scatter on `blocks` blocks, its epilogue and the
// rounding to float32 on `stream`: out32 = float(sum over entries of
// r[row] * vals into out64).  `out64` ([d] float64) must be zeroed by the
// caller; `hot`, `hot_partials` and `bad_ids` are as for
// photon_fused_value_grad.  Returns the CUDA error code.
extern "C" int photon_row_scatter(const float* r, const int32_t* ids,
                                  const float* vals, int n, int k, int d,
                                  double* out64, float* out32, int blocks,
                                  int* bad_ids, const int32_t* hot,
                                  double* hot_partials, void* stream_ptr) {
  if (n <= 0 || k <= 0 || d <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (hot != nullptr) {
    row_scatter_kernel<true><<<blocks, kThreads, kHotSmem, stream>>>(
        r, ids, vals, n, k, d, out64, bad_ids, hot, hot_partials);
  } else {
    row_scatter_kernel<false><<<blocks, kThreads, 0, stream>>>(
        r, ids, vals, n, k, d, out64, bad_ids, hot, hot_partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hot != nullptr) {
    const int e = launch_epilogue(nullptr, blocks, nullptr, hot, hot_partials, d,
                                  nullptr, out64, stream);
    if (e != 0) return e;
  }
  const int grid = d < 1024 * 256 ? (d + 255) / 256 : 1024;
  to_float_kernel<<<grid, 256, 0, stream>>>(out64, d, out32);
  return static_cast<int>(cudaGetLastError());
}
