// The three permutation passes of the xchg exchange on Hopper.
//
// Replaces, in photon_tpu/ops/vperm.py:
//   K4 _chunk_kernel (launched by _chunk_pass): the 5-stage micro-Clos
//      over each [CH, 128] chunk;
//   K5 _lane_kernel (launched by _lane_pass): a per-row lane gather;
//   K6 _chunk_expand_kernel (launched by apply_balanced_dz): the micro-Clos
//      over a chunk rebuilt from a [CH, 128/k] dz tile, each dz value
//      repeated k times along the lanes.
//
// K4.  Per chunk i (rows i*CH .. i*CH+CH-1 of x, i1, i3; rows i*128 ..
// i*128+127 of i2), the TPU kernel gathers along the lanes by i1, transposes
// to [128, CH], gathers along CH by i2, transposes back and gathers along
// the lanes by i3, all in VMEM.  Composed, every output element is one read:
//   c = i3[r, l];  r2 = i2[c, r];  out[r, l] = x[r2, i1[r2, c]]
// (chunk-local r, r2 < CH and l, c < 128).  K6 reads dz[r2, i1[r2, c] / k]
// from the dz tile instead of x: jnp.repeat(dz, k, axis=1) puts dz[r, j]
// at lanes j*k .. j*k+k-1.  Lane indices are int8 (at most 127), CH indices
// int16 (CH <= 8192).
//
// What bounds them: device-memory bytes.  K4 moves 12 bytes an element
// (x and out 4 each, i1 and i3 1 each, i2 2), K5 9, K6 8 plus dz; there is
// no arithmetic to speak of.  A chunk (1-4 MB of f32) does not fit in an
// SM's shared memory, so these first kernels read through L2: one thread
// per output element, a block per 32 rows of 128 lanes.  The i3 read and
// the out write coalesce; the i2 reads of a block cover i2's [128, 32]
// sub-block exactly once (each i3 row is a permutation of the 128 lanes),
// so they use whole sectors; the x and i1 reads land anywhere in the chunk,
// which blocks that run together keep in L2, one 32-byte sector per 4-byte
// element.  Staging chunks through shared memory is left for a later PR.
// K5 reads one 512-byte row of x per output row: coalesced, L1-resident.
//
// Pure data movement: each kernel equals its plain PyTorch version bit for
// bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRowsPerBlock = 32;
constexpr int kThreads = 256;

// out[R, l] for R in this block's rows.  The source element of the
// composed gather is src[src_row * src_stride + (i1[src_row, c] >> shift)]:
// K4 passes (x, 128, 0), K6 (dz tile, 128 / k, log2 k).
__global__ void __launch_bounds__(kThreads) chunk_pass_kernel(
    const float* __restrict__ src, int src_stride, int shift,
    const int8_t* __restrict__ i1, const int16_t* __restrict__ i2,
    const int8_t* __restrict__ i3, float* __restrict__ out, int ch,
    int64_t rows) {
  const int lane = threadIdx.x % kLanes;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  for (int dr = threadIdx.x / kLanes; dr < kRowsPerBlock;
       dr += kThreads / kLanes) {
    const int64_t row = row0 + dr;
    if (row >= rows) return;
    const int64_t chunk = row / ch;
    const int r = static_cast<int>(row - chunk * ch);
    const int c = i3[row * kLanes + lane];
    const int r2 = i2[(chunk * kLanes + c) * ch + r];
    const int64_t src_row = chunk * ch + r2;
    const int l2 = i1[src_row * kLanes + c];
    out[row * kLanes + lane] = src[src_row * src_stride + (l2 >> shift)];
  }
}

// out[r, l] = x[r, c[r, l]] over [rows, 128].
__global__ void __launch_bounds__(kThreads) lane_pass_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ c,
    float* __restrict__ out, int64_t elems) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= elems) return;
  out[e] = x[(e / kLanes) * kLanes + c[e]];
}

int launch_chunk(const float* src, int src_stride, int shift, const int8_t* i1,
                 const int16_t* i2, const int8_t* i3, float* out, int nc,
                 int ch, void* stream_ptr) {
  if (nc <= 0 || ch <= 0 || ch > 32767) return cudaErrorInvalidValue;
  const int64_t rows = static_cast<int64_t>(nc) * ch;
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  chunk_pass_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream_ptr)>>>(
      src, src_stride, shift, i1, i2, i3, out, ch, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: x, i1, i3, out [nc * ch, 128]; i2 [nc * 128, ch].  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int photon_vperm_chunk(const float* x, const int8_t* i1,
                                  const int16_t* i2, const int8_t* i3,
                                  float* out, int nc, int ch,
                                  void* stream_ptr) {
  return launch_chunk(x, kLanes, 0, i1, i2, i3, out, nc, ch, stream_ptr);
}

// K6: dz [nc * ch, 128 / k] with k a power of two dividing 128; planes and
// out as K4.
extern "C" int photon_vperm_chunk_expand(const float* dz, const int8_t* i1,
                                         const int16_t* i2, const int8_t* i3,
                                         float* out, int nc, int ch, int k,
                                         void* stream_ptr) {
  if (k <= 0 || k > kLanes || (k & (k - 1)) != 0) return cudaErrorInvalidValue;
  int shift = 0;
  while ((1 << shift) < k) ++shift;
  return launch_chunk(dz, kLanes / k, shift, i1, i2, i3, out, nc, ch,
                      stream_ptr);
}

// K5: x, c, out [rows, 128].
extern "C" int photon_vperm_lane(const float* x, const int8_t* c, float* out,
                                 int64_t rows, void* stream_ptr) {
  if (rows <= 0) return cudaErrorInvalidValue;
  const int64_t elems = rows * kLanes;
  const int64_t blocks = (elems + kThreads - 1) / kThreads;
  lane_pass_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream_ptr)>>>(x, c, out, elems);
  return static_cast<int>(cudaGetLastError());
}
