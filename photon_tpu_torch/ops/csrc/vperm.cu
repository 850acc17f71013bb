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
// The function.  Per chunk i (rows i*CH .. i*CH+CH-1 of src, i1, i3, out;
// rows i*128 .. i*128+127 of i2), chunk-local r, r2 < CH and l, c < 128:
//   stage 1, a lane gather in each row:     y1[r, c] = src[r, i1[r, c] >> s]
//   stage 2, a row gather in each column:   y2[c, r] = y1[i2[c, r], c]
//   stage 3, a lane gather in each row:     out[r, l] = y2[i3[r, l], r]
// K4 reads x [CH, 128] with s = 0; K6 the dz tile [CH, 128/k] with
// s = log2 k (jnp.repeat(dz, k, axis=1) puts dz[r, j] at lanes j*k ..
// j*k+k-1).  Lane indices are int8, CH indices int16.  Only stage 2 crosses
// rows, anywhere in a 1-4 MB chunk.
//
// What bounds them: device-memory bytes at 3.35 TB/s.  K4 moves 12 bytes a
// slot (x and out 4 each, i1 and i3 1 each, i2 2), K5 9, K6 8 plus the dz
// tile; there is no arithmetic to speak of.  Every byte can be read once,
// in order, if stage 2's random reads hit shared memory instead of L2.  A
// block has 227 KB (232,448 bytes) of it, a 2432-row chunk of f32 is
// 1.19 MB, so:
//
// * K4, the exchange form (exchange_chunk_kernel): a cluster of CL blocks
//   a chunk, persistent (as many clusters as the card runs, each walking
//   its chunks).  Block b owns 1/CL of the chunk's rows for stages 1 and 3
//   and 1/CL of its 128 columns for stage 2; two all-to-all exchanges of
//   dense 16-byte runs through the cluster's distributed shared memory
//   carry y1 from row owners to column owners and y2 back, so that every
//   random read is local.  A block holds its columns of y1 (A) and its
//   rows of y2 (B): 2 x 1/CL of the chunk, so CL = 16 (a non-portable
//   cluster size) at CH = 2432 (213 KB a block with its i2 and staging);
//   at CH = 4096 (2 MB) B holds a quarter of the block's rows at a time
//   (four passes of stages 2 and 3, 193 KB a block).  The first design kept y1 by rows and
//   read it remotely: 7/8 or 15/16 of stage 2's random 4-byte reads crossed
//   the network, and each cluster size step cost more than the last
//   (0.227 ms at CL = 1 to 0.815 at CL = 16 for the same work).  Scalar
//   remote stores cost a warp about as much as 16-byte ones, so the
//   exchanges move 4 floats a lane; the network then carries each chunk
//   twice at about the rate device memory does, and bounds the form.
//   cudaOccupancyMaxActiveClusters: 7 clusters of 16 (112 of 132 SMs).
//
// * K6, the dz-tile form (expand_chunk_kernel): a block keeps its rows' dz
//   values and their lane selectors i1 >> log2 k packed to 0, 1, 2, 4 or 8
//   bits (log2(128/k) rounded up): 48 bytes a row at k = 32, so ONE block
//   holds the headline 2432-row chunk (114 KB, 162 KB with the ring that
//   streams i1 and i3 in by bulk copies) and every read is local, with no
//   cluster (a cluster of one block).  Chunks one block cannot hold (more
//   than 3808 rows at k = 32, or k <= 16 at 2432 rows; no main-path shape)
//   take the global form.  At k = 1 the tile is 128 wide and K6 takes K4's
//   exchange form.
//
// * The global form (global_chunk_kernel), the first version of K4/K6: one
//   thread per output element composes the three stages into one read,
//     c = i3[r, l];  r2 = i2[c, r];  out[r, l] = src[r2, i1[r2, c] >> s],
//   a block per 32 rows; the src and i1 reads land anywhere in the chunk,
//   through L2, one 32-byte sector per 4-byte element.  It takes any CH.
//
// The shape rule between them is ops/vperm.py chunk_form(nc, ch, width),
// decided before the launch: the cluster form where its blocks fit in 227
// KB (K4 up to CH = 5320; K6 at k = 32 up to 3808), else the global form.
// Small data (nc = 1) puts the one chunk on one cluster: correct, and slow
// only where the data is tiny.
// Index planes and the shared-memory budgets are fixed by the route
// builders; the rule mirrors exchange_smem and expand_smem below.
//
// K5 reads one 512-byte row of x per output row: coalesced, L1-resident.
//
// The half-width payload (PHOTON_XCHG_DTYPE=bfloat16, photon_tpu/ops/
// vperm.py:1258-1310, where K4-K6 move bf16 streams): every form is a
// template on the element type, float or a 2-byte word carrying a bf16's
// bits (uint16_t: the passes only move elements, so the bits pass through
// unchanged).  The 2-byte forms keep the f32 forms' geometry: the same
// shared-memory budgets (exchange_smem, expand_smem: the 2-byte tiles use
// half of the rooms sized for floats), the same cluster sizes and passes,
// so chunk_form's pick holds for both; a lane loads and the exchanges move
// runs of 4 elements, 8 bytes in place of 16 (st.shared::cluster.v2.b32 of
// two packed pairs).  Their index planes are the f32 forms' (6 of K4's 8
// bytes a slot at bf16 are index bytes), so they cut K4's bytes by a third,
// not a half.
//
// A refused launch (too much shared memory, a cluster that cannot be
// scheduled) returns its CUDA error; the wrapper raises.  Pure data
// movement: each form equals its plain PyTorch version bit for bit; pad
// slots carry whatever src holds there.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;

// -- the global form ---------------------------------------------------------

constexpr int kRowsPerBlock = 32;
constexpr int kThreads = 256;

// Four elements of a row, one load or store: 16 bytes of float, 8 of a
// 2-byte payload.
template <typename T> struct Quad;
template <> struct Quad<float> { using V = float4; };
template <> struct Quad<uint16_t> { using V = ushort4; };

__device__ __forceinline__ float4 make_quad(float a, float b, float c, float d) {
  return make_float4(a, b, c, d);
}
__device__ __forceinline__ ushort4 make_quad(uint16_t a, uint16_t b, uint16_t c,
                                             uint16_t d) {
  return make_ushort4(a, b, c, d);
}

// out[R, l] for R in this block's rows.  The source element of the
// composed gather is src[src_row * src_stride + (i1[src_row, c] >> shift)]:
// K4 passes (x, 128, 0), K6 (dz tile, 128 / k, log2 k).
template <typename T>
__global__ void __launch_bounds__(kThreads) global_chunk_kernel(
    const T* __restrict__ src, int src_stride, int shift,
    const int8_t* __restrict__ i1, const int16_t* __restrict__ i2,
    const int8_t* __restrict__ i3, T* __restrict__ out, int ch,
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

template <typename T>
int launch_global(const T* src, int src_stride, int shift,
                  const int8_t* i1, const int16_t* i2, const int8_t* i3,
                  T* out, int nc, int ch, void* stream_ptr) {
  if (nc <= 0 || ch <= 0 || ch > 32767) return cudaErrorInvalidValue;
  const int64_t rows = static_cast<int64_t>(nc) * ch;
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  global_chunk_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream_ptr)>>>(
      src, src_stride, shift, i1, i2, i3, out, ch, rows);
  return static_cast<int>(cudaGetLastError());
}

// out[r, l] = x[r, c[r, l]] over [rows, 128].
template <typename T>
__global__ void __launch_bounds__(kThreads) lane_pass_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ c,
    T* __restrict__ out, int64_t elems) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= elems) return;
  out[e] = x[(e / kLanes) * kLanes + c[e]];
}

// -- the cluster forms --------------------------------------------------------

__device__ __forceinline__ uint32_t ldg_u32(const void* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// One store of 4 elements into the shared memory of a block of the
// cluster: 16 bytes of float, 8 of a 2-byte payload (two packed pairs, the
// lower element in the lower half, as memory holds them).  A scalar
// st.shared::cluster costs a warp about as much as a 16-byte one does, so
// the exchange moves 4 elements a lane.
__device__ __forceinline__ void st_cluster_quad(uint32_t addr, float a, float b,
                                                float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}
__device__ __forceinline__ void st_cluster_quad(uint32_t addr, uint16_t a, uint16_t b,
                                                uint16_t c, uint16_t d) {
  const uint32_t lo = static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 16);
  const uint32_t hi = static_cast<uint32_t>(c) | (static_cast<uint32_t>(d) << 16);
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};"
               :: "r"(addr), "r"(lo), "r"(hi) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- K4: the exchange form ----

constexpr int kXThreads = 1024;
constexpr int kXWarps = kXThreads / 32;  // = rows of the stage-1 tile
constexpr int kYPitch = kLanes + 4;      // elements: aligned tile rows
constexpr int kYTileBytes = kXWarps * kYPitch * 4;

// Rows a block owns when stages 2 and 3 run in `passes` passes over them:
// ceil(ch / cl) rounded up to 8 * passes.
int exchange_rpb(int ch, int cl, int passes) {
  const int q = 8 * passes;
  return ((ch + cl - 1) / cl + q - 1) / q * q;
}

// B's pitch: the pass's rows rounded up to 32 (B is XOR-swizzled, see
// exchange_chunk_kernel).
__host__ __device__ int exchange_pitch(int rpp) { return (rpp + 31) / 32 * 32; }

// Shared memory of the exchange form: two barriers; the y1 tile of stage 1,
// whose room then holds one pass's i3 rows (rpp = rpb / passes of them);
// A, the block's cpb = 128 / cl columns of y1 over the chunk's ch rows; B,
// the pass's y2, 128 x pitch f32; the i2 of the block's columns over every
// block's pass rows (cpb x cl x rpp int16).  ops/vperm.py
// (exchange_passes) mirrors it.  The 2-byte form takes the same budget (its
// tiles fill half of the rooms), so one rule picks the form for both.
size_t exchange_smem(int ch, int cl, int passes) {
  const int rpp = exchange_rpb(ch, cl, passes) / passes;
  return 32 + std::max<size_t>(kYTileBytes, static_cast<size_t>(rpp) * kLanes) +
         static_cast<size_t>(kLanes / cl) * ch * 4 +
         static_cast<size_t>(kLanes) * exchange_pitch(rpp) * 4 +
         static_cast<size_t>(kLanes) * rpp * 2;
}

// The fewest passes of 1, 2, 4, 8 whose shared memory fits; 0 if none.
int exchange_passes(int ch, int cl) {
  for (int passes = 1; passes <= 8; passes *= 2)
    if (exchange_smem(ch, cl, passes) <= 232448) return passes;
  return 0;
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(1) : "memory");
}

// The one arrival of a barrier's phase, announcing `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
        " selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Persistent clusters of `cl` blocks, each walking chunks cluster_id,
// cluster_id + clusters, ...  In a chunk, block b owns rows R_b (rpb of
// them) for stages 1 and 3 and columns C_b (cpb = 128 / cl) for stage 2:
//   stage 1: y1 of R_b, 32 rows at a time (a 16-byte src load and a 4-byte
//            i1 load a lane and row, two tiles ahead), the lane gather in
//            the tile, each column sent to its owner's A in 16-byte runs of
//            4 rows (st.shared::cluster.v4);
//   stage 2: y2[c, r] = A[c][i2[c, r]] for c in C_b and the pass's rows of
//            every block: local random reads, 16-byte runs of 4 rows into
//            the owner's B[c];
//   stage 3: out[r, l] = B[i3[r, l]][r] for the pass's rows of R_b: local
//            random reads, coalesced out stores.
// Stages 2 and 3 run in `passes` passes over the rows when B cannot hold
// all of R_b (2 MB chunks).  The i2 and i3 of each pass arrive by bulk
// copies (cp.async.bulk on an mbarrier) issued a stage ahead, and the next
// chunk's first stage-1 tiles are in flight during stage 3.  Every random
// read is local; the cluster's network carries only dense 16-byte runs,
// and bounds the form: each chunk crosses it twice.
// B holds y2[c, r] at c * pitch + (r ^ (c % 32)): a run of 4 rows stays one
// aligned 16-byte run (its lanes permuted by c % 4), and stage 3's reads of
// one row at random columns spread over all 32 banks.
template <typename T>
__global__ void __launch_bounds__(kXThreads, 1) exchange_chunk_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ i1,
    const int16_t* __restrict__ i2, const int8_t* __restrict__ i3,
    T* __restrict__ out, int nc, int ch, int rpb, int passes) {
  using V = typename Quad<T>::V;
  constexpr uint32_t kElem = sizeof(T);
  extern __shared__ __align__(16) unsigned char xsmem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int clusters = gridDim.x / cl;
  const int cpb = kLanes / cl, rpp = rpb / passes, pb = exchange_pitch(rpp);
  const int r_begin = rank * rpb;
  const int rows_b = max(0, min(ch - r_begin, rpb));  // a multiple of 8
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t bar_i3 = smem_addr(xsmem), bar_i2 = bar_i3 + 8;
  T* ytile = reinterpret_cast<T*>(xsmem + 32);
  int8_t* i3s = reinterpret_cast<int8_t*>(ytile);  // after stage 1
  T* a = reinterpret_cast<T*>(xsmem + 32 + max(kYTileBytes, rpp * kLanes));
  T* b = a + cpb * ch;
  int16_t* i2s = reinterpret_cast<int16_t*>(b + kLanes * pb);  // [cpb][cl][rpp]
  const uint32_t a_addr = smem_addr(a), b_addr = smem_addr(b);
  uint32_t i3_loads = 0, i2_loads = 0;  // phases begun on each barrier

  // Rows of block `owner` in pass p: [owner * rpb + lo, owner * rpb + hi).
  auto pass_rows = [&](int owner, int p, int& lo, int& hi) {
    const int rows = max(0, min(ch - owner * rpb, rpb));
    lo = min(rows, p * rpp);
    hi = min(rows, lo + rpp);
  };
  // Every thread calls these (each counts the phases); the copies are
  // issued by one thread (i3) or by one thread a run (i2).
  auto load_i3 = [&](int64_t chunk, int p) {
    int lo, hi;
    pass_rows(rank, p, lo, hi);
    if (hi > lo) {
      if (threadIdx.x == 0) {
        mbar_expect(bar_i3, (hi - lo) * kLanes);
        bulk_copy(smem_addr(i3s), i3 + (chunk * ch + r_begin + lo) * kLanes,
                  (hi - lo) * kLanes, bar_i3);
      }
      ++i3_loads;
    }
  };
  auto load_i2 = [&](int64_t chunk, int p) {
    if (threadIdx.x == 0) {
      int rows = 0;
      for (int owner = 0; owner < cl; ++owner) {
        int lo, hi;
        pass_rows(owner, p, lo, hi);
        rows += hi - lo;
      }
      mbar_expect(bar_i2, cpb * rows * 2);
    }
    if (threadIdx.x < kLanes) {  // run (j, owner): column rank*cpb + j
      const int j = threadIdx.x / cl, owner = threadIdx.x - j * cl;
      int lo, hi;
      pass_rows(owner, p, lo, hi);
      if (hi > lo)
        bulk_copy(smem_addr(i2s + (j * cl + owner) * rpp),
                  i2 + (chunk * kLanes + rank * cpb + j) * ch + owner * rpb + lo,
                  (hi - lo) * 2, bar_i2);
    }
    ++i2_loads;
  };

  // Stage-1 tile loads into one of two register sets: lane L holds src
  // lanes 4L .. 4L+3 of the warp's row and their i1 bytes.
  V x0, x1;
  uint32_t s0, s1;
  auto load_tile = [&](int64_t chunk, int t0, V& xv, uint32_t& sv) {
    if (warp < rows_b - t0) {
      const int64_t g = chunk * ch + r_begin + t0 + warp;
      xv = __ldg(reinterpret_cast<const V*>(x + g * kLanes) + lane);
      sv = ldg_u32(i1 + g * kLanes + 4 * lane);
    }
  };
  // Form tile t0 from (xv, sv), refill them with tile t0 + 64 and send the
  // tile's columns to their owners' A.
  auto stage1_tile = [&](int64_t chunk, int t0, V& xv, uint32_t& sv) {
    const int nt = min(kXWarps, rows_b - t0);
    const bool mine = warp < nt;
    T* trow = ytile + warp * kYPitch;
    const V xr = xv;
    const uint32_t s = sv;
    if (t0 + 2 * kXWarps < rows_b) load_tile(chunk, t0 + 2 * kXWarps, xv, sv);
    if (mine) reinterpret_cast<V*>(trow)[lane] = xr;
    __syncwarp();
    V v;
    if (mine) {
      v.x = trow[(s >> 0) & 0x7f];
      v.y = trow[(s >> 8) & 0x7f];
      v.z = trow[(s >> 16) & 0x7f];
      v.w = trow[(s >> 24) & 0x7f];
    }
    __syncwarp();
    if (mine) reinterpret_cast<V*>(trow)[lane] = v;
    __syncthreads();
    // Warp w sends columns 4w .. 4w+3: lane L column 4w + L / 8, tile rows
    // 4(L % 8) .. +3, one run of 4 into the column's owner's A.
    {
      const int c = 4 * warp + lane / 8, t = 4 * (lane % 8);
      const int owner = c / cpb, j = c - owner * cpb;
      if (t < nt) {
        const T* col = ytile + t * kYPitch + c;
        st_cluster_quad(map_rank(a_addr + kElem * (j * ch + r_begin + t0 + t), owner),
                        col[0], col[kYPitch], col[2 * kYPitch], col[3 * kYPitch]);
      }
    }
    __syncthreads();
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_i3);
    mbar_init(bar_i2);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // No block writes another's shared memory before every block of the
  // cluster runs: arrive now, wait before the first remote store.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  int64_t chunk = blockIdx.x / cl;
  if (chunk < nc) {
    load_i2(chunk, 0);
    load_tile(chunk, 0, x0, s0);
    load_tile(chunk, kXWarps, x1, s1);
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");

  for (; chunk < nc; chunk += clusters) {
    const int64_t row0 = chunk * ch + r_begin;
    const int64_t next = chunk + clusters;
    for (int t0 = 0; t0 < rows_b; t0 += 2 * kXWarps) {
      stage1_tile(chunk, t0, x0, s0);
      if (t0 + kXWarps < rows_b) stage1_tile(chunk, t0 + kXWarps, x1, s1);
    }
    cluster.sync();  // every A holds its columns
    load_i3(chunk, 0);  // into the tile's room

    for (int p = 0; p < passes; ++p) {
      // Stage 2.  Thread e takes run (j, owner) = e / q4 and its pass
      // rows 4(e % q4) .. +3, one run of 4 into the owner's B.
      mbar_wait(bar_i2, (i2_loads - 1) & 1);
      const int q4 = rpp / 4;
      for (int e = threadIdx.x; e < kLanes * q4; e += kXThreads) {
        const int run = e / q4, j = run / cl, owner = run - j * cl;
        const int rl = 4 * (e - run * q4);
        int lo, hi;
        pass_rows(owner, p, lo, hi);
        if (rl < hi - lo) {
          const uint2 w = *reinterpret_cast<const uint2*>(i2s + run * rpp + rl);
          const T* col = a + j * ch;
          const T v0 = col[static_cast<int16_t>(w.x & 0xffff)];
          const T v1 = col[static_cast<int16_t>(w.x >> 16)];
          const T v2 = col[static_cast<int16_t>(w.y & 0xffff)];
          const T v3 = col[static_cast<int16_t>(w.y >> 16)];
          // Row rl + e goes to lane e ^ (c % 4) of the run at rl ^ (c % 32).
          const int c = rank * cpb + j;
          const bool sw1 = c & 1, sw2 = c & 2;
          const T a0 = sw1 ? v1 : v0, a1 = sw1 ? v0 : v1;
          const T a2 = sw1 ? v3 : v2, a3 = sw1 ? v2 : v3;
          st_cluster_quad(map_rank(b_addr + kElem * (c * pb + (rl ^ (c & 28))), owner),
                          sw2 ? a2 : a0, sw2 ? a3 : a1, sw2 ? a0 : a2, sw2 ? a1 : a3);
        }
      }
      __syncthreads();  // i2s is free: the next pass's (or chunk's) i2
      if (p + 1 < passes) load_i2(chunk, p + 1);
      else if (next < nc) load_i2(next, 0);
      cluster.sync();  // B holds this pass's y2; after the last pass A is free

      // Stage 3 of pass p; in the last pass the next chunk's first stage-1
      // tiles load meanwhile.
      int lo, hi;
      pass_rows(rank, p, lo, hi);
      if (hi > lo) mbar_wait(bar_i3, (i3_loads - 1) & 1);
      if (p + 1 == passes && next < nc) {
        load_tile(next, 0, x0, s0);
        load_tile(next, kXWarps, x1, s1);
      }
      for (int t = lo + warp; t < hi; t += kXWarps) {
        const int tl = t - lo;
        const uint32_t cw = *reinterpret_cast<const uint32_t*>(i3s + tl * kLanes + 4 * lane);
        V v;
        int c = (cw >> 0) & 0x7f;
        v.x = b[c * pb + (tl ^ (c & 31))];
        c = (cw >> 8) & 0x7f;
        v.y = b[c * pb + (tl ^ (c & 31))];
        c = (cw >> 16) & 0x7f;
        v.z = b[c * pb + (tl ^ (c & 31))];
        c = (cw >> 24) & 0x7f;
        v.w = b[c * pb + (tl ^ (c & 31))];
        *reinterpret_cast<V*>(out + (row0 + t) * kLanes + 4 * lane) = v;
      }
      __syncthreads();  // i3s (the tile's room) is free
      if (p + 1 < passes) {
        load_i3(chunk, p + 1);
        cluster.sync();  // B is free for the next pass
      }
    }
  }
}

// ---- K6: the dz-tile form ----

constexpr int kEThreads = 512;
constexpr int kEWarps = kEThreads / 32;
constexpr int kETile = 64;               // rows a ring slot and an i2 tile hold
constexpr int kERing = 4;                // ring slots of kETile x 128 bytes
constexpr int kTilePitch = kLanes + 2;   // int16 pitch: i2 tile rows 1 bank apart
constexpr int kEScratchBytes =
    64 + kERing * kETile * kLanes + kETile * kTilePitch * 2;

// Selector bits of a dz tile `width` wide: log2(width) rounded up to 0, 1,
// 2, 4 or 8; and the shared memory of a block: barriers, the ring, the i2
// tile, and the chunk's dz rows and packed selectors.  ops/vperm.py
// mirrors both.
int selector_bits(int width) {
  int need = 0;
  while ((1 << need) < width) ++need;
  return need <= 2 ? need : need <= 4 ? 4 : 8;
}

size_t expand_smem(int width, int ch) {
  return kEScratchBytes +
         static_cast<size_t>(ch) * (4 * width + 16 * selector_bits(width));
}

// One chunk a block.  Stage 1 brings the chunk's dz rows into shared
// memory by one bulk copy and packs their lane selectors i1 >> shift
// (`bits` each) beside them; stage 3 walks the chunk in tiles of 64 rows,
// the tile's i2 [128, 64] transposed into shared memory, and reads
// y1[r2, c] = dz[r2, sel[r2, c]] there.  The i1 rows of stage 1 and the i3
// rows of stage 3 stream through a ring of four 64-row slots filled by bulk
// copies (cp.async.bulk on an mbarrier a slot), four tiles ahead; the i2
// of a tile is in flight two tiles ahead.
//
// The 2-byte form keeps the dz rows at half their f32 bytes in the same
// budget (the selectors stay where the f32 form puts them).
template <typename T>
__global__ void __launch_bounds__(kEThreads, 1) expand_chunk_kernel(
    const T* __restrict__ src, int width, int shift, int bits,
    const int8_t* __restrict__ i1, const int16_t* __restrict__ i2,
    const int8_t* __restrict__ i3, T* __restrict__ out, int ch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t chunk = blockIdx.x;
  const int64_t row0 = chunk * ch;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t bar_dz = smem_addr(smem);        // then kERing slot barriers
  int8_t* ring = reinterpret_cast<int8_t*>(smem + 64);
  int16_t* tile = reinterpret_cast<int16_t*>(ring + kERing * kETile * kLanes);
  unsigned char* state = smem + kEScratchBytes;
  const uint32_t state_addr = smem_addr(state);
  const int sel_base = ch * width * 4;  // selectors after the dz rows
  const int tiles = (ch + kETile - 1) / kETile;  // per stage

  // Ring sequence n: stage-1 tile n (i1) for n < tiles, then stage-3 tile
  // n - tiles (i3); slot n % kERing, its (n / kERing)-th use.
  auto issue = [&](int n) {
    if (threadIdx.x != 0 || n >= 2 * tiles) return;
    const int t0 = (n % tiles) * kETile;
    const int rows = min(kETile, ch - t0);
    const int8_t* from = (n < tiles ? i1 : i3) + (row0 + t0) * kLanes;
    const uint32_t bar = bar_dz + 8 * (1 + n % kERing);
    mbar_expect(bar, rows * kLanes);
    bulk_copy(smem_addr(ring + (n % kERing) * kETile * kLanes), from, rows * kLanes, bar);
  };
  auto wait_slot = [&](int n) {
    mbar_wait(bar_dz + 8 * (1 + n % kERing), (n / kERing) & 1);
  };

  if (threadIdx.x == 0) {
    for (int q = 0; q <= kERing; ++q) mbar_init(bar_dz + 8 * q);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // ch * width * sizeof(T): a multiple of 16 bytes
    const uint32_t bytes = ch * width * sizeof(T);
    mbar_expect(bar_dz, bytes);
    bulk_copy(state_addr, src + row0 * width, bytes, bar_dz);
  }
  for (int n = 0; n < kERing; ++n) issue(n);

  // Stage-3 i2 tiles, two ahead in registers: thread t holds column
  // c = t / 4, tile rows 16 (t % 4) .. +15.
  const int16_t* i2c = i2 + chunk * kLanes * ch;
  const int tc = threadIdx.x / 4, tq = threadIdx.x % 4;
  uint4 ra[2], rb[2];
  auto load_i2 = [&](int k, uint4 (&r)[2]) {
    const int t0 = k * kETile, nt = min(kETile, ch - t0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (k < tiles && 16 * tq + 8 * h < nt)
        r[h] = __ldg(reinterpret_cast<const uint4*>(
            i2c + static_cast<int64_t>(tc) * ch + t0 + 16 * tq + 8 * h));
    }
  };
  load_i2(0, ra);
  load_i2(1, rb);

  // Stage 1: the selectors.  Lane L holds those of lanes c = 4L .. 4L+3,
  // 4 * bits bits; g = 32 / (4 * bits) neighbouring lanes OR them into one
  // word.
  uint32_t* sel = reinterpret_cast<uint32_t*>(state + sel_base);
  const T* dz = reinterpret_cast<const T*>(state);
  for (int n = 0; n < tiles; ++n) {
    if (bits) {
      const int t0 = n * kETile, nt = min(kETile, ch - t0);
      const int8_t* slot = ring + (n % kERing) * kETile * kLanes;
      const int g = 32 / (4 * bits);
      wait_slot(n);
      for (int t = warp; t < nt; t += kEWarps) {
        const uint32_t s = *reinterpret_cast<const uint32_t*>(slot + t * kLanes + 4 * lane);
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          word |= (((s >> (8 * e)) & 0x7f) >> shift) << (e * bits);
        word <<= (lane % g) * 4 * bits;
        for (int o = 1; o < g; o <<= 1) word |= __shfl_xor_sync(0xffffffffu, word, o);
        if (lane % g == 0) sel[(t0 + t) * 4 * bits + lane / g] = word;
      }
    } else {
      wait_slot(n);  // the slot's copy still completes its phase
    }
    __syncthreads();
    issue(n + kERing);
  }
  mbar_wait(bar_dz, 0);
  __syncthreads();

  // Stage 3: tile k from i2 registers r (refilled with tile k + 2); warp w
  // writes tile rows w, w + 16, w + 32, w + 48, lane L lanes 4L .. 4L+3.
  auto stage3_tile = [&](int k, uint4 (&r)[2]) {
    const int n = tiles + k, t0 = k * kETile, nt = min(kETile, ch - t0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (16 * tq + 8 * h < nt) {
        const uint32_t w[4] = {r[h].x, r[h].y, r[h].z, r[h].w};
#pragma unroll
        for (int m = 0; m < 8; ++m)
          tile[(16 * tq + 8 * h + m) * kTilePitch + tc] =
              static_cast<int16_t>(w[m / 2] >> (16 * (m % 2)));
      }
    }
    __syncthreads();
    load_i2(k + 2, r);
    const int8_t* slot = ring + (n % kERing) * kETile * kLanes;
    wait_slot(n);
    for (int t = warp; t < nt; t += kEWarps) {
      const uint32_t cw = *reinterpret_cast<const uint32_t*>(slot + t * kLanes + 4 * lane);
      T v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = (cw >> (8 * e)) & 0x7f;
        const int r2 = tile[t * kTilePitch + c];
        int sl = 0;
        if (bits) {
          const int bit = c * bits;
          sl = (sel[r2 * 4 * bits + (bit >> 5)] >> (bit & 31)) & ((1u << bits) - 1);
        }
        v[e] = dz[r2 * width + sl];
      }
      *reinterpret_cast<typename Quad<T>::V*>(out + (row0 + t0 + t) * kLanes + 4 * lane) =
          make_quad(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();  // the tile and the slot are free
    issue(n + kERing);
  };
  for (int k = 0; k < tiles; k += 2) {
    stage3_tile(k, ra);
    if (k + 1 < tiles) stage3_tile(k + 1, rb);
  }
}

// ---- launching ----

cudaLaunchConfig_t cluster_config(int nc, int cl, int threads, size_t smem,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nc) * cl);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, int cl) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && cl > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

bool cluster_shape_ok(int nc, int ch, int cl) {
  return nc > 0 && ch > 0 && ch <= 32767 && ch % 8 == 0 &&
         (cl == 1 || cl == 2 || cl == 4 || cl == 8 || cl == 16);
}

// cudaOccupancyMaxActiveClusters of the exchange form, remembered per
// (device, element size, ch, cl): a launch asks it once.
template <typename T>
int exchange_clusters(int ch, int cl, size_t smem, cudaError_t* err) {
  struct Entry { int device, elem, ch, cl, clusters; };
  static Entry cache[16];
  static int used = 0;
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  const int elem = static_cast<int>(sizeof(T));
  for (int e = 0; e < used; ++e)
    if (cache[e].device == device && cache[e].elem == elem && cache[e].ch == ch &&
        cache[e].cl == cl)
      return cache[e].clusters;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t probe = cluster_config(1, cl, kXThreads, smem, nullptr, &attr);
  int clusters = 0;
  *err = cudaOccupancyMaxActiveClusters(&clusters, exchange_chunk_kernel<T>, &probe);
  if (*err != cudaSuccess) return 0;
  if (clusters <= 0) {
    *err = cudaErrorLaunchOutOfResources;
    return 0;
  }
  cache[used % 16] = {device, elem, ch, cl, clusters};
  used = used < 16 ? used + 1 : 16;
  return clusters;
}

template <typename T>
int launch_exchange(const T* x, const int8_t* i1, const int16_t* i2,
                    const int8_t* i3, T* out, int nc, int ch, int cl,
                    void* stream_ptr) {
  if (!cluster_shape_ok(nc, ch, cl)) return cudaErrorInvalidValue;
  const int passes = exchange_passes(ch, cl);
  if (passes == 0) return cudaErrorInvalidValue;
  const size_t smem = exchange_smem(ch, cl, passes);
  cudaError_t err = prepare(exchange_chunk_kernel<T>, smem, cl);
  if (err != cudaSuccess) return err;
  // As many clusters as the card runs at once, each walking its chunks.
  const int clusters = exchange_clusters<T>(ch, cl, smem, &err);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      min(nc, clusters), cl, kXThreads, smem, static_cast<cudaStream_t>(stream_ptr), &attr);
  err = cudaLaunchKernelEx(&cfg, exchange_chunk_kernel<T>, x, i1, i2, i3, out,
                           nc, ch, exchange_rpb(ch, cl, passes), passes);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_expand(const T* dz, int width, int shift, const int8_t* i1,
                  const int16_t* i2, const int8_t* i3, T* out, int nc,
                  int ch, cudaStream_t stream) {
  const size_t smem = expand_smem(width, ch);
  cudaError_t err = prepare(expand_chunk_kernel<T>, smem, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(nc, 1, kEThreads, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, expand_chunk_kernel<T>, dz, width, shift,
                           selector_bits(width), i1, i2, i3, out, ch);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

int log2_k(int k) {
  if (k <= 0 || k > kLanes || (k & (k - 1)) != 0) return -1;
  int shift = 0;
  while ((1 << shift) < k) ++shift;
  return shift;
}

// The entry points below in each element type: `bf16` non-zero selects the
// 2-byte form (the src and out pointers then hold bf16 bits).
template <typename T>
int chunk_global(const void* x, const int8_t* i1, const int16_t* i2, const int8_t* i3,
                 void* out, int nc, int ch, int k, void* stream_ptr) {
  const int shift = log2_k(k);
  if (shift < 0) return cudaErrorInvalidValue;
  return launch_global(static_cast<const T*>(x), kLanes / k, shift, i1, i2, i3,
                       static_cast<T*>(out), nc, ch, stream_ptr);
}

template <typename T>
int chunk_cluster(const void* x, const int8_t* i1, const int16_t* i2, const int8_t* i3,
                  void* out, int nc, int ch, int k, int cl, void* stream_ptr) {
  const int shift = log2_k(k);
  if (shift < 0) return cudaErrorInvalidValue;
  const T* src = static_cast<const T*>(x);
  T* dst = static_cast<T*>(out);
  if (k == 1) return launch_exchange(src, i1, i2, i3, dst, nc, ch, cl, stream_ptr);
  if (!cluster_shape_ok(nc, ch, cl) || cl != 1) return cudaErrorInvalidValue;
  return launch_expand(src, kLanes / k, shift, i1, i2, i3, dst, nc, ch,
                       static_cast<cudaStream_t>(stream_ptr));
}

}  // namespace

// K4, global form: x, i1, i3, out [nc * ch, 128]; i2 [nc * 128, ch].
// Returns the CUDA error code of the launch (0 on success).
extern "C" int photon_vperm_chunk(const void* x, const int8_t* i1,
                                  const int16_t* i2, const int8_t* i3,
                                  void* out, int nc, int ch, int bf16,
                                  void* stream_ptr) {
  return bf16 ? chunk_global<uint16_t>(x, i1, i2, i3, out, nc, ch, 1, stream_ptr)
              : chunk_global<float>(x, i1, i2, i3, out, nc, ch, 1, stream_ptr);
}

// K6, global form: dz [nc * ch, 128 / k] with k a power of two dividing
// 128; planes and out as K4.
extern "C" int photon_vperm_chunk_expand(const void* dz, const int8_t* i1,
                                         const int16_t* i2, const int8_t* i3,
                                         void* out, int nc, int ch, int k, int bf16,
                                         void* stream_ptr) {
  return bf16 ? chunk_global<uint16_t>(dz, i1, i2, i3, out, nc, ch, k, stream_ptr)
              : chunk_global<float>(dz, i1, i2, i3, out, nc, ch, k, stream_ptr);
}

// K4, cluster form (the exchange) with `cl` blocks a chunk (1, 2, 4, 8 or
// 16); ch a multiple of 8.
extern "C" int photon_vperm_chunk_cluster(const void* x, const int8_t* i1,
                                          const int16_t* i2, const int8_t* i3,
                                          void* out, int nc, int ch, int cl, int bf16,
                                          void* stream_ptr) {
  return bf16 ? chunk_cluster<uint16_t>(x, i1, i2, i3, out, nc, ch, 1, cl, stream_ptr)
              : chunk_cluster<float>(x, i1, i2, i3, out, nc, ch, 1, cl, stream_ptr);
}

// K6, cluster form: the dz-tile form, one block a chunk (cl = 1); at k = 1
// the dz tile is 128 wide and K6 is K4, so it takes K4's exchange form.
extern "C" int photon_vperm_chunk_expand_cluster(
    const void* dz, const int8_t* i1, const int16_t* i2, const int8_t* i3,
    void* out, int nc, int ch, int k, int cl, int bf16, void* stream_ptr) {
  return bf16 ? chunk_cluster<uint16_t>(dz, i1, i2, i3, out, nc, ch, k, cl, stream_ptr)
              : chunk_cluster<float>(dz, i1, i2, i3, out, nc, ch, k, cl, stream_ptr);
}

// cudaOccupancyMaxActiveClusters of the cluster form of K4 (k = 0) or K6
// (k >= 1), in its f32 form or (bf16 non-zero) its 2-byte form, at chunk
// height ch and cluster size cl: how many of its clusters the card runs at
// once.  Negative: minus the CUDA error code.
extern "C" int photon_vperm_max_active_clusters(int k, int ch, int cl, int bf16) {
  const int shift = k > 0 ? log2_k(k) : 0;
  if (shift < 0 || !cluster_shape_ok(1, ch, cl))
    return -static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const void* fn = nullptr;
  int threads = 0;
  if (k <= 1) {
    const int passes = exchange_passes(ch, cl);
    if (passes == 0) return -static_cast<int>(cudaErrorInvalidValue);
    smem = exchange_smem(ch, cl, passes);
    fn = bf16 ? reinterpret_cast<const void*>(exchange_chunk_kernel<uint16_t>)
              : reinterpret_cast<const void*>(exchange_chunk_kernel<float>);
    threads = kXThreads;
  } else {
    if (cl != 1) return -static_cast<int>(cudaErrorInvalidValue);
    smem = expand_smem(kLanes >> shift, ch);
    fn = bf16 ? reinterpret_cast<const void*>(expand_chunk_kernel<uint16_t>)
              : reinterpret_cast<const void*>(expand_chunk_kernel<float>);
    threads = kEThreads;
  }
  cudaError_t err = prepare(fn, smem, cl);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(1, cl, threads, smem, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters;
}

// K5: x, c, out [rows, 128], f32 or (bf16 non-zero) 2-byte elements.
extern "C" int photon_vperm_lane(const void* x, const int8_t* c, void* out,
                                 int64_t rows, int bf16, void* stream_ptr) {
  if (rows <= 0) return cudaErrorInvalidValue;
  const int64_t elems = rows * kLanes;
  const int64_t blocks = (elems + kThreads - 1) / kThreads;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bf16) {
    lane_pass_kernel<uint16_t><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const uint16_t*>(x), c, static_cast<uint16_t*>(out), elems);
  } else {
    lane_pass_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const float*>(x), c, static_cast<float*>(out), elems);
  }
  return static_cast<int>(cudaGetLastError());
}
