// The kernels of the primitive probes (PK1-PK7) on Hopper.
//
// Replaces the Pallas kernel bodies of the three probe tools:
//   PK1 window gather  tools/probe_permute.py:110 (probe_lane_gather_kernel,
//       body :98-99), tools/probe_blocklocal.py:52 via
//       probe_tall_lane_gather (:68) and probe_middle_sandwich (:199);
//   PK2 lane swap      tools/probe_permute.py:166 (probe_benes_stage, body
//       :151-158, masked) and tools/probe_tiles.py:53 (swap_kernel :37,
//       unmasked);
//   PK3 copy-scale     tools/probe_tiles.py:53 (copy_kernel :33);
//   PK4 tile transpose tools/probe_blocklocal.py:101 (probe_vmem_transpose);
//   PK5 fused chunk    tools/probe_blocklocal.py:146-151 (probe_fused_chunk);
//   PK6 sublane gather tools/probe_blocklocal.py:245-250
//       (probe_sublane_gather);
//   PK7 lane repeat    tools/probe_blocklocal.py:327-328
//       (probe_inkernel_repeat).
//
// What bounds them: device-memory bytes at 3.35 TB/s.  Every kernel moves
// data (PK3 adds one f32 multiply an element): at E elements PK1 and PK6
// move 12 bytes an element (x, idx, out), PK2 12 masked (x, mask, out) or 8
// unmasked, PK3 and PK4 8, PK5 20 (x, the three int32 index planes, out),
// PK7 about 4.1 an output element (the [rows, 128 / k] input is k times
// narrower).  The designs keep every read and write of the streams
// coalesced where the function allows it:
//
// PK1  out[f] = x[(f & ~(W - 1)) + (idx[f] & (W - 1))] over the flat array:
//      the windows of W (a power of two) consecutive elements are the rows
//      of 128 lanes (W = 128) or the 2048-wide windows of the transposed
//      [128, E / 128] view (W = 2048).  A block stages 2048 elements of x
//      (whole windows, W <= 2048) in shared memory (8 KB), then gathers from
//      there; idx and out stream.  Indices are masked to the window, as the
//      TPU gather cannot leave its tile.
// PK2  The Pallas body rolls the lanes by 32 and by 96 and selects by
//      (lane / 32) % 2: that reverses the four 32-lane blocks of each row,
//      out[l] = x[(3 - l / 32) * 32 + l % 32] (not l ^ 32).  Masked: out =
//      mask > 0 ? swapped : x.  In float4s of a row, output j takes source
//      j ^ 24.  The unit below (PK3's): a warp loads a row as 32 coalesced
//      float4s and each lane takes its swapped float4 from lane j ^ 24 by
//      shuffles, so x (and the mask) are read once, 16 bytes a lane.  h is
//      validated only, as PK3's (the first design gave each block one tile
//      of h rows: 32 blocks for 132 SMs at h = 8192, 35% of the bound).
// PK3  out = x * 1.0000001f over [rows, 128]: 8 bytes an element, 0.080 ms
//      at E = 2^25.  h, the TPU's tile height, is validated and does not
//      shape the launch: a block takes 8 rows (4 KB of x), so the grid is
//      rows / 8 blocks at every h (32768 at E = 2^25) and fills the card
//      (the first design gave each block one tile: 32 blocks for 132 SMs at
//      h = 8192).  The output is the same whatever the tiling.  Each thread
//      moves two 16-byte float4s, both loads in flight before the first
//      store, with 32-bit index arithmetic; a ragged last unit (262,143
//      rows) is short, in the same launch.
// PK4  [CH, 128] tiles to [128, CH] each, through a 32 x 33 shared tile (the
//      pad column keeps the transposed reads free of bank conflicts).
// PK5  The 5-stage chunk body (lane gather by i1, transpose, gather along
//      CH by i2, transpose, lane gather by i3), each index masked to its
//      range; for row r of chunk t (r, r2 chunk-local rows):
//        stage 1  y1[r, c]  = x[r, i1[r, c] & 127]
//        stage 2  y2[c, r]  = y1[i2[t * 128 + c, r] & (CH - 1), c]
//        stage 3  out[r, l] = y2[i3[r, l] & 127, r]
//      K4's algebra (ops/csrc/vperm.cu) with int32 planes: 20 bytes an
//      element, 0.200 ms at E = 2^25.  Only stage 2 crosses rows, anywhere
//      in the chunk; read from device memory, each of its reads is a random
//      4-byte read (the first design, one thread an element, reached 28% of
//      the bound on an NVIDIA H100 80GB HBM3 at 700 W).  So the chunk is
//      held on chip, and every random read is a shared-memory read.  Three forms, picked from the shape before the
//      launch by ops/probe_kernels.fused_chunk_form (it mirrors the
//      shared-memory formulas fused_block_smem and fused_cluster_smem
//      below):
//      * the block form (fused_block_kernel), where a block holds whole
//        chunks (CH <= 256): a block takes g chunks (64 rows at least), its
//        y1 rows in shared memory (512 bytes a row) and its i2 tiles masked
//        to int16 (256 bytes a row); stage 1 gathers each row in place,
//        stages 2 and 3 compose into one read of y1 an output element.
//      * the cluster form (fused_cluster_kernel), K4's exchange: a cluster
//        of CL blocks takes a chunk, persistent (as many clusters as the
//        card runs, each walking its chunks).  Block b owns rows R_b (CH /
//        CL) for stages 1 and 3 and columns C_b (128 / CL) for stage 2.
//        Stage 1 gathers 32-row tiles of R_b and sends each column to its
//        owner's A (y1 by columns, 512 CH / CL bytes) in 16-byte runs of 4
//        rows through distributed shared memory (st.shared::cluster.v4);
//        stage 2 reads the owner's columns of i2 as a coalesced stream
//        (int4), gathers from A locally and sends 16-byte runs of y2 to the
//        row owners' B; stage 3 reads i3 and gathers from B locally.  Two
//        exchanges of dense runs carry the chunk from row owners to column
//        owners and back.  B holds one pass of a block's rows (stages 2 and
//        3 run in passes); the stage-1 tile lives in B's room.  The rule
//        takes CL = CH / 128 and two passes (A 64 KB, B 32 KB, 96 KB a
//        block) where CL <= 16, so two blocks share an SM and one
//        cluster's exchanges overlap the other's streams; else the
//        smallest cluster and fewest passes that fit (CH = 4096: 16
//        blocks of 192 KB, one an SM).
//      * the global form (fused_global_kernel), the first design, one
//        thread an element through L2: only chunks no cluster holds (CH >=
//        8192, where 128 / 16 columns of CH rows pass 227 KB).
// PK6  out[8g + s, l] = x[8g + (idx[8g + s, l] & 7), l]: each warp reads 32
//      lanes of rows inside one 4 KB group, which L1 holds.
// PK7  out[r, l] = x[r, l / k] from [rows, 128 / k]: almost a pure write
//      stream.  The same unit of 8 output rows for every k: each output
//      float4 is built from four 4-byte reads of x (L1 holds the narrow
//      input) and leaves as one 16-byte store (the first design, one
//      thread and one 4-byte store an element, reached 44% of the bound).
//
// A refused launch (too much shared memory, a cluster the card cannot
// schedule) returns its CUDA error; the wrapper raises.  Pure data movement
// (PK3: one rounded multiply): each kernel equals its plain PyTorch version
// (ops/probe_kernels.py) bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kStage = 2048;  // PK1: elements a block stages; windows up to this
constexpr float kScale = 1.0000001f;

bool pow2(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

int blocks_for(int64_t work, int64_t per_block) {
  return static_cast<int>((work + per_block - 1) / per_block);
}

__global__ void __launch_bounds__(kThreads) window_gather_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t n, int window) {
  __shared__ float stage[kStage];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kStage;
  const int len = static_cast<int>(min64(kStage, n - base));
  for (int i = threadIdx.x; i < len; i += kThreads) stage[i] = x[base + i];
  __syncthreads();
  const int mask = window - 1;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    out[base + i] = stage[(i & ~mask) + (idx[base + i] & mask)];
  }
}

// PK2, PK3 and PK7 share one unit of work: block b takes rows [8b, 8b + 8)
// of the [rows, 128] output (the last one may be short) and thread t moves
// its float4s t and t + 128.  A warp holds one row's 32 float4s, and a
// unit's float4 count is a multiple of 32, so a warp is whole or idle.
constexpr int kCThreads = 128;
constexpr int kUnitVecs = 2;
constexpr int kUnitRows = kCThreads * kUnitVecs * 4 / kLanes;  // 8
constexpr int kRowVecs = kLanes / 4;                           // 32

// The launch of a unit kernel over `rows` rows: rows / 8 blocks, rounded up.
bool unit_blocks(int64_t rows, unsigned* blocks) {
  if (rows <= 0) return false;
  const int64_t n = (rows + kUnitRows - 1) / kUnitRows;
  if (n > 0x7fffffff) return false;
  *blocks = static_cast<unsigned>(n);
  return true;
}

// PK2 (mask may be null).  Output float4 j of a row is source float4
// (3 - j / 8) * 8 + j % 8 = j ^ 24 of the same row, which lane j of the
// row's warp takes from lane j ^ 24 by shuffles: x is read once, as the
// warp's own coalesced float4s.  All loads (x, and the mask) are in flight
// before the first shuffle, select and store.
__global__ void __launch_bounds__(kCThreads) lane_swap_kernel(
    const float4* __restrict__ x, const float4* __restrict__ m,
    float4* __restrict__ out, int64_t rows) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kUnitRows;
  const int n = static_cast<int>(min64(r0 + kUnitRows, rows) - r0) * kRowVecs;
  const float4* src = x + r0 * kRowVecs;
  const float4* msk = m == nullptr ? nullptr : m + r0 * kRowVecs;
  float4* dst = out + r0 * kRowVecs;
  float4 v[kUnitVecs], mv[kUnitVecs];
#pragma unroll
  for (int u = 0; u < kUnitVecs; ++u) {
    const int f = threadIdx.x + u * kCThreads;
    if (f < n) {
      v[u] = __ldg(src + f);
      if (msk != nullptr) mv[u] = __ldg(msk + f);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnitVecs; ++u) {
    const int f = threadIdx.x + u * kCThreads;
    if (f < n) {  // warp-uniform: every lane of the warp shuffles
      float4 s;
      s.x = __shfl_xor_sync(0xffffffffu, v[u].x, 24);
      s.y = __shfl_xor_sync(0xffffffffu, v[u].y, 24);
      s.z = __shfl_xor_sync(0xffffffffu, v[u].z, 24);
      s.w = __shfl_xor_sync(0xffffffffu, v[u].w, 24);
      if (msk != nullptr) {
        s = make_float4(mv[u].x > 0.0f ? s.x : v[u].x, mv[u].y > 0.0f ? s.y : v[u].y,
                        mv[u].z > 0.0f ? s.z : v[u].z, mv[u].w > 0.0f ? s.w : v[u].w);
      }
      dst[f] = s;
    }
  }
}

// PK3: the unit, each float4 times 1.0000001f.
__global__ void __launch_bounds__(kCThreads) copy_scale_kernel(
    const float4* __restrict__ x, float4* __restrict__ out, int64_t rows) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kUnitRows;
  const int n = static_cast<int>(min64(r0 + kUnitRows, rows) - r0) * kRowVecs;
  const float4* src = x + r0 * kRowVecs;
  float4* dst = out + r0 * kRowVecs;
  float4 v[kUnitVecs];
#pragma unroll
  for (int u = 0; u < kUnitVecs; ++u) {
    const int f = threadIdx.x + u * kCThreads;
    if (f < n) v[u] = __ldg(src + f);
  }
#pragma unroll
  for (int u = 0; u < kUnitVecs; ++u) {
    const int f = threadIdx.x + u * kCThreads;
    if (f < n) {
      dst[f] = make_float4(__fmul_rn(v[u].x, kScale), __fmul_rn(v[u].y, kScale),
                           __fmul_rn(v[u].z, kScale), __fmul_rn(v[u].w, kScale));
    }
  }
}

// PK4: block (32 x 8 threads) = one 32 x 32 sub-tile of one [ch, 128] tile.
__global__ void __launch_bounds__(kThreads) tile_transpose_kernel(
    const float* __restrict__ x, float* __restrict__ out, int ch) {
  __shared__ float tile[32][33];
  const int row_blocks = ch / 32;
  const int64_t t = blockIdx.x / row_blocks;
  const int r0 = (blockIdx.x % row_blocks) * 32;
  const int l0 = blockIdx.y * 32;
  const float* xt = x + t * ch * kLanes;
  float* ot = out + t * kLanes * ch;
  for (int j = threadIdx.y; j < 32; j += 8) {
    tile[j][threadIdx.x] = xt[static_cast<int64_t>(r0 + j) * kLanes + l0 + threadIdx.x];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8) {
    ot[static_cast<int64_t>(l0 + j) * ch + r0 + threadIdx.x] = tile[threadIdx.x][j];
  }
}

// -- PK5 ----------------------------------------------------------------------

// The global form: one thread per output element of [nc * ch, 128].
__global__ void __launch_bounds__(kThreads) fused_global_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ i1,
    const int32_t* __restrict__ i2, const int32_t* __restrict__ i3,
    float* __restrict__ out, int ch, int64_t elems) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= elems) return;
  const int64_t row = e / kLanes;
  const int64_t chunk = row / ch;
  const int r = static_cast<int>(row - chunk * ch);
  const int c = i3[e] & (kLanes - 1);
  const int r2 = i2[(chunk * kLanes + c) * ch + r] & (ch - 1);
  const int64_t src_row = chunk * ch + r2;
  out[e] = x[src_row * kLanes + (i1[src_row * kLanes + c] & (kLanes - 1))];
}

constexpr int kFThreads = 512;
constexpr int kFWarps = kFThreads / 32;
constexpr int kFUnroll = 4;             // rows or runs a thread has in flight
constexpr int kTileRows = 32;           // cluster form: rows of a stage-1 tile
constexpr int kTilePitch = kLanes + 4;  // floats: 16-byte aligned tile rows
constexpr size_t kSmemBlock = 232448;   // shared memory a block may use

__host__ __device__ int log2i(int v) {
  int s = 0;
  while ((1 << s) < v) ++s;
  return s;
}

// Block form: g chunks of ch rows a block: their y1 rows (f32, 512 bytes a
// row) and i2 tiles (int16, pitch ch + 2: the rows of a tile fall on
// different banks).  ops/probe_kernels.py mirrors it.
size_t fused_block_smem(int ch, int g) {
  return static_cast<size_t>(g) * ch * kLanes * 4 +
         static_cast<size_t>(g) * kLanes * (ch + 2) * 2;
}

// The y1 row t of this block's rows, gathered in place by i1 (warp-wide;
// lane L holds lanes 4L .. 4L+3 of x and i1).
__device__ __forceinline__ void gather_row(float* row, float4 xv, int4 iv, int lane) {
  reinterpret_cast<float4*>(row)[lane] = xv;
  __syncwarp();
  const float4 v = make_float4(row[iv.x & 127], row[iv.y & 127], row[iv.z & 127],
                               row[iv.w & 127]);
  __syncwarp();
  reinterpret_cast<float4*>(row)[lane] = v;
}

// Block form: chunks blockIdx.x * g .. +g (fewer in the last block).  Stage
// 1 brings each row of x and i1 in (a warp a row, four rows in flight) and
// gathers it in place; the i2 tiles come in masked to int16; then each
// output element reads y1[r2, c] with c = i3 & 127, r2 = i2s[c][r].
__global__ void __launch_bounds__(kFThreads) fused_block_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ i1,
    const int32_t* __restrict__ i2, const int32_t* __restrict__ i3,
    float* __restrict__ out, int nc, int ch, int g) {
  extern __shared__ __align__(16) unsigned char bsmem[];
  const int c0 = blockIdx.x * g;
  const int rows = min(g, nc - c0) * ch;
  const int lg = log2i(ch), mask = ch - 1, pitch = ch + 2;
  float* y1 = reinterpret_cast<float*>(bsmem);
  int16_t* i2s = reinterpret_cast<int16_t*>(bsmem + static_cast<size_t>(g) * ch * kLanes * 4);
  const int64_t row0 = static_cast<int64_t>(c0) * ch;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int32_t* i2g = i2 + row0 * kLanes;  // the chunks' tiles: rows * 128 ints
  const int n2 = rows * kLanes;
  if ((ch & 3) == 0) {
    for (int e = 4 * threadIdx.x; e < n2; e += 4 * kFThreads) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(i2g + e));
      const int q = e >> lg;  // tile row: chunk * 128 + column
      uint32_t* d = reinterpret_cast<uint32_t*>(i2s + q * pitch + (e & mask));
      d[0] = static_cast<uint32_t>(w.x & mask) | static_cast<uint32_t>(w.y & mask) << 16;
      d[1] = static_cast<uint32_t>(w.z & mask) | static_cast<uint32_t>(w.w & mask) << 16;
    }
  } else {
    for (int e = threadIdx.x; e < n2; e += kFThreads)
      i2s[(e >> lg) * pitch + (e & mask)] = static_cast<int16_t>(__ldg(i2g + e) & mask);
  }
  for (int t0 = warp; t0 < rows; t0 += kFUnroll * kFWarps) {
    float4 xv[kFUnroll];
    int4 iv[kFUnroll];
#pragma unroll
    for (int u = 0; u < kFUnroll; ++u) {
      const int t = t0 + u * kFWarps;
      if (t < rows) {
        xv[u] = __ldg(reinterpret_cast<const float4*>(x + (row0 + t) * kLanes) + lane);
        iv[u] = __ldg(reinterpret_cast<const int4*>(i1 + (row0 + t) * kLanes) + lane);
      }
    }
#pragma unroll
    for (int u = 0; u < kFUnroll; ++u) {
      const int t = t0 + u * kFWarps;
      if (t < rows) gather_row(y1 + t * kLanes, xv[u], iv[u], lane);
    }
  }
  __syncthreads();
  for (int t0 = warp; t0 < rows; t0 += kFUnroll * kFWarps) {
    int4 cv[kFUnroll];
#pragma unroll
    for (int u = 0; u < kFUnroll; ++u) {
      const int t = t0 + u * kFWarps;
      if (t < rows)
        cv[u] = __ldg(reinterpret_cast<const int4*>(i3 + (row0 + t) * kLanes) + lane);
    }
#pragma unroll
    for (int u = 0; u < kFUnroll; ++u) {
      const int t = t0 + u * kFWarps;
      if (t < rows) {
        const int j = t >> lg;
        const int16_t* i2r = i2s + j * kLanes * pitch + (t & mask);
        const float* yc = y1 + static_cast<size_t>(j) * ch * kLanes;
        const int cs[4] = {cv[u].x & 127, cv[u].y & 127, cv[u].z & 127, cv[u].w & 127};
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = yc[i2r[cs[k] * pitch] * kLanes + cs[k]];
        reinterpret_cast<float4*>(out + (row0 + t) * kLanes)[lane] =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// One 16-byte store into the shared memory of a block of the cluster.
__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float a, float b,
                                              float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}

// Cluster form: B's pitch, a pass's rows rounded up to 32 (B is
// XOR-swizzled); the shared memory of a block: A (128 / cl columns of the
// chunk's ch rows) and B (128 x pitch), the stage-1 tile in B's room.
// ops/probe_kernels.py mirrors it.
__host__ __device__ int fused_pitch(int rpp) { return (rpp + 31) / 32 * 32; }

size_t fused_cluster_smem(int ch, int cl, int passes) {
  const int rpp = ch / cl / passes;
  return 4 * (static_cast<size_t>(kLanes / cl) * ch +
              std::max<size_t>(static_cast<size_t>(kLanes) * fused_pitch(rpp),
                               kTileRows * kTilePitch));
}

bool fused_cluster_ok(int ch, int cl, int passes) {
  return (cl == 2 || cl == 4 || cl == 8 || cl == 16) &&
         (passes == 1 || passes == 2 || passes == 4 || passes == 8) &&
         ch % (cl * kTileRows) == 0 && (ch / cl) % (passes * 4) == 0 &&
         fused_cluster_smem(ch, cl, passes) <= kSmemBlock;
}

// Persistent clusters of cl blocks, each walking chunks cluster_id,
// cluster_id + clusters, ...; block b owns rows R_b = [b * rpb, +rpb) and
// columns C_b = [b * cpb, +cpb) of each chunk:
//   stage 1: tiles of 32 rows of R_b (warp w gathers rows w and w + 16 in
//            the tile), then each column of the tile goes to its owner's
//            A[j][r] in 16-byte runs of 4 rows;
//   stage 2: for c in C_b and each pass row r of every block, y2[c, r] =
//            A[c - b * cpb][i2[c, r] & (ch - 1)]: i2 read as int4 runs of 4
//            rows, 16-byte runs of y2 into the row owner's B;
//   stage 3: out[r, l] = B[i3[r, l] & 127][r] for the pass rows of R_b.
// B holds y2[c, r] at c * pitch + (r ^ (c % 32)): a run of 4 rows stays one
// aligned 16-byte run (its lanes permuted by c % 4), and stage 3's reads
// of one row at random columns spread over the banks.
__global__ void __launch_bounds__(kFThreads, 2) fused_cluster_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ i1,
    const int32_t* __restrict__ i2, const int32_t* __restrict__ i3,
    float* __restrict__ out, int nc, int ch, int passes) {
  extern __shared__ __align__(16) unsigned char csmem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int clusters = gridDim.x / cl;
  const int cpb = kLanes / cl, rpb = ch / cl, rpp = rpb / passes;
  const int pb = fused_pitch(rpp), q4 = rpp / 4, mask = ch - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_begin = rank * rpb;
  float* a = reinterpret_cast<float*>(csmem);
  float* b = a + cpb * ch;
  float* tile = b;
  const uint32_t a_addr = smem_addr(a), b_addr = smem_addr(b);

  cluster.sync();  // every block runs before any block writes another's memory
  for (int64_t chunk = blockIdx.x / cl; chunk < nc; chunk += clusters) {
    const int64_t row0 = chunk * ch + r_begin;  // this block's first row

    for (int t0 = 0; t0 < rpb; t0 += kTileRows) {
      float4 xv[2];
      int4 iv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t g = row0 + t0 + warp + h * kFWarps;
        xv[h] = __ldg(reinterpret_cast<const float4*>(x + g * kLanes) + lane);
        iv[h] = __ldg(reinterpret_cast<const int4*>(i1 + g * kLanes) + lane);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        gather_row(tile + (warp + h * kFWarps) * kTilePitch, xv[h], iv[h], lane);
      __syncthreads();
      // Run = (column c, tile rows 4q .. 4q+3), c = run / 8: a warp's runs
      // are 4 columns, all of one owner.
#pragma unroll
      for (int k = 0; k < kLanes * kTileRows / 4 / kFThreads; ++k) {
        const int run = threadIdx.x + k * kFThreads;
        const int c = run >> 3, q = run & 7;
        const int owner = c / cpb, j = c - owner * cpb;
        const float* col = tile + 4 * q * kTilePitch + c;
        st_cluster_v4(map_rank(a_addr + 4 * (j * ch + r_begin + t0 + 4 * q), owner),
                      col[0], col[kTilePitch], col[2 * kTilePitch], col[3 * kTilePitch]);
      }
      __syncthreads();
    }
    cluster.sync();  // every A holds its columns

    for (int p = 0; p < passes; ++p) {
      // Stage 2: run e = (j, owner, q), q fastest: column rank * cpb + j,
      // pass rows 4q .. 4q+3 of block owner.
      const int n_runs = cpb * cl * q4;
      for (int e0 = threadIdx.x; e0 < n_runs; e0 += kFUnroll * kFThreads) {
        int4 w[kFUnroll];
#pragma unroll
        for (int u = 0; u < kFUnroll; ++u) {
          const int e = e0 + u * kFThreads;
          if (e < n_runs) {
            const int q = e % q4, run = e / q4;
            const int owner = run % cl, j = run / cl;
            w[u] = __ldg(reinterpret_cast<const int4*>(
                i2 + (chunk * kLanes + rank * cpb + j) * ch + owner * rpb + p * rpp + 4 * q));
          }
        }
#pragma unroll
        for (int u = 0; u < kFUnroll; ++u) {
          const int e = e0 + u * kFThreads;
          if (e < n_runs) {
            const int q = e % q4, run = e / q4;
            const int owner = run % cl, j = run / cl;
            const float* col = a + j * ch;
            const float v0 = col[w[u].x & mask], v1 = col[w[u].y & mask];
            const float v2 = col[w[u].z & mask], v3 = col[w[u].w & mask];
            // Row 4q + e goes to lane e ^ (c % 4) of the run at 4q ^ (c % 32).
            const int c = rank * cpb + j;
            const bool sw1 = c & 1, sw2 = c & 2;
            const float a0 = sw1 ? v1 : v0, a1 = sw1 ? v0 : v1;
            const float a2 = sw1 ? v3 : v2, a3 = sw1 ? v2 : v3;
            st_cluster_v4(map_rank(b_addr + 4 * (c * pb + ((4 * q) ^ (c & 28))), owner),
                          sw2 ? a2 : a0, sw2 ? a3 : a1, sw2 ? a0 : a2, sw2 ? a1 : a3);
          }
        }
      }
      cluster.sync();  // B holds this pass's y2; after the last pass A is free

      // Stage 3: the pass's rows of R_b, a warp a row.
      const int64_t prow = row0 + p * rpp;
      for (int t0 = warp; t0 < rpp; t0 += kFUnroll * kFWarps) {
        int4 cv[kFUnroll];
#pragma unroll
        for (int u = 0; u < kFUnroll; ++u) {
          const int t = t0 + u * kFWarps;
          if (t < rpp)
            cv[u] = __ldg(reinterpret_cast<const int4*>(i3 + (prow + t) * kLanes) + lane);
        }
#pragma unroll
        for (int u = 0; u < kFUnroll; ++u) {
          const int t = t0 + u * kFWarps;
          if (t < rpp) {
            const int cs[4] = {cv[u].x & 127, cv[u].y & 127, cv[u].z & 127, cv[u].w & 127};
            float v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) v[k] = b[cs[k] * pb + (t ^ (cs[k] & 31))];
            reinterpret_cast<float4*>(out + (prow + t) * kLanes)[lane] =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        }
      }
      if (p + 1 < passes) cluster.sync();  // B is free for the next pass
      else __syncthreads();                // B's room holds the next chunk's tile
    }
  }
}

// -- launching the cluster form --

cudaLaunchConfig_t cluster_config(int clusters, int cl, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters) * cl);
  cfg.blockDim = dim3(kFThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t prepare_cluster(size_t smem, int cl) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && cl > 8)
    err = cudaFuncSetAttribute(fused_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// cudaOccupancyMaxActiveClusters of the cluster form, remembered per
// (device, ch, cl, passes): a launch asks it once.
int fused_clusters(int ch, int cl, int passes, cudaError_t* err) {
  struct Entry { int device, ch, cl, passes, clusters; };
  static Entry cache[16];
  static int used = 0;
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  for (int e = 0; e < used; ++e)
    if (cache[e].device == device && cache[e].ch == ch && cache[e].cl == cl &&
        cache[e].passes == passes)
      return cache[e].clusters;
  const size_t smem = fused_cluster_smem(ch, cl, passes);
  *err = prepare_cluster(smem, cl);
  if (*err != cudaSuccess) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t probe = cluster_config(1, cl, smem, nullptr, &attr);
  int clusters = 0;
  *err = cudaOccupancyMaxActiveClusters(&clusters, fused_cluster_kernel, &probe);
  if (*err != cudaSuccess) return 0;
  if (clusters <= 0) {
    *err = cudaErrorLaunchOutOfResources;
    return 0;
  }
  cache[used % 16] = {device, ch, cl, passes, clusters};
  used = used < 16 ? used + 1 : 16;
  return clusters;
}

// PK6: one thread per element of [rows, 128], rows a multiple of 8.
__global__ void __launch_bounds__(kThreads) sublane_gather_kernel(
    const float* __restrict__ x, const int32_t* __restrict__ idx,
    float* __restrict__ out, int64_t elems) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= elems) return;
  const int64_t group = e & ~static_cast<int64_t>(8 * kLanes - 1);
  out[e] = x[group + (idx[e] & 7) * kLanes + (e & (kLanes - 1))];
}

// PK7: the unit of out [rows, 128]; x [rows, 128 >> shift].  Component c
// of output float4 j in row r is x[r, (4j + c) >> shift]: one value stored
// four times for k >= 4, pairs at k = 2, a copy at k = 1, through one path.
// x is 1 / k of the bytes and read by 4-byte loads (L1 serves the repeats);
// the output leaves as one 16-byte streaming store (__stcs, evict first) a
// float4 (tools/probe_lane_kernels.py times the plain store beside it).
__global__ void __launch_bounds__(kCThreads) lane_repeat_kernel(
    const float* __restrict__ x, float4* __restrict__ out, int shift,
    int64_t rows) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kUnitRows;
  const int n = static_cast<int>(min64(r0 + kUnitRows, rows) - r0) * kRowVecs;
  const int width = kLanes >> shift;
  const float* src = x + r0 * width;
  float4* dst = out + r0 * kRowVecs;
  float4 v[kUnitVecs];
#pragma unroll
  for (int u = 0; u < kUnitVecs; ++u) {
    const int f = threadIdx.x + u * kCThreads;
    if (f < n) {
      const float* row = src + (f / kRowVecs) * width;
      const int l = 4 * (f % kRowVecs);
      v[u] = make_float4(__ldg(row + (l >> shift)), __ldg(row + ((l + 1) >> shift)),
                         __ldg(row + ((l + 2) >> shift)), __ldg(row + ((l + 3) >> shift)));
    }
  }
#pragma unroll
  for (int u = 0; u < kUnitVecs; ++u) {
    const int f = threadIdx.x + u * kCThreads;
    if (f < n) __stcs(dst + f, v[u]);
  }
}

}  // namespace

// Every entry point returns the CUDA error code of its launch (0 on
// success) and launches on `stream`.

// PK1: x, idx, out [n] (n a multiple of window, window a power of two).
extern "C" int photon_probe_window_gather(const float* x, const int32_t* idx,
                                          float* out, int64_t n, int window,
                                          void* stream) {
  if (n <= 0 || !pow2(window) || window > kStage || n % window) {
    return cudaErrorInvalidValue;
  }
  window_gather_kernel<<<blocks_for(n, kStage), kThreads, 0, as_stream(stream)>>>(
      x, idx, out, n, window);
  return static_cast<int>(cudaGetLastError());
}

// PK2: x, mask (or null), out [rows, 128] (16-byte aligned); h, the tile
// height, is only validated.
extern "C" int photon_probe_lane_swap(const float* x, const float* mask,
                                      float* out, int64_t rows, int h,
                                      void* stream) {
  unsigned blocks = 0;
  if (h <= 0 || !unit_blocks(rows, &blocks)) return cudaErrorInvalidValue;
  lane_swap_kernel<<<blocks, kCThreads, 0, as_stream(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(mask),
      reinterpret_cast<float4*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

// PK3: x, out [rows, 128] (16-byte aligned); h, the tile height, is only
// validated.
extern "C" int photon_probe_copy_scale(const float* x, float* out,
                                       int64_t rows, int h, void* stream) {
  unsigned blocks = 0;
  if (h <= 0 || !unit_blocks(rows, &blocks)) return cudaErrorInvalidValue;
  copy_scale_kernel<<<blocks, kCThreads, 0, as_stream(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

// PK4: x [n_tiles * ch, 128] -> out [n_tiles * 128, ch]; ch a multiple of 32.
extern "C" int photon_probe_tile_transpose(const float* x, float* out,
                                           int n_tiles, int ch, void* stream) {
  if (n_tiles <= 0 || ch <= 0 || ch % 32) return cudaErrorInvalidValue;
  const int64_t blocks = static_cast<int64_t>(n_tiles) * (ch / 32);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  tile_transpose_kernel<<<dim3(static_cast<unsigned>(blocks), kLanes / 32),
                          dim3(32, 8), 0, as_stream(stream)>>>(x, out, ch);
  return static_cast<int>(cudaGetLastError());
}

// PK5: x, i1, i3, out [nc * ch, 128]; i2 [nc * 128, ch]; ch a power of
// two; 16-byte aligned.  form 0: the global form; 1: the block form, g =
// arg chunks a block; 2: the cluster form, arg blocks a cluster, `passes`
// passes of stages 2 and 3.  ops/probe_kernels.fused_chunk_form picks it.
extern "C" int photon_probe_fused_chunk(const float* x, const int32_t* i1,
                                        const int32_t* i2, const int32_t* i3,
                                        float* out, int nc, int ch, int form,
                                        int arg, int passes, void* stream) {
  if (nc <= 0 || !pow2(ch)) return cudaErrorInvalidValue;
  cudaStream_t s = as_stream(stream);
  if (form == 0) {
    const int64_t elems = static_cast<int64_t>(nc) * ch * kLanes;
    fused_global_kernel<<<blocks_for(elems, kThreads), kThreads, 0, s>>>(
        x, i1, i2, i3, out, ch, elems);
    return static_cast<int>(cudaGetLastError());
  }
  if (form == 1) {
    const int g = arg;
    const size_t smem = fused_block_smem(ch, g);
    if (g < 1 || smem > kSmemBlock)
      return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fused_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fused_block_kernel<<<(nc + g - 1) / g, kFThreads, smem, s>>>(x, i1, i2, i3, out, nc, ch, g);
    return static_cast<int>(cudaGetLastError());
  }
  if (form != 2 || !fused_cluster_ok(ch, arg, passes)) return cudaErrorInvalidValue;
  const size_t smem = fused_cluster_smem(ch, arg, passes);
  cudaError_t err = prepare_cluster(smem, arg);
  if (err != cudaSuccess) return err;
  const int clusters = fused_clusters(ch, arg, passes, &err);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(std::min(nc, clusters), arg, smem, s, &attr);
  err = cudaLaunchKernelEx(&cfg, fused_cluster_kernel, x, i1, i2, i3, out, nc, ch, passes);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

// PK5's cluster form: how many clusters of `cl` blocks at chunk height ch
// and `passes` passes the card runs at once (cudaOccupancyMaxActiveClusters);
// negative: minus the CUDA error code.
extern "C" int photon_probe_fused_chunk_clusters(int ch, int cl, int passes) {
  if (!pow2(ch) || !fused_cluster_ok(ch, cl, passes))
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  const int clusters = fused_clusters(ch, cl, passes, &err);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// PK6: x, idx, out [rows, 128]; rows a multiple of 8.
extern "C" int photon_probe_sublane_gather(const float* x, const int32_t* idx,
                                           float* out, int64_t rows,
                                           void* stream) {
  if (rows <= 0 || rows % 8) return cudaErrorInvalidValue;
  const int64_t elems = rows * kLanes;
  sublane_gather_kernel<<<blocks_for(elems, kThreads), kThreads, 0,
                          as_stream(stream)>>>(x, idx, out, elems);
  return static_cast<int>(cudaGetLastError());
}

// PK7: x [rows, 128 / k] (float aligned) -> out [rows, 128] (16-byte
// aligned); k a power of two dividing 128.
extern "C" int photon_probe_lane_repeat(const float* x, float* out,
                                        int64_t rows, int k, void* stream) {
  unsigned blocks = 0;
  if (!pow2(k) || k > kLanes || !unit_blocks(rows, &blocks)) return cudaErrorInvalidValue;
  int shift = 0;
  while ((1 << shift) < k) ++shift;
  lane_repeat_kernel<<<blocks, kCThreads, 0, as_stream(stream)>>>(
      x, reinterpret_cast<float4*>(out), shift, rows);
  return static_cast<int>(cudaGetLastError());
}
