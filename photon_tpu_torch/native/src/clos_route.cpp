// Clos routing for static element permutations (the `benes` sparse kernel).
//
// The TPU-side plan (ops/KERNEL_NOTES.md, round-4 second-window verdicts)
// rewrites the random E-element exchange between row-major and
// feature-major entry orders as: per-row local permutations + matrix
// transposes.  Any permutation of an [A x B] grid factors as
//
//     P1 (independent B-perm per row) . T . P2 (A-perm per row of [B,A])
//        . T . P3 (independent B-perm per row)
//
// iff each element is assigned a "middle column" color c in [0,B) such
// that no two elements sharing a source row get the same color and no two
// elements sharing a destination row get the same color.  Model each
// element as an edge (source_row -> dest_row) of a B-regular bipartite
// multigraph on A+A vertices; a proper B-edge-coloring (exists by Konig's
// theorem) IS that assignment.  This file computes the coloring by Euler
// splitting: walk Euler circuits, label edges alternately, recurse on the
// two (B/2)-regular halves until degree 1.  Bipartite circuits have even
// length, so the alternation splits every vertex's degree exactly in half
// at every level; B must be a power of two.
//
// This is host-side, one-time-per-layout routing (the permutation is
// static data layout, not step data); the device step then runs only
// sequential reads, lane-local shuffles, and transposes.
//
// Exposed C API (ctypes):
//   clos_edge_color(E, A, B, l[], r[], color[]) -> 0 ok / <0 error

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// One Euler-split edge coloring over edges[0..E) of a B-regular bipartite
// multigraph with A vertices per side.  Iterative over an explicit task
// stack; scratch vectors are reused across tasks to bound allocation.
//
// Performance shape (round-4 rework): every per-task structure is a
// DENSE int32 copy of the subset (endpoints included), so the Euler
// walk's three dependent indirections (cursor -> slot -> used) touch
// arrays of the SUBSET's size — tasks halve per level, so deeper levels
// run cache-resident instead of striding the full-E arrays.  This took
// the walk from ~75 ns/edge-step to ~20 ns at production sizes.
struct Scratch {
  std::vector<int32_t> head;     // per vertex: next unused slot cursor
  std::vector<int32_t> stop;     // per vertex: end of slot range
  std::vector<int32_t> slots;    // 2n slot -> dense edge index
  std::vector<int32_t> ld, rd;   // dense endpoints (rd pre-offset by A)
  std::vector<int32_t> sub;      // dense index -> global edge id
  std::vector<uint8_t> used;     // per dense edge: consumed in walk
  std::vector<int32_t> stack;    // edge frames for Hierholzer
  std::vector<int32_t> vstack;   // vertex frames for Hierholzer
  std::vector<int32_t> circuit;  // dense edge ids in circuit order
};

int color_one(int64_t E, int32_t A, int32_t B, const int32_t* l,
              const int32_t* r, int32_t* color, Scratch& s) {
  if (B <= 0 || (B & (B - 1)) != 0) return -1;  // power of two required
  // Task = (subset of edges, color base, span).  Subsets are stored in a
  // shared arena; tasks reference [begin, end) ranges.
  std::vector<int32_t> arena(E);
  for (int64_t e = 0; e < E; ++e) arena[e] = static_cast<int32_t>(e);
  struct Task {
    int64_t begin, end;
    int32_t base, span;
  };
  std::vector<Task> tasks;
  tasks.push_back({0, E, 0, B});

  const int32_t V = 2 * A;
  s.head.assign(V + 1, 0);
  s.stop.assign(V, 0);

  while (!tasks.empty()) {
    Task t = tasks.back();
    tasks.pop_back();
    const int64_t n = t.end - t.begin;
    if (t.span == 1) {
      for (int64_t i = t.begin; i < t.end; ++i) color[arena[i]] = t.base;
      continue;
    }
    // Dense subset copy: one scattered read of l/r per level, then the
    // whole task works on contiguous int32 arrays.
    s.sub.resize(n);
    s.ld.resize(n);
    s.rd.resize(n);
    std::memcpy(s.sub.data(), arena.data() + t.begin, n * sizeof(int32_t));
    for (int64_t i = 0; i < n; ++i) {
      const int32_t e = s.sub[i];
      s.ld[i] = l[e];
      s.rd[i] = A + r[e];
    }
    // CSR over the subset's vertices: count, prefix, fill.  head/stop
    // cover all V vertices (untouched ones get empty ranges) — O(V) per
    // task, small next to n at every level that matters.
    std::fill(s.head.begin(), s.head.end(), 0);
    for (int64_t i = 0; i < n; ++i) {
      s.head[s.ld[i] + 1]++;
      s.head[s.rd[i] + 1]++;
    }
    for (int32_t v = 0; v < V; ++v) s.head[v + 1] += s.head[v];
    s.slots.resize(2 * n);
    for (int32_t v = 0; v < V; ++v) s.stop[v] = s.head[v + 1];
    {
      std::vector<int32_t> fill(s.head.begin(), s.head.end() - 1);
      for (int64_t i = 0; i < n; ++i) {
        s.slots[fill[s.ld[i]]++] = static_cast<int32_t>(i);
        s.slots[fill[s.rd[i]]++] = static_cast<int32_t>(i);
      }
    }
    s.used.assign(n, 0);

    // Hierholzer from every vertex with unused slots; label circuit edges
    // alternately.  Bipartite circuits have even length, so cyclic
    // alternation gives every vertex visit one edge of each label and the
    // vertex's degree splits exactly in half.  We push the edge used to
    // REACH a vertex; popping emits it, so `circuit` holds the Euler
    // circuit in reverse traversal order — still a circuit, which is all
    // alternation needs.
    const int64_t half = t.begin + n / 2;
    int64_t lo = t.begin, hi = half;  // arena write cursors for halves
    for (int32_t v0 = 0; v0 < V; ++v0) {
      while (s.head[v0] < s.stop[v0]) {
        if (s.used[s.slots[s.head[v0]]]) {
          s.head[v0]++;
          continue;
        }
        s.stack.clear();
        s.circuit.clear();
        s.vstack.clear();
        s.vstack.push_back(v0);
        s.stack.push_back(-1);
        while (!s.vstack.empty()) {
          const int32_t v = s.vstack.back();
          while (s.head[v] < s.stop[v] && s.used[s.slots[s.head[v]]]) {
            s.head[v]++;
          }
          if (s.head[v] < s.stop[v]) {
            const int32_t e = s.slots[s.head[v]];
            s.used[e] = 1;
            const int32_t a = s.ld[e], b = s.rd[e];
            s.vstack.push_back(v == a ? b : a);
            s.stack.push_back(e);
          } else {
            const int32_t e = s.stack.back();
            s.stack.pop_back();
            s.vstack.pop_back();
            if (e >= 0) s.circuit.push_back(e);
          }
        }
        // Alternate labels along the circuit (dense -> global ids).
        for (size_t i = 0; i < s.circuit.size(); ++i) {
          const int32_t g = s.sub[s.circuit[i]];
          if (i % 2 == 0) {
            arena[lo++] = g;
          } else {
            arena[hi++] = g;
          }
        }
      }
    }
    if (lo != half || hi != t.end) return -2;  // split imbalance: bug
    tasks.push_back({t.begin, half, t.base, t.span / 2});
    tasks.push_back({half, t.end,
                     static_cast<int32_t>(t.base + t.span / 2), t.span / 2});
  }
  return 0;
}

}  // namespace

extern "C" {

int32_t clos_edge_color(int64_t E, int32_t A, int32_t B, const int32_t* l,
                        const int32_t* r, int32_t* color) {
  // The arena, dense subset arrays (sub/ld/rd/slots), and the CSR
  // prefix sums in head are int32; head reaches 2*E at the root task,
  // so edge counts must stay under INT32_MAX/2 or the cursors wrap and
  // index out of bounds.  Refuse explicitly (distinct code: -1 = bad B,
  // -2 = internal split invariant, -3 = size limit).
  if (E < 0 || E > INT32_MAX / 2) return -3;
  Scratch s;
  return color_one(E, A, B, l, r, color, s);
}

}  // extern "C"
