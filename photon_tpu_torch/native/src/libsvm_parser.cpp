// Multi-threaded LIBSVM parser.
//
// Native-runtime component of the TPU rebuild (SURVEY.md §2.4): the
// reference's hot IO paths run on the JVM (Spark/Avro readers); here the
// host-side data loader is native C++ so parse throughput keeps up with
// device compute.  The file is mmap'd, line-indexed in one pass, and parsed
// into CSR arrays by a thread pool; Python (ctypes) sees three calls:
// svm_open -> svm_parse -> svm_close.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <charconv>
#include <clocale>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct SvmFile {
  char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool owned = false;  // heap copy instead of mmap (page-boundary case)
  std::vector<size_t> line_start;  // offsets of non-empty payload lines
  std::vector<size_t> line_end;    // exclusive; comments/whitespace trimmed
  std::vector<int64_t> row_nnz;
  int64_t total_nnz = 0;
};

unsigned nthreads(int64_t rows) {
  unsigned n = std::thread::hardware_concurrency();
  if (n == 0) n = 1;
  n = std::min(n, 16u);
  // Tiny files: thread spawn dominates.
  if (rows < 4096) n = 1;
  return n;
}

// Locale-free float parse via std::from_chars (~3-5x strtof), bounded at
// `end` (a number can never bleed past the trimmed line).  Parity shims:
// an optional leading '+' (strtof/Python accept it; from_chars does not)
// and the out-of-range case, which falls back to strtof so overflowing
// magnitudes become +/-inf and underflows become 0/denormal exactly as
// before (the svm_open terminator guarantee keeps strtof in bounds).
// Returns the end of the parsed token, or `p` itself on no-parse.
//
// libstdc++ shipped floating-point from_chars only from GCC 11
// (__cpp_lib_to_chars); older toolchains take a strtof path for every
// token, shimmed for cross-toolchain parity: strtof ALSO skips leading
// whitespace (refused up front — from_chars and the Python reference both
// reject it), accepts hex floats ("0x2" must parse as the leading zero
// only, like from_chars' general format), and honors LC_NUMERIC (a
// comma-decimal locale set by any host library would reparse "1.5" as "1"),
// so glibc builds parse under a cached "C" locale via strtof_l.
#if defined(__cpp_lib_to_chars)
inline const char* parse_float(const char* p, const char* end, float* out) {
  const char* q = p;
  // Skip one '+' only when a number follows: "+-2.5" must stay a parse
  // error (strtof and the Python fallback both reject double signs).
  if (q + 1 < end && *q == '+' &&
      ((q[1] >= '0' && q[1] <= '9') || q[1] == '.' || q[1] == 'i' ||
       q[1] == 'I' || q[1] == 'n' || q[1] == 'N'))
    q++;
  auto r = std::from_chars(q, end, *out);
  if (r.ec == std::errc()) return r.ptr;
  if (r.ec == std::errc::result_out_of_range) {
    char* ep = nullptr;
    *out = strtof(p, &ep);
    return ep;
  }
  return p;
}
#else
inline const char* parse_float(const char* p, const char* end, float* out) {
  if (p >= end || *p == ' ' || *p == '\t' || *p == '\n' || *p == '\r' ||
      *p == '\f' || *p == '\v')
    return p;
  const char* q = p;
  if (*q == '+' || *q == '-') ++q;
  if (q + 1 < end && q[0] == '0' && (q[1] == 'x' || q[1] == 'X')) {
    // from_chars parity: hex is not in the general format — "0x2" parses
    // as the leading zero and stops at the 'x'.
    *out = (*p == '-') ? -0.0f : 0.0f;
    return q + 1;
  }
  char* ep = nullptr;
#if defined(__GLIBC__)
  static const locale_t c_locale = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  *out = c_locale != (locale_t)0 ? strtof_l(p, &ep, c_locale)
                                 : strtof(p, &ep);
#else
  *out = strtof(p, &ep);
#endif
  if (ep == p || ep > end) return p;
  return ep;
}
#endif

}  // namespace

extern "C" {

// Map the file and index its data lines + per-row nonzero counts.
// Returns an opaque handle, or null on IO failure / empty file.
void* svm_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  auto* f = new SvmFile;
  f->data = static_cast<char*>(map);
  f->size = static_cast<size_t>(st.st_size);
  f->fd = fd;

  // strtof/strtol need a readable terminator after the last byte.  A file
  // whose size is an exact multiple of the page size has NO zero-filled
  // tail, so a final line without '\n' would read one byte past the
  // mapping.  Copy to a null-terminated heap buffer in that (rare) case.
  const size_t page = static_cast<size_t>(sysconf(_SC_PAGESIZE));
  if (f->size % page == 0 && f->data[f->size - 1] != '\n') {
    char* copy = static_cast<char*>(malloc(f->size + 1));
    if (!copy) {
      munmap(map, f->size);
      close(fd);
      delete f;
      return nullptr;
    }
    memcpy(copy, f->data, f->size);
    copy[f->size] = '\0';
    munmap(map, f->size);
    close(fd);
    f->data = copy;
    f->fd = -1;
    f->owned = true;
  }

  size_t pos = 0;
  while (pos < f->size) {
    const char* nl = static_cast<const char*>(
        memchr(f->data + pos, '\n', f->size - pos));
    size_t end = nl ? static_cast<size_t>(nl - f->data) : f->size;
    size_t s = pos, e = end;
    const char* hash =
        static_cast<const char*>(memchr(f->data + s, '#', e - s));
    if (hash) e = static_cast<size_t>(hash - f->data);
    while (s < e &&
           (f->data[s] == ' ' || f->data[s] == '\t' || f->data[s] == '\r'))
      s++;
    while (e > s && (f->data[e - 1] == ' ' || f->data[e - 1] == '\t' ||
                     f->data[e - 1] == '\r'))
      e--;
    if (e > s) {
      f->line_start.push_back(s);
      f->line_end.push_back(e);
    }
    pos = end + 1;
  }

  const int64_t rows = static_cast<int64_t>(f->line_start.size());
  f->row_nnz.assign(rows, 0);
  const unsigned nt = nthreads(rows);
  std::vector<std::thread> ts;
  std::vector<int64_t> partial(nt, 0);
  for (unsigned t = 0; t < nt; ++t) {
    ts.emplace_back([f, t, nt, rows, &partial]() {
      int64_t local = 0;
      for (int64_t i = t; i < rows; i += nt) {
        const char* p = f->data + f->line_start[i];
        const char* e = f->data + f->line_end[i];
        int64_t c = 0;
        while (p < e && (p = static_cast<const char*>(
                             memchr(p, ':', e - p))) != nullptr) {
          c++;
          p++;
        }
        f->row_nnz[i] = c;
        local += c;
      }
      partial[t] = local;
    });
  }
  for (auto& th : ts) th.join();
  for (int64_t v : partial) f->total_nnz += v;
  return f;
}

int64_t svm_rows(void* h) {
  return static_cast<int64_t>(static_cast<SvmFile*>(h)->line_start.size());
}

int64_t svm_total_nnz(void* h) { return static_cast<SvmFile*>(h)->total_nnz; }

void svm_row_nnz(void* h, int64_t* out) {
  auto* f = static_cast<SvmFile*>(h);
  memcpy(out, f->row_nnz.data(), f->row_nnz.size() * sizeof(int64_t));
}

// Parse every row into caller-allocated CSR arrays.  row_ptr is the
// exclusive prefix sum of row_nnz (rows + 1 entries).  Returns the max
// feature id seen after the zero/one-based adjustment, -1 for an all-empty
// file, or -2 on malformed input.
//
// Bounds note: strtof/strtol may scan a few bytes past a row's logical end
// but never past the buffer: either the final page's zero-filled tail
// terminates the scan, or svm_open copied the file into a null-terminated
// heap buffer (exact-page-multiple files with no trailing newline).
int64_t svm_parse(void* h, const int64_t* row_ptr, float* labels,
                  int32_t* ids, float* vals, int zero_based) {
  auto* f = static_cast<SvmFile*>(h);
  const int64_t rows = static_cast<int64_t>(f->line_start.size());
  const unsigned nt = nthreads(rows);
  std::vector<std::thread> ts;
  std::vector<int64_t> maxids(nt, -1);
  std::vector<int> errs(nt, 0);
  const int off = zero_based ? 0 : 1;
  for (unsigned t = 0; t < nt; ++t) {
    ts.emplace_back([=, &maxids, &errs]() {
      int64_t mx = -1;
      for (int64_t i = t; i < rows; i += nt) {
        const char* p = f->data + f->line_start[i];
        const char* e = f->data + f->line_end[i];
        const char* endp = parse_float(p, e, &labels[i]);
        if (endp == p) {
          errs[t] = 1;
          return;
        }
        p = endp;
        int64_t w = row_ptr[i];
        while (p < e) {
          while (p < e && (*p == ' ' || *p == '\t')) p++;
          if (p >= e) break;
          // int64 parse (from_chars: no '+' — skip one for strtoll/Python
          // parity); an out-of-range id errors below exactly as strtoll's
          // LLONG_MAX saturation did.
          const char* idp = (*p == '+' && p + 1 < e) ? p + 1 : p;
          long long id;
          auto idr = std::from_chars(idp, e, id);
          if (idr.ec == std::errc::result_out_of_range) id = INT64_MAX;
          else if (idr.ec != std::errc()) {
            errs[t] = 1;
            return;
          }
          endp = idr.ptr;
          if (endp == idp || endp >= e || *endp != ':') {
            errs[t] = 1;
            return;
          }
          // Feature ids land in int32 storage after the zero/one-based
          // adjustment; out-of-range ids (overflowing files, negative ids)
          // must be a parse error, not a silent int32 wraparound.
          if (id < off || id - off > INT32_MAX) {
            errs[t] = 1;
            return;
          }
          p = endp + 1;
          // The value must start immediately after the colon: a bare "id:"
          // at end of line (p >= e) or "id: val" would otherwise let strtof
          // skip whitespace — including the newline, stealing the NEXT
          // line's label as this feature's value.  The Python parser errors
          // on both, and both paths must accept the same files.
          if (p >= e || *p == ' ' || *p == '\t' || *p == '\r' ||
              *p == '\n' || *p == '\v' || *p == '\f') {
            errs[t] = 1;
            return;
          }
          float v;
          endp = parse_float(p, e, &v);
          if (endp == p) {
            errs[t] = 1;
            return;
          }
          p = endp;
          ids[w] = static_cast<int32_t>(id - off);
          vals[w] = v;
          if (ids[w] > mx) mx = ids[w];
          ++w;
        }
        if (w != row_ptr[i + 1]) {
          errs[t] = 1;
          return;
        }
      }
      maxids[t] = std::max(maxids[t], mx);
    });
  }
  for (auto& th : ts) th.join();
  for (int er : errs)
    if (er) return -2;
  int64_t mx = -1;
  for (int64_t v : maxids) mx = std::max(mx, v);
  return mx;
}

void svm_close(void* h) {
  auto* f = static_cast<SvmFile*>(h);
  if (f->owned) {
    free(f->data);
  } else {
    munmap(f->data, f->size);
    close(f->fd);
  }
  delete f;
}

}  // extern "C"
