// Columnar decoder for GAME training-record Avro container files.
//
// The pure-Python codec (photon_tpu/data/avro_codec.py) decodes each record
// into a dict and the reader walks features in Python — the throughput
// ceiling of the 1B-row GAME ingestion story.  The reference reads the same
// records through the JVM's native Avro decoder; this is the TPU rebuild's
// equivalent (SURVEY.md §2.4 "native where the reference's is").
//
// Scope: the TrainingExampleAvro shape (photon_tpu/data/game_io.py) over
// null-codec container blocks.  Python parses the container HEADER (schema
// JSON, codec, sync marker) and compiles the record schema into a flat
// opcode descriptor; this decoder executes it per record over an mmapped
// file, emitting columnar streams:
//   - one f64 stream per (OPT_)DOUBLE slot (null -> descriptor default),
//   - one i32 stream + interned vocab per STRING slot (entity-id columns),
//   - per BAG slot: per-record nnz, per-entry interned (name, term) pair
//     ids + f32 values, and the pair vocab in first-seen order (which is
//     entry order — exactly the Python reader's first-seen id assignment).
// Schemas outside the compiled subset fall back to the Python reader.
//
// Written from the public Avro 1.x wire spec (zigzag varints, length-
// prefixed strings, block-structured arrays); no Avro implementation code.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Descriptor opcodes (must match photon_tpu/native/avro_native.py).
enum Op : uint8_t {
  OP_DOUBLE = 1,        // scalar double
  OP_OPT_DOUBLE = 2,    // + null_branch(1B) + default(8B LE double)
  OP_STRING = 3,        // interned string -> id stream
  OP_SKIP_STRING = 4,   // decoded, discarded
  OP_SKIP_OPT_STRING = 5,  // + null_branch(1B)
  OP_BAG = 6,           // array<{string,string,double}>
  OP_SKIP_BAG = 7,      // decoded, discarded
  OP_SKIP_DOUBLE = 8,
  OP_SKIP_OPT_DOUBLE = 9,  // + null_branch(1B)
};

struct Vocab {
  // Composite-key interner: key bytes are length-unambiguous
  // (u32 name_len + name + term), values are first-seen ids.
  std::unordered_map<std::string, int32_t> map;
  std::vector<std::string> names;  // per id
  std::vector<std::string> terms;
};

struct BagOut {
  std::vector<int32_t> nnz;     // per record
  std::vector<int32_t> pairs;   // per entry
  std::vector<float> vals;      // per entry
  Vocab vocab;
};

struct StrOut {
  std::vector<int32_t> idx;  // per record
  std::vector<std::string> vocab;
  std::unordered_map<std::string, int32_t> map;
};

struct GavFile {
  const uint8_t* base = nullptr;
  size_t size = 0;
  size_t pos = 0;       // first block offset (from Python header parse)
  uint8_t sync[16];
  std::vector<uint8_t> desc;
  std::vector<std::vector<double>> dbl;  // per (OPT_)DOUBLE slot
  std::vector<StrOut> str;               // per STRING slot
  std::vector<BagOut> bags;              // per BAG slot
  int64_t n_records = 0;
  std::string error;
  int fd = -1;
};

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool fail = false;
};

inline int64_t read_varlong(Cursor& c) {
  uint64_t acc = 0;
  int shift = 0;
  while (true) {
    if (c.p >= c.end) { c.fail = true; return 0; }
    uint8_t b = *c.p++;
    acc |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
    if (shift > 63) { c.fail = true; return 0; }
  }
  return static_cast<int64_t>((acc >> 1) ^ (~(acc & 1) + 1));
}

inline double read_double(Cursor& c) {
  if (c.p + 8 > c.end) { c.fail = true; return 0.0; }
  double v;
  std::memcpy(&v, c.p, 8);
  c.p += 8;
  return v;
}

// Returns (ptr, len) of a length-prefixed string; nullptr on bounds error.
// (n is compared against the remaining byte count, never added to the
// pointer first — a hostile length must not overflow the arithmetic.)
inline const char* read_str(Cursor& c, int64_t* len) {
  int64_t n = read_varlong(c);
  if (c.fail || n < 0 || n > c.end - c.p) { c.fail = true; return nullptr; }
  const char* s = reinterpret_cast<const char*>(c.p);
  c.p += n;
  *len = n;
  return s;
}

bool decode_record(GavFile* h, Cursor& c) {
  size_t di = 0;
  int dbl_slot = 0, str_slot = 0, bag_slot = 0;
  const std::vector<uint8_t>& d = h->desc;
  while (di < d.size()) {
    switch (d[di++]) {
      case OP_DOUBLE:
        h->dbl[dbl_slot++].push_back(read_double(c));
        break;
      case OP_OPT_DOUBLE: {
        uint8_t null_branch = d[di++];
        double dflt;
        std::memcpy(&dflt, &d[di], 8);
        di += 8;
        int64_t branch = read_varlong(c);
        h->dbl[dbl_slot++].push_back(
            branch == null_branch ? dflt : read_double(c));
        break;
      }
      case OP_SKIP_DOUBLE:
        read_double(c);
        break;
      case OP_SKIP_OPT_DOUBLE: {
        uint8_t null_branch = d[di++];
        if (read_varlong(c) != null_branch) read_double(c);
        break;
      }
      case OP_STRING: {
        int64_t len;
        const char* s = read_str(c, &len);
        if (c.fail) return false;
        StrOut& so = h->str[str_slot++];
        std::string key(s, len);
        auto it = so.map.find(key);
        int32_t id;
        if (it == so.map.end()) {
          id = static_cast<int32_t>(so.vocab.size());
          so.vocab.push_back(key);
          so.map.emplace(std::move(key), id);
        } else {
          id = it->second;
        }
        so.idx.push_back(id);
        break;
      }
      case OP_SKIP_STRING: {
        int64_t len;
        read_str(c, &len);
        break;
      }
      case OP_SKIP_OPT_STRING: {
        uint8_t null_branch = d[di++];
        if (read_varlong(c) != null_branch) {
          int64_t len;
          read_str(c, &len);
        }
        break;
      }
      case OP_BAG:
      case OP_SKIP_BAG: {
        bool keep = d[di - 1] == OP_BAG;
        BagOut* bo = keep ? &h->bags[bag_slot++] : nullptr;
        int32_t count = 0;
        while (true) {
          int64_t n = read_varlong(c);
          if (c.fail) return false;
          if (n == 0) break;
          if (n < 0) {  // block with byte-size prefix
            if (n == INT64_MIN) {  // -n would be signed-overflow UB
              c.fail = true;
              return false;
            }
            read_varlong(c);
            if (c.fail) return false;
            n = -n;
          }
          for (int64_t i = 0; i < n; i++) {
            int64_t nlen, tlen;
            const char* name = read_str(c, &nlen);
            const char* term = read_str(c, &tlen);
            double value = read_double(c);
            if (c.fail) return false;
            if (keep) {
              uint32_t nl = static_cast<uint32_t>(nlen);
              std::string key;
              key.reserve(4 + nlen + tlen);
              key.append(reinterpret_cast<const char*>(&nl), 4);
              key.append(name, nlen);
              key.append(term, tlen);
              auto it = bo->vocab.map.find(key);
              int32_t id;
              if (it == bo->vocab.map.end()) {
                id = static_cast<int32_t>(bo->vocab.names.size());
                bo->vocab.names.emplace_back(name, nlen);
                bo->vocab.terms.emplace_back(term, tlen);
                bo->vocab.map.emplace(std::move(key), id);
              } else {
                id = it->second;
              }
              bo->pairs.push_back(id);
              bo->vals.push_back(static_cast<float>(value));
            }
          }
          count += static_cast<int32_t>(n);
        }
        if (keep) bo->nnz.push_back(count);
        break;
      }
      default:
        h->error = "bad descriptor opcode";
        return false;
    }
    if (c.fail) return false;
  }
  return true;
}

}  // namespace

extern "C" {

void* gav_open(const char* path, int64_t data_offset, const uint8_t* sync,
               const uint8_t* desc, int64_t desc_len) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < data_offset) {
    ::close(fd);
    return nullptr;
  }
  GavFile* h = new GavFile();
  h->fd = fd;
  h->size = static_cast<size_t>(st.st_size);
  if (h->size > 0) {
    void* m = mmap(nullptr, h->size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) {
      ::close(fd);
      delete h;
      return nullptr;
    }
    h->base = static_cast<const uint8_t*>(m);
  }
  h->pos = static_cast<size_t>(data_offset);
  std::memcpy(h->sync, sync, 16);
  h->desc.assign(desc, desc + desc_len);
  // Pre-size slot vectors by scanning the descriptor.
  size_t di = 0;
  while (di < h->desc.size()) {
    switch (h->desc[di++]) {
      case OP_DOUBLE: h->dbl.emplace_back(); break;
      case OP_OPT_DOUBLE: h->dbl.emplace_back(); di += 9; break;
      case OP_SKIP_OPT_DOUBLE: di += 1; break;
      case OP_SKIP_OPT_STRING: di += 1; break;
      case OP_STRING: h->str.emplace_back(); break;
      case OP_BAG: h->bags.emplace_back(); break;
      default: break;
    }
  }
  return h;
}

// Decode all blocks; returns record count or -1 (gav_error has detail).
int64_t gav_decode(void* hp) {
  GavFile* h = static_cast<GavFile*>(hp);
  Cursor c{h->base + h->pos, h->base + h->size};
  while (c.p < c.end) {
    int64_t count = read_varlong(c);
    if (c.fail) { h->error = "truncated block header"; return -1; }
    if (count < 0) {  // would desync n_records from the column lengths
      h->error = "negative block record count";
      return -1;
    }
    int64_t bytes = read_varlong(c);
    if (c.fail || bytes < 0 || bytes > c.end - c.p) {
      h->error = "bad block byte size";
      return -1;
    }
    const uint8_t* block_end = c.p + bytes;
    for (int64_t i = 0; i < count; i++) {
      if (!decode_record(h, c)) {
        if (h->error.empty()) h->error = "truncated record";
        return -1;
      }
    }
    if (c.p != block_end) {
      h->error = "block size mismatch (codec not null?)";
      return -1;
    }
    if (c.p + 16 > c.end || std::memcmp(c.p, h->sync, 16) != 0) {
      h->error = "sync marker mismatch";
      return -1;
    }
    c.p += 16;
    h->n_records += count;
  }
  return h->n_records;
}

const char* gav_error(void* hp) {
  return static_cast<GavFile*>(hp)->error.c_str();
}

void gav_doubles(void* hp, int32_t slot, double* out) {
  auto& v = static_cast<GavFile*>(hp)->dbl[slot];
  std::memcpy(out, v.data(), v.size() * sizeof(double));
}

void gav_string_ids(void* hp, int32_t slot, int32_t* out) {
  auto& v = static_cast<GavFile*>(hp)->str[slot].idx;
  std::memcpy(out, v.data(), v.size() * sizeof(int32_t));
}

int64_t gav_string_vocab_size(void* hp, int32_t slot) {
  return static_cast<GavFile*>(hp)->str[slot].vocab.size();
}

int64_t gav_string_vocab_bytes(void* hp, int32_t slot) {
  int64_t total = 0;
  for (auto& s : static_cast<GavFile*>(hp)->str[slot].vocab) total += s.size();
  return total;
}

void gav_string_vocab(void* hp, int32_t slot, int32_t* lens, char* bytes) {
  for (auto& s : static_cast<GavFile*>(hp)->str[slot].vocab) {
    *lens++ = static_cast<int32_t>(s.size());
    std::memcpy(bytes, s.data(), s.size());
    bytes += s.size();
  }
}

int64_t gav_bag_entries(void* hp, int32_t slot) {
  return static_cast<GavFile*>(hp)->bags[slot].pairs.size();
}

void gav_bag_nnz(void* hp, int32_t slot, int32_t* out) {
  auto& v = static_cast<GavFile*>(hp)->bags[slot].nnz;
  std::memcpy(out, v.data(), v.size() * sizeof(int32_t));
}

void gav_bag_pairs(void* hp, int32_t slot, int32_t* out) {
  auto& v = static_cast<GavFile*>(hp)->bags[slot].pairs;
  std::memcpy(out, v.data(), v.size() * sizeof(int32_t));
}

void gav_bag_vals(void* hp, int32_t slot, float* out) {
  auto& v = static_cast<GavFile*>(hp)->bags[slot].vals;
  std::memcpy(out, v.data(), v.size() * sizeof(float));
}

int64_t gav_pair_vocab_size(void* hp, int32_t slot) {
  return static_cast<GavFile*>(hp)->bags[slot].vocab.names.size();
}

int64_t gav_pair_vocab_bytes(void* hp, int32_t slot) {
  auto& v = static_cast<GavFile*>(hp)->bags[slot].vocab;
  int64_t total = 0;
  for (auto& s : v.names) total += s.size();
  for (auto& s : v.terms) total += s.size();
  return total;
}

// lens: name_len, term_len per pair (2 * size); bytes: name then term, pair
// by pair, concatenated.
void gav_pair_vocab(void* hp, int32_t slot, int32_t* lens, char* bytes) {
  auto& v = static_cast<GavFile*>(hp)->bags[slot].vocab;
  for (size_t i = 0; i < v.names.size(); i++) {
    *lens++ = static_cast<int32_t>(v.names[i].size());
    *lens++ = static_cast<int32_t>(v.terms[i].size());
    std::memcpy(bytes, v.names[i].data(), v.names[i].size());
    bytes += v.names[i].size();
    std::memcpy(bytes, v.terms[i].data(), v.terms[i].size());
    bytes += v.terms[i].size();
  }
}

void gav_close(void* hp) {
  GavFile* h = static_cast<GavFile*>(hp);
  if (h->base) munmap(const_cast<uint8_t*>(h->base), h->size);
  if (h->fd >= 0) ::close(h->fd);
  delete h;
}

}  // extern "C"
