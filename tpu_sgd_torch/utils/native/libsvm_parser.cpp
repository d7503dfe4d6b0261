// Native LIBSVM parser of tpu_sgd_torch: a copy of the JAX package's
// tpu_sgd/utils/native/libsvm_parser.cpp, so the port loads nothing of it.
//
// The reference parses LIBSVM text inside executor JVMs (SURVEY.md §3.4,
// [U] MLUtils.loadLibSVMFile).  Two-pass design: pass 1 counts rows and
// nonzeros so Python can allocate exact numpy buffers; pass 2 fills them.
// Exposed as a plain C ABI consumed via ctypes (no pybind11).
//
// Built at first use by tpu_sgd_torch/utils/native/__init__.py with the
// host C++ compiler (-O3 -shared -fPIC) into its git-ignored _build/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Read a whole file into a buffer; returns false on failure.
bool read_file(const char* path, std::vector<char>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(size) + 1);
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  if (got != static_cast<size_t>(size)) return false;
  buf[got] = '\0';
  return true;
}

inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

inline const char* line_end(const char* p) {
  while (*p && *p != '\n' && *p != '#') ++p;
  return p;
}

}  // namespace

extern "C" {

// Pass 1: count rows and nonzeros. Returns 0 on success, negative on error.
int64_t parse_libsvm_count(const char* path, int64_t* n_rows, int64_t* n_nz) {
  std::vector<char> buf;
  if (!read_file(path, buf)) return -1;
  int64_t rows = 0, nz = 0;
  const char* p = buf.data();
  while (*p) {
    const char* q = skip_ws(p);
    const char* end = line_end(q);
    if (end != q) {  // non-empty line (before any comment)
      ++rows;
      for (const char* c = q; c < end; ++c)
        if (*c == ':') ++nz;
    }
    p = end;
    while (*p && *p != '\n') ++p;  // skip comment tail
    if (*p == '\n') ++p;
  }
  *n_rows = rows;
  *n_nz = nz;
  return 0;
}

// Pass 2: fill pre-allocated buffers. Returns max feature index (1-based
// count == densified feature dim) on success, negative on parse error.
int64_t parse_libsvm_fill(const char* path, float* labels, int64_t* rows,
                          int64_t* cols, float* vals) {
  std::vector<char> buf;
  if (!read_file(path, buf)) return -1;
  int64_t row = 0, k = 0, max_idx = 0;
  char* p = buf.data();
  while (*p) {
    char* q = const_cast<char*>(skip_ws(p));
    const char* end = line_end(q);
    if (end != q) {
      char* cur = q;
      labels[row] = std::strtof(cur, &cur);
      while (cur < end) {
        cur = const_cast<char*>(skip_ws(cur));
        if (cur >= end) break;
        char* after = nullptr;
        long long idx = std::strtoll(cur, &after, 10);
        if (after == cur || *after != ':') return -2;  // malformed token
        if (idx < 1) return -3;                        // 1-based on disk
        cur = after + 1;
        char* vstart = cur;
        if (*vstart == ' ' || *vstart == '\t') return -2;  // "5: 2.0" —
                                       // strtof would skip the space and
                                       // eat the NEXT token
        float v = std::strtof(cur, &cur);
        if (cur == vstart) return -2;  // empty value token ("5:"): the
                                       // Python parser raises; accepting
                                       // 0.0 here would make corrupt
                                       // files load only when the .so
                                       // happens to be built
        rows[k] = row;
        cols[k] = idx - 1;
        vals[k] = v;
        ++k;
        if (idx > max_idx) max_idx = idx;
      }
      ++row;
    }
    p = const_cast<char*>(end);
    while (*p && *p != '\n') ++p;
    if (*p == '\n') ++p;
  }
  return max_idx;
}

}  // extern "C"
