// Fast .g2o / BAL text tokenizer — the native runtime component of the
// framework's IO path (the reference's loader is C++ iostream code,
// g2o/core/optimizable_graph.cpp:397; Python-level float parsing is ~20x
// slower on Venice-scale files).
//
// Design: one pass over the file; lines are grouped by their leading tag.
// For each tag we accumulate a dense row-major double matrix (rows = lines,
// cols = max numeric fields for that tag, short rows padded with NaN) plus a
// per-row field count.  The Python side (ctypes) copies each block into
// numpy and vectorizes graph construction from there.
//
// C API (ctypes-friendly, no Python headers needed):
//   void*       g2o_parse_file(const char* path);       // NULL on error
//   void*       g2o_parse_buffer(const char* data, long len);
//   int         g2o_num_blocks(void* h);
//   const char* g2o_block_tag(void* h, int i);
//   long        g2o_block_rows(void* h, int i);
//   int         g2o_block_cols(void* h, int i);
//   void        g2o_block_copy(void* h, int i, double* out, int* ncols_out);
//   void        g2o_free(void* h);

#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Block {
  std::string tag;
  long rows = 0;
  int max_cols = 0;
  std::vector<double> values;   // ragged, rows concatenated
  std::vector<int> row_cols;    // fields per row
};

struct Handle {
  std::vector<Block> blocks;
  std::unordered_map<std::string, int> index;
};

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

void parse_chunk(Handle* h, const char* data, long len) {
  const char* p = data;
  const char* end = data + len;
  std::vector<double> row;
  row.reserve(64);
  while (p < end) {
    // start of line
    while (p < end && (is_space(*p))) ++p;
    if (p >= end) break;
    if (*p == '\n') { ++p; continue; }
    if (*p == '#') {  // comment line
      while (p < end && *p != '\n') ++p;
      continue;
    }
    // tag token
    const char* tag_start = p;
    while (p < end && !is_space(*p) && *p != '\n') ++p;
    std::string tag(tag_start, p - tag_start);
    // numeric fields
    row.clear();
    while (p < end && *p != '\n') {
      while (p < end && is_space(*p)) ++p;
      if (p >= end || *p == '\n') break;
      char* next = nullptr;
      double v = strtod(p, &next);
      if (next == p) {  // non-numeric token: skip it
        while (p < end && !is_space(*p) && *p != '\n') ++p;
        continue;
      }
      row.push_back(v);
      p = next;
    }
    auto it = h->index.find(tag);
    Block* b;
    if (it == h->index.end()) {
      h->index.emplace(tag, (int)h->blocks.size());
      h->blocks.emplace_back();
      b = &h->blocks.back();
      b->tag = tag;
    } else {
      b = &h->blocks[it->second];
    }
    b->rows += 1;
    b->row_cols.push_back((int)row.size());
    if ((int)row.size() > b->max_cols) b->max_cols = (int)row.size();
    b->values.insert(b->values.end(), row.begin(), row.end());
  }
}

}  // namespace

extern "C" {

void* g2o_parse_buffer(const char* data, long len) {
  Handle* h = new Handle();
  parse_chunk(h, data, len);
  return h;
}

void* g2o_parse_file(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf((size_t)len);
  if (len > 0 && fread(buf.data(), 1, (size_t)len, f) != (size_t)len) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  return g2o_parse_buffer(buf.data(), len);
}

int g2o_num_blocks(void* hv) {
  return (int)static_cast<Handle*>(hv)->blocks.size();
}

const char* g2o_block_tag(void* hv, int i) {
  return static_cast<Handle*>(hv)->blocks[i].tag.c_str();
}

long g2o_block_rows(void* hv, int i) {
  return static_cast<Handle*>(hv)->blocks[i].rows;
}

int g2o_block_cols(void* hv, int i) {
  return static_cast<Handle*>(hv)->blocks[i].max_cols;
}

// copies into out (rows x max_cols, row-major, NaN padded); writes per-row
// field counts into ncols_out (length rows) when non-null
void g2o_block_copy(void* hv, int i, double* out, int* ncols_out) {
  const Block& b = static_cast<Handle*>(hv)->blocks[i];
  const double nan = __builtin_nan("");
  const double* src = b.values.data();
  for (long r = 0; r < b.rows; ++r) {
    int n = b.row_cols[r];
    double* dst = out + r * b.max_cols;
    memcpy(dst, src, n * sizeof(double));
    for (int c = n; c < b.max_cols; ++c) dst[c] = nan;
    src += n;
    if (ncols_out) ncols_out[r] = n;
  }
}

void g2o_free(void* hv) { delete static_cast<Handle*>(hv); }

}  // extern "C"
