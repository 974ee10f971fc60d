// Symbolic block-Cholesky analysis — the native runtime component of the
// direct sparse solver (the reference delegates this to CSparse's C code:
// cs_etree / cs_ereach / cs_amd, g2o/solvers/csparse/linear_solver_csparse.h:71).
//
// Given the undirected block pattern (n block columns, m unique pairs):
//   1. fill-reducing ordering: recursive BFS-layer separator nested
//      dissection (band orderings serialize the level schedule);
//   2. elimination tree via Liu's ancestor path-compression algorithm;
//   3. exact L structure via row subtree traversal (cs_ereach-style):
//      appends each row i to the columns on the path j -> ... -> i,
//      O(nnz(L)) total;
//   4. etree depth per column (the level schedule key).
//
// C API (ctypes, no Python headers):
//   void* g2o_symchol(int n, long m, const int* pairs, int min_size);
//   long  g2o_sym_nnz(void* h);
//   int   g2o_sym_nlevels(void* h);
//   void  g2o_sym_perm(void* h, int* out);     // n: new k -> old id
//   void  g2o_sym_parent(void* h, int* out);   // n (permuted indices)
//   void  g2o_sym_colptr(void* h, long* out);  // n+1 off-diag col starts
//   void  g2o_sym_rows(void* h, int* out);     // nnz, sorted per column
//   void  g2o_sym_depth(void* h, int* out);    // n: etree depth per column
//   void  g2o_sym_release(void* h);

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct SymResult {
  int n = 0;
  std::vector<int32_t> perm;      // new k -> old id
  std::vector<int32_t> parent;    // permuted
  std::vector<int64_t> colptr;    // n+1
  std::vector<int32_t> rows;      // concatenated, sorted per column
  std::vector<int32_t> depth;     // per permuted column
  int nlevels = 0;
};

// BFS layers from `start` within `nodes` (mask-based); returns layer offsets
// into `order`.
static void bfs_layers(const std::vector<int64_t>& adj_ptr,
                       const std::vector<int32_t>& adj,
                       int32_t start, const std::vector<uint8_t>& in_set,
                       std::vector<int32_t>& order,
                       std::vector<int64_t>& layer_ptr,
                       std::vector<uint8_t>& seen) {
  order.clear();
  layer_ptr.clear();
  order.push_back(start);
  seen[start] = 1;
  layer_ptr.push_back(0);
  size_t lo = 0;
  while (lo < order.size()) {
    size_t hi = order.size();
    layer_ptr.push_back(static_cast<int64_t>(hi));
    for (size_t t = lo; t < hi; ++t) {
      int32_t v = order[t];
      for (int64_t e = adj_ptr[v]; e < adj_ptr[v + 1]; ++e) {
        int32_t w = adj[e];
        if (in_set[w] && !seen[w]) {
          seen[w] = 1;
          order.push_back(w);
        }
      }
    }
    if (order.size() == hi) break;
    lo = hi;
  }
  layer_ptr.back() = static_cast<int64_t>(order.size());
}

// recursive nested dissection (explicit work stack; emits into `out`)
static void nested_dissection(const std::vector<int64_t>& adj_ptr,
                              const std::vector<int32_t>& adj,
                              std::vector<int32_t> nodes, int min_size,
                              std::vector<int32_t>& out,
                              std::vector<uint8_t>& in_set,
                              std::vector<uint8_t>& seen) {
  if (static_cast<int>(nodes.size()) <= min_size) {
    out.insert(out.end(), nodes.begin(), nodes.end());
    return;
  }
  for (int32_t v : nodes) in_set[v] = 1;

  // pseudo-peripheral start: two BFS sweeps
  std::vector<int32_t> order;
  std::vector<int64_t> layer_ptr;
  int32_t start = nodes[0];
  for (int sweep = 0; sweep < 3; ++sweep) {
    for (int32_t v : nodes) seen[v] = 0;
    bfs_layers(adj_ptr, adj, start, in_set, order, layer_ptr, seen);
    if (sweep < 2) start = order.back();
  }
  size_t nlayers = layer_ptr.size() - 1;
  if (nlayers < 3) {
    for (int32_t v : nodes) in_set[v] = 0;
    out.insert(out.end(), nodes.begin(), nodes.end());
    return;
  }
  size_t mid = nlayers / 2;
  std::vector<int32_t> part_a(order.begin() + layer_ptr[0],
                              order.begin() + layer_ptr[mid]);
  std::vector<int32_t> sep(order.begin() + layer_ptr[mid],
                           order.begin() + layer_ptr[mid + 1]);
  std::vector<int32_t> part_b(order.begin() + layer_ptr[mid + 1],
                              order.begin() + layer_ptr[nlayers]);
  // disconnected leftovers -> part_a
  if (order.size() < nodes.size()) {
    for (int32_t v : nodes)
      if (!seen[v]) part_a.push_back(v);
  }
  std::sort(sep.begin(), sep.end());
  for (int32_t v : nodes) in_set[v] = 0;
  if (!part_a.empty())
    nested_dissection(adj_ptr, adj, std::move(part_a), min_size, out,
                      in_set, seen);
  if (!part_b.empty())
    nested_dissection(adj_ptr, adj, std::move(part_b), min_size, out,
                      in_set, seen);
  out.insert(out.end(), sep.begin(), sep.end());
}

}  // namespace

extern "C" {

void* g2o_symchol(int32_t n, int64_t m, const int32_t* pairs,
                  int32_t min_size) {
  auto* res = new SymResult();
  res->n = n;

  // adjacency CSR (undirected)
  std::vector<int64_t> adj_ptr(n + 1, 0);
  for (int64_t e = 0; e < m; ++e) {
    int32_t a = pairs[2 * e], b = pairs[2 * e + 1];
    if (a == b || a < 0 || b < 0 || a >= n || b >= n) continue;
    ++adj_ptr[a + 1];
    ++adj_ptr[b + 1];
  }
  for (int32_t i = 0; i < n; ++i) adj_ptr[i + 1] += adj_ptr[i];
  std::vector<int32_t> adj(adj_ptr[n]);
  std::vector<int64_t> fill = adj_ptr;
  for (int64_t e = 0; e < m; ++e) {
    int32_t a = pairs[2 * e], b = pairs[2 * e + 1];
    if (a == b || a < 0 || b < 0 || a >= n || b >= n) continue;
    adj[fill[a]++] = b;
    adj[fill[b]++] = a;
  }

  // ordering
  std::vector<int32_t> all(n);
  for (int32_t i = 0; i < n; ++i) all[i] = i;
  std::vector<uint8_t> in_set(n, 0), seen(n, 0);
  res->perm.reserve(n);
  nested_dissection(adj_ptr, adj, std::move(all), min_size, res->perm,
                    in_set, seen);
  std::vector<int32_t> inv(n);
  for (int32_t k = 0; k < n; ++k) inv[res->perm[k]] = k;

  // permuted strict-lower pattern of A, grouped by ROW i: cols j < i
  std::vector<int64_t> rptr(n + 1, 0);
  for (int64_t e = 0; e < m; ++e) {
    int32_t a = pairs[2 * e], b = pairs[2 * e + 1];
    if (a == b || a < 0 || b < 0 || a >= n || b >= n) continue;
    int32_t i = inv[a], j = inv[b];
    if (i < j) std::swap(i, j);
    ++rptr[i + 1];
  }
  for (int32_t i = 0; i < n; ++i) rptr[i + 1] += rptr[i];
  std::vector<int32_t> rcols(rptr[n]);
  std::vector<int64_t> rfill = rptr;
  for (int64_t e = 0; e < m; ++e) {
    int32_t a = pairs[2 * e], b = pairs[2 * e + 1];
    if (a == b || a < 0 || b < 0 || a >= n || b >= n) continue;
    int32_t i = inv[a], j = inv[b];
    if (i < j) std::swap(i, j);
    rcols[rfill[i]++] = j;
  }

  // pass 1: elimination tree (Liu's ancestor path-compression algorithm)
  res->parent.assign(n, -1);
  {
    std::vector<int32_t> ancestor(n, -1);
    for (int32_t i = 0; i < n; ++i) {
      for (int64_t e = rptr[i]; e < rptr[i + 1]; ++e) {
        int32_t k = rcols[e];
        while (k != -1 && k < i) {
          int32_t next = ancestor[k];
          ancestor[k] = i;  // path compression
          if (next == -1) res->parent[k] = i;
          k = next;
        }
      }
    }
  }

  // pass 2: L structure by row subtrees (cs_ereach): every column k on the
  // UNCOMPRESSED etree path j -> parent -> ... below i gets entry L(i, k);
  // the per-row mark makes the total walk O(nnz(L))
  std::vector<int32_t> mark(n, -1);
  std::vector<std::vector<int32_t>> cols(n);
  for (int32_t i = 0; i < n; ++i) {
    mark[i] = i;
    for (int64_t e = rptr[i]; e < rptr[i + 1]; ++e) {
      int32_t k = rcols[e];
      while (k != -1 && k < i && mark[k] != i) {
        mark[k] = i;
        cols[k].push_back(i);
        k = res->parent[k];
      }
    }
  }

  // pack column structures (already sorted: rows appended in ascending i)
  res->colptr.assign(n + 1, 0);
  for (int32_t j = 0; j < n; ++j)
    res->colptr[j + 1] = res->colptr[j] + static_cast<int64_t>(cols[j].size());
  res->rows.resize(res->colptr[n]);
  for (int32_t j = 0; j < n; ++j)
    std::copy(cols[j].begin(), cols[j].end(),
              res->rows.begin() + res->colptr[j]);

  // etree depths (parent > child in permuted order)
  res->depth.assign(n, 0);
  int32_t maxd = -1;
  for (int32_t j = 0; j < n; ++j) {
    int32_t p = res->parent[j];
    if (p >= 0 && res->depth[j] + 1 > res->depth[p])
      res->depth[p] = res->depth[j] + 1;
    if (res->depth[j] > maxd) maxd = res->depth[j];
  }
  res->nlevels = n > 0 ? maxd + 1 : 0;
  return res;
}

int64_t g2o_sym_nnz(void* h) { return static_cast<SymResult*>(h)->colptr.back(); }
int32_t g2o_sym_nlevels(void* h) { return static_cast<SymResult*>(h)->nlevels; }

void g2o_sym_perm(void* h, int32_t* out) {
  auto* r = static_cast<SymResult*>(h);
  std::memcpy(out, r->perm.data(), r->n * sizeof(int32_t));
}
void g2o_sym_parent(void* h, int32_t* out) {
  auto* r = static_cast<SymResult*>(h);
  std::memcpy(out, r->parent.data(), r->n * sizeof(int32_t));
}
void g2o_sym_colptr(void* h, int64_t* out) {
  auto* r = static_cast<SymResult*>(h);
  std::memcpy(out, r->colptr.data(), (r->n + 1) * sizeof(int64_t));
}
void g2o_sym_rows(void* h, int32_t* out) {
  auto* r = static_cast<SymResult*>(h);
  std::memcpy(out, r->rows.data(), r->rows.size() * sizeof(int32_t));
}
void g2o_sym_depth(void* h, int32_t* out) {
  auto* r = static_cast<SymResult*>(h);
  std::memcpy(out, r->depth.data(), r->n * sizeof(int32_t));
}
void g2o_sym_release(void* h) { delete static_cast<SymResult*>(h); }

}  // extern "C"
