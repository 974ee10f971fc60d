// Host scalar sparse Cholesky — the native NUMERIC phase of the direct
// solver family (the reference runs this phase in CSparse's cs_chol /
// CHOLMOD on CPU, g2o/solvers/csparse/linear_solver_csparse.h:107;
// our implementation is an independent up-looking factorization on an
// upper-CSC layout, written against Davis' textbook description).
//
// Role in the TPU framework: XLA/Pallas own every large batched compute
// path, but a tiny ill-conditioned f64 tail system (e.g. the manhattan
// gn_var fixed point, kappa ~2e9 — f32 floors, TPU f64 dots are emulated
// 20-80x slow) is a latency-bound SEQUENTIAL workload: exactly what a
// host core does at speed-of-light.  The hybrid step is: assemble H/b on
// the TPU, ship ~0.5 MB, factor+solve here in ~10 ms, push dx back.
//
// C API (ctypes):
//   void*  g2o_hostchol_sym(int n, const int64* Ap, const int32* Ai);
//       Ap/Ai: CSC pattern of the UPPER triangle of A (diagonal included,
//       rows sorted ascending per column) — column i lists {j <= i}, which
//       is exactly row i of the lower triangle (what up-looking consumes).
//       Runs etree + row/col L patterns once; reusable across factors.
//   int64  g2o_hostchol_lnz(void* h);        // strictly-lower nnz(L)
//   int32  g2o_hostchol_factor(void* h, const double* Ax);
//       values aligned with (Ap, Ai); returns 0 on success, -(i+1) when
//       the matrix is not positive definite at scalar column i.
//   void   g2o_hostchol_solve(void* h, double* b);   // L L^T x = b in place
//   void   g2o_hostchol_release(void* h);

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct HostChol {
  int32_t n = 0;
  // A pattern (upper CSC), borrowed copies
  std::vector<int64_t> Ap;
  std::vector<int32_t> Ai;
  // L pattern: strictly-lower CSC (rows ascending per column, built in
  // ascending row order) + row-major view (cols ascending per row)
  std::vector<int64_t> Lp;    // n+1
  std::vector<int32_t> Lrows; // lnz
  std::vector<int64_t> Rp;    // n+1 row pattern pointers
  std::vector<int32_t> Rcols; // lnz, ascending per row
  // numeric factor
  std::vector<double> Lx;     // lnz, aligned with Lrows
  std::vector<double> Ldiag;  // n
  // workspaces
  std::vector<int64_t> colfill;
  std::vector<double> work;
  std::vector<int32_t> parent;
};

}  // namespace

extern "C" {

void* g2o_hostchol_sym(int32_t n, const int64_t* Ap, const int32_t* Ai) {
  auto* h = new HostChol();
  h->n = n;
  h->Ap.assign(Ap, Ap + n + 1);
  h->Ai.assign(Ai, Ai + Ap[n]);

  // elimination tree (Liu's ancestor path compression over row patterns;
  // column i of the upper-CSC input IS row i of the lower triangle)
  h->parent.assign(n, -1);
  std::vector<int32_t> ancestor(n, -1);
  for (int32_t i = 0; i < n; ++i) {
    for (int64_t p = Ap[i]; p < Ap[i + 1]; ++p) {
      int32_t k = Ai[p];
      while (k != -1 && k < i) {
        int32_t next = ancestor[k];
        ancestor[k] = i;
        if (next == -1) h->parent[k] = i;
        k = next;
      }
    }
  }

  // L pattern: for each row i, the reach of its seeds through the etree
  // (columns k < i with L(i,k) != 0).  Two passes: count, then fill.
  std::vector<int32_t> mark(n, -1);
  std::vector<int64_t> colcount(n, 0);
  int64_t lnz = 0;
  for (int32_t i = 0; i < n; ++i) {
    mark[i] = i;
    for (int64_t p = Ap[i]; p < Ap[i + 1]; ++p) {
      int32_t k = Ai[p];
      while (k != -1 && k < i && mark[k] != i) {
        mark[k] = i;
        ++colcount[k];
        ++lnz;
        k = h->parent[k];
      }
    }
  }
  h->Lp.assign(n + 1, 0);
  for (int32_t j = 0; j < n; ++j) h->Lp[j + 1] = h->Lp[j] + colcount[j];
  h->Lrows.resize(lnz);
  h->colfill.assign(n, 0);
  std::vector<int64_t> fill(n);
  for (int32_t j = 0; j < n; ++j) fill[j] = h->Lp[j];
  std::fill(mark.begin(), mark.end(), -1);
  for (int32_t i = 0; i < n; ++i) {
    mark[i] = i;
    for (int64_t p = Ap[i]; p < Ap[i + 1]; ++p) {
      int32_t k = Ai[p];
      while (k != -1 && k < i && mark[k] != i) {
        mark[k] = i;
        h->Lrows[fill[k]++] = i;  // ascending i per column
        k = h->parent[k];
      }
    }
  }

  // row-major view: iterate columns ascending, append to each row's list
  // -> columns ascend per row (the topological order the up-looking
  // triangular solve needs)
  h->Rp.assign(n + 1, 0);
  for (int64_t p = 0; p < lnz; ++p) ++h->Rp[h->Lrows[p] + 1];
  for (int32_t i = 0; i < n; ++i) h->Rp[i + 1] += h->Rp[i];
  h->Rcols.resize(lnz);
  std::vector<int64_t> rfill(h->Rp.begin(), h->Rp.end() - 1);
  for (int32_t j = 0; j < n; ++j)
    for (int64_t p = h->Lp[j]; p < h->Lp[j + 1]; ++p)
      h->Rcols[rfill[h->Lrows[p]]++] = j;

  h->Lx.resize(lnz);
  h->Ldiag.resize(n);
  h->work.assign(n, 0.0);
  return h;
}

int64_t g2o_hostchol_lnz(void* hv) {
  return static_cast<int64_t>(static_cast<HostChol*>(hv)->Lrows.size());
}

int32_t g2o_hostchol_factor(void* hv, const double* Ax) {
  auto* h = static_cast<HostChol*>(hv);
  const int32_t n = h->n;
  double* x = h->work.data();
  for (int32_t j = 0; j < n; ++j) h->colfill[j] = h->Lp[j];

  for (int32_t i = 0; i < n; ++i) {
    // scatter A(0:i, i) (upper CSC column i); diagonal is the last row
    double d = 0.0;
    for (int64_t p = h->Ap[i]; p < h->Ap[i + 1]; ++p) {
      int32_t j = h->Ai[p];
      if (j == i)
        d = Ax[p];
      else
        x[j] = Ax[p];
    }
    // sparse triangular solve along row i's pattern (ascending columns)
    for (int64_t rp = h->Rp[i]; rp < h->Rp[i + 1]; ++rp) {
      int32_t k = h->Rcols[rp];
      double lik = x[k] / h->Ldiag[k];
      x[k] = 0.0;
      // entries of column k so far all have row < i (rows processed in
      // ascending order) and every such row is on row i's reach
      for (int64_t p = h->Lp[k]; p < h->colfill[k]; ++p)
        x[h->Lrows[p]] -= h->Lx[p] * lik;
      d -= lik * lik;
      h->Lx[h->colfill[k]] = lik;
      ++h->colfill[k];
    }
    if (!(d > 0.0)) return -(i + 1);
    h->Ldiag[i] = std::sqrt(d);
  }
  return 0;
}

void g2o_hostchol_solve(void* hv, double* b) {
  auto* h = static_cast<HostChol*>(hv);
  const int32_t n = h->n;
  // forward: L y = b
  for (int32_t j = 0; j < n; ++j) {
    double yj = b[j] / h->Ldiag[j];
    b[j] = yj;
    for (int64_t p = h->Lp[j]; p < h->Lp[j + 1]; ++p)
      b[h->Lrows[p]] -= h->Lx[p] * yj;
  }
  // backward: L^T x = y
  for (int32_t j = n - 1; j >= 0; --j) {
    double s = b[j];
    for (int64_t p = h->Lp[j]; p < h->Lp[j + 1]; ++p)
      s -= h->Lx[p] * b[h->Lrows[p]];
    b[j] = s / h->Ldiag[j];
  }
}

void g2o_hostchol_release(void* hv) { delete static_cast<HostChol*>(hv); }

}  // extern "C"
