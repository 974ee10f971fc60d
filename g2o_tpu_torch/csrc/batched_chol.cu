// Batched Cholesky factorization and forward substitution for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of g2o_tpu/ops/pallas_chol.py:
//   K1  chol_batched         (_chol_kernel)          -> g2o_chol_batched_f32/_f64
//   K2  solve_lower_batched  (_solve_lower_kernel)   -> g2o_solve_lower_batched_f32/_f64
// Plain C entry points (no PyTorch headers) so nvcc builds the library in
// seconds; g2o_tpu_torch/ops/chol_kernels.py loads it with ctypes.  Every
// matrix is row-major and contiguous, S matrices back to back.  Kernels
// launch on the caller's stream, never synchronize and allocate nothing:
// the caller owns every buffer.  Each entry returns cudaGetLastError().
//
// The TPU version held whole batch tiles in VMEM and stored U = L^T so
// that every access was a row access (lane-dim indexing is slow there).
// Neither constraint exists here, so both kernels work on L directly.
//
// K1 design.  The main path factors ONE 960 x 960 matrix (3.7 MB in f32,
// 7.4 MB in f64): it does not fit a block's 227 KB of shared memory but
// stays in the 50 MB L2.  So the factorization is right-looking and
// blocked by panels of NB = 32 columns, working in place in global memory,
// with three launches per panel, in order on the stream:
//   chol_diag  one block per matrix factors the NB x NB diagonal block in
//              shared memory;
//   chol_rows  one thread per row below the panel solves its NB entries
//              against the diagonal block (L21 = A21 L11^-T);
//   chol_syrk  a 2-D grid of NB x NB tiles applies the trailing update
//              A22 -= L21 L21^T to the lower triangle.
// Bound: the work is about n^3/3 FMAs (2.9e8 at n = 960, a few
// microseconds of the card's f32 rate), so at S = 1 the cost is the
// 3 * ceil(n/NB) launches (90 at n = 960) and the sequential diagonal
// steps, not arithmetic.  Larger panels would cut launches but serialize
// more work inside chol_diag; NB = 32 keeps every per-thread array in
// registers.  Small matrices (the test shapes, n <= 126) take the same
// path with fewer panels, the batch on grid.z.
//
// K2 design.  Y = L^-1 B is independent over (matrix, rhs column).  One
// thread owns one rhs column and sweeps the rows in tiles of NB: it keeps
// the NB running sums of the tile in registers, subtracts each finished
// NB x NB tile of L (staged in shared memory, read as broadcasts) times
// its own finished Y rows, then solves the diagonal tile.  A warp covers
// 32 neighbouring columns, so every Y/B access is coalesced.
// Bound: n^2 m / 2 FMAs (4.4e8 at n = m = 960) spread over only m threads
// (30 warps at m = 960), so it is latency-bound on the per-thread sweep;
// the 32 independent running sums give each thread instruction-level
// parallelism.  Using B = I (the coarse inverse) or fusing K1 and K2 is
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;

__device__ __forceinline__ float dev_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dev_sqrt(double x) { return sqrt(x); }

// Factor the diagonal block [j0, j0+nb) of each matrix in place and zero
// the rest of its rows to the right of the diagonal (the upper triangle,
// which no later step of this factorization reads).
template <typename T>
__global__ void chol_diag(T* A, int n, int j0) {
  __shared__ T d[NB][NB + 1];
  const int nb = min(NB, n - j0);
  T* a = A + (size_t)blockIdx.z * n * n;
  const int tid = threadIdx.x;
  for (int e = tid; e < nb * nb; e += blockDim.x) {
    const int r = e / nb, c = e % nb;
    d[r][c] = c <= r ? a[(size_t)(j0 + r) * n + j0 + c] : T(0);
  }
  __syncthreads();
  for (int j = 0; j < nb; ++j) {
    if (tid == 0) d[j][j] = dev_sqrt(d[j][j]);
    __syncthreads();
    for (int r = j + 1 + tid; r < nb; r += blockDim.x) d[r][j] /= d[j][j];
    __syncthreads();
    const int w = nb - j - 1;
    for (int e = tid; e < w * w; e += blockDim.x) {
      const int r = j + 1 + e / w, c = j + 1 + e % w;
      if (c <= r) d[r][c] -= d[r][j] * d[c][j];
    }
    __syncthreads();
  }
  for (int e = tid; e < nb * nb; e += blockDim.x) {
    const int r = e / nb, c = e % nb;
    a[(size_t)(j0 + r) * n + j0 + c] = d[r][c];
  }
  const int right = n - j0 - nb;
  for (int e = tid; e < nb * right; e += blockDim.x) {
    const int r = e / right, c = e % right;
    a[(size_t)(j0 + r) * n + j0 + nb + c] = T(0);
  }
}

// Rows below a full panel: row i of L21 solves x L11^T = A[i, j0:j0+NB].
template <typename T>
__global__ void chol_rows(T* A, int n, int j0) {
  __shared__ T d[NB][NB + 1];
  T* a = A + (size_t)blockIdx.z * n * n;
  for (int e = threadIdx.x; e < NB * NB; e += blockDim.x) {
    const int r = e / NB, c = e % NB;
    d[r][c] = a[(size_t)(j0 + r) * n + j0 + c];
  }
  __syncthreads();
  const int i = j0 + NB + blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T* row = a + (size_t)i * n + j0;
  T x[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    T s = row[c];
#pragma unroll
    for (int m = 0; m < c; ++m) s -= x[m] * d[c][m];
    x[c] = s / d[c][c];
  }
#pragma unroll
  for (int c = 0; c < NB; ++c) row[c] = x[c];
}

// Trailing update A22 -= L21 L21^T on the lower triangle, one NB x NB tile
// per block (tiles above the diagonal return at once).
template <typename T>
__global__ void chol_syrk(T* A, int n, int j0) {
  const int bi = blockIdx.y, bk = blockIdx.x;
  if (bk > bi) return;
  __shared__ T li[NB][NB + 1];
  __shared__ T lk[NB][NB + 1];
  T* a = A + (size_t)blockIdx.z * n * n;
  const int t0 = j0 + NB;
  const int r0 = t0 + bi * NB, c0 = t0 + bk * NB;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int rr = ty; rr < NB; rr += blockDim.y) {
    const int r = r0 + rr, c = c0 + rr;
    li[rr][tx] = r < n ? a[(size_t)r * n + j0 + tx] : T(0);
    lk[rr][tx] = c < n ? a[(size_t)c * n + j0 + tx] : T(0);
  }
  __syncthreads();
  const int c = c0 + tx;
  for (int rr = ty; rr < NB; rr += blockDim.y) {
    const int r = r0 + rr;
    if (r < n && c < n && c <= r) {
      T s = 0;
#pragma unroll
      for (int m = 0; m < NB; ++m) s += li[rr][m] * lk[tx][m];
      a[(size_t)r * n + c] -= s;
    }
  }
}

// Y = L^-1 B; one thread per rhs column, blockDim.x == NB.
template <typename T>
__global__ void solve_lower(const T* L, const T* B, T* Y, int n, int m) {
  __shared__ T t[NB][NB + 1];
  const T* l = L + (size_t)blockIdx.z * n * n;
  const T* b = B + (size_t)blockIdx.z * n * m;
  T* y = Y + (size_t)blockIdx.z * n * m;
  const int tx = threadIdx.x;
  const int col = blockIdx.x * NB + tx;
  const bool live = col < m;
  for (int i0 = 0; i0 < n; i0 += NB) {
    T acc[NB];
#pragma unroll
    for (int ii = 0; ii < NB; ++ii)
      acc[ii] = (live && i0 + ii < n) ? b[(size_t)(i0 + ii) * m + col] : T(0);
    for (int k0 = 0; k0 < i0; k0 += NB) {
      __syncthreads();
      for (int rr = 0; rr < NB; ++rr) {
        const int r = i0 + rr;
        t[rr][tx] = r < n ? l[(size_t)r * n + k0 + tx] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        const T yk = live ? y[(size_t)(k0 + kk) * m + col] : T(0);
#pragma unroll
        for (int ii = 0; ii < NB; ++ii) acc[ii] -= t[ii][kk] * yk;
      }
    }
    __syncthreads();
    // diagonal tile; rows past n get a unit diagonal so the sweep stays finite
    for (int rr = 0; rr < NB; ++rr) {
      const int r = i0 + rr, k = i0 + tx;
      t[rr][tx] = (r < n && k < n) ? l[(size_t)r * n + k] : (rr == tx ? T(1) : T(0));
    }
    __syncthreads();
#pragma unroll
    for (int ii = 0; ii < NB; ++ii) {
      T s = acc[ii];
#pragma unroll
      for (int kk = 0; kk < ii; ++kk) s -= t[ii][kk] * acc[kk];
      acc[ii] = s / t[ii][ii];
    }
#pragma unroll
    for (int ii = 0; ii < NB; ++ii)
      if (live && i0 + ii < n) y[(size_t)(i0 + ii) * m + col] = acc[ii];
  }
}

template <typename T>
int chol_batched(T* out, const T* D, int S, int n, cudaStream_t st) {
  cudaError_t err = cudaMemcpyAsync(out, D, sizeof(T) * (size_t)S * n * n,
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  for (int j0 = 0; j0 < n; j0 += NB) {
    chol_diag<T><<<dim3(1, 1, S), 256, 0, st>>>(out, n, j0);
    const int below = n - j0 - NB;
    if (below > 0) {
      chol_rows<T><<<dim3((below + 127) / 128, 1, S), 128, 0, st>>>(out, n, j0);
      const int tiles = (below + NB - 1) / NB;
      chol_syrk<T><<<dim3(tiles, tiles, S), dim3(NB, 8), 0, st>>>(out, n, j0);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int solve_lower_batched(const T* L, const T* B, T* Y, int S, int n, int m,
                        cudaStream_t st) {
  solve_lower<T><<<dim3((m + NB - 1) / NB, 1, S), NB, 0, st>>>(L, B, Y, n, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int g2o_chol_batched_f32(void* out, const void* D, int S, int n, void* stream) {
  return chol_batched<float>((float*)out, (const float*)D, S, n, (cudaStream_t)stream);
}

int g2o_chol_batched_f64(void* out, const void* D, int S, int n, void* stream) {
  return chol_batched<double>((double*)out, (const double*)D, S, n, (cudaStream_t)stream);
}

int g2o_solve_lower_batched_f32(const void* L, const void* B, void* Y, int S, int n,
                                int m, void* stream) {
  return solve_lower_batched<float>((const float*)L, (const float*)B, (float*)Y, S, n, m,
                                    (cudaStream_t)stream);
}

int g2o_solve_lower_batched_f64(const void* L, const void* B, void* Y, int S, int n,
                                int m, void* stream) {
  return solve_lower_batched<double>((const double*)L, (const double*)B, (double*)Y, S,
                                     n, m, (cudaStream_t)stream);
}

}  // extern "C"
