// Batched Cholesky factorization and forward/backward substitution for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of g2o_tpu/ops/pallas_chol.py:
//   K1  chol_batched         (:89, _chol_kernel :57-85)         -> g2o_chol_batched_f32/_f64
//   K2  solve_lower_batched  (:188, _solve_lower_kernel :113-132) -> g2o_solve_lower_batched_f32/_f64
//   K3  solve_upper_batched  (_solve_upper_kernel)   -> g2o_solve_upper_batched_f32/_f64
// Plain C entry points (no PyTorch headers) so nvcc builds the library in
// seconds; g2o_tpu_torch/ops/chol_kernels.py loads it with ctypes.  Every
// matrix is row-major and contiguous, S matrices back to back.  Kernels
// launch on the caller's stream, never synchronize and allocate nothing:
// the caller owns every buffer, the int32 scratch of K1 and K2 included.
// Each entry returns cudaGetLastError().
//
// The TPU version held whole batch tiles in VMEM and stored U = L^T so
// that every access was a row access (lane-dim indexing is slow there).
// Neither constraint exists here, so the kernels work on L directly.
//
// K1 and K2: what bounds them.  The chunk2 path gives each ONE 960 x 960
// f32 matrix per LM trial (K2 with B = I, the coarse inverse); the
// supernodal path batches of 144-column panels, (55, 144, 144) for K1 and
// (55, 144, 192) / (55, 144, 1) for K2.  At 960 the work is n^3/3 = 2.9e8
// FMAs for K1 and n^2 m / 2 = 4.4e8 for K2, ~9 and ~13 us at the card's
// f32 rate, over 3.7 MB that stay in the 50 MB L2.  Neither arithmetic nor
// memory bounds them: the dependent chain does.  A blocked factorization
// of n/64 = 15 tile columns is 15 steps of (factor the diagonal tile,
// solve the tiles below it, update the next column), and a launch per step
// would cost more than the step does.  In the design below one step of K1's
// chain is one
// 64-step substitution, one 64 x 64 x 64 GEMM, the 64 pivots of the
// diagonal factor on one warp and one handoff between blocks; one step of
// K2's is a handoff, a GEMM and a substitution.  The chain, not the ~3% of
// the card's f32 rate the arithmetic needs, sets their time.
//
// K1 and K2: the design.  ONE kernel launch per call (plus a memset of the
// scratch), a persistent tile DAG over TILE x TILE (64 x 64) tiles:
//   * every tile of the output is one task; a block claims tasks from an
//     atomic counter (scratch[0]) in a topological order and keeps claiming
//     until none is left.  A task waits only for tasks of lower index,
//     which blocks already running have claimed, so progress never depends
//     on which blocks are resident; the grid is the number of blocks the
//     card holds at once (occupancy x SMs, read once per device), at most
//     the number of tasks.  Tasks of the S matrices interleave (task t is
//     matrix t % S), so a batch of small matrices fills the card the same
//     way one large matrix does;
//   * a finished tile publishes a ready flag (scratch[1 + ...]): its
//     writes, __syncthreads, then __threadfence and one st.release.gpu on
//     one thread (the pattern of a cooperative grid barrier); a waiting
//     block polls with ld.acquire.gpu on one thread, then __syncthreads,
//     and reads the tile with __ldcg (L2, never a stale L1 line).  There
//     is no barrier between steps, so the next diagonal tile is factored
//     as soon as its own inputs are ready (lookahead);
//   * K1 is left-looking: a task loads A_ij into registers (a 4 x 4 block
//     per thread), subtracts L_ik L_jk^T for k < j as each pair of tiles
//     becomes ready (a register-tiled GEMM out of shared memory, 16-byte
//     reads, CUDA-core FMAs: no TF32), then solves L_ij L_jj^T = A_ij or
//     factors the diagonal tile.  The critical path is the chain of
//     diagonal tiles, so the task that factors L_jj first finishes the tile
//     (j, j-1) beside it (the solve against L_{j-1,j-1}; a second warp
//     releases it to the others while the first factors) and applies it
//     from shared memory: one handoff per tile column.  The diagonal tile
//     is factored by ONE warp with no block
//     barrier: a 32 x 32 Cholesky in registers (lane r holds row r; each
//     pivot's reciprocal square root and each column's entries are
//     broadcast with __shfl_sync), the 32 x 32 solve and update below it,
//     a second 32 x 32 Cholesky.  The solve of an off-diagonal tile is a
//     forward substitution per row, four lanes to a row, each solved entry
//     passed with __shfl_sync: again no block barrier per column.  A task
//     also zeroes the mirror tile of the upper triangle; a pivot that is
//     not positive gives NaN, which spreads to every later column, as
//     before;
//   * K2 computes Y_ic = L_ii^-1 (B_ic - sum_{k<i} L_ik Y_kc) as task
//     (i, c) over row tiles i and column tiles c of B, in row order: the
//     GEMMs as in K1, then the forward substitution of each column of the
//     tile, four lanes to a column.  The substitution is backward stable,
//     so no diagonal tile is inverted and rounding is not amplified by
//     cond(L_ii).  A task flags its tile as zero when B_ic and every Y_kc
//     it needs are zero and L_ii is finite; later tasks skip the GEMM of a
//     zero tile where L_ik is finite.  So a NaN or Inf in L spreads as in
//     the plain solve (0 * NaN is NaN), and a NaN factor from K1 gives a
//     NaN solve.  With B = I every tile above the diagonal is zero, which
//     halves the work; the kernel finds that in the data and stays a
//     general solve.
// Ragged shapes: a tile past n is read as the identity (on the diagonal)
// or zero, so every tile is a full 64 x 64 task and nothing past n, m is
// written.  Shape rule: there is none; K1 at (55, 144, 144) is 220 tasks
// of 3 tile columns, at (1, 960, 960) 106 tasks of 15.
//
// K3: what bounds it.  X = L^-T B with L lower, the backward sweep of the
// supernodal solve.  That path calls it at m = 1 only, on (S, 144, 1) with
// S = 1, 2, 3, 12 or 55, ten of its 17 calls per sweep on ONE matrix.
// Bytes say little (43 KB, L's lower triangle and the column, at S = 1:
// 0.013 us at 3.35 TB/s) and the
// n^2/2 FMAs less: the bound is the dependent chain of n steps (x_k needs
// every x_j, j > k), one multiply-add and one broadcast each, a few us at
// n = 144.  The parent gave each (matrix, column) ONE thread of a 32-thread
// block, which walked the chain with a block barrier per 32-row tile and
// loads of L on it: 70-78 us per call (H100 80GB HBM3, 700 W).
//
// K3: the design, for m < NB (the path's m = 1): one block of UP_THREADS
// per (rhs column, matrix), so a batch's matrices run side by side and a
// call takes the time of one chain.
//   * The sweep is column-oriented, 32-row tiles from the bottom up.  Warp
//     0 solves a diagonal tile with no block barrier: lane r holds b_r and
//     the tile's column r scaled by the reciprocal diagonal, a[k] =
//     L[k][r] / L[k][k], and for k from the tile's bottom up lane k's value
//     is broadcast with __shfl_sync and the lanes above subtract a[k] times
//     it, so a step of the chain is one shuffle and one FMA; x_r = b_r /
//     L[r][r] after the chain.
//   * Before the sweep all warps form every diagonal tile's coefficients
//     and reciprocal diagonal in shared memory (33 values per row: 20 KB at
//     n = 144 in f32), so a tile's chain starts with 32 shared loads.
//   * One block barrier per tile: then warp 0 applies the tile's x to the
//     32 rows of the next tile (a 32-term GEMV, lane per row) while the
//     other warps apply it to every row above that.  The rows of L outside
//     the diagonal tiles are read from global memory (L2), coalesced along
//     the columns, and each thread loads its row's 32 coefficients before
//     the barrier, so the loads are in flight during the chain.  Staging
//     all of L in shared memory first cost ~5 us before the chain could
//     start (scripts/solve_upper_probe.py), more than it saved.
//   * Only the lower triangle of L is read.  A NaN or Inf in L spreads as
//     in the plain solve: every product that the plain solve forms is
//     formed (a predicated subtraction, never a multiply by a zero mask).
//     Ragged n: the last tile has fewer rows.
// For m >= NB, and past UP_SMEM_MAX (n > 1504 in f32, 736 in f64), no path,
// the parent's kernel stays: one thread per (matrix, rhs column) in
// NB-thread blocks, full there at m >= NB, each sweeping the rows in NB-row
// tiles from the BOTTOM up, staging each finished tile of L transposed in
// shared memory (only its lower triangle is used).  The chain kernel at
// every m lost where chip_smoke.py times K3 at m > 1 (device us, f32,
// scripts/onehot_ab.py --k3, H100 80GB HBM3, 700 W): 318 against 77.6 at
// (55, 144, 144), 423 against 56.4 at (55, 144, 192) (a block per column
// reads all of L from L2), though 598 against 1347 at (1, 960, 960) and
// 18.6 against 37.3 at (5, 126, 96).
// Both are one launch per call, no scratch, no memset, so a call can be
// captured in a CUDA graph.  Measured (H100 80GB HBM3, 700 W): 10.59-10.69
// us of device time per call at (1|2|3|12|55, 144, 1) f32, against the
// parent's 69.3-75.0 in the same process (scripts/onehot_ab.py --k3); by
// scripts/solve_upper_probe.py about 1.2 of it is the launch, 1.4 the
// coefficients, 4.6 the chains and 2.8 the updates.

#include <cuda_runtime.h>

#include <atomic>

#include "device_sms.cuh"

namespace {

constexpr int NB = 32;                  // K3's row tile (a warp)
constexpr int UP_THREADS = 256;         // K3 for m < NB: a block per column
constexpr int UP_SMEM_MAX = 200 * 1024; // K3: the most shared memory
constexpr int TILE = 64;                // K1's and K2's tile edge
constexpr int THREADS = 256;            // K1 and K2: a 16 x 16 grid of 4 x 4 blocks
constexpr int STATIC_SMEM = 48 * 1024;  // without an opt-in
constexpr unsigned FULL = 0xffffffffu;
constexpr int READY = 1, ZERO = 2;      // tile flags (0: not ready)

__device__ __forceinline__ float dev_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double dev_rsqrt(double x) { return rsqrt(x); }

// 16 bytes of shared memory (4 floats or 2 doubles) in one load
__device__ __forceinline__ void ld16(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld16(const double* p, double (&v)[2]) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x; v[1] = t.y;
}

// row stride of a tile in shared memory: a row is TILE values plus 16
// bytes, so rows stay 16-byte aligned for ld16 and neighbouring rows start
// 4 banks apart
template <typename T>
__host__ __device__ constexpr int ld_of() { return TILE + 16 / (int)sizeof(T); }

// --------------------------------------------------------------------------
// K1 / K2: tile flags, tile moves, the tile GEMM and the substitutions
// --------------------------------------------------------------------------

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

// spin until another block has published flag *f; returns its value
__device__ __forceinline__ int wait_flag(const int* f) {
  int v;
  while ((v = ld_acquire(f)) == 0) __nanosleep(32);
  return v;
}

// every thread's writes of the task are visible before the flag is: the
// barrier orders them before thread 0's fence and release store
__device__ __forceinline__ void publish(int* f, int v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(f, v);
  }
}

// element (r, c) of the row-major rows x cols matrix a; past its edge the
// identity (ident) or zero.  CG reads through L2 only: the tile was
// written by another block.
template <typename T, bool CG>
__device__ __forceinline__ T elem(const T* a, int rows, int cols, int r, int c,
                                  bool ident) {
  if (r < rows && c < cols) {
    const T* p = a + (size_t)r * cols + c;
    return CG ? __ldcg(p) : *p;
  }
  return ident && r == c ? T(1) : T(0);
}

// s[r][c] = a[r0 + r][c0 + c] (TRANS: s[c][r]) for the TILE x TILE tile;
// every load of the thread is in flight before the first store
template <typename T, bool CG, bool TRANS>
__device__ __forceinline__ void load_tile(T* s, const T* a, int rows, int cols,
                                          int r0, int c0, bool ident) {
  constexpr int LD = ld_of<T>(), PER = TILE * TILE / THREADS;
  T v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * THREADS, r = e / TILE, c = e % TILE;
    v[u] = elem<T, CG>(a, rows, cols, r0 + r, c0 + c, ident);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * THREADS, r = e / TILE, c = e % TILE;
    s[TRANS ? c * LD + r : r * LD + c] = v[u];
  }
}

// Thread (ty, tx) of the 16 x 16 grid holds tile rows ty*4 + i and
// columns tx + 16*j (i, j < 4).  acc -= sA sB^T, both operands [row][k] in
// shared memory, read 16 bytes along k at a time: the A operand as a
// broadcast, the B operand by 8 lanes a phase in distinct banks.
template <typename T>
__device__ __forceinline__ void gemm_sub(T (&acc)[4][4], const T* sA,
                                         const T* sB, int ty, int tx) {
  constexpr int LD = ld_of<T>(), W = 16 / (int)sizeof(T);
#pragma unroll 4
  for (int k = 0; k < TILE; k += W) {
    T a[4][W], b[4][W];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ld16(sA + (ty * 4 + i) * LD + k, a[i]);
      ld16(sB + (tx + 16 * i) * LD + k, b[i]);
    }
#pragma unroll
    for (int kk = 0; kk < W; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] -= a[i][kk] * b[j][kk];
  }
}

template <typename T>
__device__ __forceinline__ void acc_to_tile(T* s, const T (&acc)[4][4],
                                            int ty, int tx) {
  constexpr int LD = ld_of<T>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[(ty * 4 + i) * LD + tx + 16 * j] = acc[i][j];
}

// rd[c] = 1 / L[c][c] for the lower TILE x TILE tile L in shared memory
// (threads 0..63); the caller's __syncthreads publishes it
template <typename T>
__device__ __forceinline__ void recip_diag(T* rd, const T* L) {
  constexpr int LD = ld_of<T>();
  if (threadIdx.x < TILE) rd[threadIdx.x] = T(1) / L[threadIdx.x * LD + threadIdx.x];
}

// The substitution below is a dependent chain of 64 steps.  Unrolled in
// full it needs more registers than the kernel can give it and ran slower
// on the card than a ROLLED loop over blocks of four columns: the values a
// lane holds shift down one register per block, so the current column is
// always index 0 and every register index stays a constant (an index that
// is not would put the array in local memory).  The body is a template on
// how many entries can still be live, chosen per range of steps, and
// entries past the tile are masked, never skipped with a break.

// Columns 4it .. 4it+3 of subst64: x[q] holds v[4(it + q) + g]; only
// q < NQ can be live.
template <int NQ, typename T>
__device__ __forceinline__ void subst4(T (&x)[16], const T* L, const T* rd,
                                       int g, int base, int it) {
  constexpr int LD = ld_of<T>();
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    const int c = 4 * it + cc;
    if (g == cc) x[0] *= rd[c];
    const T v = __shfl_sync(FULL, x[0], base + cc);
    const T* lc = L + (4 * it + g) * LD + c;     // L[4(it + q) + g][c] at q * 4 * LD
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if ((q > 0 || g > cc) && it + q < TILE / 4) x[q] -= v * lc[q * 4 * LD];
  }
}

// Forward substitution L x = v for one 64-vector held by four neighbouring
// lanes: lane g of the four (base + g) holds v[4q + g] in x[q].  L is the
// lower TILE x TILE tile in shared memory, rd its reciprocal diagonal.
// Each solved entry goes to the other three lanes by __shfl_sync; no block
// barrier.  Solved entry 4i + g is written to out[(4i + g) * stride].
template <typename T>
__device__ __forceinline__ void subst64(T (&x)[16], const T* L, const T* rd,
                                        int g, int base, T* out, int stride) {
#pragma unroll 1
  for (int it = 0; it < TILE / 4; ++it) {
    if (it < 4) subst4<16>(x, L, rd, g, base, it);
    else if (it < 8) subst4<12>(x, L, rd, g, base, it);
    else if (it < 12) subst4<8>(x, L, rd, g, base, it);
    else subst4<4>(x, L, rd, g, base, it);
    out[(4 * it + g) * stride] = x[0];
#pragma unroll
    for (int q = 0; q < 15; ++q) x[q] = x[q + 1];
  }
}

// In-register Cholesky of a 32 x 32 block, one warp: lane r holds row r
// in a[]; returns L's row r (entries past the diagonal are garbage) and
// rd[j] = 1 / L[j][j].  Each column scales by the pivot's reciprocal
// square root (lane j: p / sqrt(p) = sqrt(p)); a pivot that is not
// positive gives NaN.  Unrolled in full: a rolled form with a register
// shift ran slower on the card.
template <typename T>
__device__ __forceinline__ void potrf32(T (&a)[32], int lane, T* rd) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const T inv = dev_rsqrt(__shfl_sync(FULL, a[j], j));
    const T lj = lane >= j ? a[j] * inv : T(0);
    a[j] = lj;
    if (lane == 0) rd[j] = inv;
#pragma unroll
    for (int c = j + 1; c < 32; ++c) {
      const T lc = __shfl_sync(FULL, lj, c);
      if (c <= lane) a[c] -= lj * lc;
    }
  }
}

// Cholesky of the TILE x TILE tile s in shared memory, in place, by ONE
// warp (lane = 0..31), as 2 x 2 blocks of 32: L11, L21 = A21 L11^-T,
// A22 - L21 L21^T, L22.  Writes zeros above the diagonal; uses rd[0..63].
template <typename T>
__device__ void potrf64(T* s, T* rd, int lane) {
  constexpr int LD = ld_of<T>();
  T a[32];
  T* top = s + lane * LD;
  T* row = s + (32 + lane) * LD;
#pragma unroll
  for (int c = 0; c < 32; ++c) a[c] = top[c];
  potrf32(a, lane, rd);
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    top[c] = c <= lane ? a[c] : T(0);
    top[32 + c] = T(0);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 32; ++c) a[c] = row[c];
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    a[c] *= rd[c];
#pragma unroll
    for (int c2 = c + 1; c2 < 32; ++c2) a[c2] -= a[c] * s[c2 * LD + c];
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) row[c] = a[c];
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 32; ++c) a[c] = row[32 + c];
#pragma unroll 4
  for (int k = 0; k < 32; ++k) {
    const T lk = row[k];
#pragma unroll
    for (int c = 0; c < 32; ++c) a[c] -= lk * s[(32 + c) * LD + k];
  }
  potrf32(a, lane, rd + 32);
#pragma unroll
  for (int c = 0; c < 32; ++c) row[32 + c] = c <= lane ? a[c] : T(0);
}

// Whether every entry of the TILE x TILE tile of the n x n matrix a at
// (r0, c0) that this thread reads is finite; `lower`: only the entries on
// and below the diagonal of a diagonal tile, the part a lower solve uses.
// Entries past n count as finite (they are the identity or zero).
template <typename T>
__device__ __forceinline__ bool tile_finite(const T* a, int n, int r0, int c0,
                                            bool lower) {
  bool ok = true;
  for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE, c = e % TILE;
    if (r0 + r < n && c0 + c < n && (!lower || c <= r))
      ok &= isfinite(a[(size_t)(r0 + r) * n + c0 + c]);
  }
  return ok;
}

// l[r0 + r][c0 + c] = s[r][c] for the part of the TILE x TILE tile inside
// the rows x cols matrix l
template <typename T>
__device__ __forceinline__ void store_tile(T* l, const T* s, int rows, int cols,
                                           int r0, int c0) {
  constexpr int LD = ld_of<T>();
  for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
    const int r = e / TILE, c = e % TILE;
    if (r0 + r < rows && c0 + c < cols) l[(size_t)(r0 + r) * cols + c0 + c] = s[r * LD + c];
  }
}

// acc = the TILE x TILE tile of the n x n matrix a at (r0, c0), in the
// GEMM's 4 x 4 layout, the identity past n
template <typename T>
__device__ __forceinline__ void load_acc(T (&acc)[4][4], const T* a, int n,
                                         int r0, int c0, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      acc[r][c] = elem<T, false>(a, n, n, r0 + ty * 4 + r, c0 + tx + 16 * c, true);
}

// Solve X L_jj^T = A for the tile A in s (L_jj staged in sl, rd its
// reciprocal diagonal): row r of X solves L_jj x = a_r, four lanes to a
// row.  Leaves X in s and writes it into l at (i0, j0); zeroes the tile
// (j0, i0) above the diagonal.
template <typename T>
__device__ __forceinline__ void trsm_tile(T* s, const T* sl, const T* rd, T* l,
                                          int n, int i0, int j0) {
  constexpr int LD = ld_of<T>();
  const int tid = threadIdx.x, r = tid / 4, g = tid % 4, base = (tid % 32) & ~3;
  T x[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) x[q] = s[r * LD + 4 * q + g];
  subst64(x, sl, rd, g, base, s + r * LD, 1);
  __syncthreads();
  store_tile(l, s, n, n, i0, j0);
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int rr = e / TILE, c = e % TILE;
    if (j0 + rr < n && i0 + c < n) l[(size_t)(j0 + rr) * n + i0 + c] = T(0);
  }
}

// --------------------------------------------------------------------------
// K1: the tile Cholesky.  Task order: matrix fastest, then tile column by
// tile column; column j holds its DIAGONAL task, which finishes tile
// (j, j-1) and then (j, j), followed by the solve tasks of (j+2, j) ..
// (nt-1, j).  Tile (j+1, j) belongs to the next diagonal task: the block
// that factors L_{j+1,j+1} solves its own row of the previous column and
// keeps it in shared memory, so no block-to-block handoff and no tile
// reload lies between two diagonal tiles but the factor L_jj itself.
// Flags: one per tile (i, j) of each matrix, flags[1 + s*nt*nt + i*nt + j].
// --------------------------------------------------------------------------

__host__ __device__ constexpr int col_tasks(int nt, int j) {
  return nt - 1 - j > 1 ? nt - 1 - j : 1;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
chol_tiles(const T* __restrict__ D, T* out, int* flags, int S, int n, int nt) {
  constexpr int LD = ld_of<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s0 = reinterpret_cast<T*>(smem_raw);
  T* s1 = s0 + TILE * LD;
  T* rd = s1 + TILE * LD;
  __shared__ int s_task;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long ntask = (long long)S * (1 + nt * (nt - 1) / 2);
  for (;;) {
    if (tid == 0) s_task = atomicAdd(flags, 1);
    __syncthreads();
    const int t = s_task;
    if (t >= ntask) return;
    const int s = t % S;
    int loc = t / S, j = 0;
    while (loc >= col_tasks(nt, j)) loc -= col_tasks(nt, j++);
    const int i = loc ? j + 1 + loc : j, i0 = i * TILE, j0 = j * TILE;
    const T* a = D + (size_t)s * n * n;
    T* l = out + (size_t)s * n * n;
    int* f = flags + 1 + (size_t)s * nt * nt;

    if (i != j) {
      // tile (i, j), i >= j + 2: A_ij - sum_k L_ik L_jk^T, then the solve
      T acc[4][4];
      load_acc(acc, a, n, i0, j0, ty, tx);
      for (int k = 0; k < j; ++k) {
        if (tid == 0) {
          wait_flag(f + i * nt + k);
          wait_flag(f + j * nt + k);
        }
        __syncthreads();
        load_tile<T, true, false>(s0, l, n, n, i0, k * TILE, true);
        load_tile<T, true, false>(s1, l, n, n, j0, k * TILE, true);
        __syncthreads();
        gemm_sub(acc, s0, s1, ty, tx);
        __syncthreads();
      }
      acc_to_tile(s0, acc, ty, tx);
      if (tid == 0) wait_flag(f + j * nt + j);
      __syncthreads();
      load_tile<T, true, false>(s1, l, n, n, j0, j0, true);
      __syncthreads();
      recip_diag(rd, s1);
      __syncthreads();
      trsm_tile(s0, s1, rd, l, n, i0, j0);
      publish(f + i * nt + j, READY);
      continue;
    }

    // the diagonal task of column j: tile (j, j-1) in `low`, (j, j) in acc
    T acc[4][4], low[4][4];
    load_acc(acc, a, n, j0, j0, ty, tx);
    if (j > 0) load_acc(low, a, n, j0, j0 - TILE, ty, tx);
    for (int k = 0; k + 1 < j; ++k) {
      if (tid == 0) {
        wait_flag(f + j * nt + k);
        wait_flag(f + (j - 1) * nt + k);
      }
      __syncthreads();
      load_tile<T, true, false>(s0, l, n, n, j0, k * TILE, true);
      load_tile<T, true, false>(s1, l, n, n, j0 - TILE, k * TILE, true);
      __syncthreads();
      gemm_sub(acc, s0, s0, ty, tx);
      gemm_sub(low, s0, s1, ty, tx);
      __syncthreads();
    }
    if (j > 0) {
      acc_to_tile(s0, low, ty, tx);
      if (tid == 0) wait_flag(f + (j - 1) * nt + j - 1);
      __syncthreads();
      load_tile<T, true, false>(s1, l, n, n, j0 - TILE, j0 - TILE, true);
      __syncthreads();
      recip_diag(rd, s1);
      __syncthreads();
      trsm_tile(s0, s1, rd, l, n, j0, j0 - TILE);   // s0 holds L_{j,j-1}
      gemm_sub(acc, s0, s0, ty, tx);
      __syncthreads();
    }
    acc_to_tile(s0, acc, ty, tx);
    __syncthreads();
    if (tid < 32) {
      potrf64(s0, rd, tid);
    } else if (tid == 32 && j > 0) {
      // L_{j,j-1} was stored before the barriers above: release it while
      // warp 0 factors (the next diagonal task's last update needs it)
      __threadfence();
      st_release(f + j * nt + j - 1, READY);
    }
    __syncthreads();
    store_tile(l, s0, n, n, j0, j0);
    publish(f + j * nt + j, READY);
  }
}

// --------------------------------------------------------------------------
// K2: the tile forward substitution.  Task order: matrix fastest, then
// row tile, then column tile.  Flags: one per (i, c) of each matrix,
// flags[1 + s*nt*mt + i*mt + c], READY or ZERO.
// --------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
solve_lower_tiles(const T* __restrict__ L, const T* __restrict__ B, T* Y,
                  int* flags, int S, int n, int m, int nt, int mt) {
  constexpr int LD = ld_of<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s0 = reinterpret_cast<T*>(smem_raw);
  T* s1 = s0 + TILE * LD;
  T* rd = s1 + TILE * LD;
  __shared__ int s_task, s_flag;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long ntask = (long long)S * nt * mt;
  for (;;) {
    if (tid == 0) s_task = atomicAdd(flags, 1);
    __syncthreads();
    const int t = s_task;
    if (t >= ntask) return;
    const int s = t % S, loc = t / S, i = loc / mt, c = loc % mt;
    const int i0 = i * TILE, c0 = c * TILE;
    const T* l = L + (size_t)s * n * n;
    const T* b = B + (size_t)s * n * m;
    T* y = Y + (size_t)s * n * m;
    int* f = flags + 1 + (size_t)s * nt * mt;

    T acc[4][4];
    int nonzero = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        acc[r][cc] = elem<T, false>(b, n, m, i0 + ty * 4 + r, c0 + tx + 16 * cc, false);
        nonzero |= acc[r][cc] != T(0);
      }
    for (int k = 0; k < i; ++k) {
      if (tid == 0) s_flag = wait_flag(f + k * mt + c);
      __syncthreads();
      // a ZERO tile's product is skipped only where L_ik is finite: as in
      // the plain solve, 0 * NaN and 0 * Inf give NaN (s_flag is the same
      // for every thread, so all or none reach the barrier)
      if (s_flag == READY ||
          !__syncthreads_and(tile_finite(l, n, i0, k * TILE, false))) {
        load_tile<T, false, false>(s0, l, n, n, i0, k * TILE, true);
        load_tile<T, true, true>(s1, y, n, m, k * TILE, c0, false);
        __syncthreads();
        gemm_sub(acc, s0, s1, ty, tx);
        nonzero = 1;
      }
      __syncthreads();
    }
    // a zero tile, unless L_ii is not finite (then the substitution
    // below spreads its NaN, as the plain solve does)
    if (!__syncthreads_or(nonzero) &&
        __syncthreads_and(tile_finite(l, n, i0, i0, true))) {
      for (int e = tid; e < TILE * TILE; e += THREADS) {
        const int r = e / TILE, cc = e % TILE;
        if (i0 + r < n && c0 + cc < m) y[(size_t)(i0 + r) * m + c0 + cc] = T(0);
      }
      publish(f + i * mt + c, ZERO);
      continue;
    }
    acc_to_tile(s0, acc, ty, tx);
    load_tile<T, false, false>(s1, l, n, n, i0, i0, true);
    __syncthreads();
    recip_diag(rd, s1);
    __syncthreads();
    // column cc of the tile solves L_ii y = r_cc; four lanes to a column
    const int cc = tid / 4, g = tid % 4, base = (tid % 32) & ~3;
    T x[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) x[q] = s0[(4 * q + g) * LD + cc];
    subst64(x, s1, rd, g, base, s0 + cc, LD);
    __syncthreads();
    store_tile(y, s0, n, m, i0, c0);
    publish(f + i * mt + c, READY);
  }
}

// X = L^-T B for m < NB: block (column, matrix) of UP_THREADS threads; in
// shared memory the rhs column (xb), and the chain's coefficients of every
// diagonal tile, coef[t][k][r] = L[i0 + k][i0 + r] / L[i0 + k][i0 + k] for
// r < k (i0 = 32 t), and the reciprocal diagonal rdg[t][r], prepared by all
// warps before the sweep.  Rows of L outside the diagonal tiles are read
// from global memory (L2), each thread's row of the next update loaded
// before the chain.
template <typename T>
__global__ void __launch_bounds__(UP_THREADS)
solve_upper_chain(const T* __restrict__ L, const T* __restrict__ B,
                  T* __restrict__ X, int n, int m) {
  constexpr int W = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = (n + NB - 1) / NB;
  T* xb = reinterpret_cast<T*>(smem_raw);
  T* rdg = xb + (n + W - 1) / W * W;              // (nt, NB)
  T* coef = rdg + nt * NB;                        // (nt, NB, NB)
  const size_t z = blockIdx.y;
  const T* l = L + z * n * n;
  const T* b = B + z * n * m + blockIdx.x;
  T* x = X + z * n * m + blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n; i += UP_THREADS) xb[i] = b[(size_t)i * m];
  for (int t = warp; t < nt; t += UP_THREADS / 32) {
    const int i0 = t * NB, rows = min(NB, n - i0);
    const T rd = lane < rows ? T(1) / l[(size_t)(i0 + lane) * n + i0 + lane] : T(1);
    T c[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k)
      c[k] = k < rows && lane < k ? l[(size_t)(i0 + k) * n + i0 + lane] : T(0);
    rdg[t * NB + lane] = rd;
#pragma unroll
    for (int k = 0; k < NB; ++k)
      coef[(t * NB + k) * NB + lane] = c[k] * __shfl_sync(FULL, rd, k);
  }
  __syncthreads();
  for (int t = nt - 1; t >= 0; --t) {
    const int i0 = t * NB, rows = min(NB, n - i0);
    // the rows above take the tile's x next: warp 0 the 32 rows of the next
    // tile, the other warps the rest; each thread's first row's
    // coefficients load now, in flight during the chain
    const bool first = warp == 0;
    const int lo = first ? i0 - NB + lane : tid - 32;
    const int hi = first ? i0 : i0 - NB;
    const int step = first ? NB : UP_THREADS - 32;
    T u[NB];
    if (t > 0 && lo < hi) {
#pragma unroll
      for (int k = 0; k < NB; ++k)
        u[k] = k < rows ? l[(size_t)(i0 + k) * n + lo] : T(0);
    }
    if (warp == 0) {
      // lane r: row i0 + r; rd its reciprocal diagonal, a[k] the tile's
      // L[i0 + k][i0 + r] * rd_k below the diagonal
      const bool live = lane < rows;
      const T rd = rdg[t * NB + lane];
      T a[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) a[k] = coef[(t * NB + k) * NB + lane];
      T v = live ? xb[i0 + lane] : T(0);
#pragma unroll
      for (int k = NB - 1; k >= 0; --k) {
        if (k >= rows) continue;                  // the same for the warp
        const T vk = __shfl_sync(FULL, v, k);
        if (lane < k) v -= a[k] * vk;
      }
      v *= rd;
      if (live) {
        xb[i0 + lane] = v;
        x[(size_t)(i0 + lane) * m] = v;
      }
    }
    if (t == 0) break;
    __syncthreads();
    // disjoint rows; the next barrier orders them before their reads
    for (int i = lo; i < hi; i += step) {
      T s = xb[i];
      if (i == lo) {
#pragma unroll
        for (int k = 0; k < NB; ++k)
          if (k < rows) s -= u[k] * xb[i0 + k];
      } else {
        for (int k = 0; k < rows; ++k) s -= l[(size_t)(i0 + k) * n + i] * xb[i0 + k];
      }
      xb[i] = s;
    }
  }
}

// X = L^-T B; one thread per rhs column, blockDim.x == NB.
template <typename T>
__global__ void solve_upper(const T* L, const T* B, T* X, int n, int m) {
  __shared__ T t[NB][NB + 1];
  const T* l = L + (size_t)blockIdx.z * n * n;
  const T* b = B + (size_t)blockIdx.z * n * m;
  T* x = X + (size_t)blockIdx.z * n * m;
  const int tx = threadIdx.x;
  const int col = blockIdx.x * NB + tx;
  const bool live = col < m;
  const int last = ((n - 1) / NB) * NB;
  for (int i0 = last; i0 >= 0; i0 -= NB) {
    T acc[NB];
#pragma unroll
    for (int ii = 0; ii < NB; ++ii)
      acc[ii] = (live && i0 + ii < n) ? b[(size_t)(i0 + ii) * m + col] : T(0);
    for (int k0 = i0 + NB; k0 < n; k0 += NB) {
      __syncthreads();
      // t[ii][kk] = L[k0 + kk][i0 + ii] = (L^T)[i0 + ii][k0 + kk]
      for (int rr = 0; rr < NB; ++rr) {
        const int r = k0 + rr;
        t[tx][rr] = r < n ? l[(size_t)r * n + i0 + tx] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        const T xk = (live && k0 + kk < n) ? x[(size_t)(k0 + kk) * m + col] : T(0);
#pragma unroll
        for (int ii = 0; ii < NB; ++ii) acc[ii] -= t[ii][kk] * xk;
      }
    }
    __syncthreads();
    // transposed diagonal tile; rows past n get a unit diagonal so the
    // sweep stays finite
    for (int rr = 0; rr < NB; ++rr) {
      const int r = i0 + rr, c = i0 + tx;
      t[tx][rr] = (r < n && c < n) ? l[(size_t)r * n + c] : (rr == tx ? T(1) : T(0));
    }
    __syncthreads();
#pragma unroll
    for (int ii = NB - 1; ii >= 0; --ii) {
      T s = acc[ii];
#pragma unroll
      for (int kk = ii + 1; kk < NB; ++kk) s -= t[ii][kk] * acc[kk];
      acc[ii] = s / t[ii][ii];
    }
#pragma unroll
    for (int ii = 0; ii < NB; ++ii)
      if (live && i0 + ii < n) x[(size_t)(i0 + ii) * m + col] = acc[ii];
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

// dynamic shared memory of a tile task: two padded tiles and a reciprocal
// diagonal
template <typename T>
constexpr size_t tile_smem() { return (2 * TILE * ld_of<T>() + TILE) * sizeof(T); }

// Blocks of `kernel` the current device holds at once (occupancy x SMs);
// raises its shared-memory limit first where it needs more than 48 KB.
// `cache` is the caller's, one slot per device, so both are done once.
template <typename K>
int resident_blocks(K kernel, size_t smem, std::atomic<int>* cache, int* blocks) {
  int dev, sms;
  int err = device_sms(&dev, &sms);
  if (err) return err;
  *blocks = cache[dev].load(std::memory_order_relaxed);
  if (*blocks > 0) return 0;
  cudaError_t e;
  if (smem > (size_t)STATIC_SMEM) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  cache[dev].store(*blocks, std::memory_order_relaxed);
  return 0;
}

// Check the caller's scratch (nflags ints; `need` of them are used), zero
// it on the stream and size the grid of `kernel`: min(tasks, resident).
template <typename K>
int prepare_tiles(K kernel, size_t smem, std::atomic<int>* cache, int* flags,
                  long long nflags, long long need, long long tasks,
                  cudaStream_t st, unsigned* grid) {
  if (nflags < need) return (int)cudaErrorInvalidValue;
  int blocks;
  int err = resident_blocks(kernel, smem, cache, &blocks);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(flags, 0, sizeof(int) * (size_t)need, st);
  if (e != cudaSuccess) return (int)e;
  *grid = (unsigned)(tasks < blocks ? tasks : blocks);
  return 0;
}

// int32 scratch of K1 and K2: the task counter, then one flag per tile of
// each matrix's n x n factor (K1) or n x m solution (K2)
long long chol_scratch_len(int S, int n) {
  const long long nt = (n + TILE - 1) / TILE;
  return 1 + S * nt * nt;
}

long long solve_lower_scratch_len(int S, int n, int m) {
  return 1 + (long long)S * ((n + TILE - 1) / TILE) * ((m + TILE - 1) / TILE);
}

template <typename T>
int chol_batched(T* out, const T* D, int* flags, long long nflags, int S, int n,
                 cudaStream_t st) {
  static std::atomic<int> cache[MAX_DEVICES];
  const int nt = (n + TILE - 1) / TILE;
  const size_t smem = tile_smem<T>();
  unsigned grid;
  const int err = prepare_tiles(chol_tiles<T>, smem, cache, flags, nflags,
                                chol_scratch_len(S, n),
                                (long long)S * (1 + nt * (nt - 1) / 2), st, &grid);
  if (err) return err;
  chol_tiles<T><<<grid, THREADS, smem, st>>>(D, out, flags, S, n, nt);
  return (int)cudaGetLastError();
}

template <typename T>
int solve_lower_batched(const T* L, const T* B, T* Y, int* flags, long long nflags,
                        int S, int n, int m, cudaStream_t st) {
  static std::atomic<int> cache[MAX_DEVICES];
  const int nt = (n + TILE - 1) / TILE, mt = (m + TILE - 1) / TILE;
  const size_t smem = tile_smem<T>();
  unsigned grid;
  const int err = prepare_tiles(solve_lower_tiles<T>, smem, cache, flags, nflags,
                                solve_lower_scratch_len(S, n, m),
                                (long long)S * nt * mt, st, &grid);
  if (err) return err;
  solve_lower_tiles<T><<<grid, THREADS, smem, st>>>(L, B, Y, flags, S, n, m, nt, mt);
  return (int)cudaGetLastError();
}

// shared memory of solve_upper_chain: the rhs column, padded to 16 bytes,
// and the diagonal tiles' reciprocal diagonals and coefficients
template <typename T>
constexpr size_t chain_smem(int n) {
  const size_t w = 16 / sizeof(T), nt = (n + NB - 1) / NB;
  return ((n + w - 1) / w * w + nt * NB * (NB + 1)) * sizeof(T);
}

template <typename T>
int solve_upper_batched(const T* L, const T* B, T* X, int S, int n, int m,
                        cudaStream_t st) {
  const size_t smem = chain_smem<T>(n);
  if (m >= NB || smem > (size_t)UP_SMEM_MAX) {
    solve_upper<T><<<dim3((m + NB - 1) / NB, 1, S), NB, 0, st>>>(L, B, X, n, m);
    return (int)cudaGetLastError();
  }
  if (smem > (size_t)STATIC_SMEM) {
    static std::atomic<bool> raised[MAX_DEVICES];
    int dev, sms;
    int err = device_sms(&dev, &sms);
    if (err) return err;
    if (!raised[dev].load(std::memory_order_relaxed)) {
      const cudaError_t e = cudaFuncSetAttribute(
          solve_upper_chain<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          UP_SMEM_MAX);
      if (e != cudaSuccess) return (int)e;
      raised[dev].store(true, std::memory_order_relaxed);
    }
  }
  solve_upper_chain<T><<<dim3((unsigned)m, (unsigned)S), UP_THREADS, smem, st>>>(
      L, B, X, n, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// length of the int32 scratch the K1 / K2 entries below take
long long g2o_chol_scratch_len(int S, int n) { return chol_scratch_len(S, n); }

long long g2o_solve_lower_scratch_len(int S, int n, int m) {
  return solve_lower_scratch_len(S, n, m);
}

int g2o_chol_batched_f32(void* out, const void* D, void* flags, long long nflags,
                         int S, int n, void* stream) {
  return chol_batched<float>((float*)out, (const float*)D, (int*)flags, nflags, S,
                             n, (cudaStream_t)stream);
}

int g2o_chol_batched_f64(void* out, const void* D, void* flags, long long nflags,
                         int S, int n, void* stream) {
  return chol_batched<double>((double*)out, (const double*)D, (int*)flags, nflags,
                              S, n, (cudaStream_t)stream);
}

int g2o_solve_lower_batched_f32(const void* L, const void* B, void* Y, void* flags,
                                long long nflags, int S, int n, int m, void* stream) {
  return solve_lower_batched<float>((const float*)L, (const float*)B, (float*)Y,
                                    (int*)flags, nflags, S, n, m,
                                    (cudaStream_t)stream);
}

int g2o_solve_lower_batched_f64(const void* L, const void* B, void* Y, void* flags,
                                long long nflags, int S, int n, int m, void* stream) {
  return solve_lower_batched<double>((const double*)L, (const double*)B, (double*)Y,
                                     (int*)flags, nflags, S, n, m,
                                     (cudaStream_t)stream);
}

int g2o_solve_upper_batched_f32(const void* L, const void* B, void* X, int S, int n,
                                int m, void* stream) {
  return solve_upper_batched<float>((const float*)L, (const float*)B, (float*)X, S, n, m,
                                    (cudaStream_t)stream);
}

int g2o_solve_upper_batched_f64(const void* L, const void* B, void* X, int S, int n,
                                int m, void* stream) {
  return solve_upper_batched<double>((const double*)L, (const double*)B, (double*)X, S,
                                     n, m, (cudaStream_t)stream);
}

}  // extern "C"
