// Row gather and segment sum for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of scripts/pallas_onehot_experimental.py,
// the hand-kernel forms of the one-hot gather and segment sum of
// g2o_tpu/ops/onehot.py:
//   K5   gather_t_mxu          (:80,  _mk_gather_kernel)   -> g2o_gather_*,
//   K7   gather_mxu_rows       (:143, _mk_gather_kernel)      dims_major = 1
//   K10  gather_t_mxu2         (:364, _mk_gather2_kernel)     for K5/K10, 0 for K7
//   K6   segment_sum_t_mxu     (:112, _mk_scatter_kernel)  -> g2o_scatter_add_*,
//   K8   segment_sum_rows_mxu  (:172, _mk_scatter_kernel)     dims_major = 1
//   K9   segment_sum_t_mxu2    (:274, _mk_segsum2_kernel)     for K6/K9, 0 for K8
// K9 and K10 differ from K6 and K5 only in how the TPU is driven (one grid
// step, a hand DMA loop); they compute the same function, so one kernel
// serves each pair.
//
//   gather:       out[n, d] = table[idx[n], d], zero where idx[n] lies
//                 outside [0, S);
//   segment sum:  out[s, d] = sum of values[n, d] over the n with
//                 idx[n] == s; rows with an id outside [0, S) are dropped.
// table and out of the segment sum are (S, D) row-major; the per-row side
// (the gather's out, the segment sum's values) is (N, D) row-major or, with
// dims_major, (D, N): the edge axis last, the layout of the implicit Schur
// solver's dims-major arrays.  idx is (N,) int32.  Sums are plain
// float32/float64 adds; the one-hot matrix products of the TPU form (a TPU
// scatter serializes per row) are not carried over.  Plain C entry points
// (no PyTorch headers), loaded with ctypes by g2o_tpu_torch/ops/onehot.py.
// The caller owns every buffer and checks N*D, S*D < 2^31; `out` needs no
// initial value.  The kernels launch on the caller's stream, never
// synchronize, and each entry returns the first CUDA error it meets.
//
// On the solver's paths a call moves little (1.3 MB at the runtime-bucketed
// ladybug shape, (35000, 9) <-> (49, 9): 0.4 us at 3.35 TB/s), so what a
// call costs is its launches and the host's work around them, not bytes.
// Every branch below is ONE operation on the card, except the segment sum
// outside its row-major small-table branch (dims-major, or S*D past
// ROWSUM_MAX_CELLS), which is a memset of `out` and a kernel.
//
// Gather.  Row-major with a table of at most ~46 KB (K7 on the path): a
// block stages the (S, D) table in shared memory, then walks tiles of
// GATHER_TILE_ROWS rows: it reads each row's id once into shared memory (as
// a table offset, -1 for an id out of range), then writes the tile's flat
// slice of `out` as 16-byte stores (`out` must be 16-byte aligned, and a
// tile is 2 KB of rows times D), scalar stores at its ragged end.
// Otherwise (dims-major, K5/K10 on the paths, or a wider table) one thread
// per output element in a grid-stride loop, four independent elements per
// thread per pass (their id loads in flight together), the table staged in
// shared memory while it fits the 48 KB of static shared memory, else read
// through __ldg; in the dims-major layout a warp's idx reads are
// consecutive too.  Bound: bytes, N*D values written, N ids and S*D values
// read (about 36 MB at Venice, 9 x ~900k floats: 0.011 ms at 3.35 TB/s).
//
// Segment sum, row-major with S*D <= ROWSUM_MAX_CELLS (K8 on the path):
// one cooperative launch, no memset, no global atomics, and the same bits
// on every run.  Blocks of 16 warps, at most one per SM, sized so each warp
// gets about ROWSUM_BATCH rows.  Each warp owns a (S, D) accumulator in
// shared memory and a contiguous run of rows; it takes ROWSUM_BATCH rows at
// a time (their ids read by one lane each and shuffled to the warp, their
// values loaded together, lane c holding column c) and adds them in row
// order with a read of the cell and a predicated store (no branch per
// row), so no two lanes of an instruction touch one cell and the order is
// fixed.  The block sums its warps' accumulators in warp order and stores
// the partial into a scratch (one (S, D) slot per block, no initial
// value); after a grid-wide barrier (cooperative_groups' grid sync:
// the blocks of a cooperative launch are co-resident) each warp of the grid
// takes cells of `out`, its lanes sum the blocks' partials in a fixed order
// and a fixed shuffle tree adds the lanes, and lane 0 stores the cell,
// zeros included.  No value is kept between calls: eager calls on one
// stream share one scratch (they run in order), and a call captured in a
// CUDA graph allocates its own with cudaMallocAsync / cudaFreeAsync (graph
// memory nodes), so graphs replayed at once share nothing.  A last-block
// ticket would need a zero counter on entry, so a memset or a value kept
// between calls.  Bound: bytes, as below.  Measured at the ladybug shape
// ((35000, 9) -> (49, 9), f32; H100 80GB HBM3, 700 W;
// scripts/rowsum_probe.py): 5.93 us of device time, of which 3.33 us are
// fixed (launch, accumulators, partials, barrier, the pass over the
// partials; the barrier ~0.9, that pass ~1.0); the memset branch takes
// 5.1-5.4 us in two operations, 7.32 us against 6.74 per call in a CUDA
// graph.  A branch per row cost 1.8 us more, two blocks of 8 warps per SM
// 0.8 us, 16 rows per warp 0.9 us, more blocks than ~N/512 0.7 us; rows
// loaded as one coalesced run through a shared tile saved only 0.14 us,
// too little for a second load path.
// ROWSUM_MAX_CELLS is set by shared memory: sixteen warps' float64
// accumulators fill SCATTER_BUDGET at 768 cells.

// Segment sum, otherwise: the threads walk the flat (row, column) elements
// of the per-row side in a grid-stride loop, four per thread per pass, so a
// warp's loads are consecutive addresses in either layout.  While one
// column of S values fits SCATTER_BUDGET (96 KB of shared memory, two
// blocks on one SM: S <= 24576 in float32, 12288 in float64), each block
// keeps a private (S, Dt) accumulator in shared memory, the counterpart of
// K9's VMEM-resident (S, D) accumulator; its threads atomicAdd into shared
// memory, then the block flushes its nonzero partials with one global
// atomicAdd each into `out`, zeroed by a memset on the caller's stream
// first.  D is tiled over blockIdx.y so that S*Dt values fit the budget (at
// Venice, 800 x 81 floats = 259 KB do not fit one block: Dt = 30, three
// tiles); above 48 KB the kernel's dynamic shared-memory limit is raised
// once per device.  Blocks per tile are chosen so each block sums at least
// about four times as many elements as it flushes.  A wider S adds each
// element straight from registers into `out` with a global atomicAdd: ids
// spread over that many segments rarely collide, and the kernel serves
// every S.  Bound: bytes, N*D values and N ids read, S*D values written (36
// MB for 9 x ~900k -> 800 x 9 floats, 295 MB for 81 x ~900k -> 800 x 81).
// Summation order varies with the atomics, so results differ from a
// sequential sum in the last bits.
//
// Why not one thread block cluster for K8 (8 blocks, per-warp shared sums
// in a fixed order, combined through distributed shared memory): measured
// on an H100 80GB HBM3 at 700 W (scripts/onehot_ab.py), it took 17.4-18.6
// us per call at the ladybug shape against 5.0-5.1 us for the grid kernel
// and its memset, and 11.9 us against 4.7 even at 1820 rows: eight SMs
// cannot stream the rows in a few us.

#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include <atomic>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include "device_sms.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int STATIC_SMEM = 48 * 1024;          // without an opt-in
constexpr int SCATTER_BUDGET = 96 * 1024;       // two blocks on one SM
constexpr int UNROLL = 4;                       // elements per thread per pass

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_TILE_ROWS = 512;

constexpr int ROWSUM_THREADS = 512;             // one block per SM
constexpr int ROWSUM_WARPS = ROWSUM_THREADS / 32;
constexpr int ROWSUM_BATCH = 32;                // rows in flight per warp (<= 32)
// the most cells of the row-major one-launch sum: sixteen warps' float64
// accumulators fill SCATTER_BUDGET (onehot.py's ROWSUM_MAX_CELLS)
constexpr int ROWSUM_MAX_CELLS = 768;

// one 16-byte store of 16 / sizeof(T) values
__device__ __forceinline__ void store16(float* p, const float* s) {
  *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
}
__device__ __forceinline__ void store16(double* p, const double* s) {
  *reinterpret_cast<double2*>(p) = make_double2(s[0], s[1]);
}

// flat element i of an (N, W) row-major or, dims_major, (W, N) array ->
// (row n, column c)
__device__ __forceinline__ void split(unsigned i, int N, int W,
                                      int dims_major, unsigned& n,
                                      unsigned& c) {
  if (dims_major) {
    c = i / (unsigned)N;
    n = i - c * (unsigned)N;
  } else {
    n = i / (unsigned)W;
    c = i - n * (unsigned)W;
  }
}

// ------------------------------------------------------------------------ //
// row-major gather, small table
// ------------------------------------------------------------------------ //

template <typename T>
__global__ void __launch_bounds__(GATHER_THREADS)
gather_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                   T* __restrict__ out, int N, int S, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* off = reinterpret_cast<int*>(smem_raw);              // tile's offsets
  T* tab = reinterpret_cast<T*>(smem_raw + GATHER_TILE_ROWS * sizeof(int));
  for (int j = threadIdx.x; j < S * D; j += blockDim.x) tab[j] = table[j];
  constexpr int V = 16 / sizeof(T);
  const int tiles = (N + GATHER_TILE_ROWS - 1) / GATHER_TILE_ROWS;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = t * GATHER_TILE_ROWS;
    const int rows = min(GATHER_TILE_ROWS, N - n0);
    __syncthreads();           // the table is staged; the last tile is done
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int s = __ldg(idx + n0 + r);
      off[r] = (s >= 0 && s < S) ? s * D : -1;
    }
    __syncthreads();
    T* o = out + (size_t)n0 * D;
    const int m = rows * D;
    const int nv = m / V;
    for (int k = threadIdx.x; k < nv; k += blockDim.x) {
      int n = k * V / D;
      int c = k * V - n * D;
      T v[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int a = off[n];
        v[u] = a >= 0 ? tab[a + c] : T(0);
        if (++c == D) {
          c = 0;
          ++n;
        }
      }
      store16(o + k * V, v);
    }
    for (int li = nv * V + threadIdx.x; li < m; li += blockDim.x) {
      const int n = li / D;
      const int a = off[n];
      o[li] = a >= 0 ? tab[a + li - n * D] : T(0);
    }
  }
}

// ------------------------------------------------------------------------ //
// grid kernels
// ------------------------------------------------------------------------ //

template <typename T, bool STAGE>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const T* __restrict__ table, const int* __restrict__ idx,
              T* __restrict__ out, int N, int S, int D, int dims_major) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tab = reinterpret_cast<T*>(smem_raw);
  if (STAGE) {
    for (int j = threadIdx.x; j < S * D; j += blockDim.x) tab[j] = table[j];
    __syncthreads();
  }
  const unsigned total = (unsigned)N * (unsigned)D;
  const unsigned step = gridDim.x * blockDim.x * UNROLL;
  for (unsigned base = blockIdx.x * blockDim.x * UNROLL + threadIdx.x;
       base < total; base += step) {
    // UNROLL independent elements per pass: their id loads are in flight
    // together instead of one dependent load per loop trip
    int s[UNROLL];
    unsigned d[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned i = base + u * blockDim.x;
      s[u] = -1;
      d[u] = 0;
      if (i < total) {
        unsigned n;
        split(i, N, D, dims_major, n, d[u]);
        s[u] = __ldg(idx + n);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned i = base + u * blockDim.x;
      if (i >= total) continue;
      T v = T(0);
      if (s[u] >= 0 && s[u] < S) {
        const unsigned k = (unsigned)s[u] * (unsigned)D + d[u];
        v = STAGE ? tab[k] : __ldg(table + k);
      }
      out[i] = v;
    }
  }
}

// PRIVATE: sum into the block's shared (S, Dt) accumulator and flush it
// into `out`; else add straight into out (Dt = D, one tile)
template <typename T, bool PRIVATE>
__global__ void __launch_bounds__(THREADS)
scatter_add_kernel(const T* __restrict__ values, const int* __restrict__ idx,
                   T* __restrict__ out, int N, int S, int D, int dims_major,
                   int Dt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = PRIVATE ? reinterpret_cast<T*>(smem_raw) : out;   // (S, ld)
  const int d0 = blockIdx.y * Dt;
  const int dt = min(Dt, D - d0);
  const int ld = PRIVATE ? dt : D;
  const int cells = S * dt;
  if (PRIVATE) {
    for (int j = threadIdx.x; j < cells; j += blockDim.x) acc[j] = T(0);
    __syncthreads();
  }
  const unsigned total = (unsigned)N * (unsigned)dt;
  const unsigned step = gridDim.x * blockDim.x * UNROLL;
  for (unsigned base = blockIdx.x * blockDim.x * UNROLL + threadIdx.x;
       base < total; base += step) {
    int s[UNROLL];
    unsigned c[UNROLL];
    T v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned e = base + u * blockDim.x;
      s[u] = -1;
      c[u] = 0;
      v[u] = T(0);
      if (e < total) {
        unsigned n;
        split(e, N, dt, dims_major, n, c[u]);
        s[u] = __ldg(idx + n);
        v[u] = __ldg(values + (dims_major
                                   ? (unsigned)(d0 + c[u]) * (unsigned)N + n
                                   : n * (unsigned)D + (unsigned)d0 + c[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)         // out-of-range rows dropped
      if (s[u] >= 0 && s[u] < S) atomicAdd(acc + s[u] * ld + c[u], v[u]);
  }
  if (!PRIVATE) return;
  __syncthreads();
  for (int j = threadIdx.x; j < cells; j += blockDim.x) {
    const T v = acc[j];
    if (v != T(0)) {
      const int s = j / dt;
      atomicAdd(out + s * D + d0 + (j - s * dt), v);
    }
  }
}

// the row-major segment sum for S*D <= ROWSUM_MAX_CELLS: per-warp sums in
// row order, per-block partials into `part` ((gridDim.x, S, D)), a grid
// barrier, then each cell summed over the blocks in a fixed order
template <typename T>
__global__ void __launch_bounds__(ROWSUM_THREADS, 1)
segment_sum_rows_kernel(const T* __restrict__ values,
                        const int* __restrict__ idx, T* __restrict__ out,
                        T* __restrict__ part, int N, int S, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* accs = reinterpret_cast<T*>(smem_raw);          // (ROWSUM_WARPS, S, D)
  const int cells = S * D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* acc = accs + warp * cells;
  for (int j = lane; j < cells; j += 32) acc[j] = T(0);
  __syncwarp();
  const int warps = gridDim.x * ROWSUM_WARPS;
  const int gw = blockIdx.x * ROWSUM_WARPS + warp;
  const long long per = ((long long)N + warps - 1) / warps;
  const long long n1 = min((long long)N, (gw + 1) * per);
  for (long long nb = gw * per; nb < n1; nb += ROWSUM_BATCH) {
    const int rows = (int)min((long long)ROWSUM_BATCH, n1 - nb);
    const int mine = lane < rows ? __ldg(idx + nb + lane) : -1;
    for (int c0 = 0; c0 < D; c0 += 32) {    // D <= 32: one pass
      const int c = c0 + lane;
      T v[ROWSUM_BATCH];                     // in flight beside the ids
#pragma unroll
      for (int u = 0; u < ROWSUM_BATCH; ++u)
        v[u] = u < rows && c < D ? __ldg(values + (nb + u) * D + c) : T(0);
#pragma unroll
      for (int u = 0; u < ROWSUM_BATCH; ++u) {
        // read every lane's cell (cell 0 for a dropped row) and store only
        // the kept ones: a predicated store, no branch per row
        const int s = __shfl_sync(0xffffffffu, mine, u);
        const bool keep = c < D && s >= 0 && s < S;   // out of range: dropped
        const int k = keep ? s * D + c : 0;
        const T a = acc[k];
        if (keep) acc[k] = a + v[u];
      }
    }
  }
  __syncthreads();
  T* mine_part = part + (size_t)blockIdx.x * cells;
  for (int j = threadIdx.x; j < cells; j += ROWSUM_THREADS) {
    T a = accs[j];
#pragma unroll
    for (int w = 1; w < ROWSUM_WARPS; ++w) a += accs[w * cells + j];
    mine_part[j] = a;
  }
  cooperative_groups::this_grid().sync();
  for (int j = gw; j < cells; j += warps) {
    T a = T(0);
#pragma unroll 4
    for (int b = lane; b < (int)gridDim.x; b += 32)
      a += __ldcg(part + (size_t)b * cells + j);   // from L2
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (lane == 0) out[j] = a;
  }
}

// raise `kernel`'s dynamic shared-memory limit to `bytes`, once per device
template <typename K>
int raise_smem(K kernel, int bytes, int dev, std::atomic<bool>* raised) {
  if (raised[dev].load(std::memory_order_relaxed)) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  raised[dev].store(true, std::memory_order_relaxed);
  return 0;
}

template <typename T>
int gather(const void* table, const void* idx, void* out, int N, int S,
           int D, int dims_major, void* stream) {
  int dev = 0, sms = 0;
  int err = device_sms(&dev, &sms);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const long long tbytes = (long long)S * D * (long long)sizeof(T);
  const long long rows_smem = GATHER_TILE_ROWS * sizeof(int) + tbytes;
  if (!dims_major && rows_smem <= STATIC_SMEM) {   // ids of a tile + table
    if (reinterpret_cast<uintptr_t>(out) & 15) return (int)cudaErrorInvalidValue;
    long long blocks = (N + GATHER_TILE_ROWS - 1) / GATHER_TILE_ROWS;
    if (blocks > 4LL * sms) blocks = 4LL * sms;
    if (blocks < 1) blocks = 1;
    gather_rows_kernel<T><<<(unsigned)blocks, GATHER_THREADS,
                            (size_t)rows_smem, st>>>(
        (const T*)table, (const int*)idx, (T*)out, N, S, D);
    return (int)cudaGetLastError();
  }
  const long long total = (long long)N * D;
  long long blocks = (total + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  if (blocks > 2LL * sms) blocks = 2LL * sms;
  if (blocks < 1) blocks = 1;
  if (tbytes <= STATIC_SMEM) {
    gather_kernel<T, true><<<(unsigned)blocks, THREADS, (size_t)tbytes, st>>>(
        (const T*)table, (const int*)idx, (T*)out, N, S, D, dims_major);
  } else {
    gather_kernel<T, false><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const T*)table, (const int*)idx, (T*)out, N, S, D, dims_major);
  }
  return (int)cudaGetLastError();
}

// the partials of the one-launch sum for eager calls: one scratch per
// (device, stream), room for one block per SM at ROWSUM_MAX_CELLS doubles,
// made at its first use and kept.  Launches on one stream run one after
// another and the kernel writes every partial before it reads it, so
// they can share it; a call captured in a CUDA graph allocates its own
int eager_scratch(int dev, int sms, cudaStream_t st, void** part) {
  static std::mutex mu;
  static std::map<std::pair<int, cudaStream_t>, void*> made;
  std::lock_guard<std::mutex> lock(mu);
  void*& p = made[{dev, st}];
  if (!p) {
    cudaError_t e = cudaMalloc(&p, (size_t)sms * ROWSUM_MAX_CELLS *
                                       sizeof(double));
    if (e != cudaSuccess) {
      p = nullptr;
      return (int)e;
    }
  }
  *part = p;
  return 0;
}

template <typename T>
int scatter_add(const void* values, const void* idx, void* out, int N, int S,
                int D, int dims_major, void* stream) {
  int dev = 0, sms = 0;
  int err = device_sms(&dev, &sms);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (!dims_major && (long long)S * D <= ROWSUM_MAX_CELLS) {
    // each warp about ROWSUM_BATCH rows, at most one block per SM: a
    // cooperative launch needs its blocks co-resident
    long long g = ((long long)N + ROWSUM_WARPS * ROWSUM_BATCH - 1) /
                  (ROWSUM_WARPS * ROWSUM_BATCH);
    if (g > sms) g = sms;
    if (g < 1) g = 1;
    const size_t smem = (size_t)ROWSUM_WARPS * S * D * sizeof(T);
    if (smem > (size_t)STATIC_SMEM) {
      static std::atomic<bool> raised[MAX_DEVICES];
      err = raise_smem(segment_sum_rows_kernel<T>, SCATTER_BUDGET, dev,
                       raised);
      if (err) return err;
    }
    cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
    cudaError_t e = cudaStreamIsCapturing(st, &capture);
    if (e != cudaSuccess) return (int)e;
    const bool captured = capture != cudaStreamCaptureStatusNone;
    void* part = nullptr;
    if (captured) {       // a graph memory node: each captured call its own
      e = cudaMallocAsync(&part, (size_t)g * S * D * sizeof(T), st);
      if (e != cudaSuccess) return (int)e;
    } else {
      err = eager_scratch(dev, sms, st, &part);
      if (err) return err;
    }
    const T* v = (const T*)values;
    const int* i = (const int*)idx;
    T* o = (T*)out;
    T* p = (T*)part;
    void* args[] = {&v, &i, &o, &p, &N, &S, &D};
    e = cudaLaunchCooperativeKernel((const void*)segment_sum_rows_kernel<T>,
                                    dim3((unsigned)g), dim3(ROWSUM_THREADS),
                                    args, smem, st);
    if (e != cudaSuccess) return (int)e;
    return captured ? (int)cudaFreeAsync(part, st) : 0;
  }
  const long long need1 =
      ((long long)N * D + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const long long col = (long long)S * (long long)sizeof(T);
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)S * D * sizeof(T), st);
  if (e != cudaSuccess) return (int)e;
  if (col > SCATTER_BUDGET) {              // one column does not fit: global
    const long long blocks = need1 < 2LL * sms ? need1 : 2LL * sms;
    scatter_add_kernel<T, false><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const T*)values, (const int*)idx, (T*)out, N, S, D, dims_major, D);
    return (int)cudaGetLastError();
  }
  const long long dt = SCATTER_BUDGET / col < D ? SCATTER_BUDGET / col : D;
  const int tiles = (int)((D + dt - 1) / dt);
  const size_t smem = (size_t)(col * dt);
  // each block sums at least ~4x the cells it zeroes and flushes, and the
  // tiles together fill about two blocks per SM
  long long gx = ((long long)N + 4LL * S - 1) / (4LL * S);
  const long long cap = (2LL * sms + tiles - 1) / tiles;
  if (gx > cap) gx = cap;
  const long long need =
      ((long long)N * dt + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  if (gx > need) gx = need;
  if (gx < 1) gx = 1;
  if (smem > (size_t)STATIC_SMEM) {
    static std::atomic<bool> raised[MAX_DEVICES];
    err = raise_smem(scatter_add_kernel<T, true>, SCATTER_BUDGET, dev,
                     raised);
    if (err) return err;
  }
  scatter_add_kernel<T, true><<<dim3((unsigned)gx, (unsigned)tiles), THREADS,
                                smem, st>>>(
      (const T*)values, (const int*)idx, (T*)out, N, S, D, dims_major,
      (int)dt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int g2o_gather_f32(const void* table, const void* idx, void* out, int N,
                   int S, int D, int dims_major, void* stream) {
  return gather<float>(table, idx, out, N, S, D, dims_major, stream);
}

int g2o_gather_f64(const void* table, const void* idx, void* out, int N,
                   int S, int D, int dims_major, void* stream) {
  return gather<double>(table, idx, out, N, S, D, dims_major, stream);
}

int g2o_scatter_add_f32(const void* values, const void* idx, void* out,
                        int N, int S, int D, int dims_major, void* stream) {
  return scatter_add<float>(values, idx, out, N, S, D, dims_major, stream);
}

int g2o_scatter_add_f64(const void* values, const void* idx, void* out,
                        int N, int S, int D, int dims_major, void* stream) {
  return scatter_add<double>(values, idx, out, N, S, D, dims_major, stream);
}

}  // extern "C"
