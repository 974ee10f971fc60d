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
// The caller owns every buffer, passes the segment sum's `out` ZEROED and
// checks N*D, S*D < 2^31; the kernels launch on the caller's stream, never
// synchronize, and each entry returns the first CUDA error it meets.
//
// Both kernels walk their flat (row, column) elements in a grid-stride
// loop, four independent elements per thread per pass (a loop trip's id
// load no longer waits on the last trip's), so a warp's accesses to the
// per-row side are consecutive addresses in either layout.
//
// Gather.  One thread per output element; in the dims-major layout a
// warp's idx reads are consecutive too.  The (S, D)
// table is small on the solver's path (800 x 9 floats = 28.8 KB on the
// Venice file): a block stages it in shared memory when it fits the 48 KB
// of static shared memory, else it reads the table through __ldg.  Bound:
// bytes, N*D values written, N ids and S*D values read (about 36 MB at
// Venice, 9 x ~900k floats: 0.011 ms at 3.35 TB/s).
//
// Segment sum.  While one column of S values fits SCATTER_BUDGET (96 KB of
// shared memory, two blocks on one SM: S <= 24576 in float32, 12288 in
// float64), each block keeps a private (S, Dt) accumulator in shared
// memory, the counterpart of K9's VMEM-resident (S, D) accumulator; its
// threads stride over the (row, column) elements of its share of the rows
// and atomicAdd into shared memory; then the block flushes its nonzero
// partials with one global atomicAdd each.  D is tiled over blockIdx.y so
// that S*Dt values fit the budget (at Venice, 800 x 81 floats = 259 KB do
// not fit one block: Dt = 30, three tiles); above 48 KB the kernel's
// dynamic shared-memory limit is raised once per device.  Blocks per tile
// are chosen so each block sums at least about four times as many elements
// as it flushes.  A wider S adds each element straight from registers into
// `out` with a global atomicAdd: ids spread over that many segments rarely
// collide, and the kernel serves every S.  Bound: bytes, N*D values and N
// ids read, S*D values written (36 MB for 9 x ~900k -> 800 x 9 floats,
// 295 MB for 81 x ~900k -> 800 x 81).  Summation order varies with the
// atomics, so results differ from a sequential sum in the last bits.

#include <cuda_runtime.h>

#include <atomic>

#include "device_sms.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int STATIC_SMEM = 48 * 1024;          // without an opt-in
constexpr int SCATTER_BUDGET = 96 * 1024;       // two blocks on one SM
constexpr int UNROLL = 4;                       // elements per thread per pass

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

// PRIVATE: sum into the block's shared (S, Dt) accumulator and flush it;
// else add straight into out (Dt = D, one tile)
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

template <typename T>
int gather(const void* table, const void* idx, void* out, int N, int S,
           int D, int dims_major, void* stream) {
  int dev = 0, sms = 0;
  int err = device_sms(&dev, &sms);
  if (err) return err;
  const long long total = (long long)N * D;
  long long blocks = (total + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  if (blocks > 2LL * sms) blocks = 2LL * sms;
  if (blocks < 1) blocks = 1;
  const long long tbytes = (long long)S * D * (long long)sizeof(T);
  cudaStream_t st = (cudaStream_t)stream;
  if (tbytes <= STATIC_SMEM) {
    gather_kernel<T, true><<<(unsigned)blocks, THREADS, (size_t)tbytes, st>>>(
        (const T*)table, (const int*)idx, (T*)out, N, S, D, dims_major);
  } else {
    gather_kernel<T, false><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const T*)table, (const int*)idx, (T*)out, N, S, D, dims_major);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int scatter_add(const void* values, const void* idx, void* out, int N, int S,
                int D, int dims_major, void* stream) {
  int dev = 0, sms = 0;
  int err = device_sms(&dev, &sms);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  const long long need1 =
      ((long long)N * D + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  const long long col = (long long)S * (long long)sizeof(T);
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
    // raise this instantiation's dynamic shared-memory limit once per device
    static std::atomic<bool> raised[MAX_DEVICES];
    if (!raised[dev].load(std::memory_order_relaxed)) {
      cudaError_t e = cudaFuncSetAttribute(
          scatter_add_kernel<T, true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, SCATTER_BUDGET);
      if (e != cudaSuccess) return (int)e;
      raised[dev].store(true, std::memory_order_relaxed);
    }
  }
  dim3 grid((unsigned)gx, (unsigned)tiles);
  scatter_add_kernel<T, true><<<grid, THREADS, smem, st>>>(
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
