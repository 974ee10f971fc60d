// Segment sum for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of g2o_tpu/ops/pallas_kernels.py:
//   K4  segment_sum_mxu  (_kernel)  -> g2o_segment_sum_f32/_f64
//   out[s, :] = sum of values[i, :] over the rows i with seg[i] == s,
// for values (N, D) row-major, seg (N,) int32 and out (S, D).  Rows whose
// id lies outside [0, S) are dropped and empty segments stay zero, as in
// the Pallas kernel (whose one-hot columns match no such id).  Plain C
// entry points (no PyTorch headers), loaded with ctypes by
// g2o_tpu_torch/ops/segment_kernels.py.  The caller owns every buffer and
// passes `out` ZEROED; the kernel launches on the caller's stream, never
// synchronizes, and the entry returns cudaGetLastError().
//
// The TPU kernel turned the scatter into one-hot matrix products on the
// MXU (a TPU scatter serializes per update) and needed full-precision
// passes, since bf16 operands ruin a Hessian.  Hopper has atomics, and the
// sums here are plain float32/float64 adds: no tensor cores, no TF32.
//
// Design.  One warp walks a chunk of ROWS_PER_WARP consecutive rows; its
// lanes cover the columns in tiles of 32 (D = 81 on the Schur path: three
// tiles, the last one 17 wide), up to TILES tiles per pass over the chunk.
// Each lane keeps a running sum per tile in registers while the segment id
// stays the same and flushes it with one atomicAdd per (run, column) when
// the id changes (float64 atomicAdd is native on sm_90).  The ids of the
// chunk are loaded once, one per lane, and broadcast with __shfl_sync, so
// every branch on the id is warp-uniform.  The result is right for ids in
// any order; SchurSolver sorts its pairs by segment once on the host, so a
// warp flushes about once per segment it touches instead of once per row.
// Summation order varies with the atomics, so results differ from a
// sequential sum in the last bits.
//
// Bound: bandwidth.  The function reads N*D values and N ids and writes
// S*D values, about 58 MB on the ladybug Schur path (175,000 x 81 -> 2,401
// segments, float32) and 398 MB on the stress path (1,200,313 x 81 ->
// 14,400); it does N*D adds, far below the card's rate.  A warp reads 32
// neighbouring floats of a row per tile, so loads are coalesced but a
// 324-byte row is not 16-byte aligned; shared-memory staging and a
// deterministic CSR pass are later work.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;            // warps per block
constexpr int ROWS_PER_WARP = 32;   // consecutive rows per warp: one id per lane
constexpr int TILES = 4;            // 32-column tiles per pass: 128 columns
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ void flush(T* out, int seg, int S, int D, int c0,
                                      int lane, T (&acc)[TILES]) {
  if (seg >= 0 && seg < S) {
    T* row = out + (size_t)seg * D;
#pragma unroll
    for (int k = 0; k < TILES; ++k) {
      const int c = c0 + 32 * k + lane;
      if (c < D) atomicAdd(row + c, acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < TILES; ++k) acc[k] = T(0);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
segment_sum_kernel(const T* __restrict__ values, const int* __restrict__ seg,
                   T* __restrict__ out, long long N, int D, int S) {
  const int lane = threadIdx.x & 31;
  const long long r0 =
      ((long long)blockIdx.x * WARPS + (threadIdx.x >> 5)) * ROWS_PER_WARP;
  if (r0 >= N) return;                        // warp-uniform
  const int rows = (int)min((long long)ROWS_PER_WARP, N - r0);
  const int my_seg = lane < rows ? seg[r0 + lane] : -1;
  for (int c0 = 0; c0 < D; c0 += 32 * TILES) {
    T acc[TILES];
#pragma unroll
    for (int k = 0; k < TILES; ++k) acc[k] = T(0);
    int cur = -1;
    for (int i = 0; i < rows; ++i) {
      const int s = __shfl_sync(FULL, my_seg, i);
      if (s != cur) {
        flush(out, cur, S, D, c0, lane, acc);
        cur = s;
      }
      if (s >= 0 && s < S) {                  // out-of-range rows are dropped
        const T* row = values + (r0 + i) * D;
#pragma unroll
        for (int k = 0; k < TILES; ++k) {
          const int c = c0 + 32 * k + lane;
          if (c < D) acc[k] += row[c];
        }
      }
    }
    flush(out, cur, S, D, c0, lane, acc);
  }
}

template <typename T>
int launch(const void* values, const void* seg, void* out, long long N, int D,
           int S, void* stream) {
  const long long warps = (N + ROWS_PER_WARP - 1) / ROWS_PER_WARP;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<T><<<(unsigned)blocks, WARPS * 32, 0,
                          (cudaStream_t)stream>>>(
      (const T*)values, (const int*)seg, (T*)out, N, D, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int g2o_segment_sum_f32(const void* values, const void* seg, void* out,
                        long long N, int D, int S, void* stream) {
  return launch<float>(values, seg, out, N, D, S, stream);
}

int g2o_segment_sum_f64(const void* values, const void* seg, void* out,
                        long long N, int D, int S, void* stream) {
  return launch<double>(values, seg, out, N, D, S, stream);
}

}  // extern "C"
