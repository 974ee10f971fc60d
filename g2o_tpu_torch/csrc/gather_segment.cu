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
// past its one-launch branches (row-major with S*D past ROWSUM_MAX_CELLS,
// dims-major with S*D past SEGT_MAX_CELLS or S past SEGT_COUNTS), which is
// a memset of `out` and a kernel.  At BAL Final's 13,682 cameras (S past
// SEGT_COUNTS) every dims-major camera sum of the implicit Schur path takes
// that branch, and a call moves up to a few GB.
//
// Gather.  Row-major with a table of at most ~46 KB (K7 on the path): a
// block stages the (S, D) table in shared memory, then walks tiles of
// GATHER_TILE_ROWS rows: it reads each row's id once into shared memory (as
// a table offset, -1 for an id out of range), then writes the tile's flat
// slice of `out` as 16-byte stores (`out` must be 16-byte aligned, and a
// tile is 2 KB of rows times D), scalar stores at its ragged end.  A wider
// table (no path): one thread per output element in a grid-stride loop,
// four elements per thread per pass, the table staged while it fits 48 KB,
// else read through __ldg.
//
// Gather, dims-major (K5/K10 on the three dims-major implicit paths: (S,
// 9) -> (9, N) with S = 49, 120, 800 and N = 35000, 198088, 900000):
// gather_t_kernel.  Bound: bytes, N*D values written, N ids and S*D values
// read (36 MB at Venice: 10.75 us at 3.35 TB/s; 8.0 MB at stress, 2.37 us;
// 1.4 MB at ladybug, 0.42 us).  A thread owns V = 16 / sizeof(T)
// consecutive edges (4 in f32): it reads their ids once, in one vector
// load, and for each row d stores the V values as one 16-byte store, so
// each id is read once, no thread divides, and a warp writes 512
// contiguous bytes of a row per store.  Each thread loads its next ids
// before its stores.  The table is staged in shared memory once per block
// (up to GATHER_T_STAGE_MAX), GATHER_T_STAGE_LOADS loads in flight per
// thread while the first ids are in flight too; past that it is read
// through __ldg.  Blocks of 1024 threads, halved down to 64 while the
// items fill fewer than half as many blocks as there are SMs, as many
// blocks as fit at once.  A ragged N (N % V != 0) or idx / out off 16
// bytes takes the same kernel with one thread per edge (the id read once,
// a warp's stores to a row consecutive).  Measured (device us per call,
// f32, scripts/gather_t_probe.py and scripts/onehot_ab.py against the
// parent's kernel in one process; H100 80GB HBM3, 700.00 W): ladybug /
// stress / Venice 1.77 / 3.66 / 12.67 (parent: one thread per output
// element, 1024-thread blocks, 2.44 / 6.01 / 20.28); Venice reaches 85% of
// its bound, the two small shapes pay the launch (~1.2 us) and the first
// ids' latency.  Tried there: the table read through L1 (__ldg) with no
// staging barrier 2.21 / 4.14 / 15.93 (a warp's 32 random reads touch ~30
// lines); the staging one load at a time 2.07 / 3.81 / 14.49; fixed blocks
// of 1024 threads 4.14 / 4.81 / 13.19 and of 128 1.84 / 3.71 / 15.89; one
// thread per edge everywhere 1.89 / 4.55 / 12.61; the next ids loaded after
// the stores, or one block per SM walking several groups, within noise.
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

// Segment sum, dims-major with S*D <= SEGT_MAX_CELLS and S <= SEGT_COUNTS
// (K6/K9 on the three dims-major implicit paths: (9 or 81, N) -> (S, 9 or
// 81) with N = 35000, 198088, 900000 and S = 49, 120, 800): K8's
// properties in this layout, one cooperative launch, no memset, no global
// atomics, the same bits on every run.  What bounded the parent's memset +
// atomics kernel there (scripts/rowsum_probe.py --dims-major; device us,
// H100 80GB HBM3, 700 W): the per-value shared atomicAdds, whose lanes
// collide on the few segment ids of a column (3.3, 15.2, 19.0, 64.1, 12.0,
// 140.9 us of 7.2, 28.5, 27.7, 105.5, 36.0, 317.0 at ladybug, stress,
// Venice, D = 9 then 81), then the elementwise loop (an id reread and a
// division per value); the global flush took 0.2-7.7 and the memset ~1.1.
// Designs that kept lane = row and resolved the collisions inside a warp
// (__match_any_sync groups summed by shuffles into K shared accumulator
// copies, columns split among warps) stayed at 1.5 TB/s on the values and
// paid bank-conflicted adds at Venice's 800 ids (312 us at D = 81; with
// shared atomic adds 1118).  Two row phases instead, in one kernel:
//   * by column, where SEGT_WARPS copies of the (S, D) accumulator fit
//     SEGT_COLUMN_BUDGET (ladybug and stress D = 9): K8's scheme in this
//     layout.  Each warp has its own copy and its own run of 32-row
//     batches, lane = column; a batch's ids are read once and broadcast by
//     shuffles, each lane's 32 values are one 128-byte run, and the adds
//     go in row order with no two lanes on one cell.  The copies are then
//     summed in warp order;
//   * else by sorted rows, with no accumulator.  Block r takes the r-th run
//     of rows (one block per SEGT_PER_BLOCK values, at most one per SM),
//     in chunks of at most SEGT_CHUNK_BYTES of one column.  It sorts a
//     chunk's rows by id, stably: the ids are read once, all loads issued
//     at once, into shared memory (read inside the warps' sequential walk,
//     each 32 rows cost a round trip); warps count their slices' ids
//     (integer adds), a scan gives each segment's start and each warp's
//     offset in it, and the warps place their rows in row order (a warp's
//     lanes with one id ranked after __match_any_sync).  Rows with an id
//     outside [0, S) are left out.  The counters take SEGT_COUNTS ints, so
//     S <= SEGT_COUNTS.  Meanwhile the chunk's values stream into shared
//     memory, Cs columns a stage (at least SEGT_STAGE bytes), by cp.async,
//     16 bytes where rows are aligned, through a ring of 2-4 stages
//     (SEGT_RING), all but one in flight while one is summed (with one in
//     flight the pass over Venice's 291 MB ran at 0.9 TB/s).  A thread per
//     (segment, column) of a stage adds the segment's rows of the column in
//     sorted (row) order, four loads ahead of the adds, from its partial of
//     the run's earlier chunks, and stores the run's partial part[r][d][s]:
//     column by column, so consecutive threads store consecutive cells
//     (row by row, 81 floats apart, each store cost a sector and held the
//     Venice D = 81 call at ~360 us).  No atomics, no two threads on one
//     cell, no D-tiling (nothing of S x D is kept in shared memory), and
//     one read of each id and each value.
// After the grid barrier L lanes per cell (as many as the grid has threads
// for, a power of two up to 32) sum the runs' partials in a fixed order,
// eight loads ahead of the adds, and a fixed shuffle tree adds the lanes.
// The partials are runs x S*D values: at Venice D = 81, 132 x 64800
// floats, 34 MB written and read once more beside the 291 MB of values
// (most of it stays in the 50 MB L2); SEGT_MAX_CELLS = 65536 caps the
// scratch (the Venice D = 81 shape has 64800 cells).  Measured (device us
// per call, scripts/onehot_ab.py against the parent's memset + atomics
// kernel in one process, H100 80GB HBM3, 700 W): ladybug D = 9 / 81 6.47 /
// 19.69 (parent 7.25 / 28.55), stress 12.16 / 76.59 (28.00 / 106.25),
// Venice 45.05 / 270.28 (36.64 / 318.58).  Venice stays far above its
// bound (10.8 / 88.2 us): by scripts/rowsum_probe.py --dims-major the
// sums' gathers through perm (bank conflicts at 800 ids, two rounds of
// 512 threads over 800 segments) take ~126 us at D = 81 and ~15 at D = 9,
// the copies ~56 / ~7 where the sums do not hide them, and the sort and
// fixed costs ~30 at D = 9.  Copying each value straight to its sorted
// place (4-byte cp.async) instead cost more: 317 us at D = 81.  Also
// measured (scripts/rowsum_probe.py --dims-major, same card): by column
// with as many copies as fit 224 KB (7 at Venice D = 9, 5 at stress D = 81,
// 14 at ladybug D = 81) and the next batch in flight while one is added,
// 59.9, 60.2 and 16.4 us against the sorted phase's 45.7, 76.8 and 19.7:
// a loss at Venice, where each warp's chain of dependent shared
// read-add-stores is ~1000 rows long, a gain at D = 81 left for later; the
// sorted sums cut into equal pieces of positions, a thread per (column,
// piece), so that no thread waits on a long segment: 59.5 / 400.1 us at
// Venice D = 9 / 81 against 45.1 / 269.1; the ids loaded all at once: 44.8
// against 45.7, no gain.  The sorted phase at ladybug / stress D = 9 took
// 8.86 / 16.88 us against the by-column phase's 6.41 / 12.06.
// The scratch follows K8's rule: eager calls on one stream share one that
// the library keeps per (device, stream) and grows to the largest call in
// stream order; a call captured in a CUDA graph allocates its own
// (cudaMallocAsync / cudaFreeAsync, graph memory nodes).
//
// Segment sum, otherwise (row-major past ROWSUM_MAX_CELLS, dims-major past
// SEGT_MAX_CELLS or SEGT_COUNTS: the dims-major camera sums of a BAL problem
// with more than 8192 cameras, such as Final-13682's linearization,
// preconditioner, reduced right-hand side and back-substitution, and the
// row-major ones of the sba paths' wider blocks): the threads walk the
// flat (row, column) elements of the per-row side in a grid-stride loop,
// four per thread per pass, so a warp's loads are consecutive addresses in
// either layout.  While one
// column of S values fits SCATTER_BUDGET (96 KB of shared memory, two
// blocks on one SM: S <= 24576 in float32, 12288 in float64), each block
// keeps a private (S, Dt) accumulator in shared memory, the counterpart of
// K9's VMEM-resident (S, D) accumulator; its threads atomicAdd into shared
// memory, then the block flushes its nonzero partials with one global
// atomicAdd each into `out`, zeroed by a memset on the caller's stream
// first.  D is tiled over blockIdx.y so that S*Dt values fit the budget;
// above 48 KB the kernel's dynamic shared-memory limit is raised once per
// device.  Blocks per tile are chosen so each block sums at least about
// four times as many elements as it flushes.  A wider S adds each element
// straight from registers into `out` with a global atomicAdd: ids spread
// over that many segments rarely collide, and the kernel serves every S.
// Bound: bytes, N*D values and N ids read, S*D values written.  Summation
// order varies with the atomics, so results differ from a sequential sum
// in the last bits.
//
// Schur rows (g2o_schur_rows_*; the dims-major implicit Schur solver's S·v,
// once per CG iteration): out[c] = sum over the rows of camera c of B_row
// s_k, where k is the row's landmark, s_k = Dinv_k t_k and t_k = sum over the
// rows j of k of B_jᵀ v[ids[j]].  B is (DP, DL, N) dims-major in slab order
// (bucket b: count[b] landmarks x degree[b] rows, degree-major, so row j of
// landmark k is row0[b] + j*count[b] + k), Dinv (DL, DL, S_used) in bucket
// order, v and out (C, DP).  It replaces no Pallas kernel: the JAX package
// leaves this product to XLA as slab reshapes and sums.  It fuses K5's
// gather, the PyTorch products around it (Bᵀu, the slab sums, Dinv, the slab
// broadcast, B s) and K6's segment sum, which wrote a (DP, N) gather, two
// (DP, DL, N) products and their (DL, N) and (DP, N) reductions to device
// memory in ~35 launches.  Bound: bytes, B read once (DP*DL values a row:
// 540 MB over the 5.0M observations of the benchmark's Venice configuration
// in float32, 585 MB with the slab layout's padding rows) beside the ids and
// Dinv; nothing of size N is written.  Design: a block of 256 threads is L
// landmarks x R row slots, R the degree rounded up to a power of two (at most
// 8, so L >= 32 and a warp's lanes are 32 neighbouring landmarks: each load
// of B is one coalesced run); slot r takes rows r, r + R, ... of its
// landmark, keeps the first row's B and id in registers, reads v[id] through
// L1 (B streams past it, evict-first) and adds Bᵀu in row order; slot 0 loads
// Dinv_k beside its first row.  The slots' sums meet in shared memory, where
// slot 0 adds them in slot order and applies Dinv_k.  Then, a round per row
// of a slot (the first from registers, any later one, past R, read again from
// L1 or L2), each thread stages B s and its camera in shared memory, and each
// warp adds the staged rows of its own cameras (id % 8), in row order, into
// the block's (C, DP) sums in shared memory, its lane groups (32 / DP of DP
// lanes) on disjoint cameras side by side.  After the tiles (blocks walk the
// tiles of all buckets, as many blocks as the SMs hold at once) each block
// stores its sums as a partial; after a grid barrier (a cooperative launch)
// each cell is summed over the blocks in a fixed order, as K6 does.  No
// atomics, so a call gives the same bits every time; the partials' scratch
// follows K6's rule.  The block's sums bound C: C*DP values and the buffers
// within SROWS_SMEM (C <= 5915 at DP = 9 in float32, 2743 in float64).
// Measured (device us per call, float32, chip_smoke.py's [schur_rows] rows
// and variants built side by side; H100 80GB HBM3, 700 W): at the Venice
// configuration (9x3x5414584 -> 1778) 506, against 2490 for the composition
// it replaces (K5, 22 PyTorch operations, K6) and a bound of 178 over the
// observations (192 with the padding rows); at
// chip_smoke.py's C800 Venice file 94 against 388.  Tried there: the first
// design, which wrote B s per row (195 MB) for K6 to sum, 438 + 352 for K6;
// the camera adds one row at a time per warp with B read through L1, 632;
// with the lane groups and B streamed but Dinv loaded after the barrier, 540;
// blocks of 512 threads 519-529, of 128 856.  What holds it at 35% of its
// bound is not measured: each block runs its phases in turn (loads, two
// barriers, the camera adds), and the (C, DP) sums' 64 KB leave room for two
// blocks on an SM.
// The tiled form (g2o_schur_rows_tiled_*, past C*DP in SROWS_SMEM: BAL
// Final-13682's 13,682 cameras need 508,972 bytes): the camera sums leave
// shared memory, and the sums keep a fixed order without atomics.  One
// cooperative launch of schur_rows_tiled_kernel, in two phases.  First the
// landmark tiles as above, with no round buffers: each thread stores each
// of its rows' B s (srows_ld values, DP padded to whole 16-byte stores) at
// the row's own place, into the caller's scratch (a warp's stores are one
// contiguous run).  order lists the rows sorted by camera, stably
// (ops/onehot.py's schur_rows_order, made once per problem), so camera c's
// rows are order[starts[c]] to order[starts[c+1] - 1], in slab order.
// After a grid barrier the blocks take the cameras in turn and sum each
// camera's rows, gathered through order, in a fixed order (the loop's note
// says how).  Bound: bytes, B read once as above; beyond it the per-row B s
// are written once and gathered once (48 bytes a row each way beside B's
// 108 at DP = 9 in float32).  Nothing is kept between calls, so a call
// gives the same bits every time.  Measured at Final's size (float32,
// scripts/schur_rows_tiled_probe.py --split; H100 80GB HBM3, 700 W): 4.42
// ms a call, of which the tiles without stores 1.91, their stores ~1.1 and
// the gathered sums ~1.4; the first design, each row's B s stored at its
// place in camera order and the runs read contiguously, took 6.55 (its
// scattered 48-byte stores ~4.1).
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

constexpr int GATHER_T_THREADS = 1024;          // the dims-major gather's
constexpr int GATHER_T_MIN_THREADS = 64;        // largest and least block
constexpr int GATHER_T_SM_THREADS = 2048;       // an SM's resident threads
constexpr int GATHER_T_SM_SMEM = 228 * 1024;    // an SM's shared memory
constexpr int GATHER_T_STAGE_MAX = 96 * 1024;   // the largest staged table
constexpr int GATHER_T_STAGE_LOADS = 8;         // its loads in flight per thread

constexpr int ROWSUM_THREADS = 512;             // one block per SM
constexpr int ROWSUM_WARPS = ROWSUM_THREADS / 32;
constexpr int ROWSUM_BATCH = 32;                // rows in flight per warp (<= 32)
// the most cells of the row-major one-launch sum: sixteen warps' float64
// accumulators fill SCATTER_BUDGET (onehot.py's ROWSUM_MAX_CELLS)
constexpr int ROWSUM_MAX_CELLS = 768;

constexpr int SEGT_THREADS = 512;               // dims-major one-launch sum
constexpr int SEGT_WARPS = SEGT_THREADS / 32;   // (one block per SM)
constexpr int SEGT_CHUNK_BYTES = 32 * 1024;     // a chunk's rows of one column
constexpr int SEGT_STAGE = 24 * 1024;           // a stage of columns, at least one
constexpr int SEGT_RING = 112 * 1024;           // the stages' ring (2 to 4 of them)
constexpr int SEGT_COUNTS = 8192;               // the sort's per-warp counters
constexpr int SEGT_SMEM = 224 * 1024;           // its shared-memory limit
constexpr int SEGT_COLUMN_BUDGET = 176 * 1024;  // the by-column copies
constexpr int SEGT_PER_BLOCK = 4096;            // values per block, at least
// the most cells (S*D) of the dims-major one-launch sum: the partials'
// scratch is blocks x S*D values
constexpr int SEGT_MAX_CELLS = 65536;
// the sorted phase fits SEGT_SMEM with two stages of the widest chunk (a
// stage is at most SEGT_CHUNK_BYTES) beside the most ids, order, counters
// and segment starts (S = SEGT_COUNTS)
static_assert(2 * SEGT_CHUNK_BYTES +
                  (2 * (SEGT_CHUNK_BYTES / 4) + 2 * SEGT_COUNTS + 1) * 4 <= SEGT_SMEM,
              "the sorted phase's shared memory");

constexpr int SROWS_LG_THREADS = 8;             // the Schur rows' blocks:
constexpr int SROWS_THREADS = 1 << SROWS_LG_THREADS;   // landmarks x row slots
constexpr int SROWS_LG_WARPS = SROWS_LG_THREADS - 5;
constexpr int SROWS_WARPS = 1 << SROWS_LG_WARPS;
constexpr int SROWS_WLD = SROWS_THREADS + 1;    // a round's rows: the columns
                                                // of one row on distinct banks
constexpr int SROWS_LG_MAX_SLOTS = 3;           // at most 8 row slots, so a
                                                // warp takes 32 landmarks
constexpr int SROWS_MAX_BUCKETS = 16;
constexpr int SROWS_SMEM = 224 * 1024;          // its shared-memory limit
// the tiled form's rows of B s: DP values padded to whole 16-byte stores
template <typename T>
__host__ __device__ constexpr int srows_ld(int dp) {
  return (dp + 16 / (int)sizeof(T) - 1) / (16 / (int)sizeof(T)) *
         (16 / (int)sizeof(T));
}

// one 16-byte store of 16 / sizeof(T) values
__device__ __forceinline__ void store16(float* p, const float* s) {
  *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
}
__device__ __forceinline__ void store16(double* p, const double* s) {
  *reinterpret_cast<double2*>(p) = make_double2(s[0], s[1]);
}

// 16 / sizeof(T) values in one read-only 16-byte load
__device__ __forceinline__ void ldg16(const float* p, float* v) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ldg16(const double* p, double* v) {
  const double2 t = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = t.x; v[1] = t.y;
}

// 16 / sizeof(T) values in one 16-byte load through L2 (data written earlier
// in the same launch)
__device__ __forceinline__ void ldcg16(const float* p, float* v) {
  const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ldcg16(const double* p, double* v) {
  const double2 t = __ldcg(reinterpret_cast<const double2*>(p));
  v[0] = t.x; v[1] = t.y;
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
// dims-major gather
// ------------------------------------------------------------------------ //

// the ids of V consecutive edges in one load (16 bytes in f32, 8 in f64)
__device__ __forceinline__ void ldg_ids(const int* p, int (&s)[4]) {
  const int4 t = __ldg(reinterpret_cast<const int4*>(p));
  s[0] = t.x; s[1] = t.y; s[2] = t.z; s[3] = t.w;
}
__device__ __forceinline__ void ldg_ids(const int* p, int (&s)[2]) {
  const int2 t = __ldg(reinterpret_cast<const int2*>(p));
  s[0] = t.x; s[1] = t.y;
}

// out (D, N): out[d][n] = table[idx[n]][d], zero for an id outside [0, S).
// vec: a thread owns groups of V = 16 / sizeof(T) consecutive edges (N % V
// == 0, idx and out 16-byte aligned): their ids in one load, then for each
// row d the V values in one 16-byte store, so a warp writes 512 bytes of a
// row per store.  Else one thread per edge, its id read once, and a warp's
// stores to a row are consecutive.  Each thread's next ids are loaded
// before its stores.  STAGE: the table staged in shared memory once per
// block (the first ids in flight meanwhile), else read through __ldg.
template <typename T, bool STAGE>
__global__ void __launch_bounds__(GATHER_T_THREADS)
gather_t_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                T* __restrict__ out, int N, int S, int D, int vec) {
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* staged = reinterpret_cast<T*>(smem_raw);
  const unsigned items = vec ? N / V : N;   // groups of V edges, or edges
  const unsigned stride = gridDim.x * blockDim.x;
  unsigned it = blockIdx.x * blockDim.x + threadIdx.x;
  int s[V] = {};
  auto load = [&](unsigned i) {
    if (i >= items) return;
    if (vec) {
      ldg_ids(idx + (size_t)i * V, s);
    } else {
      s[0] = __ldg(idx + i);
    }
  };
  auto value = [&](int k) { return STAGE ? staged[k] : __ldg(table + k); };
  load(it);
  if (STAGE) {   // GATHER_T_STAGE_LOADS loads in flight per thread
    const int cells = S * D;
    for (int j0 = threadIdx.x; j0 < cells; j0 += GATHER_T_STAGE_LOADS * blockDim.x) {
      T t[GATHER_T_STAGE_LOADS];
#pragma unroll
      for (int u = 0; u < GATHER_T_STAGE_LOADS; ++u) {
        const int j = j0 + u * blockDim.x;
        t[u] = j < cells ? __ldg(table + j) : T(0);
      }
#pragma unroll
      for (int u = 0; u < GATHER_T_STAGE_LOADS; ++u) {
        const int j = j0 + u * blockDim.x;
        if (j < cells) staged[j] = t[u];
      }
    }
    __syncthreads();
  }
  for (; it < items; it += stride) {
    int off[V];
#pragma unroll
    for (int u = 0; u < V; ++u) off[u] = s[u] >= 0 && s[u] < S ? s[u] * D : -1;
    load(it + stride);                        // the next ids, before the stores
    if (vec) {
      T* o = out + (size_t)it * V;
#pragma unroll 9
      for (int d = 0; d < D; ++d) {
        T v[V];
#pragma unroll
        for (int u = 0; u < V; ++u) v[u] = off[u] >= 0 ? value(off[u] + d) : T(0);
        store16(o + (size_t)d * N, v);
      }
    } else {
      T* o = out + it;
#pragma unroll 9
      for (int d = 0; d < D; ++d) o[(size_t)d * N] = off[0] >= 0 ? value(off[0] + d) : T(0);
    }
  }
}

// ------------------------------------------------------------------------ //
// grid kernels
// ------------------------------------------------------------------------ //

// the row-major gather with a table past the small-table kernel's shared
// memory (no path): one thread per output element
template <typename T, bool STAGE>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const T* __restrict__ table, const int* __restrict__ idx,
              T* __restrict__ out, int N, int S, int D) {
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
        split(i, N, D, 0, n, d[u]);
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

// asynchronous copies global -> shared (cp.async): 16 bytes through L2
// only, or one 4- or 8-byte value; their commit, and the wait until at
// most N groups of this thread's are in flight
__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)), "l"(g) : "memory");
}
template <typename T>
__device__ __forceinline__ void cp_async1(T* s, const T* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)), "l"(g), "n"(sizeof(T))
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but(int n) {   // n <= 3
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
  }
}

// the dims-major one-launch sum by column, where SEGT_WARPS copies of the
// (S, D) accumulator fit SEGT_COLUMN_BUDGET (the narrow path shapes): each
// warp its own copy and its own run of the block's 32-row batches, lane =
// column; a batch's ids are read once (a lane each) and broadcast by
// shuffles, each lane loads its column's 32 values (one 128-byte run) and
// adds them row by row into its cells, so no two lanes touch one cell and
// every cell is updated in row order.  The copies are then summed in warp
// order into the block's partial part[r][d][s].
template <typename T>
__device__ void segment_sum_t_by_column(const T* __restrict__ values,
                                        const int* __restrict__ idx,
                                        T* __restrict__ part, int N, int S,
                                        int D, T* accs) {
  constexpr int V = 16 / (int)sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cells = S * D;
  for (int e = threadIdx.x; e < SEGT_WARPS * cells; e += SEGT_THREADS) accs[e] = T(0);
  __syncthreads();
  T* acc = accs + warp * cells;
  const bool vec = N % V == 0 && (reinterpret_cast<uintptr_t>(values) & 15) == 0;
  const long long nb = ((long long)N + 31) / 32;
  const long long b0 = nb * blockIdx.x / gridDim.x, b1 = nb * (blockIdx.x + 1) / gridDim.x;
  const long long w1 = b0 + (b1 - b0) * (warp + 1) / SEGT_WARPS;
  for (long long bb = b0 + (b1 - b0) * warp / SEGT_WARPS; bb < w1; ++bb) {
    const long long n0 = bb * 32;
    const int rows = (int)min(32LL, (long long)N - n0);
    const int mine = lane < rows ? __ldg(idx + n0 + lane) : -1;
    for (int c0 = 0; c0 < D; c0 += 32) {
      const int c = c0 + lane;
      const T* src = values + (size_t)c * N + n0;
      T v[32];
      if (c < D && rows == 32 && vec) {
#pragma unroll
        for (int u = 0; u < 32; u += V) ldg16(src + u, v + u);
      } else {
#pragma unroll
        for (int u = 0; u < 32; ++u) v[u] = c < D && u < rows ? __ldg(src + u) : T(0);
      }
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        // read every lane's cell (cell 0 for a dropped row) and store only
        // the kept ones: a predicated store, no branch per row
        const int sg = __shfl_sync(0xffffffffu, mine, u);
        const bool keep = c < D && sg >= 0 && sg < S;   // out of range: dropped
        const int cell = keep ? sg * D + c : 0;
        const T a = acc[cell];
        if (keep) acc[cell] = a + v[u];
      }
    }
  }
  __syncthreads();
  T* mine_part = part + blockIdx.x * (size_t)cells;
  for (int e = threadIdx.x; e < cells; e += SEGT_THREADS) {   // e = d*S + s
    const int d = e / S, sg = e - d * S;
    T a = accs[sg * D + d];
    for (int w = 1; w < SEGT_WARPS; ++w) a += accs[w * cells + sg * D + d];
    mine_part[e] = a;
  }
}

// the dims-major one-launch sum by sorted rows (the header says how): each
// chunk's rows sorted by id once (perm: the chunk's rows segment by
// segment, in row order), its values streamed through the stage ring, a
// thread per (segment, column) of a stage adding in perm's order
template <typename T>
__device__ void segment_sum_t_sorted(const T* __restrict__ values,
                                     const int* __restrict__ idx,
                                     T* __restrict__ part, int N, int S, int D,
                                     int ld, int Cs, int nbuf, int Ws,
                                     unsigned char* smem_raw) {
  constexpr int V = 16 / (int)sizeof(T);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t cells = (size_t)S * D;
  T* stage = reinterpret_cast<T*>(smem_raw);              // nbuf x (Cs, ld)
  int* perm = reinterpret_cast<int*>(stage + (size_t)nbuf * Cs * ld);   // ld
  int* ids = perm + ld;                                   // ld
  int* cnt = ids + ld;                                    // (Ws, S)
  int* start = cnt + Ws * S;                              // S + 1
  __shared__ int wsum[SEGT_WARPS];
  const long long nb = ((long long)N + 31) / 32;
  const long long r0 = nb * blockIdx.x / gridDim.x * 32;
  const long long r1 = min((long long)N, nb * (blockIdx.x + 1) / gridDim.x * 32);
  T* mine = part + blockIdx.x * cells;
  const int stages = (D + Cs - 1) / Cs;
  const bool vec = N % V == 0 && (reinterpret_cast<uintptr_t>(values) & 15) == 0;
  bool first = true;
  for (long long c0 = r0; c0 < r1; c0 += ld) {
    const int rows = (int)min((long long)ld, r1 - c0);
    // columns st*Cs .. of the chunk's rows into stage buffer st % nbuf (a
    // group of copies, empty past the last stage)
    auto issue = [&](int st) {
      T* buf = stage + (size_t)(st % nbuf) * Cs * ld;
      const int cols = st < stages ? min(Cs, D - st * Cs) : 0;
      const int nv = vec ? rows / V : 0;
      const int tail = rows - nv * V;
      for (int e = tid; e < cols * nv; e += SEGT_THREADS) {
        const int cl = e / nv, q = e - cl * nv;
        cp_async16(buf + (size_t)cl * ld + q * V,
                   values + (size_t)(st * Cs + cl) * N + c0 + q * V);
      }
      for (int e = tid; e < cols * tail; e += SEGT_THREADS) {
        const int cl = e / tail, q = nv * V + e - cl * tail;
        cp_async1(buf + (size_t)cl * ld + q, values + (size_t)(st * Cs + cl) * N + c0 + q);
      }
      cp_async_commit();
    };
    for (int st = 0; st + 1 < nbuf; ++st) issue(st);
    // the chunk's ids, read once, -1 for an id outside [0, S) (dropped)
    for (int n = tid; n < rows; n += SEGT_THREADS) {
      const int id = __ldg(idx + c0 + n);
      ids[n] = id >= 0 && id < S ? id : -1;
    }
    for (int e = tid; e < Ws * S; e += SEGT_THREADS) cnt[e] = 0;
    __syncthreads();
    // count: warp w < Ws over its slice [lo, hi) of the chunk
    const int lo = rows * warp / Ws, hi = rows * (warp + 1) / Ws;
    int* mycnt = cnt + warp * S;
    if (warp < Ws) {                              // integer counts: any order
#pragma unroll 4
      for (int n = lo + lane; n < hi; n += 32) {
        const int id = ids[n];
        if (id >= 0) atomicAdd(mycnt + id, 1);
      }
    }
    __syncthreads();
    // start[s]: the rows of segments before s; cnt[w][s]: warp w's first
    // place in segment s (thread t scans segments t*per .. t*per + per - 1)
    const int per = (S + SEGT_THREADS - 1) / SEGT_THREADS;
    const int s0 = min(S, tid * per), s1 = min(S, s0 + per);
    int mine_rows = 0;
    for (int sg = s0; sg < s1; ++sg)
      for (int w = 0; w < Ws; ++w) mine_rows += cnt[w * S + sg];
    int incl = mine_rows;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    int run = incl - mine_rows;
    for (int w = 0; w < warp; ++w) run += wsum[w];
    for (int sg = s0; sg < s1; ++sg) {
      start[sg] = run;
      for (int w = 0; w < Ws; ++w) {
        const int c = cnt[w * S + sg];
        cnt[w * S + sg] = run;
        run += c;
      }
    }
    if (tid == 0) {
      int total = 0;
      for (int w = 0; w < SEGT_WARPS; ++w) total += wsum[w];
      start[S] = total;
    }
    __syncthreads();
    // place: each row at its segment's next place, in row order
    if (warp < Ws) {
      for (int b = lo; b < hi; b += 32) {
        const int n = b + lane;
        const int id = n < hi ? ids[n] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, id);
        const int base = id >= 0 ? mycnt[id] : 0;
        __syncwarp();
        if (id >= 0) {
          perm[base + __popc(peers & ((1u << lane) - 1u))] = n;
          if (__ffs(peers) - 1 == lane) mycnt[id] = base + __popc(peers);
        }
        __syncwarp();
      }
    }
    // sum the stages: thread per (segment, column) pair
    for (int st = 0; st < stages; ++st) {
      issue(st + nbuf - 1);                       // into the buffer freed last
      cp_async_wait_all_but(nbuf - 1);            // stage st has landed
      __syncthreads();                            // for every thread; perm too
      const T* buf = stage + (size_t)(st % nbuf) * Cs * ld;
      const int cols = min(Cs, D - st * Cs);
      for (int pr = tid; pr < S * cols; pr += SEGT_THREADS) {
        const int cl = pr / S, sg = pr - cl * S;
        const T* col = buf + (size_t)cl * ld;
        T* cell = mine + (size_t)(st * Cs + cl) * S + sg;   // coalesced
        T a = first ? T(0) : *cell;
        const int end = start[sg + 1];
        int k = start[sg];
        for (; k + 4 <= end; k += 4) {            // four loads, then in order
          const T x0 = col[perm[k]], x1 = col[perm[k + 1]];
          const T x2 = col[perm[k + 2]], x3 = col[perm[k + 3]];
          a += x0;
          a += x1;
          a += x2;
          a += x3;
        }
        for (; k < end; ++k) a += col[perm[k]];
        *cell = a;
      }
      __syncthreads();                            // before the buffer refills
    }
    first = false;
  }
  if (first)                                      // a run without rows
    for (size_t e = tid; e < cells; e += SEGT_THREADS) mine[e] = T(0);
}

// after a one-launch sum's grid barrier: cell c of `cells` summed over
// the gridDim.x partials part[b][c] in a fixed order and handed to
// store(c, sum).  L lanes per cell (a power of two, as many as the grid's
// threads allow, at most 32): lane `sub` sums partials sub, sub + L, ... in
// order, eight loads ahead of the adds, then a fixed shuffle tree adds the
// L lanes
template <typename T, typename Store>
__device__ __forceinline__ void sum_partials(const T* __restrict__ part,
                                             size_t cells, Store store) {
  const int threads = gridDim.x * blockDim.x;
  int L = 32;
  while (L > 1 && cells * L > (size_t)threads) L >>= 1;
  const int gt = blockIdx.x * blockDim.x + threadIdx.x, sub = gt & (L - 1);
  const size_t grp = gt / L, groups = threads / L, firstg = (gt & ~31) / L;
  for (size_t r = 0; firstg + r * groups < cells; ++r) {   // the same for a warp
    const size_t c = grp + r * groups;
    T a = T(0);
    if (c < cells) {
      const T* pc = part + c;
      const int G = gridDim.x;
      int b = sub;
      for (; b + 7 * L < G; b += 8 * L) {         // eight loads, then in order
        T x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = __ldcg(pc + (size_t)(b + u * L) * cells);
#pragma unroll
        for (int u = 0; u < 8; ++u) a += x[u];
      }
      for (; b < G; b += L) a += __ldcg(pc + (size_t)b * cells);
    }
    for (int o = L / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o, L);
    if (c < cells && sub == 0) store(c, a);
  }
}

// the dims-major segment sum for S*D <= SEGT_MAX_CELLS and S <=
// SEGT_COUNTS: values (D, N), out (S, D).  Block r sums the r-th of
// gridDim.x runs of rows into its partial part[r][d][s], by column or by
// sorted rows (the header says how; `ld`, `Cs`, `nbuf`, `Ws` are the
// sorted phase's chunk rows, stage columns, stage buffers and counting
// warps); after a grid barrier each cell is summed over the runs in a
// fixed order.
template <typename T, bool BY_COLUMN>
__global__ void __launch_bounds__(SEGT_THREADS, 1)
segment_sum_t_kernel(const T* __restrict__ values, const int* __restrict__ idx,
                     T* __restrict__ out, T* __restrict__ part, int N, int S,
                     int D, int ld, int Cs, int nbuf, int Ws) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t cells = (size_t)S * D;
  if constexpr (BY_COLUMN) {
    segment_sum_t_by_column(values, idx, part, N, S, D,
                            reinterpret_cast<T*>(smem_raw));
  } else {
    segment_sum_t_sorted(values, idx, part, N, S, D, ld, Cs, nbuf, Ws,
                         smem_raw);
  }
  cooperative_groups::this_grid().sync();
  sum_partials(part, cells, [&](size_t c, T a) {
    out[(c % S) * D + c / S] = a;                 // cell (s, d)
  });
}

// ------------------------------------------------------------------------ //
// the implicit Schur product's Schur term per camera, dims-major
// ------------------------------------------------------------------------ //

// a bucketed batch's slabs as schur_rows_kernel walks them: bucket b holds
// count[b] landmarks of degree[b] rows, degree-major from row row0[b]; its
// landmarks are seg0[b].. in bucket order; a tile of it is 256 >> lg_slots[b]
// landmarks times 1 << lg_slots[b] row slots; its tiles are tile0[b]..
struct SlabBuckets {
  int n;
  int count[SROWS_MAX_BUCKETS];
  int degree[SROWS_MAX_BUCKETS];
  int lg_slots[SROWS_MAX_BUCKETS];
  int row0[SROWS_MAX_BUCKETS];
  int seg0[SROWS_MAX_BUCKETS];
  int tile0[SROWS_MAX_BUCKETS + 1];
};

// one round's rows into the block's per-camera sums.  Warp w owns the
// cameras with cam % SROWS_WARPS == w, and its 32 / DP groups of DP lanes
// split them further (group g: cam / SROWS_WARPS % groups == g); each
// group walks the staged rows of its cameras in row order, lane a of it
// adding column a.  No two groups touch one cell, each cell is added in a
// fixed order, and the groups' chains of shared-memory adds run side by
// side
template <typename T, int DP>
__device__ __forceinline__ void add_round(T* acc, const T* wbuf,
                                          const int* cbuf) {
  constexpr int G = 32 / DP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane / DP, col = lane - grp * DP;
  for (int c0 = 0; c0 < SROWS_THREADS; c0 += 32) {
    const int cam = cbuf[c0 + lane];
    const bool ours = cam >= 0 && (cam & (SROWS_WARPS - 1)) == warp;
    const int cg = (cam >> SROWS_LG_WARPS) % G;
    unsigned mine = 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const unsigned m = __ballot_sync(0xffffffffu, ours && cg == g);
      if (grp == g) mine = m;
    }
    while (__any_sync(0xffffffffu, mine != 0)) {
      const int u = mine ? __ffs(mine) - 1 : 0;
      const int cu = __shfl_sync(0xffffffffu, cam, u);
      if (mine) acc[cu * DP + col] += wbuf[col * SROWS_WLD + c0 + u];
      mine &= mine - 1;
    }
  }
}

// out (C, DP): out[c] = sum over the rows of camera c of B_row Dinv_k
// sum_{rows j of k} B_jᵀ v[ids[j]], k each row's landmark (the header says
// how).  B[a][c][row] = Bt[a*sb0 + c*sb1 + row], Dinv[i][j][k] = dinv[i*sd0
// + j*sd1 + k*sd2].  part_g: gridDim.x x C*DP partials; SORTED (the tiled
// form), each row's B s, srows_ld values a row, with order the rows sorted
// by camera and starts each camera's first place in it (no initial value
// either way)
template <typename T, int DP, int DL, bool SORTED>
__device__ __forceinline__ void schur_rows_body(
    const T* __restrict__ Bt, long long sb0, long long sb1,
    const int* __restrict__ ids, const T* __restrict__ dinv, long long sd0,
    long long sd1, long long sd2, const T* __restrict__ v, int C,
    T* __restrict__ out, T* __restrict__ part_g, const SlabBuckets& bk,
    const int* __restrict__ order, const int* __restrict__ starts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cells = SORTED ? 0 : C * DP;
  T* acc = reinterpret_cast<T*>(smem_raw);        // (C, DP): the block's sums
  T* part = acc + cells;                          // (DL, threads): per slot
  T* sk = part + DL * SROWS_THREADS;              // (DL, landmarks): s
  T* wbuf = sk + DL * SROWS_THREADS;              // (DP, SROWS_WLD): a round
  int* cbuf = reinterpret_cast<int*>(wbuf + DP * SROWS_WLD);   // its cameras
  const int tid = threadIdx.x;
  for (int j = tid; j < cells; j += SROWS_THREADS) acc[j] = T(0);
  __syncthreads();
  // B streams: read once (evict first), so L1 keeps the camera table
  auto load_b = [&](int row, T (&B)[DP * DL]) {
#pragma unroll
    for (int a = 0; a < DP; ++a)
#pragma unroll
      for (int c = 0; c < DL; ++c)
        B[a * DL + c] = __ldcs(Bt + a * sb0 + c * sb1 + row);
  };
  // t += Bᵀ v[id]; v through L1, zero for an id outside [0, C)
  auto add_bt_u = [&](const T (&B)[DP * DL], int id, T (&t)[DL]) {
    const bool in = id >= 0 && id < C;
    T u[DP];
#pragma unroll
    for (int a = 0; a < DP; ++a) u[a] = in ? __ldg(v + id * DP + a) : T(0);
#pragma unroll
    for (int c = 0; c < DL; ++c) {
      T a_ = B[c] * u[0];
#pragma unroll
      for (int a = 1; a < DP; ++a) a_ += B[a * DL + c] * u[a];
      t[c] += a_;
    }
  };
  // the round's buffer: B s of this thread's row
  auto stage_bs = [&](const T (&B)[DP * DL], const T (&s)[DL]) {
#pragma unroll
    for (int a = 0; a < DP; ++a) {
      T a_ = B[a * DL] * s[0];
#pragma unroll
      for (int c = 1; c < DL; ++c) a_ += B[a * DL + c] * s[c];
      wbuf[a * SROWS_WLD + tid] = a_;
    }
  };
  const int tiles = bk.tile0[bk.n];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int b = 0;
    while (tile >= bk.tile0[b + 1]) ++b;
    const int lg_r = bk.lg_slots[b], R = 1 << lg_r;
    const int lg_l = SROWS_LG_THREADS - lg_r, L = 1 << lg_l;
    const int l = tid & (L - 1), r = tid >> lg_l;   // landmark, row slot
    const int n = bk.count[b], d = bk.degree[b];
    const int k = ((tile - bk.tile0[b]) << lg_l) + l;
    const bool live = k < n;
    const int row0 = bk.row0[b] + k;                // + j * n: row j of k
    // slot 0 loads its landmark's Dinv now, beside the first row's B, so
    // that applying it waits on no load
    T Dk[DL * DL];
    if (r == 0 && live) {
      const long long seg = bk.seg0[b] + k;
#pragma unroll
      for (int i = 0; i < DL; ++i)
#pragma unroll
        for (int c = 0; c < DL; ++c)
          Dk[i * DL + c] = __ldg(dinv + i * sd0 + c * sd1 + seg * sd2);
    }
    // Σ Bᵀu over the slot's rows r, r + R, ..., in order; the first row's
    // B and id stay in registers for the rounds
    T B0[DP * DL], t[DL];
#pragma unroll
    for (int c = 0; c < DL; ++c) t[c] = T(0);
    int id0 = -1;
    if (live && r < d) {
      const int row = row0 + r * n;
      load_b(row, B0);
      id0 = __ldg(ids + row);
      add_bt_u(B0, id0, t);
    }
    for (int j = r + R; live && j < d; j += R) {
      T Bj[DP * DL];
      const int row = row0 + j * n;
      load_b(row, Bj);
      add_bt_u(Bj, __ldg(ids + row), t);
    }
#pragma unroll
    for (int c = 0; c < DL; ++c) part[c * SROWS_THREADS + tid] = t[c];
    __syncthreads();
    // slot 0: the slots' sums in slot order, then s = Dinv_k t
    if (r == 0 && live) {
      T tk[DL];
#pragma unroll
      for (int c = 0; c < DL; ++c) {
        T a_ = part[c * SROWS_THREADS + l];
        for (int q = 1; q < R; ++q) a_ += part[c * SROWS_THREADS + (q << lg_l) + l];
        tk[c] = a_;
      }
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        T a_ = Dk[i * DL] * tk[0];
#pragma unroll
        for (int c = 1; c < DL; ++c) a_ += Dk[i * DL + c] * tk[c];
        sk[i * SROWS_THREADS + l] = a_;
      }
    }
    __syncthreads();
    T s[DL];
#pragma unroll
    for (int c = 0; c < DL; ++c) s[c] = live ? sk[c * SROWS_THREADS + l] : T(0);
    if constexpr (SORTED) {
      // each row's B s (srows_ld values, the padding zero) stored at the
      // row's place, as 16-byte stores; a row whose camera lies outside [0,
      // C) is left out.  The first row's B from registers, a later row's,
      // past R, read again from L1 or L2
      constexpr int V = 16 / (int)sizeof(T), LD = srows_ld<T>(DP);
      auto put_bs = [&](const T (&B)[DP * DL], int cam, int row) {
        if (cam < 0 || cam >= C) return;
        T w[LD];
#pragma unroll
        for (int a = 0; a < DP; ++a) {
          T a_ = B[a * DL] * s[0];
#pragma unroll
          for (int c = 1; c < DL; ++c) a_ += B[a * DL + c] * s[c];
          w[a] = a_;
        }
#pragma unroll
        for (int a = DP; a < LD; ++a) w[a] = T(0);
        T* dst = part_g + (size_t)row * LD;
#pragma unroll
        for (int q = 0; q < LD; q += V) store16(dst + q, w + q);
      };
      if (live && r < d) put_bs(B0, id0, row0 + r * n);
      for (int j = r + R; live && j < d; j += R) {
        T Bj[DP * DL];
        const int row = row0 + j * n;
        load_b(row, Bj);
        put_bs(Bj, __ldg(ids + row), row);
      }
      continue;
    }
    // rounds of one row per slot: B s staged, then summed per camera (the
    // first row's B from registers, a later row's, past R, read again from
    // L1 or L2)
    const int rounds = (d + R - 1) >> lg_r;
    for (int q = 0; q < rounds; ++q) {
      const int j = r + (q << lg_r);
      int cam = -1;
      if (live && j < d) {
        if (q == 0) {
          stage_bs(B0, s);
          cam = id0;
        } else {
          T Bj[DP * DL];
          const int row = row0 + j * n;
          load_b(row, Bj);
          stage_bs(Bj, s);
          cam = __ldg(ids + row);
        }
        if (cam >= C) cam = -1;                     // out of range: dropped
      }
      cbuf[tid] = cam;
      __syncthreads();
      add_round<T, DP>(acc, wbuf, cbuf);
      __syncthreads();
    }
  }
  if constexpr (SORTED) {
    // after a grid barrier each camera's rows, in slab order, are summed
    // by one block, the blocks taking cameras in turn: thread t adds rows
    // order[start + t], order[start + t + SROWS_THREADS], ... in order, four
    // loads ahead of the adds (through L2: the rows were written in this
    // launch); a fixed shuffle tree adds each warp's lanes and the warps'
    // sums are added in warp order
    cooperative_groups::this_grid().sync();
    constexpr int V = 16 / (int)sizeof(T), LD = srows_ld<T>(DP), U = 4;
    T* wsum = part;                               // (warps, DP)
    const int lane = tid & 31, warp = tid >> 5;
    for (int c = blockIdx.x; c < C; c += gridDim.x) {
      const int hi = starts[c + 1];
      T a[DP];
#pragma unroll
      for (int k = 0; k < DP; ++k) a[k] = T(0);
      int i = starts[c] + tid;
      for (; i + (U - 1) * SROWS_THREADS < hi; i += U * SROWS_THREADS) {
        T x[U][LD];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int q = 0; q < LD; q += V)
            ldcg16(part_g + (size_t)order[i + u * SROWS_THREADS] * LD + q,
                   x[u] + q);
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int k = 0; k < DP; ++k) a[k] += x[u][k];
      }
      for (; i < hi; i += SROWS_THREADS) {
        T x[LD];
#pragma unroll
        for (int q = 0; q < LD; q += V)
          ldcg16(part_g + (size_t)order[i] * LD + q, x + q);
#pragma unroll
        for (int k = 0; k < DP; ++k) a[k] += x[k];
      }
#pragma unroll
      for (int k = 0; k < DP; ++k)
        for (int o = 16; o > 0; o >>= 1) a[k] += __shfl_xor_sync(0xffffffffu, a[k], o);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < DP; ++k) wsum[warp * DP + k] = a[k];
      }
      __syncthreads();
      if (tid < DP) {
        T a_ = wsum[tid];
        for (int w = 1; w < SROWS_WARPS; ++w) a_ += wsum[w * DP + tid];
        out[(size_t)c * DP + tid] = a_;
      }
      __syncthreads();                            // before wsum is reused
    }
    return;
  }
  // the block's sums into its partial; after a grid barrier each cell
  // summed over the blocks in a fixed order
  T* mine = part_g + (size_t)blockIdx.x * cells;
  for (int j = tid; j < cells; j += SROWS_THREADS) mine[j] = acc[j];
  cooperative_groups::this_grid().sync();
  sum_partials(part_g, (size_t)cells, [&](size_t c, T a_) { out[c] = a_; });
}

// the Schur rows kernel: the camera sums in each block's shared memory
template <typename T, int DP, int DL>
__global__ void __launch_bounds__(SROWS_THREADS)
schur_rows_kernel(const T* __restrict__ Bt, long long sb0, long long sb1,
                  const int* __restrict__ ids, const T* __restrict__ dinv,
                  long long sd0, long long sd1, long long sd2,
                  const T* __restrict__ v, int C, T* __restrict__ out,
                  T* __restrict__ part_g, SlabBuckets bk) {
  schur_rows_body<T, DP, DL, false>(Bt, sb0, sb1, ids, dinv, sd0, sd1, sd2, v,
                                    C, out, part_g, bk, nullptr, nullptr);
}

// its tiled form: each row's B s stored, then each camera's rows gathered
// and summed (the header says how)
template <typename T, int DP, int DL>
__global__ void __launch_bounds__(SROWS_THREADS)
schur_rows_tiled_kernel(const T* __restrict__ Bt, long long sb0,
                        long long sb1, const int* __restrict__ ids,
                        const T* __restrict__ dinv, long long sd0,
                        long long sd1, long long sd2, const T* __restrict__ v,
                        int C, T* __restrict__ out, T* __restrict__ rows,
                        SlabBuckets bk, const int* __restrict__ order,
                        const int* __restrict__ starts) {
  schur_rows_body<T, DP, DL, true>(Bt, sb0, sb1, ids, dinv, sd0, sd1, sd2, v,
                                   C, out, rows, bk, order, starts);
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
  if (dims_major) {
    constexpr int V = 16 / (int)sizeof(T);
    const int vec = N % V == 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    const long long items = vec ? N / V : N;
    // blocks of GATHER_T_THREADS, halved (down to GATHER_T_MIN_THREADS)
    // while the items fill fewer than half as many blocks as there are
    // SMs, so that a small call still spreads over the card; as many
    // blocks as the items need, at most as many as the SMs hold at once
    // (threads, and the staged table beside the 1 KB each block keeps)
    const bool stage = tbytes <= GATHER_T_STAGE_MAX;
    long long bt = GATHER_T_THREADS;
    while (bt > GATHER_T_MIN_THREADS && 2 * items < bt * sms) bt /= 2;
    long long per_sm = GATHER_T_SM_THREADS / bt;
    if (stage && GATHER_T_SM_SMEM / (tbytes + 1024) < per_sm)
      per_sm = GATHER_T_SM_SMEM / (tbytes + 1024);
    long long blocks = (items + bt - 1) / bt;
    if (blocks > per_sm * sms) blocks = per_sm * sms;
    if (blocks < 1) blocks = 1;
    if (stage) {
      if (tbytes > STATIC_SMEM) {
        static std::atomic<bool> raised[MAX_DEVICES];
        err = raise_smem(gather_t_kernel<T, true>, GATHER_T_STAGE_MAX, dev, raised);
        if (err) return err;
      }
      gather_t_kernel<T, true><<<(unsigned)blocks, (unsigned)bt, (size_t)tbytes,
                                 st>>>(
          (const T*)table, (const int*)idx, (T*)out, N, S, D, vec);
    } else {
      gather_t_kernel<T, false><<<(unsigned)blocks, (unsigned)bt, 0, st>>>(
          (const T*)table, (const int*)idx, (T*)out, N, S, D, vec);
    }
    return (int)cudaGetLastError();
  }
  const long long total = (long long)N * D;
  long long blocks = (total + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  if (blocks > 2LL * sms) blocks = 2LL * sms;
  if (blocks < 1) blocks = 1;
  if (tbytes <= STATIC_SMEM) {
    gather_kernel<T, true><<<(unsigned)blocks, THREADS, (size_t)tbytes, st>>>(
        (const T*)table, (const int*)idx, (T*)out, N, S, D);
  } else {
    gather_kernel<T, false><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const T*)table, (const int*)idx, (T*)out, N, S, D);
  }
  return (int)cudaGetLastError();
}

// the partials of a one-launch sum (the row-major and the dims-major) for
// eager calls: one scratch per (device, stream), grown to the largest call
// so far and kept.  Launches on one stream run one after another and each
// kernel writes every partial it reads, so they can share it; the scratch
// is allocated and freed in stream order (cudaMallocAsync, cudaFreeAsync),
// so a growth waits for the launches that used the old one.  A call
// captured in a CUDA graph allocates its own.
int eager_scratch(int dev, cudaStream_t st, size_t bytes, void** part) {
  static std::mutex mu;
  static std::map<std::pair<int, cudaStream_t>, std::pair<void*, size_t>> made;
  std::lock_guard<std::mutex> lock(mu);
  auto& slot = made[{dev, st}];
  if (slot.second < bytes) {
    if (slot.first) {
      cudaError_t e = cudaFreeAsync(slot.first, st);
      slot = {nullptr, 0};
      if (e != cudaSuccess) return (int)e;
    }
    void* p = nullptr;
    cudaError_t e = cudaMallocAsync(&p, bytes, st);
    if (e != cudaSuccess) return (int)e;
    slot = {p, bytes};
  }
  *part = slot.first;
  return 0;
}

// the partials' scratch of a one-launch sum: its own in a capture (a graph
// memory node, freed by the caller after the launch), else the stream's
int partial_scratch(int dev, cudaStream_t st, size_t bytes, bool* captured,
                    void** part) {
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  cudaError_t e = cudaStreamIsCapturing(st, &capture);
  if (e != cudaSuccess) return (int)e;
  *captured = capture != cudaStreamCaptureStatusNone;
  if (*captured) return (int)cudaMallocAsync(part, bytes, st);
  return eager_scratch(dev, st, bytes, part);
}

// the dims-major one-launch sum's launch: blocks (one per SEGT_PER_BLOCK
// values, at most one per SM: a cooperative launch needs them
// co-resident), rows per chunk `ld` (a run's rows, at most
// SEGT_CHUNK_BYTES of one column), columns per stage Cs, stage buffers
// nbuf (2 to 4 in SEGT_RING, fewer where the counters leave less room, never
// below 2), counting warps Ws and the shared memory they take; false where
// S*D or S is past what the partials or the sort's counters hold
template <typename T>
bool segt_plan(int N, int S, int D, int sms, bool* by_column, int* grid,
               int* ld, int* Cs, int* nbuf, int* Ws, size_t* smem) {
  if ((long long)S * D > SEGT_MAX_CELLS || S > SEGT_COUNTS) return false;
  long long g = ((long long)N * D + SEGT_PER_BLOCK - 1) / SEGT_PER_BLOCK;
  g = g > sms ? sms : g < 1 ? 1 : g;
  *smem = (size_t)SEGT_WARPS * S * D * sizeof(T);
  *by_column = *smem <= (size_t)SEGT_COLUMN_BUDGET;
  *ld = *Cs = *nbuf = *Ws = 0;
  *grid = (int)g;
  if (*by_column) return true;
  const long long nb = ((long long)N + 31) / 32;
  const long long run = (nb + g - 1) / g * 32;
  const int chunk = SEGT_CHUNK_BYTES / (int)sizeof(T);
  *ld = (int)(run < chunk ? run : chunk);
  const size_t col = (size_t)*ld * sizeof(T);
  const size_t cs = SEGT_STAGE / col;
  *Cs = (int)(cs < 1 ? 1 : cs > (size_t)D ? D : cs);
  const size_t nb_ring = SEGT_RING / (col * *Cs);
  *nbuf = (int)(nb_ring < 2 ? 2 : nb_ring > 4 ? 4 : nb_ring);
  *Ws = SEGT_COUNTS / S < SEGT_WARPS ? SEGT_COUNTS / S : SEGT_WARPS;
  // the ids, the order, the counters and the starts, then as many stages
  // as fit beside them (two always do)
  const size_t ints = (2 * (size_t)*ld + (size_t)*Ws * S + S + 1) * sizeof(int);
  const size_t stage = (size_t)*Cs * col;      // at most SEGT_CHUNK_BYTES
  if ((size_t)*nbuf * stage > SEGT_SMEM - ints) *nbuf = (int)((SEGT_SMEM - ints) / stage);
  *smem = (size_t)*nbuf * stage + ints;
  return true;
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
    bool captured;
    void* part = nullptr;
    err = partial_scratch(dev, st, (size_t)g * S * D * sizeof(T), &captured,
                          &part);
    if (err) return err;
    const T* v = (const T*)values;
    const int* i = (const int*)idx;
    T* o = (T*)out;
    T* p = (T*)part;
    void* args[] = {&v, &i, &o, &p, &N, &S, &D};
    cudaError_t e = cudaLaunchCooperativeKernel(
        (const void*)segment_sum_rows_kernel<T>, dim3((unsigned)g),
        dim3(ROWSUM_THREADS), args, smem, st);
    if (e != cudaSuccess) return (int)e;
    return captured ? (int)cudaFreeAsync(part, st) : 0;
  }
  bool by_column;
  int grid, ld, Cs, nbuf, Ws;
  size_t tsmem;
  if (dims_major && segt_plan<T>(N, S, D, sms, &by_column, &grid, &ld, &Cs,
                                 &nbuf, &Ws, &tsmem)) {
    static std::atomic<bool> raised[2][MAX_DEVICES];
    err = by_column ? raise_smem(segment_sum_t_kernel<T, true>, SEGT_SMEM, dev,
                                 raised[1])
                    : raise_smem(segment_sum_t_kernel<T, false>, SEGT_SMEM, dev,
                                 raised[0]);
    if (err) return err;
    bool captured;
    void* part = nullptr;
    err = partial_scratch(dev, st, (size_t)grid * S * D * sizeof(T), &captured,
                          &part);
    if (err) return err;
    const T* v = (const T*)values;
    const int* i = (const int*)idx;
    T* o = (T*)out;
    T* p = (T*)part;
    void* args[] = {&v, &i, &o, &p, &N, &S, &D, &ld, &Cs, &nbuf, &Ws};
    cudaError_t e = cudaLaunchCooperativeKernel(
        by_column ? (const void*)segment_sum_t_kernel<T, true>
                  : (const void*)segment_sum_t_kernel<T, false>,
        dim3((unsigned)grid), dim3(SEGT_THREADS), args, tsmem, st);
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

// schur_rows_kernel's cooperative launch: shared memory for the block's
// per-camera sums and the slot and round buffers; as many blocks as the
// tiles need, at most as many as the SMs hold at once (registers, threads
// and shared memory; each block walks its tiles), and their partials'
// scratch
// the tiled form's cooperative launch (C past what a block's shared memory
// sums): shared memory for the slot buffers alone; as many blocks as the
// tiles need, at most as many as the SMs hold at once; `rows`, each row's
// B s, is the caller's
template <typename T, int DP, int DL>
int schur_rows_tiled(const void* Bt, long long sb0, long long sb1,
                     const void* ids, const void* dinv, long long sd0,
                     long long sd1, long long sd2, const void* v, int C,
                     void* out, const SlabBuckets& bk, cudaStream_t st, int sms,
                     const int* order, const int* starts, void* rows) {
  const size_t smem = (size_t)2 * DL * SROWS_THREADS * sizeof(T);
  auto kernel = &schur_rows_tiled_kernel<T, DP, DL>;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)kernel, SROWS_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long g = bk.tile0[bk.n];
  if (g > (long long)per_sm * sms) g = (long long)per_sm * sms;
  if (g < 1) g = 1;
  const T* b_ = (const T*)Bt;
  const int* i_ = (const int*)ids;
  const T* d_ = (const T*)dinv;
  const T* v_ = (const T*)v;
  T* o_ = (T*)out;
  T* r_ = (T*)rows;
  SlabBuckets bk_ = bk;
  void* args[] = {&b_, &sb0, &sb1, &i_, &d_, &sd0, &sd1, &sd2, &v_, &C, &o_,
                  &r_, &bk_, &order, &starts};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel,
                                          dim3((unsigned)g),
                                          dim3(SROWS_THREADS), args, smem, st);
}

template <typename T, int DP, int DL>
int schur_rows(const void* Bt, long long sb0, long long sb1, const void* ids,
               const void* dinv, long long sd0, long long sd1, long long sd2,
               const void* v, int C, void* out, const SlabBuckets& bk,
               cudaStream_t st, int dev, int sms, const int* order,
               const int* starts, void* rows) {
  if (order)
    return schur_rows_tiled<T, DP, DL>(Bt, sb0, sb1, ids, dinv, sd0, sd1, sd2,
                                       v, C, out, bk, st, sms, order, starts,
                                       rows);
  const size_t smem =
      (size_t)(C * DP + 2 * DL * SROWS_THREADS + DP * SROWS_WLD) * sizeof(T) +
      SROWS_THREADS * sizeof(int);
  if (smem > (size_t)SROWS_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = &schur_rows_kernel<T, DP, DL>;
  static std::atomic<bool> raised[MAX_DEVICES];
  int err = raise_smem(kernel, SROWS_SMEM, dev, raised);
  if (err) return err;
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)kernel, SROWS_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long g = bk.tile0[bk.n];
  if (g > (long long)per_sm * sms) g = (long long)per_sm * sms;
  if (g < 1) g = 1;
  bool captured;
  void* part = nullptr;
  err = partial_scratch(dev, st, (size_t)g * C * DP * sizeof(T), &captured,
                        &part);
  if (err) return err;
  const T* b_ = (const T*)Bt;
  const int* i_ = (const int*)ids;
  const T* d_ = (const T*)dinv;
  const T* v_ = (const T*)v;
  T* o_ = (T*)out;
  T* p_ = (T*)part;
  SlabBuckets bk_ = bk;
  void* args[] = {&b_, &sb0, &sb1, &i_, &d_, &sd0, &sd1, &sd2, &v_, &C, &o_,
                  &p_, &bk_};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)g),
                                  dim3(SROWS_THREADS), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return captured ? (int)cudaFreeAsync(part, st) : 0;
}

template <typename T>
int schur_rows_entry(const void* Bt, long long sb0, long long sb1,
                     const void* ids, const void* dinv, long long sd0,
                     long long sd1, long long sd2, const void* v, int C,
                     void* out, int N, int dp, int dl, int nb,
                     const int* counts, const int* degrees, void* stream,
                     const int* order = nullptr, const int* starts = nullptr,
                     void* rows = nullptr) {
  if (nb < 1 || nb > SROWS_MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  SlabBuckets bk = {};
  bk.n = nb;
  long long row = 0, seg = 0, tiles = 0;
  for (int b = 0; b < nb; ++b) {
    if (counts[b] < 0 || degrees[b] < 1) return (int)cudaErrorInvalidValue;
    int lg = 0;                       // row slots: the degree, rounded up
    while (lg < SROWS_LG_MAX_SLOTS && (1 << lg) < degrees[b]) ++lg;
    bk.count[b] = counts[b];
    bk.degree[b] = degrees[b];
    bk.lg_slots[b] = lg;
    bk.row0[b] = (int)row;
    bk.seg0[b] = (int)seg;
    bk.tile0[b] = (int)tiles;
    const int L = SROWS_THREADS >> lg;
    row += (long long)counts[b] * degrees[b];
    seg += counts[b];
    tiles += (counts[b] + L - 1) / L;
  }
  bk.tile0[nb] = (int)tiles;
  if (row != N || C < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  int err = device_sms(&dev, &sms);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dp == 9 && dl == 3)
    return schur_rows<T, 9, 3>(Bt, sb0, sb1, ids, dinv, sd0, sd1, sd2, v, C,
                               out, bk, st, dev, sms, order, starts, rows);
  if (dp == 6 && dl == 3)
    return schur_rows<T, 6, 3>(Bt, sb0, sb1, ids, dinv, sd0, sd1, sd2, v, C,
                               out, bk, st, dev, sms, order, starts, rows);
  return (int)cudaErrorInvalidValue;
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

int g2o_schur_rows_f32(const void* Bt, long long sb0, long long sb1,
                       const void* ids, const void* dinv, long long sd0,
                       long long sd1, long long sd2, const void* v, int C,
                       void* out, int N, int dp, int dl, int nb,
                       const int* counts, const int* degrees, void* stream) {
  return schur_rows_entry<float>(Bt, sb0, sb1, ids, dinv, sd0, sd1, sd2, v, C,
                                 out, N, dp, dl, nb, counts, degrees, stream);
}

int g2o_schur_rows_f64(const void* Bt, long long sb0, long long sb1,
                       const void* ids, const void* dinv, long long sd0,
                       long long sd1, long long sd2, const void* v, int C,
                       void* out, int N, int dp, int dl, int nb,
                       const int* counts, const int* degrees, void* stream) {
  return schur_rows_entry<double>(Bt, sb0, sb1, ids, dinv, sd0, sd1, sd2, v,
                                  C, out, N, dp, dl, nb, counts, degrees, stream);
}

// the tiled form: order (N,) the rows sorted by camera, starts (C + 1,) each
// camera's first place in it, rows the caller's scratch of srows_ld values a
// row
int g2o_schur_rows_tiled_f32(const void* Bt, long long sb0, long long sb1,
                             const void* ids, const void* dinv, long long sd0,
                             long long sd1, long long sd2, const void* v,
                             int C, void* out, int N, int dp, int dl, int nb,
                             const int* counts, const int* degrees,
                             const int* order, const int* starts, void* rows,
                             void* stream) {
  return schur_rows_entry<float>(Bt, sb0, sb1, ids, dinv, sd0, sd1, sd2, v, C,
                                 out, N, dp, dl, nb, counts, degrees, stream,
                                 order, starts, rows);
}

int g2o_schur_rows_tiled_f64(const void* Bt, long long sb0, long long sb1,
                             const void* ids, const void* dinv, long long sd0,
                             long long sd1, long long sd2, const void* v,
                             int C, void* out, int N, int dp, int dl, int nb,
                             const int* counts, const int* degrees,
                             const int* order, const int* starts, void* rows,
                             void* stream) {
  return schur_rows_entry<double>(Bt, sb0, sb1, ids, dinv, sd0, sd1, sd2, v,
                                  C, out, N, dp, dl, nb, counts, degrees,
                                  stream, order, starts, rows);
}

}  // extern "C"
