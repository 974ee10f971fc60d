"""Where a segment sum's device time goes, on the CUDA card: variants of
``g2o_tpu_torch/csrc/gather_segment.cu``, each with one phase cut out or one
setting changed, built side by side and timed.

    python3 scripts/rowsum_probe.py [--n 35000] [--s 49] [--d 9]
    python3 scripts/rowsum_probe.py --dims-major SOURCE

Without ``--dims-major``: the row-major one-launch segment sum at one shape
(by default the runtime-bucketed ladybug shape, 35000 rows of 9 values into
49 segments, ids in [0, 49], f32).  With ``--dims-major SOURCE``: the split
of the dims-major segment sum of SOURCE (a ``gather_segment.cu``) at the six
shapes of the dims-major implicit Schur paths (ladybug, stress and Venice,
D = 9 and 81, with the paths' own camera ids, as ``chip_smoke.py`` loads
them): of the one-launch kernel (:data:`SEGT_VARIANTS`) where SOURCE has
it, else of the memset-and-atomics kernel (:data:`DM_VARIANTS`); see
:func:`dims_major_split`.

Row-major variants (a cut variant computes wrong sums and is timed
only):

* ``ship``: the source as it is;
* ``no_rows``: without the pass over the rows (the fixed cost);
* ``no_barrier``: the grid barrier replaced by a block barrier;
* ``no_final``: without the pass that sums the blocks' partials;
* ``plain_launch``: ``no_barrier`` launched with ``cudaLaunchKernel``
  instead of the cooperative launch;
* ``batch16``: 16 rows in flight per warp instead of 32;
* ``no_shared_sums``: each lane adds its rows into a register instead of
  the warp's shared accumulator (timing only);
* ``branch``: the shared read too under the row's condition (the
  compiler may branch per row);
* ``spread16`` / ``spread8``: blocks sized for 16 / 8 rows per warp
  instead of 32 (more SMs, more partials);
* ``final_unroll8``: the blocks' partials read 8 at a time per lane;
* ``staged``: each warp's rows loaded as one coalesced flat run into a
  shared tile, then read per row and column (D <= 32 only);
* ``warps8``: 8 warps per block, two blocks per SM, instead of 16 and one
  (the library's scratch holds their partials at this shape);
* ``memset``: the shipped library's memset branch (memset + grid kernel),
  reached with the same ids and more segments than the one launch takes.

For each: ``device_us`` (``torch.profiler``, kernels and memsets per call)
and ``graph_us`` (CUDA events around a CUDA graph of 100 calls, per call),
each the median of ``--rounds`` in turns; then the host µs per call of
the pieces of a call (:func:`host`).  The first line names the card and
its power limit.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNC = "cooperative_groups::this_grid().sync();"
VARIANTS = {
    "ship": [],
    "no_rows": [("for (long long nb = gw * per; nb < n1;",
                 "for (long long nb = n1; nb < n1;")],
    "no_barrier": [(SYNC, "__syncthreads();")],
    "no_final": [("for (int j = gw; j < cells; j += warps) {",
                  "for (int j = gw + cells; j < cells; j += warps) {")],
    "plain_launch": [(SYNC, "__syncthreads();"),
                     ("cudaLaunchCooperativeKernel(", "cudaLaunchKernel(")],
    "batch16": [("constexpr int ROWSUM_BATCH = 32;",
                 "constexpr int ROWSUM_BATCH = 16;")],
    "no_shared_sums": [
        ("  __syncwarp();\n", "  __syncwarp();\n  T racc = T(0);\n"),
        ("if (keep) acc[k] = a + v[u];", "if (keep) racc += a + v[u];"),
        ("  __syncthreads();\n  T* mine_part",
         "  if (lane < cells) acc[lane] += racc;\n"
         "  __syncthreads();\n  T* mine_part")],
    "branch": [("const T a = acc[k];\n        if (keep) acc[k] = a + v[u];",
                "if (keep) acc[k] += v[u];")],
    "spread16": [("ROWSUM_WARPS * ROWSUM_BATCH - 1) /\n                  (ROWSUM_WARPS * ROWSUM_BATCH);",
                  "ROWSUM_WARPS * 16 - 1) /\n                  (ROWSUM_WARPS * 16);")],
    "spread8": [("ROWSUM_WARPS * ROWSUM_BATCH - 1) /\n                  (ROWSUM_WARPS * ROWSUM_BATCH);",
                 "ROWSUM_WARPS * 8 - 1) /\n                  (ROWSUM_WARPS * 8);")],
    "final_unroll8": [("#pragma unroll 4\n    for (int b = lane;",
                       "#pragma unroll 8\n    for (int b = lane;")],
    "staged": [('    for (int c0 = 0; c0 < D; c0 += 32) {    // D <= 32: one pass\n      const int c = c0 + lane;\n      T v[ROWSUM_BATCH];                     // in flight beside the ids\n#pragma unroll\n      for (int u = 0; u < ROWSUM_BATCH; ++u)\n        v[u] = u < rows && c < D ? __ldg(values + (nb + u) * D + c) : T(0);\n', '    T* tile = accs + ROWSUM_WARPS * cells + warp * (ROWSUM_BATCH * D);\n    {\n      const int m = rows * D;\n      const T* src = values + nb * D;\n      T r[32];\n#pragma unroll\n      for (int q = 0; q < 32; ++q)\n        r[q] = q < D && lane + 32 * q < m ? __ldg(src + lane + 32 * q) : T(0);\n#pragma unroll\n      for (int q = 0; q < 32; ++q)\n        if (q < D && lane + 32 * q < m) tile[lane + 32 * q] = r[q];\n      __syncwarp();\n    }\n    for (int c0 = 0; c0 < D; c0 += 32) {\n      const int c = c0 + lane;\n      T v[ROWSUM_BATCH];\n#pragma unroll\n      for (int u = 0; u < ROWSUM_BATCH; ++u)\n        v[u] = u < rows && c < D ? tile[u * D + c] : T(0);\n'),
               ("    }\n  }\n  __syncthreads();\n  T* mine_part",
                "    }\n    __syncwarp();\n  }\n  __syncthreads();\n"
                "  T* mine_part"),
               ("const size_t smem = (size_t)ROWSUM_WARPS * S * D * sizeof(T);",
                "const size_t smem = (size_t)ROWSUM_WARPS *\n"
                "        (S * D + ROWSUM_BATCH * D) * sizeof(T);")],
    "warps8": [("constexpr int ROWSUM_THREADS = 512;",
                "constexpr int ROWSUM_THREADS = 256;"),
               ("__launch_bounds__(ROWSUM_THREADS, 1)",
                "__launch_bounds__(ROWSUM_THREADS, 2)"),
               ("if (g > sms) g = sms;", "if (g > 2 * sms) g = 2 * sms;")],
}


# the dims-major split: variants of the memset-and-atomics branch (a cut
# variant computes wrong sums and is timed only)
DM_VARIANTS = {
    "ship": [],
    # without the memset of `out` before the kernel
    "no_memset": [("  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)S * D * "
                   "sizeof(T), st);\n  if (e != cudaSuccess) return (int)e;",
                   "  cudaError_t e = cudaSuccess;\n  (void)e;")],
    # without the flush of the blocks' partials by global atomics: (b)
    "no_flush": [("    if (v != T(0)) {\n      const int s = j / dt;",
                  "    if (false) {\n      const int s = j / dt;")],
    # plain (racy) shared adds in place of the per-value shared atomics: (a)
    "no_shared_atomics": [
        ("if (s[u] >= 0 && s[u] < S) atomicAdd(acc + s[u] * ld + c[u], v[u]);",
         "if (s[u] >= 0 && s[u] < S) acc[s[u] * ld + c[u]] += v[u];")],
    # without the pass over the values (launch, zeroing, an empty flush)
    "no_rows": [("const unsigned total = (unsigned)N * (unsigned)dt;",
                 "const unsigned total = 0u;")],
    # one block per D-tile: a flush of one partial per cell
    "one_block": [("  if (gx < 1) gx = 1;\n", "  gx = 1;\n")],
}


# the split of the dims-major one-launch sum (segment_sum_t_kernel), and its
# sorted phase forced at every shape
SEGT_VARIANTS = {
    "ship": [],
    # by sorted rows at every shape (ladybug and stress D = 9 too)
    "sorted": [("*by_column = *smem <= (size_t)SEGT_COLUMN_BUDGET;",
                "*by_column = false;")],
    # by column (ladybug and stress D = 9): without the pass over the rows
    "col_no_rows": [("for (long long bb = b0 + (b1 - b0) * warp / SEGT_WARPS; "
                     "bb < w1; ++bb) {", "for (long long bb = w1; bb < w1; "
                     "++bb) {")],
    # sorted: without the sums over the staged columns (the sort, the
    # copies, the partials' stores and the final pass kept)
    "no_sums": [("const int end = start[sg + 1];",
                 "const int end = start[sg];")],
    # sorted: without the 16-byte copies of the values (the sums read
    # stale shared memory)
    "no_copies": [("for (int e = tid; e < cols * nv; e += SEGT_THREADS) {",
                   "for (int e = cols * nv; e < cols * nv; e += SEGT_THREADS) {")],
    # without the pass over the runs' partials
    "no_final": [("for (size_t r = 0; firstg + r * groups < cells; ++r) {",
                  "for (size_t r = 0; false; ++r) {")],
    # a block barrier in place of the grid barrier
    "no_grid_barrier": [("  cooperative_groups::this_grid().sync();\n"
                         "  // L lanes per cell",
                         "  __syncthreads();\n  // L lanes per cell")],
}
# the variants that compute the sum (the others are timed only)
SEGT_WHOLE = ("ship", "sorted")


def build(out_dir, variants=None, src_path=None, tag="probe",
          kernel="segment_sum_rows_kernel", entry="g2o_scatter_add_f32",
          argtypes=None):
    """``{variant: entry point}``: C function ``entry`` (``argtypes``,
    default the segment sum's) of each of ``variants`` (default
    :data:`VARIANTS`) of ``src_path`` (default this checkout's
    ``gather_segment.cu``), one nvcc per variant, all at once; prints
    ptxas's registers and spills of ``kernel``."""
    from g2o_tpu_torch.ops import chol_kernels as ck

    variants = VARIANTS if variants is None else variants
    src_path = src_path or ck.SOURCES["gather_segment"]
    src = open(src_path).read()
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{tag}_{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        so = cu[:-3] + ".so"
        procs[name] = (so, subprocess.Popen(
            [ck._nvcc(), *ck.NVCC_FLAGS, "-I", os.path.dirname(src_path),
             "-Xptxas", "-v", "-o", so, cu], stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}: {err[-2000:]}")
        # ptxas's registers and spills of the row-major sum's kernels
        lines = err.splitlines()
        for i, line in enumerate(lines):
            if kernel in line:
                print(f"[{tag}_build] variant={name} " + " ".join(
                    x.strip() for x in lines[i + 1:i + 3]), flush=True)
        sass = subprocess.run([os.path.join(os.path.dirname(ck._nvcc()),
                                            "cuobjdump"), "-sass", so],
                              capture_output=True, text=True).stdout
        print(f"[{tag}_build] variant={name} sass_BSSY={sass.count('BSSY')}"
              f" sass_BRA={sass.count(' BRA ')}", flush=True)
        fn = getattr(ctypes.CDLL(so), entry)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = argtypes or [vp, vp, vp, ci, ci, ci, ci, vp]
        fn.restype = ci
        libs[name] = fn
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=35000)
    ap.add_argument("--s", type=int, default=49)
    ap.add_argument("--d", type=int, default=9)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--dims-major", metavar="SOURCE",
                    help="split the dims-major memset-and-atomics segment "
                    "sum of this gather_segment.cu at the paths' shapes")
    args = ap.parse_args()
    sys.path.insert(0, HERE)

    import torch

    import chip_smoke
    from g2o_tpu_torch.ops import chol_kernels as ck
    from g2o_tpu_torch.ops import onehot as oh

    card = chip_smoke.device_phase(torch)
    os.makedirs(ck.BUILD_DIR, exist_ok=True)
    if args.dims_major:
        dims_major_split(torch, chip_smoke, oh, card,
                         os.path.abspath(args.dims_major), args.rounds)
        return
    fns = build(ck.BUILD_DIR)
    fns["memset"] = fns["ship"]
    N, S, D = args.n, args.s, args.d
    rng = np.random.default_rng(3)
    ids = torch.as_tensor(rng.integers(0, S + 1, N).astype(np.int32),
                          device="cuda")
    rows = torch.as_tensor(rng.standard_normal((N, D)), dtype=torch.float32,
                           device="cuda")
    # the memset branch: the same ids into more segments than the
    # one-launch branch takes (the extra segments stay zero)
    s_memset = oh.ROWSUM_MAX_CELLS // D + 1
    out = rows.new_empty((max(S, s_memset), D))
    want = oh.onehot_scatter_add_plain(ids, rows, S)

    def call_of(name):
        fn = fns[name]
        s_arg = s_memset if name == "memset" else S

        def call():
            err = fn(rows.data_ptr(), ids.data_ptr(), out.data_ptr(), N,
                     s_arg, D, 0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        return call

    calls = {name: call_of(name) for name in fns}
    for name in ("ship", "batch16", "branch", "spread16", "spread8",
                 "final_unroll8", "staged", "warps8", "memset"):
        calls[name]()
        torch.cuda.synchronize()
        err = float((out[:S] - want).abs().max())
        if err > 2e-5 * float(want.abs().max()):
            raise RuntimeError(f"{name} disagrees with the plain version")

    def graph_us(call, reps=100):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                call()
        g.replay()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) * 1e3 / reps

    res = {k: {"device_us": [], "graph_us": []} for k in calls}
    for r in range(args.rounds):
        for name in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            res[name]["device_us"].append(
                chip_smoke.device_profile(torch, calls[name])[0])
            res[name]["graph_us"].append(graph_us(calls[name]))
    for name, v in res.items():
        print(f"[rowsum_probe] card={card.replace(' ', '_')} N={N} S={S} "
              f"D={D} variant={name} device_us="
              f"{float(np.median(v['device_us'])):.2f} graph_us="
              f"{float(np.median(v['graph_us'])):.2f}", flush=True)

    host(torch, oh, fns, card, ids, rows, S, s_memset, args.rounds)


def dims_major_split(torch, chip_smoke, oh, card, source, rounds):
    """Device µs and operations per call (``torch.profiler``, the median
    of ``rounds`` in turns) of each variant of ``source``'s dims-major
    segment sum (:data:`SEGT_VARIANTS` where it has the one-launch kernel,
    else :data:`DM_VARIANTS`), called through its C entry with
    ``dims_major = 1``, at the six dims-major path shapes with the paths'
    camera ids; each variant that computes the sum (:data:`SEGT_WHOLE`)
    must agree with the plain version.  The cost of a phase is ``ship``
    less the variant without it."""
    import g2o_tpu_torch as g2o
    from g2o_tpu_torch.ops import chol_kernels as ck

    one_launch = "segment_sum_t_kernel" in open(source).read()
    fns = build(ck.BUILD_DIR, SEGT_VARIANTS if one_launch else DM_VARIANTS,
                source, "dm", "segment_sum_t_kernel" if one_launch
                else "scatter_add_kernel")
    path_ids = chip_smoke._path_ids(chip_smoke.load_implicit(torch, g2o))
    rng = np.random.default_rng(6)
    for kind in ("ladybug_dm", "stress_dm", "venice"):
        ids, S = path_ids[kind]
        N = ids.shape[0]
        for D in (9, 81):
            rows_t = torch.as_tensor(rng.standard_normal((D, N)),
                                     dtype=torch.float32, device="cuda")
            out = rows_t.new_empty((S, D))

            def call_of(fn):
                def call():
                    err = fn(rows_t.data_ptr(), ids.data_ptr(),
                             out.data_ptr(), N, S, D, 1,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"CUDA error {err}")
                return call

            calls = {name: call_of(fn) for name, fn in fns.items()}
            want = oh.onehot_scatter_add_t_plain(ids, rows_t, S)
            for name in (SEGT_WHOLE if one_launch else ("ship",)):
                calls[name]()
                torch.cuda.synchronize()
                if float((out - want).abs().max()) > 2e-5 * float(
                        want.abs().max()):
                    raise RuntimeError(f"{name} disagrees at {kind} D={D}")
            res = {k: [] for k in calls}
            ops = {}
            for r in range(rounds):
                for name in (list(calls) if r % 2 == 0
                             else list(calls)[::-1]):
                    us, ops[name] = chip_smoke.device_profile(torch,
                                                              calls[name])
                    res[name].append(us)
            print(f"[dm_split] card={card.replace(' ', '_')} path={kind} "
                  f"N={N} D={D} S={S} " + " ".join(
                      f"{k}:device_us={float(np.median(v)):.2f}/"
                      f"ops={ops[k]}" for k, v in res.items()), flush=True)


def host(torch, oh, fns, card, ids, rows, S, s_memset, rounds, reps=500):
    """Host µs per call (the host clock over ``reps`` calls back to back,
    then a synchronize; median of ``rounds`` in turns) of the pieces of a
    segment-sum call at the probe's shape: the wrapper, its entry point
    alone in each branch on an output made once (ctypes and the launch), a
    ``new_empty`` of the output, and ``index_add``."""
    import time

    N, D = rows.shape
    out = rows.new_empty((s_memset, D))
    stream = torch.cuda.current_stream().cuda_stream
    Z = rows.new_zeros((S + 1, D))
    one, plain = fns["ship"], fns["plain_launch"]
    pieces = {
        "wrapper": lambda: oh.onehot_scatter_add(ids, rows, S),
        "entry_one_launch": lambda: one(rows.data_ptr(), ids.data_ptr(),
                                        out.data_ptr(), N, S, D, 0, stream),
        "entry_plain_launch": lambda: plain(rows.data_ptr(), ids.data_ptr(),
                                            out.data_ptr(), N, S, D, 0,
                                            stream),
        "entry_memset": lambda: one(rows.data_ptr(), ids.data_ptr(),
                                    out.data_ptr(), N, s_memset, D, 0,
                                    stream),
        "new_empty": lambda: rows.new_empty((S, D)),
        "index_add": lambda: torch.index_add(Z, 0, ids, rows),
    }
    res = {k: [] for k in pieces}
    for r in range(rounds):
        for k in (list(pieces) if r % 2 == 0 else list(pieces)[::-1]):
            fn = pieces[k]
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            res[k].append((time.perf_counter() - t0) * 1e6 / reps)
            torch.cuda.synchronize()
    for k, v in res.items():
        print(f"[rowsum_probe] card={card.replace(' ', '_')} host piece={k} "
              f"host_us={float(np.median(v)):.2f}", flush=True)

if __name__ == "__main__":
    main()
