#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``g2o_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line of facts; any failure raises and the script
exits non-zero without printing a result:

1. device: requires a CUDA card; prints ``nvidia-smi``'s name and power limit;
2. build: compiles the CUDA kernels from ``g2o_tpu_torch/csrc`` with nvcc,
   one process per source, all started together;
3. kernels: K1 (batched Cholesky), K2 (batched forward substitution) and K3
   (batched backward substitution) against their plain PyTorch versions on
   the card, float32 and float64, at the test shapes, the shapes the two
   main paths give them and shapes that reach every branch of K1's and
   K2's tile DAG; times each kernel, its plain version and the one PyTorch
   call that computes the same function at those path shapes, in turns
   (K2 and K3 also at every single-column batch of the supernodal sweeps,
   (1|2|3|12|55, 144, 1)), and reads the device µs and the operations one
   call puts on the card (kernels, memsets, copies) with
   ``torch.profiler``.  Then K4 (segment sum) the same way, at the Pallas
   test shapes, an unsorted shape with out-of-range ids, and the two
   bundle adjustment paths' shapes with their real segment ids;
4. main path, PCG: sphere2500 (``data/sphere2500.g2o``), Huber(1.0),
   float32 on the card, ``optimize_fused`` with
   ``PCGSolver(precond="chunk2")`` for 50 iterations at most after a
   warm-up; the final chi2 must be within 1% of the reference g2o's chi2
   after 50 iterations, every chi2 finite, and K1 and K2 launched during the
   run; then K1 and K2 on the run's real coarse matrix (its first λ-trial)
   against their plain versions (``LLᵀ`` and ``L·L⁻¹`` residuals within 10×
   the plain versions'), the time per layer, and a save/reload round trip
   of the result;
5. main path, supernodal: the same problem with
   ``SupernodalCholeskySolver()``, the direct multifrontal solver; the same
   chi2 bound, and K1, K2 and K3 launched during the run; then the time of
   assembly + factorization, of one solve sweep and of the refinement step,
   and the relative residual of one solve at the final λ;
6. main path, bundle adjustment: the ladybug-scale BAL file
   (``data/bal_cache/bal-C49-P7000-K5-N1-S0.txt.gz``, no robust kernel) and
   the stress file (``balstress-…-seed0``, Huber 1.0), both with every
   camera free, float32 on the card, ``optimize_fused`` with
   ``SchurSolver(use_pallas=True)`` for 10 iterations after a warm-up; the
   chi2 after 10 iterations must be within 1% of the reference g2o's
   (Cholesky) chi2 after 10, every chi2 finite, and K4 launched once per
   λ-trial; then the time per layer (linearize, the B blocks, the pair
   products, K4, the Hpp build, the dense factor and solve, the
   back-substitution) and the relative residual of one solve;
7. kernels, gather and segment sum: the two kernels of
   ``g2o_tpu_torch/csrc/gather_segment.cu`` (the port of K5–K10) against
   their plain versions, float32 and float64, row-major and dims-major, at
   the Pallas test shape, unsorted shapes with out-of-range ids (among them
   20,000 and 70,000 segments, on each side of the segment sum's
   shared-memory limit; a ragged N and ids that start off 16 bytes, which
   take the dims-major gather's one-thread-per-edge branch), and the
   implicit Schur paths' shapes with their solvers' own ids (the
   slab-ordered camera ids of the dims-major Venice, ladybug and stress
   paths; the runtime-bucketed ladybug ids of its real rows); the
   gathers must give the plain version's bits, the sums agree within the
   tolerance; timed beside the plain version and one
   ``index_select``/``index_add`` at those path shapes, with the device µs
   and device operations of one call (``torch.profiler``); the row-major
   gather and segment sum (K7, K8) must put one operation on the card per
   call at the runtime-bucketed ladybug shape, the dims-major gather
   (K5/K10) and segment sum (K6/K9) at the three dims-major paths' shapes,
   where two calls of the sum must also give the same bits; and K7/K8 at
   the mixed sba path's shapes (phase 10): (49, 6) -> (E_pad, 6) gathers
   bit for bit, (E_pad, 6) -> (49, 6) and (E_pad, 36) -> (49, 36) sums
   (the latter past ``ROWSUM_MAX_CELLS``: a memset and the kernel);
   Then the Schur rows kernel (``onehot.schur_rows_t``, the dims-major
   ``S·v``'s Schur term per camera) and its tiled form past the
   shared-memory camera cap (``onehot.schur_rows_tiled_t``) on the three
   dims-major paths' own ``Bt``, ids and ``DinvT`` and at the benchmark's
   Venice and Final-13682 configurations (``SCHUR_ROWS_VENICE``,
   ``SCHUR_ROWS_FINAL``, drawn; Final past the cap, so the tiled form
   alone): each form against the plain version in float32 and float64,
   the same bits on two calls, one operation a call; timed in turns
   beside the plain version and the composition they replace (K5, the
   PyTorch products and slab sums, K6), with the bound over the
   observations and over every slab row (``[schur_rows]``);
8. main paths, implicit Schur: ``ImplicitSchurSolver`` with ``bench.py``'s
   settings, 10 LM iterations after a warm-up, float32, every camera free:
   ladybug, Venice (``bal-C800-P150000-K6``, with gauge deflation) and
   stress loaded with ``bucket_landmarks=True`` (the dims-major layout),
   and ladybug without it (``layout="bucketed"``, the runtime-bucketed
   layout); the chi2 after 10 iterations must be within 1% of the
   reference g2o's PCG chi2 after 10, every chi2 finite, and the gather and
   segment-sum kernels launched; then the time per layer (linearize, the
   per-trial setup, one CG iteration, the back-substitution) and the
   relative residual of one solve; on the runtime-bucketed problem also the
   difference from the explicit solver's step.  Then a dims-major path past
   the Schur rows kernel's camera cap (``TILED_PATH``: the benchmark's
   Final-13682 solver and scene rules at 6,000 cameras, built as
   ``portbench/bench.py`` builds it), whose tiled-form launches must equal
   its CG iterations (``[launches_ba_implicit_tiled]``).

9. main path, manhattan3500 (``bench.py``'s ``bench_manhattan``):
   ``create_manhattan(3500, seed=0)`` (3500 SE2 poses, 6565 edges), f32
   on the card, 60 fused LM iterations with ``PCGSolver(precond="chunk2",
   chunk_size=16, max_iter=32, tol=1e-2, precond_mode="every_k",
   precond_refresh_every=8)``: chi2 must fall within 1% of the reference
   g2o's lm_var chi2 after 30 iterations, and K1/K2 launch at (1, 672,
   672), the coarse level of 219 chunks × 3 = 657 columns padded to 672;
   K1/K2 on that run's real coarse matrix as on sphere2500; the same run
   with ``precond_mode="per_solve"`` beside it; then 6 Gauss-Newton
   iterations with the deep chunk2 CG from the LM plateau, which must
   reach the reference's lm_var chi2; then the exact phase at f64 from
   the original estimates, ``optimize_gn_host`` over ``HostCholSolver``
   (blocks on the card, the sparse factor on the host) and, beside it,
   ``optimize_fused_gn`` over ``SupernodalCholeskySolver`` all on the
   card, each of which must reach the reference's gn_var fixed point
   (+0.25) within 8 iterations, each traced as well (device ms per GN
   iteration); and a save/reload of the exact result.

10. main paths, sba (``g2o_tpu_torch/types/sba.py``): ba_demo's geometry
    as ``create_ba_scene(n_cameras=49, n_points=7000, seed=0)`` builds it
    (6,412 points, 218,655 observations), three problems: anchored inverse
    depth as ``examples/ba_anchored_inverse_depth.py`` builds it (3-ary
    ``EDGE_PROJECT_PSI2UV``, a third of the points anchored on free
    cameras), every third point kept out of the marginalization, and the
    points observed by stereo edges from even cameras and mono edges from
    odd ones (``bucket_landmarks=True``: the bucketed multi-observer
    branch, K7 and K8 in the CG body). Each: one f64 solve at the initial
    linearization against ``DenseSolver`` (≤ 1e-7; on the mixed path also
    the bucketed step against the ``rows`` step, ≤ 1e-10), 15 f64 LM
    iterations with the example's ``ImplicitSchurSolver(max_iter=150,
    tol=1e-8)``, then the same in f32 (``[main_path_<path>]``): its final
    chi2 within 1% of the f64 run's and 10× below the first; CG iterations
    and kernel launches per λ-trial (``[launches_<path>]``; inverse depth
    also the example's median world-point error; mixed also the f32 run at
    ``layout="rows"``).

11. the rest of the public API on the card: sphere2500 with vertex 0
    fixed (the reference CLI's gauge for a file without a FIX line),
    Huber 1.0 —
    ``Dogleg()`` over ``SupernodalCholeskySolver()`` through
    ``SparseOptimizer``, 50 iterations in f64 and in f32 (every chi2
    finite, the f32 final within 1% of the f64 final, K1/K2/K3 launched in
    the f32 run; the GN / SD / blend step counts; a 5-iteration trace),
    ``[main_path_dogleg]``; ``FusedLevenbergMarquardt`` over
    ``PCGSolver(precond="chunk2")`` for 5 iterations, equal to
    ``optimize_fused``'s first five chi2 within rtol 1e-6
    (``[fused_lm]``); ``SparseCholeskySolver`` in ``optimize_fused`` for 50
    f32 iterations (chi2 ≤ the phase 4 bound) and one f64 step at its final
    λ from the initial estimates against ``SupernodalCholeskySolver``'s
    (≤ 1e-8,
    ``[main_path_sparse_chol]``, ``[check_sparse_chol]``); then
    ``CGLSSolver(max_iter=200, eta=1e-4)`` on ladybug loaded with
    ``bucket_landmarks=True`` for 10 f32 iterations (chi2 ≤ the reference
    g2o's PCG chi2 after 10, +1%, and K5/K6 launched at least once per CG
    iteration, ``[main_path_cgls]``) and one f64 CGLS step (``eta=1e-16``)
    at λ = 1e-2 on each phase 10 problem against ``DenseSolver``
    (≤ 1e-6, ``[check_cgls_<path>]``); and the marginals: on sphere2500
    in f64 at λ = 1e-5 the ``takahashi`` blocks of all 2500 vertices, the
    ``sparse`` blocks of 16 vertices against them and one sparse cross
    block against the dense route's (≤ 1e-8); on ladybug in f64 the
    ``schur`` blocks of 4 cameras and 4 points against the ``dense``
    route's (≤ 1e-8), ``[marginals]``.

12. the remaining type libraries and the simulators: ``[check_types]``,
    every edge type of the slam3d additions, slam3d_addons,
    slam2d_addons, sclam2d, icp and sim3 — residuals and ``torch.func``
    Jacobians at 2·10⁴ random valid edges each, f64 on the card against the
    CPU (≤ 1e-10), and the Sim3 edge at errors on both sides of
    ``_sim3_W``'s 1e-7 thresholds (≤ 1e-8, the branches' cancellation);
    then two scenes built by the port's simulators with all nine sensors
    each: ``create_simulator3d(1000 poses, 800 landmarks, 30 lines, 12
    planes)`` (1,001 SE3 poses with the fixed calibration vertex, 638
    points, 31,555 edges, 8,076 dims) on ``SupernodalCholeskySolver`` and
    ``create_simulator2d(3500 poses, 1000 landmarks, 80 segments, 40
    lines)`` (4,428 vertices, 185,608 edges, 12,488 dims) on chunk2 PCG
    with the sphere path's settings.  Each is written with ``dumps`` and
    read back with ``loads`` (the text a fixed point, the chi2 the
    in-memory graph's within 1e-7, ``[load_sim*]``); from the generator's
    estimates moved by seeded tangent noise, one f64 step at LM's first
    λ against ``DenseSolver`` (≤ 1e-8, ``[check_sim*]``), 10 f64 LM
    iterations on ``SupernodalCholeskySolver`` (``[yardstick_sim*]``),
    then the f32 main path, 30 iterations after a warm-up
    (``[main_path_sim*]``: chi2 within 1% of the yardstick's and 10x
    below the first, K1/K2/K3 launched on the 3D scene and K1/K2 on the
    2D scene, per λ-trial counts; ``[trace_main_path_sim*]``), and K1/K2/K3
    timed at the shapes that run gave them (the 2D coarse level (1, 1152,
    1152) also held on its real coarse matrix).

13. the ``g2o`` command-line tool (``g2o_tpu_torch.apps.cli.main``, in
    this process so that the kernel counts see its launches) and the
    modules behind its modes: ``[cli_sphere]``, sphere2500 with ``-i 50
    -solver lm_supernodal -robustKernel Huber -fused`` in f32 (the CLI
    fixes vertex 0): chi2 within 1% of the reference g2o's, every chi2
    finite, K1/K2/K3 launched, the written file's chi2 the summary's
    within 1e-6; ``[cli_inc_manhattan]``, ``create_manhattan(3500,
    seed=0)`` written to a file and replayed with ``-inc -update 10
    -solver lm_pcg`` and a frozen chunk2 preconditioner in f32, with
    ``-gt data/manhattan3500_ref_opt.g2o``: chi2 within 1% of a cold batch
    ``optimize_fused`` over the same graph with the manhattan path's
    solver, K1/K2 launched, ATE/RPE, ms per update, and K1/K2 timed at the
    coarse shapes the updates gave them (``[kernels_inc]``);
    ``[guess_linear_manhattan]``, ``-guessLinear -solver gn_host_chol
    -fp64 -i 8`` on the same file: chi2 within 0.25 of the reference's
    gn_var fixed point, and ``solve_slam2d_linear``'s poses on the card
    the CPU's within 1e-8; ``[structure_only_ladybug]``: ladybug's points
    moved by seeded noise, ``structure_only_refine`` in f64: no landmark's
    chi2 up, the total cut 10x, each landmark's chi2 the CPU run's within
    1e-10 and the points within the CPU run's own spread under a 1e-16
    nudge of its start;
    ``[write_debug]``: a failed LM step on card tensors writes the dump
    with the JAX package's keys.

14. the fast loader, the other apps, the FLOP model and the examples:
    ``[fast_load]``, ``g2o_fast.load_problem`` on sphere2500 (Huber 1.0)
    and on the reference's manhattan optimum, its arrays bit for bit the
    object loader's, both loaders' host seconds; ``[fast_sphere]``, phase
    4's chunk2 LM from the fast-loaded problem (K1/K2 once per λ-trial),
    and from both loaders' problems under PyTorch's deterministic
    algorithms, the chi2 histories equal (≤ 1e-6);
    ``[hierarchical_manhattan|sphere]``, ``optimize_hierarchical`` with
    its defaults on ``create_manhattan(3500)`` and on sphere2500: stars and
    skeleton as a CPU run's, chi2 below half the start's and within 1.5x
    of 30 flat LM iterations, the seconds of each stage, f64 card against
    CPU on manhattan3500 (≤ 1e-6); ``[interactive_manhattan|sphere]``, the
    ``interactive_slam`` protocol replaying both (a solve every 500 poses;
    one solve): the final ``QUERY_STATE`` read back within 1e-8 of the
    estimates, ms per solve, recompiles, f64 card against CPU on the first
    1000 poses (≤ 1e-6); ``[convert_segment_line]`` and ``[anonymize]`` on
    phase 12's 2D scene (5 LM iterations cut the converted graph's chi2;
    the detached endpoints the JAX package's rule counts); ``[flops]``,
    the analytic FLOP model of the fast-loaded run and of the dims-major
    ladybug run, their share of the card's published peak in (0, 1); and
    ``[examples]``, all 16 scripts of ``g2o_tpu_torch/examples`` with
    ``-device cuda`` against ``-device cpu``.

15. the multi-process paths and mixed precision (``g2o_tpu_torch.parallel``,
    ``state_dtype``): the worker ``python -m g2o_tpu_torch.parallel.worker``
    as two Gloo processes, each rank's tensors on ``cuda:0`` (NCCL refuses
    two ranks on one card), and as one NCCL process, each rank counting its
    own kernel launches.  ``[sharded_sphere]``: sphere2500 (Huber 1.0,
    padded to 2 ranks), one f64 ``make_fused_step`` with chunk2 (K1/K2 at
    (1, 960, 960)) and jacobi PCG against the same step in one process
    (estimates within 1e-8, chi2 within 1e-10), then 5 f32 LM iterations
    of the main path's chunk2 PCG: ms per λ-trial unsharded, at two Gloo
    ranks and at one NCCL rank, all-reduce calls per trial and host ms per
    call; ``[sharded_manhattan]``: ``create_manhattan(3500, seed=7)`` over
    the ``(hosts=2, edges=1)`` mesh through ``shard_problem_data_global``,
    10 f64 ``optimize_fused`` iterations of ``PCGSolver(max_iter=100,
    tol=1e-10)``: the iteration counts the one-process run's, the chi2
    histories within 1e-8; ``[sharded_schur_ladybug]``: ladybug with
    ``SchurSolver(mesh=, use_pallas=True)``, one f64 solve against one
    process (dx within 1e-9), 10 f32 LM iterations (chi2 <= 49278.23, K4
    launched), and K4 held and timed at one rank's pair batch;
    ``[sharded_implicit_ladybug]``: ladybug with ``bucket_landmarks=True``,
    ``ImplicitSchurSolver`` in its dims-major layout, one f64 step against
    one process (estimates within 1e-8 relative, K5/K6 launched), and K5
    and K6 held and timed at one rank's slab rows; the landmark-bucketed
    layouts, each at two Gloo ranks and one NCCL rank with ms per λ-trial
    against one process, all-reduce calls per trial and host ms and KB per
    call, and its kernels launched on every rank — ``[sharded_runtime_
    ladybug]`` (ladybug built without ``bucket_landmarks``,
    ``ImplicitSchurSolver(layout="bucketed")``, the runtime-bucketed form:
    one f64 step against one process, estimates within 1e-8 relative and
    the stepped chi2 within 1e-10, 10 f32 LM iterations to chi2 <=
    49278.23, K7/K8), ``[sharded_cgls_ladybug]`` (ladybug with
    ``bucket_landmarks=True``, ``CGLSSolver``: one f64 solve, dx within
    1e-8 relative, 10 f32 LM iterations to <= 49278.23, K5/K6) and
    ``[sharded_mixed_sba]`` (phase 10's mixed mono/stereo map with
    ``bucket_landmarks=True``, the multi-observer form: the f64 step as
    above, 15 f32 LM iterations within phase 10's bar, 1% above its f64
    run's 522307.59, K7/K8) — then K7/K8 and
    K5/K6 held and timed at the ids rank 0 handed them; ``[mixed_manhattan]``:
    ``create_manhattan(3500, seed=0)`` compiled mixed (``dtype=float32,
    state_dtype=float64``), f64 and f32, 8 Gauss-Newton iterations over
    ``SupernodalCholeskySolver`` from the original estimates each, the
    mixed run going on in blocks of 8 until its chi2 is within 1e-4 of
    the f64 run's (48 iterations at most): all three beside the
    reference's gn_var, the iterations the mixed run took, ms per
    iteration (its panels reach no hand-written kernel);
    ``[done_parallel]``.

Each main path also runs ``TRACE_ITERS`` (2) LM iterations under
``torch.profiler`` and
prints a ``[trace_*]`` line: the card's busy time per λ-trial against the
untraced run's wall time per λ-trial, kernel launches per λ-trial and the
kernels with the most device time; on the supernodal path also K3's device
ms per λ-trial, on the dims-major implicit paths K5/K10's and K6/K9's.

The line before the last is a JSON object with one entry per kernel (its
launches on each main path, its error against its plain version, its time,
the plain version's and the library call's, and the least time the card
could take for the same work); the last line is
``{"ok": true, "device": {...}}``.
"""

import gzip
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATASET = os.path.join(HERE, "data", "sphere2500.g2o")
# the reference g2o's own chi2 after 50 LM iterations on this file
# (baseline_measured.json, sphere2500.chi2_after_50_iters), +1%
CHI2_BOUND = 29741.18 * 1.01
TOL = {"float32": 2e-5, "float64": 1e-11}   # max|Δ| / max|ref|
BAL = os.path.join(HERE, "data", "bal_cache")
# the bundle adjustment paths: file, Huber width, the reference g2o's chi2
# after 10 LM iterations with its Cholesky solver (baseline_measured.json
# ladybug_ba.chi2_after_10_iters, bal_stress.chi2_after_10_iters_chol) +1%,
# and its CPU seconds per LM iteration with that solver
BA_PATHS = {
    "ladybug": dict(
        file="bal-C49-P7000-K5-N1-S0.txt.gz", huber=0.0,
        bound=48790.33 * 1.01, ref_s_per_iter=0.0656),
    "stress": dict(
        file="balstress-depth_sigma0.8-estimate_noise1-hub_boost10-"
             "hub_fraction0.1-mean_obs_per_point6-n_cameras120-"
             "n_points30000-outlier_fraction0.07-pixel_noise1-seed0.txt.gz",
        huber=1.0, bound=13338643.1 * 1.01, ref_s_per_iter=0.6061),
}
LADYBUG, STRESS = BA_PATHS["ladybug"]["file"], BA_PATHS["stress"]["file"]
# the implicit Schur paths: file, Huber width, whether the file is loaded
# with bucket_landmarks, bench.py's solver settings, gauge deflation, the
# reference g2o's chi2 after 10 LM iterations with its PCG solver
# (baseline_measured.json ladybug_ba / venice_ba .chi2_after_10_iters,
# bal_stress.chi2_after_10_iters) +1%, and its CPU ms per LM iteration
# with PCG (.sec_per_lm_iter_pcg)
IMPLICIT_PATHS = {
    "": dict(file=LADYBUG, huber=0.0, bucket=True, deflate=False,
             solver=dict(max_iter=100, tol=1e-2, precond="jacobi",
                         matvec_precision="highest"),
             bound=48790.33 * 1.01, ref_ms=41.6),
    "_venice": dict(file="bal-C800-P150000-K6-N1-S0.txt.gz", huber=0.0,
                    bucket=True, deflate=True,
                    solver=dict(max_iter=100, tol=1e-2, precond="jacobi",
                                matvec_precision="auto"),
                    bound=1343704.04 * 1.01, ref_ms=7740.0),
    "_stress": dict(file=STRESS, huber=1.0, bucket=True, deflate=False,
                    solver=dict(max_iter=100, tol=1e-2,
                                precond="schur_jacobi",
                                matvec_precision="highest"),
                    bound=13338682.04 * 1.01, ref_ms=256.2),
    "_runtime": dict(file=LADYBUG, huber=0.0, bucket=False, deflate=False,
                     solver=dict(max_iter=100, tol=1e-2, precond="jacobi",
                                 layout="bucketed"),
                     bound=48790.33 * 1.01, ref_ms=41.6),
}
# the sba paths: ba_demo's geometry as create_ba_scene builds it at 49
# cameras and 7000 drawn points (6,412 seen by two or more cameras, 218,655
# observations), examples/ba_anchored_inverse_depth.py's solver and
# iteration count, the stereo edges' focal x baseline; the f64 check's
# solve runs CG to the rounding floor
SBA_SCENE = dict(n_cameras=49, n_points=7000, seed=0)
SBA_SOLVER = dict(max_iter=150, tol=1e-8)
SBA_ITERS = 15
SBA_TRACE_ITERS = 2         # the general path puts ~9k operations a trial
# the LM iterations each [trace_*] line profiles: the profiler costs ~0.6
# ms of host a device event, and five iterations of every path took 197 s
# of a full run on an NVIDIA H100 80GB HBM3 (700 W); two give the same
# per-trial rates
TRACE_ITERS = 2
SBA_BF = 75.0
SBA_PATHS = ("inverse_depth", "partial", "mixed")
SBA_CHECK_SOLVER = dict(max_iter=2000, tol=1e-13)
SBA_EDGES = ("EDGE_STEREO_SE3_PROJECT_XYZ:EXPMAP",
             "EDGE_SE3_PROJECT_XYZ:EXPMAP")
# the row-major wrappers (K7, K8) that put one operation per call on the
# card at the runtime-bucketed ladybug shape
RUNTIME_ONE_OP = ("onehot_gather", "onehot_scatter_add")
# the dims-major wrappers (K5/K10, K6/K9) that put one operation per call on
# the card at the three dims-major paths' shapes
DIMS_MAJOR_ONE_OP = ("onehot_gather_t", "onehot_scatter_add_t")
ONEHOT = ("onehot_gather", "onehot_gather_t", "onehot_scatter_add",
          "onehot_scatter_add_t", "schur_rows_t", "schur_rows_tiled_t")
# the JSON line's entry of each new kernel, and the wrappers that launch it
NEW_KERNELS = {"onehot_gather": ("onehot_gather", "onehot_gather_t"),
               "onehot_scatter_add": ("onehot_scatter_add",
                                      "onehot_scatter_add_t"),
               "schur_rows": ("schur_rows_t",),
               "schur_rows_tiled": ("schur_rows_tiled_t",)}
# the benchmark's Venice configuration (portbench/configs/bal-venice-1778
# .json): cameras, points, observations; the Schur rows kernel is timed on
# a slab layout drawn at these counts (tracks of 2 + Poisson(mean - 2))
SCHUR_ROWS_VENICE = (1778, 993923, 5001946)
# the benchmark's Final-13682 configuration (portbench/configs/bal-final-
# 13682.json), drawn the same way: past the Schur rows kernel's shared-
# memory camera cap (5,915 cameras at dp = 9 in float32), so its tiled form
SCHUR_ROWS_FINAL = (13682, 4456117, 28987644)
# a dims-major main path past that cap: the Final configuration's solver,
# scene rules and cold start at these counts (portbench/scene.py), LM
# iterations after a warm-up
TILED_PATH = dict(cameras=6000, points=100_000, observations=650_000,
                  iters=5)
# published H100 SXM peaks: HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# K1/K2/K3 against their plain versions: the Pallas test shapes, the
# paths' shapes, and shapes that reach every branch of K1's and K2's 64 x 64
# tile DAG: n one past a tile (65), a ragged large n with m != n and S > 1
# (1000 = 15 tiles + 40, m = 37 < one tile), a larger single matrix (1536)
SHAPES = [(7, 12, 5), (33, 48, 1), (5, 126, 96), (1, 960, 960),
          (1, 672, 672), (55, 144, 144), (55, 144, 192), (55, 144, 1),
          (1, 144, 1), (2, 144, 1), (3, 144, 1), (12, 144, 1),
          (3, 65, 65), (2, 1000, 37), (1, 1536, 1536)]
# (S, n, m) the main paths give the kernels: the chunk2 coarse level (K1,
# and K2 with B = I); the supernodal path's largest batch of 144-column
# panels (K1 on the diagonal panels, K2 on the below-panel blocks, K2 and
# K3 on the forward and backward sweeps)
TIMED = [(1, 960, 960), (55, 144, 144), (55, 144, 192), (55, 144, 1)]
# manhattan3500's chunk2 coarse level: K1 and K2 (B = I) only
COARSE_TIMED = [(1, 672, 672)]
# the supernodal sweeps' other single-column batches, K2 and K3 timed alone
# (S = 1 carries ten of each sweep's 17 K3 calls)
SWEEP_TIMED = [(1, 144, 1), (2, 144, 1), (3, 144, 1), (12, 144, 1)]
KERNELS = ("chol_batched", "solve_lower_batched", "solve_upper_batched",
           "segment_sum")
# manhattan3500 (baseline_measured.json manhattan3500): the reference g2o's
# lm_var chi2 after 30 LM iterations (phase 1 within 1% of it, phase 2 at
# or below it) and its gn_var fixed point (phase 3, +0.25 as bench.py)
MANHATTAN_LM = 9146.503719
MANHATTAN_GN = 9116.756453
# phase 11: Dogleg's iterations and trace; CGLS as the JAX package's
# defaults on ladybug and for the f64 step against DenseSolver on the
# phase 10 problems (to the rounding floor); the sparse Cholesky run; the
# marginals' damping, the sphere2500 vertices of the sparse route and the
# ladybug vertices of the schur route
DOGLEG_ITERS = 50
CGLS_SOLVER = dict(max_iter=200, eta=1e-4)
CGLS_CHECK_SOLVER = dict(max_iter=2000, eta=1e-16)
CGLS_CHECK_LAM = 1e-2
# the phase 10 problem whose f64 CGLS step is held to 1e-6 of the dense
# step: the bucketed one, whose camera slot runs K5/K6 in the CG loop.  The
# other two print theirs: η = 1e-16 stops CG at an error set by each
# system's conditioning (on an NVIDIA H100: 1.9e-7 on inverse depth,
# 1.3e-6 on partial), as the JAX package's CGLS does
CGLS_CHECK_PATH = "mixed"
CGLS_BOUND = 48790.33 * 1.01
MARGINAL_LAM = 1e-5
MARGINAL_SPARSE_VERTICES = 16
MARGINAL_BA_VERTICES = 4
# phase 12: the two simulator scenes with all nine sensors each, as the
# port's create_simulator3d / create_simulator2d build them.  Each scene's
# LM runs start from the generator's estimates moved by seeded tangent
# noise (SIM_START_SIGMA[scene] on every coordinate of every free vertex):
# the generator returns the true poses, whose chi2 is only 2-4x the
# optimum's, and the bar asks the runs to cut chi2 10x.  The noise puts
# the start 20-100x above the optimum while LM still converges within
# SIM_ITERS: on the 3D scene (rotation noise 0.005 rad) sigma = 0.05 left
# the f64 and f32 runs 2% apart and short of the optimum after 30
# iterations on an NVIDIA H100
SIM3D_SENSORS = ("odometry", "pose", "pose_offset", "se3prior", "trackxyz",
                 "depth", "disparity", "line3d", "plane")
SIM2D_SENSORS = ("odometry", "pose", "pointxy", "bearing", "pointxy_offset",
                 "segment", "segment_line", "segment_pointline", "line2d")
SIM_SCENES = {
    "sim3d": ("create_simulator3d", dict(
        n_poses=1000, n_landmarks=800, world_size=30.0, n_lines=30,
        n_planes=12, seed=0, sensors=SIM3D_SENSORS)),
    "sim2d": ("create_simulator2d", dict(
        n_poses=3500, n_landmarks=1000, world_size=75.0, n_segments=80,
        n_lines=40, seed=4, sensors=SIM2D_SENSORS)),
}
SIM_ITERS = 30
# the f64 supernodal yardstick's iterations: the f64 runs stopped at 16
# (3D) and 21 (2D) with chi2 at iteration 10 within 0.02% of the final on
# an NVIDIA H100 80GB HBM3 (700 W), well inside the main path's 1% bar
SIM_YARDSTICK_ITERS = 10
SIM_START_SIGMA = {"sim3d": 0.01, "sim2d": 0.05}
SIM_START_SEED = 100
# the 2D scene's solver: the sphere path's PCG settings; its f64 check
# runs CG to the rounding floor
SIM_PCG = dict(max_iter=50, tol=1e-1, precond="chunk2", chunk_size=16)
SIM_PCG_CHECK = dict(max_iter=5000, tol=1e-13, precond="chunk2",
                     chunk_size=16, absolute_tolerance=False)
# [check_types]: edges per type, and the (sigma, |omega|) pairs of the
# Sim3 error on both sides of _sim3_W's 1e-7 thresholds.  Just above the
# sigma threshold A = (e^sigma - 1)/sigma cancels: one ulp of exp moves W by
# ~eps/sigma = 5.5e-10 at sigma = 2e-7 (W is that far from its integral in
# the JAX package too, tests/test_torch_sim3.py), so card and CPU part by
# ~1e-9 there: those cases are held to SIM3_W_LIMIT, every random-state
# case to 1e-10 (ROADMAP C)
CHECK_TYPES_EDGES = 20_000
SIM3_W_CASES = ((0.0, 0.0), (5e-8, 5e-8), (2e-7, 5e-8), (5e-8, 2e-7),
                (2e-7, 2e-7), (1e-3, 0.3))
SIM3_W_LIMIT = 1e-8

# phase 13: the CLI runs.  The sphere run's iterations as phase 4; the
# incremental replay as the reference's g2o_incremental demo (an update
# every 10 vertices, one LM iteration each), with the frozen chunk2
# preconditioner of the JAX package's incremental warm start; the cold batch
# it is held to (within 1%) is the manhattan path's every_k LM.  The
# structure-only run moves ladybug's points by seeded noise (sigma 0.05 cuts
# chi2 33x on the CPU) and refines them for 10 iterations
CLI_INC_ARGS = ["-inc", "-update", "10", "-incIterations", "1",
                "-solver", "lm_pcg", "-solverProperties",
                "precond=chunk2,chunk_size=16,precond_mode=frozen"]
MANHATTAN_REF_OPT = os.path.join(HERE, "data", "manhattan3500_ref_opt.g2o")
# the replay's final chi2 is also held within 0.5% of the reference's gn_var
# fixed point (the cold batch LM plateaus up to 1% above it), and its ATE
# against the reference's optimum to INC_ATE_LIMIT: 4.776 on an NVIDIA H100
# 80GB HBM3 (700 W), where the batch LM stays at 35.8-36.3 from a start of
# 36.25 (pose graphs have flat modes that chi2 barely sees)
INC_GN_FACTOR = 1.005
INC_ATE_LIMIT = 5.0
# [trace_cli_inc]: the update path through the API over a window at the end
# of the replay: the first INC_WINDOW_START vertices added at once and
# brought near their optimum, then INC_WINDOW_TIMED timed updates of 10
# vertices (about three recompiles) and INC_WINDOW_TRACED traced ones that
# do not recompile
INC_WINDOW_START = 3000
INC_WINDOW_TIMED = 39
INC_WINDOW_TRACED = TRACE_ITERS
STRUCTURE_SIGMA = 0.05
STRUCTURE_SEED = 13
STRUCTURE_ITERS = 10
# the structure-only points card vs CPU, relative to the largest coordinate.
# A point seen from a short baseline has a nearly flat depth direction along
# which a one-ulp change moves the result by ~1e-9: the CPU run itself moves
# by 3.85e-9 when its start is nudged by 1e-16, and the card's index_add_
# sums in another order.  Card vs CPU read 1.51e-9-3.83e-9 in four runs on
# an NVIDIA H100 80GB HBM3 (700 W): the limit is 2.6x the largest.  Each
# landmark's chi2 is held to 1e-10
STRUCTURE_POINTS_LIMIT = 1e-8
# the keys of the JAX package's debug dump (g2o_tpu/utils/debug_dump.py) of
# a pose graph of VERTEX_SE2 vertices
DEBUG_KEYS = {"iteration", "lambda", "reason", "chi2", "b",
              "H_diag_VERTEX_SE2", "fixed_VERTEX_SE2",
              "tangent_dim_VERTEX_SE2"}

# phase 14: the fast loader, the apps, the FLOP model and the examples.
# [fast_sphere] runs phase 4's LM from the fast-loaded problem and from the
# object-loaded one (bit-equal arrays) under PyTorch's deterministic
# algorithms, their chi2 histories held to FAST_CHI2_RTOL, fused_lm's bar
# (without them the card's index_add_ adds in a run-dependent order: two
# runs parted by 1.39e-4 on the way down and 2.3e-6 at the end on an NVIDIA
# H100 80GB HBM3, 700 W).
# [hierarchical]: tests/test_hierarchical.py's bar (final chi2 within 1.5x
# 30 flat LM iterations); the f64 card run against the f64 CPU run (they
# read 2.9e-12 apart on manhattan3500 and 1.9e-12 on sphere2500 on an
# NVIDIA H100 80GB HBM3, 700 W; the interactive replays 1.8e-14 and
# 7.6e-15), held to 1e-6.
# [interactive]: a solve every INTER_EVERY poses; the QUERY_STATE text
# (%.9g) read back within INTER_PRINT_RTOL of the estimates; the f64 card
# and CPU replays cut to INTER_F64_POSES poses.  [examples]: each script's
# printed numbers on the card within EXAMPLE_RTOL (or one unit of the last
# printed digit) of its CPU run's
FAST_ITERS = 50
FAST_CHI2_RTOL = 1e-6
HIER_FLAT_FACTOR = 1.5
HIER_F64_RTOL = 1e-6
HIER_CPU_COUNT_ITERS = 1
INTER_EVERY = 500
INTER_F64_POSES = 1000
INTER_F64_RTOL = 1e-6
INTER_PRINT_RTOL = 1e-8
SEG_ITERS = 5
# (the examples whose LM solves with PCGSolver's default tol of 1e-6 print
# chi2 only as well as that tolerance holds it, and the card's f64
# index_add_ adds in a run-dependent order: plane_slam's card and CPU runs
# parted by 1.2e-6 and by 1.08e-5 at its second and third iterations in
# two runs on an NVIDIA H100 80GB HBM3, 700 W; they get EXAMPLE_PCG_RTOL)
EXAMPLE_RTOL = 1e-6
EXAMPLE_PCG_RTOL = 1e-4
EXAMPLES = (
    ("simple_optimize", ["{tmp}/sphere2500.g2o"], EXAMPLE_PCG_RTOL),
    ("create_sphere", ["{dir}/sphere.g2o"], EXAMPLE_RTOL),
    ("g2o_unfold", ["{tmp}/manhattan.g2o", "-maxCost", "1e9", "-gnudump",
                    "{dir}/dump.dat", "-o", "{dir}/out.g2o"],
     EXAMPLE_PCG_RTOL),
    ("circle_fit", [], EXAMPLE_RTOL), ("curve_fit", [], EXAMPLE_RTOL),
    ("odom_calibration", [], EXAMPLE_RTOL),
    ("tutorial_slam2d", [], EXAMPLE_PCG_RTOL),
    ("target_tracking", [], EXAMPLE_PCG_RTOL),
    ("gicp_demo", [], EXAMPLE_RTOL), ("line_slam", [], EXAMPLE_PCG_RTOL),
    ("plane_slam", [], EXAMPLE_PCG_RTOL), ("ba_demo", [], EXAMPLE_RTOL),
    ("sba_demo", [], EXAMPLE_RTOL), ("data_convert", [], EXAMPLE_RTOL),
    ("ba_anchored_inverse_depth", [], EXAMPLE_RTOL),
    ("bal_example", [], EXAMPLE_RTOL),
)

# phase 15: the ranks of the sharded runs (two Gloo processes on one card;
# NCCL refuses two ranks on one card, so its run has one), the bars of the
# sharded runs against the same computation in one process, the explicit
# Schur run's bound (the reference g2o's chi2 after 10 LM iterations +1%,
# PERF.md section 2), the mixed-precision run's iterations and its bar (the
# JAX package's test_mixed_precision.py).  From the original estimates the
# f32 supernodal solves slow Gauss-Newton down: on an NVIDIA H100 80GB HBM3
# (700 W) the mixed run stood 1.8e-3 to 4.3e-3 above the f64 run after 8
# iterations and 5.1e-4 after 16 (PERF.md section 6), so it runs in blocks
# of 8 until it is within the bar, MIXED_MAX_ITERS at most, and prints the
# iterations it took
PARALLEL_WORLD = 2
PARALLEL_TIMEOUT = 480
SHARDED_EST_ATOL = 1e-8           # __graft_entry__.py's sharded-step bar
SHARDED_CHI2_RTOL = 1e-10
SHARDED_HIST_RTOL = 1e-8
SHARDED_SCHUR_DX_ATOL = 1e-9      # test_sharded_schur_matches_single
SHARDED_IMPLICIT_RTOL = 1e-8
SHARDED_SCHUR_BOUND = 49278.23
SHARDED_ITERS = 10
SHARDED_MANHATTAN_POSES = 3500
# the landmark-bucketed layouts on sharded data: the float64 step's (or,
# CGLS, the solve's) bar against one process's, relative; the float32 LM
# runs' chi2 bounds — ladybug: SHARDED_SCHUR_BOUND; the mixed sba map:
# phase 10's bar, its f64 run's chi2 after SBA_ITERS iterations +1% (the
# f64 run reached 522307.59 and the f32 run 522307.56 on an NVIDIA H100
# 80GB HBM3, 700 W, so the converged value itself is no bar: f32 rounding
# moves it by 0.03); the mixed map's LM iterations, phase 10's SBA_ITERS
# (five left it at 1285623 there)
SHARDED_STEP_RTOL = 1e-8
SHARDED_STEP_CHI2_RTOL = 1e-10
SHARDED_MIXED_BOUND = 522307.59 * 1.01
SHARDED_SBA_ITERS = 15
# the worker cases of the two spawns
GLOO_CASES = "sphere,manhattan,schur,implicit,runtime,cgls,mixed_sba"
NCCL_CASES = "sphere,runtime,cgls,mixed_sba"
BUCKETED_RUNS = ("runtime", "cgls", "mixed_sba")
MIXED_ITERS = 8
MIXED_MAX_ITERS = 48
MIXED_RTOL = 1e-4

# the shape each kernel's entry in the JSON line reports
PRIMARY = {"chol_batched": (1, 960, 960),
           "solve_lower_batched": (1, 960, 960),
           "solve_upper_batched": (55, 144, 1)}


def phase(tag, **facts):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in facts.items()),
          flush=True)


def device_phase(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    return card


def _spd(rng, S, n):
    A = rng.standard_normal((S, n, n))
    return A @ A.transpose(0, 2, 1) + n * np.eye(n)


def _time_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _shape(S, n, m):
    return f"{S}x{n}x{m}"


def bound(name, shape, width=4, rhs_identity=False):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``name`` at ``shape`` in a ``width``-byte float type — the larger of
    the bytes it must move (each input read once, each output written once)
    over the memory rate, and its operations over the float32 rate.  The
    factorization and the triangular solves read only the lower triangle
    of their matrix, n(n+1)/2 values, and the factorization writes only
    the lower triangle of its factor.  Operations count a multiply-add as
    two, as the peak rate does: the factorization needs n³/6 multiply-adds,
    a triangular solve n²m/2, and one against ``B = I``
    (``rhs_identity``) n³/6: the inverse of a triangle is a triangle."""
    if name in ("segment_sum", "onehot_scatter_add", "onehot_gather"):
        # (N, D) rows and N int32 ids against an (S, D) table; the sum
        # adds N*D values, the gather only moves them
        N, D, S = shape
        nbytes = (N * D + S * D) * width + N * 4
        ops = 0 if name == "onehot_gather" else N * D
    else:
        S, n, m = shape
        tri = S * n * (n + 1) // 2
        if name == "chol_batched":
            nbytes, ops = 2 * tri * width, S * n ** 3 / 3
        else:                      # n²m/2 multiply-adds
            nbytes, ops = (tri + 2 * S * n * m) * width, S * n * n * m
            if rhs_identity:
                ops /= 3
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def device_profile(torch, fn, calls=10, tries=5):
    """``(device µs, device operations)`` per call of ``fn``, from the
    device-side events (kernels, memsets, copies) that ``torch.profiler``
    records over ``calls`` calls after one warm call.  The tracer may drop
    events of a window (on the H100, 9 of 10 one-kernel calls, and every
    event of a window, or more than half of a 270 µs kernel's three windows
    running), so a window with fewer events than calls (each call puts at
    least one operation on the card) is traced again, up to ``tries``
    times in all; the operations per call are the events per call of the
    fullest window, rounded, and the time per call its mean event's time
    times that count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    n, us = 0, 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in ev) > n:
            n = sum(e.count for e in ev)
            us = sum(e.self_device_time_total for e in ev)
        if n >= calls:
            break
    ops = round(n / calls)
    return (us / n * ops if n else 0.0), ops


def _in_turns(torch, fns, reps=20, rounds=2):
    """Median ms of each of ``fns`` ({which: fn}), timed in turns: the
    given order, then reversed, ``rounds`` times in all; ``reps`` calls per
    timing window."""
    t = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            t[k].append(_time_ms(torch, fns[k], reps))
    return {k: float(np.median(v)) for k, v in t.items()}


def kernel_phase(torch, ck):
    """Kernel vs plain on the card; returns ``{shape: {kernel: {max_abs_err,
    ms, plain_ms}}}`` at the path shapes (float32, the main paths' dtype)."""
    rng = np.random.default_rng(0)
    out = {}
    for dtype in (torch.float32, torch.float64):
        for S, n, m in SHAPES:
            timed = (KERNELS[:3] if (S, n, m) in TIMED else KERNELS[1:3]
                     if (S, n, m) in SWEEP_TIMED else KERNELS[:2]
                     if (S, n, m) in COARSE_TIMED else ())
            res = chol_shape_check(torch, ck, rng, dtype, (S, n, m), timed)
            if res:
                out[_shape(S, n, m)] = res
    return out


def chol_shape_check(torch, ck, rng, dtype, shape, timed, tag="kernels"):
    """K1/K2/K3 against their plain versions at ``shape`` = (S, n, m) on a
    random SPD batch (B = I when n == m), raising past ``TOL``; in float32
    also time the kernels of ``timed`` beside their plain versions and the
    library call, in turns, with their bound and the device µs and
    operations of one call.  Returns ``{kernel: facts}`` of the timed
    ones."""
    S, n, m = shape
    dname = str(dtype).split(".")[1]
    D = torch.as_tensor(_spd(rng, S, n), dtype=dtype, device="cuda")
    B = (torch.eye(n, dtype=dtype, device="cuda").expand(S, n, n)
         .contiguous() if n == m else
         torch.as_tensor(rng.standard_normal((S, n, m)), dtype=dtype,
                         device="cuda"))
    Lp = ck.chol_batched_plain(D).contiguous()
    # (kernel, plain version, the one library call)
    fns = {
        "chol_batched": (lambda: ck.chol_batched(D),
                         lambda: ck.chol_batched_plain(D),
                         lambda: torch.linalg.cholesky_ex(D)),
        "solve_lower_batched": (
            lambda: ck.solve_lower_batched(Lp, B),
            lambda: ck.solve_lower_batched_plain(Lp, B),
            lambda: torch.linalg.solve_triangular(Lp, B, upper=False)),
        "solve_upper_batched": (
            lambda: ck.solve_upper_batched(Lp, B),
            lambda: ck.solve_upper_batched_plain(Lp, B),
            lambda: torch.linalg.solve_triangular(Lp.mT, B, upper=True)),
    }
    err, rel = {}, {}
    for k, (kern, plain, _) in fns.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err[k] = (got - want).abs().max().item()
        rel[k] = err[k] / want.abs().max().item()
    ok = max(rel.values()) <= TOL[dname]
    phase(tag, dtype=dname, shape=_shape(S, n, m),
          chol_rel_err=f"{rel['chol_batched']:.3e}",
          solve_rel_err=f"{rel['solve_lower_batched']:.3e}",
          solve_upper_rel_err=f"{rel['solve_upper_batched']:.3e}",
          tol=TOL[dname], ok=ok)
    if not ok:
        raise RuntimeError(f"a kernel disagrees with its plain version at "
                           f"{dname} {(S, n, m)}: {rel}")
    res = {}
    if not timed or dtype != torch.float32:
        return res
    # in turns: plain, library, kernel, kernel, library, plain
    for k in timed:
        kern, plain, lib = fns[k]
        t = _in_turns(torch, {"plain_ms": plain, "library_ms": lib,
                              "ms": kern})
        b_ms, b_by = bound(k, (S, n, m), rhs_identity=n == m)
        dev_us, ops = device_profile(torch, kern)
        res[k] = dict(max_abs_err=err[k], ms=t["ms"], plain_ms=t["plain_ms"],
                      library_ms=t["library_ms"], bound_ms=b_ms,
                      bound_by=b_by, device_us_per_call=dev_us,
                      device_ops_per_call=ops)
    phase("kernel_times", shape=_shape(S, n, m), dtype=dname,
          **{f"{k}_ms": f"{v['ms']:.4f}" for k, v in res.items()},
          **{f"{k}_plain_ms": f"{v['plain_ms']:.4f}"
             for k, v in res.items()},
          **{f"{k}_library_ms": f"{v['library_ms']:.4f}"
             for k, v in res.items()},
          **{f"{k}_bound_ms": f"{v['bound_ms']:.4f}"
             for k, v in res.items()},
          **{f"{k}_device_us": f"{v['device_us_per_call']:.2f}"
             for k, v in res.items()},
          **{f"{k}_device_ops": v["device_ops_per_call"]
             for k, v in res.items()})
    return res


def segment_kernel_phase(torch, sk, ba):
    """K4 against its plain version on the card, float32 and float64, at the
    Pallas test shapes, an unsorted shape with out-of-range ids and each
    bundle adjustment path's shape with its solver's real (sorted) segment
    ids; times it, the plain version and ``index_add`` at the path shapes
    (float32, the paths' dtype), in turns.  Returns ``{shape: {...}}``."""
    rng = np.random.default_rng(1)
    cases = [((1000, 81, 37), None), ((5000, 16, 300), None),
             ((100, 128, 8), None), ((7, 4, 2), None),
             ((700, 200, 37), "out_of_range")]
    for name, (_, solver) in ba.items():
        seg = solver.aux["pair_seg"]
        cases.append(((seg.shape[0], solver._layout["dp"] ** 2,
                       solver._layout["n_uniq"]), name))
    out = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        for (N, D, S), kind in cases:
            if kind in ba:
                ids = ba[kind][1].aux["pair_seg"]
            else:
                lo, hi = (-3, S + 5) if kind == "out_of_range" else (0, S)
                ids = torch.as_tensor(rng.integers(lo, hi, N).astype(np.int32),
                                      device="cuda")
            V = torch.as_tensor(rng.standard_normal((N, D)), dtype=dtype,
                                device="cuda")
            got = sk.segment_sum(V, ids, S)
            want = sk.segment_sum_plain(V, ids, S)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            shape = f"{N}x{D}->{S}"
            ok = rel <= TOL[dname]
            phase("kernels", kernel="segment_sum", dtype=dname, shape=shape,
                  ids=kind or "random", rel_err=f"{rel:.3e}", tol=TOL[dname],
                  ok=ok)
            if not ok:
                raise RuntimeError(f"segment_sum disagrees with its plain "
                                   f"version at {dname} {shape}: {rel}")
            if kind in ba and dtype == torch.float32:
                Z = torch.zeros((S, D), dtype=dtype, device="cuda")
                t = _in_turns(torch, {
                    "plain_ms": lambda: sk.segment_sum_plain(V, ids, S),
                    "library_ms": lambda: torch.index_add(Z, 0, ids, V),
                    "ms": lambda: sk.segment_sum(V, ids, S)})
                b_ms, b_by = bound("segment_sum", (N, D, S))
                dev_us, ops = device_profile(
                    torch, lambda: sk.segment_sum(V, ids, S))
                out[shape] = {"segment_sum": dict(
                    max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                    library_ms=t["library_ms"], bound_ms=b_ms,
                    bound_by=b_by, device_us_per_call=dev_us,
                    device_ops_per_call=ops)}
                phase("kernel_times", kernel="segment_sum", path=kind,
                      shape=shape, dtype=dname, ms=f"{t['ms']:.4f}",
                      plain_ms=f"{t['plain_ms']:.4f}",
                      library_ms=f"{t['library_ms']:.4f}",
                      bound_ms=f"{b_ms:.4f}", bound_by=b_by,
                      device_us_per_call=f"{dev_us:.2f}",
                      device_ops_per_call=ops)
    return out


def _wall_ms(torch, fn, reps=5):
    """Synchronized host wall time of ``fn`` (ms, mean of ``reps`` after one
    warm call) and its last result."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        r = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, r


def layer_times(torch, p, solver, lam):
    """Time each layer alone at the final estimates (synchronized)."""
    lin_ms, lin = _wall_ms(torch, lambda: p.linearize_fn(p.data, p.estimates))
    pre_ms, minv = _wall_ms(torch,
                            lambda: solver.build_precond(p.data, lin, lam))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st = solver.cg(p.data, lin, lam, minv)
    torch.cuda.synchronize()
    cg_ms = (time.perf_counter() - t0) * 1e3
    return dict(linearize_ms=lin_ms, precond_build_ms=pre_ms,
                cg_ms_per_iteration=cg_ms / max(st["cg_iterations"], 1))


def _profile(run):
    """``run()`` under ``torch.profiler``: ``(its result, the device-side
    events as (µs, name, count) with the longest first, the kernel
    launches on the host)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run()
    ka = prof.key_averages()
    # device-side events only (kernels, memsets, copies): an operator's
    # entry also reports the time of the kernels it launched
    kern = sorted(((e.self_device_time_total, e.key, e.count) for e in ka
                   if e.device_type == DeviceType.CUDA), reverse=True)
    # kernel launches on the host, cooperative ones included
    launches = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cudaLaunchCooperativeKernel"))
    return res, kern, launches


def _top(kern, n=8):
    return ";".join(f"{k[:48].replace(' ', '_')}:{us / 1e3:.3f}ms/{c}"
                    for us, k, c in kern[:n])


def trace(g2o, p, est0, solver, tag, ms_per_trial, iters=None,
          watch=None):
    """``torch.profiler`` over ``iters`` LM iterations from ``est0``.  The
    tracer slows the host, so the busy share divides the traced device time
    per λ-trial by the UNtraced run's wall time per λ-trial.  ``watch``
    ({label: kernel-name substrings}) adds each label's device ms per
    λ-trial: the kernels whose name holds one of its substrings."""
    iters = TRACE_ITERS if iters is None else iters
    final = p.estimates
    p.set_estimates({t: v.clone() for t, v in est0.items()})
    res, kern, launches = _profile(
        lambda: g2o.optimize_fused(p, solver, iters))
    p.set_estimates(final)
    trials = sum(res["trials_per_iteration"])
    dev_ms = sum(k[0] for k in kern) / 1e3 / trials
    dev_ops = sum(k[2] for k in kern)
    phase(f"trace_{tag}", iterations=iters, lm_trials=trials,
          device_ms_per_lambda_trial=f"{dev_ms:.3f}",
          untraced_ms_per_lambda_trial=f"{ms_per_trial:.3f}",
          device_busy_share=f"{dev_ms / ms_per_trial:.4f}",
          kernel_launches_per_lambda_trial=f"{launches / trials:.1f}",
          device_ops_per_lambda_trial=f"{dev_ops / trials:.1f}",
          **{f"{label}_device_ms_per_lambda_trial": "{:.4f}".format(
              sum(us for us, key, _ in kern
                  if any(w in key for w in names)) / 1e3 / trials)
             for label, names in (watch or {}).items()},
          top=_top(kern))
    if not kern:
        raise RuntimeError(f"the {tag} trace shows no device time")


def trace_gn(p, est0, run, tag, ms_per_iteration, iters):
    """``torch.profiler`` over ``run(iters)``, a GN run of ``iters``
    iterations from ``est0``: device ms per GN iteration, and the busy
    share against the UNtraced run's wall ms per iteration."""
    final = p.estimates
    p.set_estimates({t: v.clone() for t, v in est0.items()})
    res, kern, launches = _profile(lambda: run(iters))
    p.set_estimates(final)
    n = max(res["iterations"], 1)
    dev_ms = sum(k[0] for k in kern) / 1e3 / n
    phase(f"trace_{tag}", iterations=res["iterations"],
          device_ms_per_gn_iteration=f"{dev_ms:.3f}",
          untraced_ms_per_gn_iteration=f"{ms_per_iteration:.3f}",
          device_busy_share=f"{dev_ms / ms_per_iteration:.4f}",
          kernel_launches_per_gn_iteration=f"{launches / n:.1f}",
          device_ops_per_gn_iteration=(
              f"{sum(k[2] for k in kern) / n:.1f}"),
          top=_top(kern))
    if not kern:
        raise RuntimeError(f"the {tag} trace shows no device time")


def _run_lm(torch, g2o, wrappers, p, est0, solver, tag, need,
            iters=50, chi2_bound=CHI2_BOUND, extra=None, watch=None,
            trace_iters=None, per_trial=()):
    """Warm up, then run ``optimize_fused(p, solver, iters)`` from ``est0``
    with every kernel count set to 0 just before; print the ``[tag]`` line
    (plus the ``extra`` facts) and raise unless every chi2 is finite, the
    final chi2 is within ``chi2_bound`` and each kernel of ``need``
    launched; then trace ``trace_iters`` iterations of it
    (``[trace_<tag>]``).  ``per_trial``: kernels whose launches per
    λ-trial the line adds, with the CG iterations per solve.  Returns the
    result and the launch counts of that run."""
    g2o.optimize_fused(p, solver, 2)                 # warm-up
    p.set_estimates({t: v.clone() for t, v in est0.items()})
    for w in wrappers.values():
        w.launches = 0
    res = g2o.optimize_fused(p, solver, iters)
    launches = {k: w.launches for k, w in wrappers.items()}
    chis = res["chi2_per_iteration"] + [res["chi2_final"]]
    n = res["iterations"]
    trials = sum(res["trials_per_iteration"])
    # LM stops early, as the reference does, when an iteration exhausts
    # its trials (f32 convergence); the histories then hold n < 50 entries,
    # the last of them a rejected iteration (its chi2 unchanged).  So the
    # time per λ-trial (one solve + one linearize) is the rate that stays
    # comparable between runs that stop at different iterations.
    rejected_last = res["chi2_final"] == res["chi2_per_iteration"][-1]
    phase(tag, iterations_requested=iters, iterations=n,
          accepted_iterations=n - rejected_last,
          ms_per_lm_iteration=f"{res['wall_s'] * 1e3 / max(n, 1):.3f}",
          ms_per_lambda_trial=f"{res['wall_s'] * 1e3 / max(trials, 1):.3f}",
          wall_s=f"{res['wall_s']:.3f}",
          cg_iterations_total=sum(res["cg_per_iteration"]),
          lm_trials_total=trials,
          chi2_0=f"{chis[0]:.4f}", chi2_10=f"{chis[min(10, n)]:.4f}",
          chi2_final=f"{res['chi2_final']:.4f}", bound=f"{chi2_bound:.2f}",
          **(extra or {}),
          **({"cg_iterations_per_solve": "{:.2f}".format(
              sum(res["cg_per_iteration"]) / max(trials, 1))}
             if per_trial else {}),
          **{f"{k}_per_lambda_trial": f"{launches[k] / max(trials, 1):.2f}"
             for k in per_trial},
          **{f"launches_{k}": v for k, v in launches.items()})
    if not all(math.isfinite(c) for c in chis):
        raise RuntimeError(f"non-finite chi2 on the {tag} run")
    if any(launches[k] < 1 for k in need):
        raise RuntimeError(f"a kernel was not launched on the {tag} run: "
                           f"{launches}")
    if not res["chi2_final"] <= chi2_bound:
        raise RuntimeError(f"{tag}: final chi2 {res['chi2_final']} after {n} "
                           f"iterations; need <= {chi2_bound}")
    trace(g2o, p, est0, solver, tag,
          res["wall_s"] * 1e3 / max(trials, 1), iters=trace_iters,
          watch=watch)
    return res, launches


def main_path_phase(torch, g2o, wrappers):
    """The PCG (chunk2) path and the supernodal path on sphere2500; returns
    the launch counts of each path's run."""
    from g2o_tpu_torch.io import g2o_format

    t0 = time.perf_counter()
    g = g2o_format.load(DATASET)
    g.set_robust_kernel("Huber", 1.0)
    p = g.compile(dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    phase("load", vertices=g.num_vertices, edges=g.num_edges,
          seconds=f"{time.perf_counter() - t0:.3f}")
    est0 = {t: v.clone() for t, v in p.estimates.items()}
    solver = g2o.PCGSolver(max_iter=50, tol=1e-1, precond="chunk2",
                           chunk_size=16)
    # keep the coarse matrix of the first λ-trial for coarse_matrix_check
    coarse = _keep_first_coarse(solver)
    res, launches = _run_lm(torch, g2o, wrappers, p, est0, solver,
                            "main_path",
                            need=("chol_batched", "solve_lower_batched"))
    del solver._assemble_coarse
    coarse_matrix_check(torch, coarse[0])
    n = res["iterations"]
    lt = layer_times(torch, p, solver, res["lambda_final"])
    phase("layers", **{k: f"{v:.3f}" for k, v in lt.items()},
          cg_iterations_per_lm_iteration=
          f"{sum(res['cg_per_iteration']) / max(n, 1):.2f}",
          cg_per_iteration=",".join(map(str, res["cg_per_iteration"])))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sphere2500_opt.g2o")
        g2o_format.save(g, path, estimates_by_vid=p.estimates_by_vid())
        g2 = g2o_format.load(path)
    g2.set_robust_kernel("Huber", 1.0)
    p2 = g2.compile(dtype=torch.float32, device="cuda")
    chi_back = float(p2.chi2_fn(p2.data, p2.estimates)[0])
    rel = abs(chi_back - res["chi2_final"]) / res["chi2_final"]
    phase("save_reload", chi2=f"{chi_back:.4f}", rel_diff=f"{rel:.3e}")
    if not rel <= 1e-3:
        raise RuntimeError("the saved result does not reload to its chi2")

    # the direct solver on the same problem, from the same start
    t0 = time.perf_counter()
    sn = g2o.SupernodalCholeskySolver().setup(p)
    torch.cuda.synchronize()
    groups = sn._static["groups"]
    phase("setup_supernodal", seconds=f"{time.perf_counter() - t0:.3f}",
          supernodes=sn.meta["n_supernodes"], levels=sn.meta["n_levels"],
          groups=len(groups), kernel_groups=sum(
              g["spb"] * 6 > 96 for g in groups),
          frontal_slots=sn._static["acc_T"])
    res_sn, launches_sn = _run_lm(torch, g2o, wrappers, p, est0, sn,
                                  "main_path_supernodal", need=KERNELS[:3],
                                  watch={"k3": ("solve_upper",)})
    lt = supernodal_layer_times(torch, p, sn, res_sn["lambda_final"])
    phase("layers_supernodal", **{k: f"{v:.3e}" if "residual" in k
                                  else f"{v:.3f}" for k, v in lt.items()})
    return {"chunk2": launches, "supernodal": launches_sn}


def _keep_first_coarse(solver):
    """Make ``solver`` keep the coarse matrix of its next assembly; returns
    the list it lands in.  ``del solver._assemble_coarse`` restores it."""
    coarse, assemble = [], solver._assemble_coarse

    def assemble_and_keep(*args):
        Hd = assemble(*args)
        if not coarse:
            coarse.append(Hd.clone())
        return Hd

    solver._assemble_coarse = assemble_and_keep
    return coarse


def _first_at_or_below(chis, bound):
    return next((i for i, c in enumerate(chis) if c <= bound), None)


def _launches(wrappers):
    return {k: w.launches for k, w in wrappers.items()}


def manhattan_path_phase(torch, g2o, wrappers):
    """``bench.py``'s ``bench_manhattan`` through the port's entry points:
    the f32 every_k LM phase, the f32 GN polish and the f64 exact phase
    (hybrid host Cholesky, and the all-card supernodal GN beside it).
    Returns the launch counts of the LM run and of the polish run."""
    from g2o_tpu_torch.io import g2o_format
    from g2o_tpu_torch.sim.generators import create_manhattan

    t0 = time.perf_counter()
    g = create_manhattan(n_poses=3500, seed=0)
    p = g.compile(dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    solver = g2o.PCGSolver(max_iter=32, tol=1e-2, precond="chunk2",
                           chunk_size=16, precond_mode="every_k",
                           precond_refresh_every=8)
    solver.setup(p)
    torch.cuda.synchronize()
    cfg = solver._chunk
    phase("load_manhattan", vertices=g.num_vertices, edges=g.num_edges,
          coarse_columns=cfg["ncd"], coarse_padded=cfg["ncd_pad"],
          seconds=f"{time.perf_counter() - t0:.3f}")
    if (g.num_vertices, g.num_edges, cfg["ncd_pad"]) != (3500, 6565, 672):
        raise RuntimeError("manhattan3500 is not 3500 poses / 6565 edges "
                           "with a 672-column coarse level")
    est0 = {t: v.clone() for t, v in p.estimates.items()}

    # phase 1: every_k LM; the coarse matrix of its first λ-trial is kept
    bound = MANHATTAN_LM * 1.01
    coarse = _keep_first_coarse(solver)
    res, launches = _run_lm(
        torch, g2o, wrappers, p, est0, solver, "manhattan",
        need=("chol_batched", "solve_lower_batched"), iters=60,
        chi2_bound=bound,
        watch={"k1k2": ("chol_tiles", "solve_lower_tiles")})
    del solver._assemble_coarse
    coarse_matrix_check(torch, coarse[0])
    plateau = {t: v.clone() for t, v in p.estimates.items()}
    n, trials = res["iterations"], sum(res["trials_per_iteration"])
    chis = res["chi2_per_iteration"] + [res["chi2_final"]]
    cross = _first_at_or_below(chis, bound)
    k12 = launches["chol_batched"] + launches["solve_lower_batched"]

    # the same run with a preconditioner built on every solve
    ps = g2o.PCGSolver(max_iter=32, tol=1e-2, precond="chunk2",
                       chunk_size=16)
    g2o.optimize_fused(p, ps, 2)
    p.set_estimates({t: v.clone() for t, v in est0.items()})
    before = _launches(wrappers)
    res_ps = g2o.optimize_fused(p, ps, 60)
    k12_ps = sum(wrappers[k].launches - before[k]
                 for k in ("chol_batched", "solve_lower_batched"))
    n_ps = res_ps["iterations"]
    trials_ps = sum(res_ps["trials_per_iteration"])
    chis_ps = res_ps["chi2_per_iteration"] + [res_ps["chi2_final"]]
    phase("main_path_manhattan", iterations=n, lm_trials=trials,
          ms_per_lambda_trial=f"{res['wall_s'] * 1e3 / max(trials, 1):.3f}",
          ms_per_lm_iteration=f"{res['wall_s'] * 1e3 / max(n, 1):.3f}",
          trials_per_iteration=f"{trials / max(n, 1):.3f}",
          cg_per_iteration=(
              f"{sum(res['cg_per_iteration']) / max(n, 1):.2f}"),
          first_iteration_within_bound=cross, bound=f"{bound:.2f}",
          chi2_final=f"{res['chi2_final']:.4f}",
          k1_k2_launches_per_lambda_trial=f"{k12 / 2 / max(trials, 1):.4f}",
          per_solve_ms_per_lambda_trial=
          f"{res_ps['wall_s'] * 1e3 / max(trials_ps, 1):.3f}",
          per_solve_ms_per_lm_iteration=
          f"{res_ps['wall_s'] * 1e3 / max(n_ps, 1):.3f}",
          per_solve_cg_per_iteration=
          f"{sum(res_ps['cg_per_iteration']) / max(n_ps, 1):.2f}",
          per_solve_first_iteration_within_bound=_first_at_or_below(
              chis_ps, bound),
          per_solve_chi2_final=f"{res_ps['chi2_final']:.4f}",
          per_solve_k1_k2_launches_per_lambda_trial=
          f"{k12_ps / 2 / max(trials_ps, 1):.4f}")
    if cross is None:
        raise RuntimeError(f"manhattan LM: chi2 {res['chi2_final']} never "
                           f"within {bound}")
    if not all(math.isfinite(c) for c in chis_ps):
        raise RuntimeError("non-finite chi2 on the per-solve manhattan run")

    # phase 2: GN polish with the deep chunk2 CG from the plateau
    deep = g2o.PCGSolver(max_iter=128, tol=1e-6, precond="chunk2",
                         chunk_size=16, carry_factor=0.01,
                         matvec_precision="highest")
    g2o.optimize_fused_gn(p, deep, 1)
    p.set_estimates({t: v.clone() for t, v in plateau.items()})
    for w in wrappers.values():
        w.launches = 0
    res2 = g2o.optimize_fused_gn(p, deep, 6)
    launches2 = _launches(wrappers)
    n2 = res2["iterations"]
    chis2 = res2["chi2_per_iteration"] + [res2["chi2_final"]]
    cross2 = _first_at_or_below(chis2, MANHATTAN_LM)
    phase("polish_manhattan", iterations=n2,
          ms_per_gn_iteration=f"{res2['wall_s'] * 1e3 / max(n2, 1):.3f}",
          cg_per_iteration=(
              f"{sum(res2['cg_per_iteration']) / max(n2, 1):.1f}"),
          cg=",".join(map(str, res2["cg_per_iteration"])),
          chi2=",".join(f"{c:.4f}" for c in chis2),
          first_iteration_at_or_below=cross2, bound=f"{MANHATTAN_LM}",
          **{f"launches_{k}": launches2[k] for k in KERNELS[:2]})
    if cross2 is None or not all(math.isfinite(c) for c in chis2):
        raise RuntimeError(f"manhattan GN polish: chi2 {chis2} never at or "
                           f"below {MANHATTAN_LM}")
    if min(launches2[k] for k in KERNELS[:2]) < 1:
        raise RuntimeError(f"K1/K2 not launched in the polish: {launches2}")

    # phase 3: the exact f64 phase from the original estimates
    gn_bound = MANHATTAN_GN + 0.25
    p64 = g.compile(dtype=torch.float64, device="cuda")
    est64 = {t: v.clone() for t, v in p64.estimates.items()}
    t0 = time.perf_counter()
    host = g2o.HostCholSolver().setup(p64)
    setup_s = time.perf_counter() - t0
    g2o.optimize_gn_host(p64, host, 2)
    p64.set_estimates({t: v.clone() for t, v in est64.items()})
    res3 = g2o.optimize_gn_host(p64, host, 8)
    exact = {t: v.clone() for t, v in p64.estimates.items()}
    chis3 = res3["chi2_per_iteration"] + [res3["chi2_final"]]
    cross3 = _first_at_or_below(chis3, gn_bound)
    walls, hosts = res3["iter_walls"], res3["host_walls"]
    n3 = res3["iterations"]

    p64.set_estimates({t: v.clone() for t, v in est64.items()})
    sn = g2o.SupernodalCholeskySolver()
    g2o.optimize_fused_gn(p64, sn, 1)
    p64.set_estimates({t: v.clone() for t, v in est64.items()})
    before = _launches(wrappers)
    res4 = g2o.optimize_fused_gn(p64, sn, 8)
    sn_launches = {k: wrappers[k].launches - before[k] for k in KERNELS[:3]}
    chis4 = res4["chi2_per_iteration"] + [res4["chi2_final"]]
    cross4 = _first_at_or_below(chis4, gn_bound)
    n4 = res4["iterations"]
    phase("exact_manhattan", dim=host._N, l_nnz=host._hc.lnz,
          setup_s=f"{setup_s:.3f}", iterations=n3,
          ms_per_gn_iteration=f"{res3['wall_s'] * 1e3 / max(n3, 1):.3f}",
          iter_ms=",".join(f"{w * 1e3:.2f}" for w in walls),
          card_side_wall_ms=",".join(f"{(w - h) * 1e3:.2f}"
                                     for w, h in zip(walls, hosts)),
          host_wall_ms=",".join(f"{h * 1e3:.2f}" for h in hosts),
          chi2=",".join(f"{c:.6f}" for c in chis3),
          first_iteration_within_bound=cross3, bound=f"{gn_bound:.6f}",
          ms_to_bound=(f"{sum(walls[:cross3]) * 1e3:.2f}"
                       if cross3 is not None else None),
          supernodal_iterations=n4,
          supernodal_ms_per_gn_iteration=
          f"{res4['wall_s'] * 1e3 / max(n4, 1):.3f}",
          supernodal_chi2=",".join(f"{c:.6f}" for c in chis4),
          supernodal_first_iteration_within_bound=cross4,
          supernodal_launches=",".join(f"{k}:{v}"
                                       for k, v in sn_launches.items()))
    if cross3 is None or cross4 is None:
        raise RuntimeError(f"manhattan exact phase: chi2 {chis3} (hybrid), "
                           f"{chis4} (supernodal); need <= {gn_bound}")
    trace_gn(p64, est64, lambda k: g2o.optimize_gn_host(p64, host, k),
             "exact_manhattan", res3["wall_s"] * 1e3 / max(n3, 1), 4)
    trace_gn(p64, est64, lambda k: g2o.optimize_fused_gn(p64, sn, k),
             "exact_manhattan_supernodal",
             res4["wall_s"] * 1e3 / max(n4, 1), 2)

    # the exact result saved and reloaded
    p64.set_estimates(exact)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "manhattan3500_opt.g2o")
        g2o_format.save(g, path, estimates_by_vid=p64.estimates_by_vid())
        g2 = g2o_format.load(path)
    p2 = g2.compile(dtype=torch.float64, device="cuda")
    chi_back = float(p2.chi2_fn(p2.data, p2.estimates)[0])
    rel = abs(chi_back - res3["chi2_final"]) / res3["chi2_final"]
    phase("save_reload_manhattan", chi2=f"{chi_back:.6f}",
          rel_diff=f"{rel:.3e}", limit="1e-6")
    if not rel <= 1e-6:
        raise RuntimeError("the saved manhattan result does not reload to "
                           "its chi2")
    return {"manhattan": launches, "manhattan_polish": launches2}


def coarse_matrix_check(torch, Hd):
    """K1 and K2 on the chunk2 path's real coarse matrix ``Hd`` (f32, its
    first λ-trial), against their plain versions: factor, form ``L⁻¹``
    (B = I), and hold ``max|LLᵀ − Hd| / max|Hd|`` and ``max|L·Y − I|``
    (products in float64) of the kernels within 10× the plain versions'."""
    from g2o_tpu_torch.ops import chol_kernels as ck

    n = Hd.shape[0]
    D = Hd[None].contiguous()
    eye = torch.eye(n, dtype=Hd.dtype, device=Hd.device)[None]
    H64, I64 = Hd.double(), torch.eye(n, dtype=torch.float64,
                                       device=Hd.device)
    res = {}
    for route, chol, solve in (
            ("kernel", ck.chol_batched, ck.solve_lower_batched),
            ("plain", ck.chol_batched_plain, ck.solve_lower_batched_plain)):
        L = chol(D).contiguous()
        Y = solve(L, eye)
        L64, Y64 = L[0].double(), Y[0].double()
        res[f"{route}_llt_residual"] = float(
            (L64 @ L64.T - H64).abs().max() / H64.abs().max())
        res[f"{route}_ly_residual"] = float((L64 @ Y64 - I64).abs().max())
    phase("coarse_matrix", n=n, dtype=str(Hd.dtype).split(".")[1],
          max_abs=f"{float(H64.abs().max()):.4e}",
          **{k: f"{v:.3e}" for k, v in res.items()}, limit="10x_plain")
    for which in ("llt", "ly"):
        got, ref = res[f"kernel_{which}_residual"], res[f"plain_{which}_residual"]
        if not (math.isfinite(got) and got <= 10 * ref):
            raise RuntimeError(f"K1/K2 on the real coarse matrix: {which} "
                               f"residual {got} against the plain {ref}")


def supernodal_layer_times(torch, p, solver, lam):
    """Time assembly + factorization, one forward/backward sweep and the
    refinement step alone at the final estimates and λ (synchronized), and
    the relative residual ``‖b − (H + λI)dx‖ / ‖b‖`` of the single sweep and
    of the refined solve, with ``hvp_operator`` (float32, as the solve), at
    the final λ and at λ = 1e-3 (the final λ of a run that stopped on a
    rejected iteration is large, and its system close to λI)."""
    data, aux, parts = p.data, solver.aux, solver._parts
    lin_ms, lin = _wall_ms(torch, lambda: p.linearize_fn(data, p.estimates))
    fac_ms, factors = _wall_ms(
        torch, lambda: solver._factor_fn(data, lin, lam, aux))
    bfull = parts["to_full"](p.split_tangent(lin.b))
    sweep_ms, _ = _wall_ms(torch,
                           lambda: parts["sweep"](factors, bfull, aux))
    hvp = p.hvp_operator(data, lin, precision="highest")

    def refine(factors, lam, x0):
        # as in the solve: the H·v operator is built, then one residual and
        # one sweep
        h = p.hvp_operator(data, lin, precision="highest")
        r = parts["residual"](data, lam, bfull, x0, h)
        return x0 + parts["sweep"](factors, r, aux)

    x0 = parts["sweep"](factors, bfull, aux)
    refine_ms, _ = _wall_ms(torch, lambda: refine(factors, lam, x0))
    solve_ms, dx = _wall_ms(torch, lambda: solver.solve(data, lin, lam))
    out = dict(linearize_ms=lin_ms, assemble_factor_ms=fac_ms,
               sweep_ms=sweep_ms, refine_step_ms=refine_ms,
               solve_ms=solve_ms, lam=lam)
    bn = float(bfull.norm())
    for tag, lm in (("final_lam", lam), ("lam_1e-3", 1e-3)):
        f = solver._factor_fn(data, lin, lm, aux)
        x0 = parts["sweep"](f, bfull, aux)
        x1 = refine(f, lm, x0)
        for which, x in (("one_sweep", x0), ("refined", x1)):
            rel = float(parts["residual"](data, lm, bfull, x, hvp).norm()) / bn
            if not math.isfinite(rel):
                raise RuntimeError(f"non-finite supernodal solve at λ={lm}")
            out[f"rel_residual_{which}_{tag}"] = rel
    if not bool(torch.isfinite(dx).all()):
        raise RuntimeError("non-finite supernodal solve at the final λ")
    return out


def load_ba(torch, g2o):
    """The bundle adjustment problems, float32 on the card, each with its
    ``SchurSolver(use_pallas=True)`` set up: ``{name: (problem, solver)}``."""
    import io as _io

    from g2o_tpu_torch.io import bal

    out = {}
    for name, cfg in BA_PATHS.items():
        t0 = time.perf_counter()
        path = os.path.join(BAL, cfg["file"])
        with gzip.open(path, "rt") as fh:
            text = fh.read()
        p = bal.load_bal_problem(_io.StringIO(text), huber=cfg["huber"],
                                 fix_first_camera=False, dtype=torch.float32)
        t1 = time.perf_counter()
        solver = g2o.SchurSolver(use_pallas=True).setup(p)
        torch.cuda.synchronize()
        lay = solver._layout
        phase(f"load_ba_{name}", file=cfg["file"][:40],
              cameras=p.counts["VERTEX_CAMERA_BAL"],
              points=p.counts["VERTEX_TRACKXYZ"], observations=p.num_edges,
              schur_pairs=lay["n_pairs"], camera_pairs=lay["n_uniq"],
              reduced_dim=lay["Tp"], load_seconds=f"{t1 - t0:.3f}",
              setup_seconds=f"{time.perf_counter() - t1:.3f}")
        out[name] = (p, solver)
    return out


def ba_main_path_phase(torch, g2o, wrappers, ba):
    """The Schur path on each bundle adjustment problem; returns the launch
    counts of each path's run."""
    by_path = {}
    for name, (p, solver) in ba.items():
        cfg = BA_PATHS[name]
        suffix = "" if name == "ladybug" else f"_{name}"
        tag = f"main_path_ba{suffix}"
        est0 = {t: v.clone() for t, v in p.estimates.items()}
        res, launches = _run_lm(
            torch, g2o, wrappers, p, est0, solver, tag, need=("segment_sum",),
            iters=10, chi2_bound=cfg["bound"], extra=dict(
                reference_g2o_cpu_cholesky_ms_per_iteration=(
                    f"{cfg['ref_s_per_iter'] * 1e3:.1f}")))
        trials = sum(res["trials_per_iteration"])
        if launches["segment_sum"] != trials:
            raise RuntimeError(f"{tag}: K4 launched {launches['segment_sum']} "
                               f"times in {trials} λ-trials")
        lt = ba_layer_times(torch, p, solver, res["lambda_final"])
        phase(f"layers_ba{suffix}", **{
            k: f"{v:.3e}" if "residual" in k or k.startswith("lam")
            else f"{v:.3f}" for k, v in lt.items()})
        by_path[tag] = launches
    return by_path


def ba_layer_times(torch, p, solver, lam):
    """Time each layer of the Schur path alone at the final estimates and
    λ (synchronized), and the relative residual
    ``‖b − (H + λI)dx‖ / ‖b‖`` of one solve, with ``hvp_operator``, at
    λ₀ = 1e-5·max|H_jj| of the final linearization (the λ an LM run starts
    from): the final λ follows the last accepted step down and may lie
    below what a float32 factorization of the free-gauge system takes."""
    from g2o_tpu_torch.core.optimizer import _max_abs_diag

    data, aux, parts = p.data, solver.aux, solver._parts
    out = {}
    out["linearize_ms"], lin = _wall_ms(
        torch, lambda: p.linearize_fn(data, p.estimates))
    out["build_B_ms"], B = _wall_ms(torch, lambda: parts["build_B"](data, lin))
    out["landmark_inverse_ms"], Dinv = _wall_ms(
        torch, lambda: parts["landmark_dinv"](lin, lam, aux))
    out["pair_products_ms"], M = _wall_ms(
        torch, lambda: parts["pair_products"](B, Dinv, aux))
    out["k4_segment_sum_ms"], _ = _wall_ms(
        torch, lambda: parts["aggregate"](M, aux))
    out["build_Hpp_ms"], _ = _wall_ms(
        torch, lambda: parts["build_Hpp"](data, lin, lam, aux))
    out["reduced_parts_ms"], (H, bs, B, Dinv) = _wall_ms(
        torch, lambda: solver._reduced_parts_fn(data, lin, lam, aux))
    out["factor_solve_ms"], dxp = _wall_ms(
        torch, lambda: parts["factor_solve"](H, bs))
    out["back_substitute_ms"], _ = _wall_ms(
        torch, lambda: parts["back_substitute"](lin, B, Dinv, dxp, aux))
    out["solve_ms"], dx = _wall_ms(torch, lambda: solver.solve(data, lin, lam))
    out["final_lam_solve_finite"] = float(bool(torch.isfinite(dx).all()))
    lam0 = 1e-5 * float(_max_abs_diag(p, lin))
    dx = solver.solve(data, lin, lam0)
    hvp = p.hvp_operator(data, lin)
    Hdx = p.join_tangent(hvp(p.split_tangent(dx))) + lam0 * dx
    rel = float((lin.b - Hdx).norm() / lin.b.norm())
    if not math.isfinite(rel):
        raise RuntimeError(f"non-finite Schur solve at λ₀ = {lam0}")
    out["rel_residual_at_lam0"] = rel
    out["lam"] = lam
    out["lam0"] = lam0
    return out


def load_implicit(torch, g2o):
    """The implicit Schur problems, float32 on the card, each with its
    solver set up: ``{suffix: (problem, solver, initial estimates)}``."""
    import io as _io

    from g2o_tpu_torch.io import bal
    from g2o_tpu_torch.types.bal import bal_gauge_basis

    out = {}
    for suffix, cfg in IMPLICIT_PATHS.items():
        t0 = time.perf_counter()
        with gzip.open(os.path.join(BAL, cfg["file"]), "rt") as fh:
            text = fh.read()
        p = bal.load_bal_problem(_io.StringIO(text), huber=cfg["huber"],
                                 fix_first_camera=False, dtype=torch.float32,
                                 bucket_landmarks=cfg["bucket"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kw = dict(cfg["solver"])
        if cfg["deflate"]:
            kw["deflate_basis"] = bal_gauge_basis(p)
        solver = g2o.ImplicitSchurSolver(**kw).setup(p)
        torch.cuda.synchronize()
        lay = solver._layout
        phase(f"load_ba_implicit{suffix}", file=cfg["file"][:40],
              cameras=p.counts["VERTEX_CAMERA_BAL"],
              points=p.counts["VERTEX_TRACKXYZ"], observations=p.num_edges,
              layout=lay["form"], buckets=sum(lay["buckets"].values()),
              slab_rows=sum(lay["slab_rows"].values()),
              load_seconds=f"{t1 - t0:.3f}",
              setup_seconds=f"{time.perf_counter() - t1:.3f}")
        out[suffix] = (p, solver, {t: v.clone()
                                   for t, v in p.estimates.items()})
    return out


def _path_ids(implicit, sba):
    """``{kind: (ids, S, widths)}``: the camera ids the implicit paths hand
    the gather and segment-sum kernels and the row widths they gather and
    sum (the camera's tangent dim and its square) — the slab-ordered ids of
    the three dims-major paths (Venice, ladybug, stress), the
    runtime-bucketed ladybug ids (its real rows in slab order), and the
    slab-ordered ids of the mixed sba path's stereo and mono batches."""
    name, cam = "EDGE_OBSERVATION_BAL", "VERTEX_CAMERA_BAL"
    out = {}
    for kind, suffix in (("venice", "_venice"), ("ladybug_dm", ""),
                         ("stress_dm", "_stress")):
        p, _, _ = implicit[suffix]
        nb = p.bucket_specs[name].n_rows
        out[kind] = (p.data.plans[name]["ids32"][0, :nb], p.counts[cam],
                     (9, 81))
    p, solver, _ = implicit["_runtime"]
    out["ladybug_runtime"] = (solver._rows_here(p.data, name)[2],
                              p.counts[cam], (9, 81))
    p = sba["mixed"]["p32"]
    for kind, name in zip(("mixed_stereo", "mixed_mono"), SBA_EDGES):
        sp = p.bucket_specs[name]
        out[kind] = (p.data.plans[name]["ids32"][sp.pose_slot, :sp.n_rows],
                     p.counts["VERTEX_SE3:EXPMAP"], (6, 36))
    return out


def onehot_kernel_phase(torch, oh, implicit, sba):
    """The gather and segment-sum kernels against their plain versions on
    the card, float32 and float64, in both layouts, at the Pallas test
    shape (ids up to S+3), unsorted shapes with ids in [-3, S+5) and the
    implicit paths' shapes with their solvers' ids (D = 9 for the camera
    states, b and the CG vectors, D = 81 for the camera diagonal blocks; on
    the mixed sba path D = 6 and 36, where only K7 at D = 6 and K8 are
    timed);
    at the path shapes in float32 times kernel, plain version and one
    ``index_select`` / ``index_add`` into ``S+1`` rows, in turns (six
    windows of 200 calls a side, the median), with the device µs and
    operations of one call.  Returns
    ``{shape: {kernel: {...}}}``."""
    rng = np.random.default_rng(2)
    path_ids = _path_ids(implicit, sba)
    # the segment sum keeps a shared accumulator while one column of S
    # values fits 96 KB (S <= 24576 in float32, 12288 in float64) and adds
    # into global memory above: S = 20000 lies below in float32 and above
    # in float64, S = 70000 above in both
    # the dims-major gather takes 16-byte groups of edges only where N is a
    # multiple of 4 (f32) or 2 (f64) and the ids are 16-byte aligned: a
    # ragged N and ids that start one int into their tensor reach its
    # one-thread-per-edge branch
    cases = [(700, 37, 5, "pallas_test"), (5000, 300, 81, "out_of_range"),
             (300000, 20000, 9, "wide_s"), (300000, 70000, 9, "wide_s"),
             (40001, 120, 9, "ragged"), (40000, 120, 9, "misaligned")]
    for kind, (ids, S, widths) in path_ids.items():
        cases += [(ids.shape[0], S, D, kind) for D in widths]
    out = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        for N, S, D, kind in cases:
            if kind in path_ids:
                ids = path_ids[kind][0]
            else:
                lo, hi = (0, S + 3) if kind == "pallas_test" else (-3, S + 5)
                off = int(kind == "misaligned")
                ids = torch.as_tensor(rng.integers(lo, hi, N + off)
                                      .astype(np.int32), device="cuda")[off:]
            table = torch.as_tensor(rng.standard_normal((S, D)), dtype=dtype,
                                    device="cuda")
            rows = torch.as_tensor(rng.standard_normal((N, D)), dtype=dtype,
                                   device="cuda")
            rows_t = rows.T.contiguous()
            fns = {   # wrapper: (kernel, plain version)
                "onehot_gather": (
                    lambda: oh.onehot_gather(ids, table),
                    lambda: oh.onehot_gather_plain(ids, table)),
                "onehot_gather_t": (
                    lambda: oh.onehot_gather_t(ids, table),
                    lambda: oh.onehot_gather_t_plain(ids, table)),
                "onehot_scatter_add": (
                    lambda: oh.onehot_scatter_add(ids, rows, S),
                    lambda: oh.onehot_scatter_add_plain(ids, rows, S)),
                "onehot_scatter_add_t": (
                    lambda: oh.onehot_scatter_add_t(ids, rows_t, S),
                    lambda: oh.onehot_scatter_add_t_plain(ids, rows_t, S)),
            }
            rel, err, same = {}, {}, {}
            for k, (kern, plain) in fns.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                err[k] = (got - want).abs().max().item()
                rel[k] = err[k] / max(want.abs().max().item(), 1e-300)
                same[k] = torch.equal(got, want)
            # the gathers move values: they must give the plain version's
            # bits, the sums agree within TOL
            ok = max(rel.values()) <= TOL[dname] and all(
                same[k] for k in fns if "gather" in k)
            shape = f"{N}x{D}<->{S}"
            phase("kernels", kernel="gather+segment_sum", dtype=dname,
                  shape=shape, ids=kind,
                  **{f"{k}_rel_err": f"{v:.3e}" for k, v in rel.items()},
                  gathers_bit_equal=all(same[k] for k in fns
                                        if "gather" in k),
                  tol=TOL[dname], ok=ok)
            if not ok:
                raise RuntimeError(f"a gather/segment-sum kernel disagrees "
                                   f"with its plain version at {dname} "
                                   f"{shape} ({kind}): {rel}, bit-equal "
                                   f"{same}")
            if kind not in path_ids or dtype != torch.float32:
                continue
            # the mixed sba path runs the row-major kernels only: K7 on its
            # (49, 6) camera states, K8 on rows of 6 and 36
            timed = fns if not kind.startswith("mixed") else (
                RUNTIME_ONE_OP if D == 6 else ("onehot_scatter_add",))
            # the library call: index_select / index_add over S+1 rows, the
            # last a zero row (an out-of-range id S reads zero)
            tz = torch.cat([table, table.new_zeros((1, D))])
            tzt = tz.T.contiguous()
            Z, Zt = tz.new_zeros((S + 1, D)), tz.new_zeros((D, S + 1))
            lib = {"onehot_gather": lambda: torch.index_select(tz, 0, ids),
                   "onehot_gather_t": lambda: torch.index_select(tzt, 1, ids),
                   "onehot_scatter_add": lambda: torch.index_add(Z, 0, ids,
                                                                 rows),
                   "onehot_scatter_add_t": lambda: torch.index_add(
                       Zt, 1, ids, rows_t)}
            for k in timed:
                kern, plain = fns[k]
                # a call here is 15-25 µs of host time, and windows of the
                # shared host vary by a third: 200 calls per window and the
                # median of six windows a side
                t = _in_turns(torch, {"plain_ms": plain,
                                      "library_ms": lib[k], "ms": kern},
                              reps=200, rounds=6)
                dev_us, ops = device_profile(torch, kern)
                entry = "onehot_gather" if "gather" in k else \
                    "onehot_scatter_add"
                b_ms, b_by = bound(entry, (N, D, S))
                key = f"{kind}:{k}:{shape}"
                out[key] = {entry: dict(
                    max_abs_err=err[k], ms=t["ms"], plain_ms=t["plain_ms"],
                    library_ms=t["library_ms"], bound_ms=b_ms, bound_by=b_by,
                    device_us_per_call=dev_us, device_ops_per_call=ops)}
                phase("kernel_times", kernel=k, path=kind, shape=shape,
                      dtype=dname, ms=f"{t['ms']:.4f}",
                      plain_ms=f"{t['plain_ms']:.4f}",
                      library_ms=f"{t['library_ms']:.4f}",
                      bound_ms=f"{b_ms:.4f}", bound_by=b_by,
                      device_us_per_call=f"{dev_us:.2f}",
                      device_ops_per_call=ops)
                # K7 and K8 at the runtime-bucketed shape, K5/K10 and K6/K9
                # at the dims-major paths': one operation on the card per
                # call (no memset or copy beside the kernel); K6/K9's sums
                # the same bits on two calls.  On the mixed path K7 is one
                # operation, K8 one up to S·D = ROWSUM_MAX_CELLS and a
                # memset and the kernel past it
                one_op = (k in RUNTIME_ONE_OP if kind == "ladybug_runtime"
                          else k in DIMS_MAJOR_ONE_OP)
                if kind.startswith("mixed"):
                    want = (2 if k == "onehot_scatter_add"
                            and S * D > oh.ROWSUM_MAX_CELLS else 1)
                    if ops != want:
                        raise RuntimeError(f"{k} at {shape} ({kind}) puts "
                                           f"{ops} operations on the card "
                                           f"per call, not {want}")
                elif one_op and (D == 9 or kind != "ladybug_runtime") and \
                        ops != 1:
                    raise RuntimeError(f"{k} at {shape} puts {ops} "
                                       f"operations on the card per call")
                if k == "onehot_scatter_add_t":
                    same = torch.equal(kern(), kern())
                    phase("kernel_bits", kernel=k, path=kind, shape=shape,
                          dtype=dname, same_bits_on_two_calls=same)
                    if not same:
                        raise RuntimeError(f"{k} at {shape} ({kind}) gives "
                                           f"other bits on a second call")
    return out


def schur_rows_synthetic(torch, C, P, O, seed=0):
    """Schur rows inputs ``(counts, degrees, Bt, ids, DinvT, v)``, float32,
    at C cameras, P points and O observations, and the observations drawn:
    tracks of 2 + Poisson(O/P - 2) observations bucketed as
    ``build_problem`` buckets them, random B (zero on padding rows, as W = 0
    makes it), random camera ids, ``DinvT`` a dims-major view of row-major
    blocks (as ``inv_small_t`` gives it)."""
    from g2o_tpu_torch.ops.bucketed import bucket_by_segment

    rng = np.random.default_rng(seed)
    deg = 2 + rng.poisson(O / P - 2, P)
    plan = bucket_by_segment(np.repeat(np.arange(P), deg), P)
    n, S = len(plan.perm_src), len(plan.seg_perm)
    g = torch.Generator(device="cuda").manual_seed(seed)
    Bt = torch.randn((9, 3, n), generator=g, device="cuda")
    Bt *= torch.as_tensor(plan.perm_src < deg.sum(), device="cuda")
    ids = torch.as_tensor(rng.integers(0, C, n).astype(np.int32),
                          device="cuda")
    DinvT = torch.randn((S, 3, 3), generator=g, device="cuda").movedim(0, -1)
    v = torch.randn((C, 9), generator=g, device="cuda")
    return (plan.counts, plan.degrees, Bt, ids, DinvT, v), int(deg.sum())


def schur_rows_path_inputs(torch, p, solver, lam=1e-3):
    """The Schur rows inputs of a dims-major implicit solve of ``p``: its
    own ``Bt``, ids and ``DinvT`` at ``lam``, and a random camera vector;
    and its observations."""
    name = "EDGE_OBSERVATION_BAL"
    ctx = solver._parts["landmark_system"](
        p.data, p.linearize_fn(p.data, p.estimates), lam, solver.aux)
    spec = p.bucket_specs[name]
    v = torch.randn((p.counts["VERTEX_CAMERA_BAL"], 9), device="cuda")
    return (spec.counts, spec.degrees, ctx["Bt"][name],
            solver._rows_here(p.data, name)[2], ctx["DinvT"][name],
            v), p.num_edges


def schur_rows_phase(torch, oh, cases):
    """The Schur rows kernel (the S·v Schur term per camera) at each case
    (``{tag: (float32 inputs, observations)}``) in each of its forms that
    takes the case: the shared-memory form (``schur_rows_t``, where
    ``schur_rows_fits``) and the tiled form (``schur_rows_tiled_t``, at
    every camera count).  Each form against the plain version in float32
    and float64 (the inputs cast) within TOL, two calls the same bits, one
    operation on the card a call; then, float32, in turns (six windows of
    20 calls a side, the median): the forms (``ms``, ``tiled_ms``), the
    plain version and the composition they replace (``composed_ms``: K5,
    the PyTorch products and slab sums, K6), with the device µs and
    operations of each form and of the composition, and the bound: B and
    ids of the observations (the slab layout's padding rows left out),
    Dinv and v read, the camera sums written, against 3.35 TB/s
    (``padded_bound_ms``: B and ids of every slab row; the tiled form's
    stored rows are not counted).  Returns ``{shape: {kernel: times}}``."""
    out = {}
    for tag, (args32, n_obs) in cases.items():
        counts, degrees, Bt, ids, DinvT, v = args32
        C, (dp, dl, N), S = v.shape[0], Bt.shape, DinvT.shape[-1]
        order = oh.schur_rows_order(ids, C)
        shape = f"{dp}x{dl}x{N}->{C}"
        forms = {"schur_rows_tiled": lambda *a: oh.schur_rows_tiled_t(
            *a, order)}
        if oh.schur_rows_fits(C, dp, dl, torch.float32):
            forms = {"schur_rows": oh.schur_rows_t, **forms}
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            args = (counts, degrees, Bt.to(dtype), ids, DinvT.to(dtype),
                    v.to(dtype))
            want = oh.schur_rows_t_plain(*args)
            for kernel, fn in forms.items():
                if not (kernel == "schur_rows_tiled"
                        or oh.schur_rows_fits(C, dp, dl, dtype)):
                    continue
                got = fn(*args)
                rel = ((got - want).abs().max() / want.abs().max()).item()
                same = torch.equal(got, fn(*args))
                del got
                ops = device_profile(torch, lambda: fn(*args))[1]
                phase("kernels", kernel=f"{kernel}_t", path=tag, dtype=dname,
                      shape=shape, rel_err=f"{rel:.3e}",
                      same_bits_on_two_calls=same, device_ops_per_call=ops,
                      tol=TOL[dname])
                if rel > TOL[dname] or not same or ops != 1:
                    raise RuntimeError(f"{kernel}_t at {tag} {dname}: rel "
                                       f"{rel}, same bits {same}, {ops} "
                                       f"operations a call")
            del args, want

        def composed():
            return oh.schur_rows_t_plain(
                *args32, gather=oh.onehot_gather_t,
                scatter_add=oh.onehot_scatter_add_t)

        ms_of = {"schur_rows": "ms", "schur_rows_tiled": "tiled_ms"}
        fns = {**{ms_of[k]: (lambda fn=fn: fn(*args32))
                  for k, fn in forms.items()},
               "plain_ms": lambda: oh.schur_rows_t_plain(*args32),
               "composed_ms": composed}
        t = _in_turns(torch, fns, reps=20, rounds=6)
        want = composed()
        rel = {k: ((fn(*args32) - want).abs().max()
                   / want.abs().max()).item() for k, fn in forms.items()}
        del want
        dev = {k: device_profile(torch, fns[k])
               for k in (*(ms_of[k] for k in forms), "composed_ms")}

        def bound_ms(rows):
            ops = rows * dp * dl * 4 + rows * dp + S * dl * dl * 2
            nbytes = (dp * dl * rows + dl * dl * S + 2 * C * dp) * 4 + 4 * rows
            return max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S) * 1e3

        b_ms, pad_ms = bound_ms(n_obs), bound_ms(N)
        for k in forms:
            out[f"{tag}:{k}_t:{shape}"] = {k: dict(
                ms=t[ms_of[k]], plain_ms=t["plain_ms"],
                composed_ms=t["composed_ms"], bound_ms=b_ms,
                padded_bound_ms=pad_ms, bound_by="bytes",
                device_us_per_call=dev[ms_of[k]][0],
                device_ops_per_call=dev[ms_of[k]][1],
                composed_device_us=dev["composed_ms"][0],
                composed_device_ops=dev["composed_ms"][1])}
        pre = {"schur_rows": "", "schur_rows_tiled": "tiled_"}
        phase("schur_rows", path=tag, shape=shape, buckets=len(counts),
              dtype="float32", **{k: f"{x:.4f}" for k, x in t.items()},
              **{f"{pre[k]}device_us_per_call": f"{dev[ms_of[k]][0]:.2f}"
                 for k in forms},
              **{f"{pre[k]}device_ops_per_call": dev[ms_of[k]][1]
                 for k in forms},
              composed_device_us=f"{dev['composed_ms'][0]:.2f}",
              composed_device_ops=dev["composed_ms"][1],
              observations=n_obs, bound_ms=f"{b_ms:.4f}",
              padded_bound_ms=f"{pad_ms:.4f}", bound_by="bytes",
              **{f"{pre[k]}vs_composed_rel": f"{rel[k]:.3e}" for k in forms})
    return out


def implicit_main_path_phase(torch, g2o, wrappers, implicit, keep):
    """The implicit Schur paths; returns the launch counts of each run and
    keeps the dims-major ladybug run (problem, solver, result) for the
    FLOP model under ``keep["ba_implicit"]``."""
    by_path = {}
    for suffix, (p, solver, est0) in implicit.items():
        cfg = IMPLICIT_PATHS[suffix]
        tag = f"main_path_ba_implicit{suffix}"
        form = solver._layout["form"]
        need = (("onehot_gather_t", "onehot_scatter_add_t", "schur_rows_t")
                if form == "dm" else ("onehot_gather", "onehot_scatter_add"))
        p.set_estimates({t: v.clone() for t, v in est0.items()})
        res, launches = _run_lm(
            torch, g2o, wrappers, p, est0, solver, tag, need=need, iters=10,
            chi2_bound=cfg["bound"], extra=dict(
                layout=form,
                reference_g2o_cpu_pcg_ms_per_iteration=f"{cfg['ref_ms']:.1f}"),
            watch={"k6": ("segment_sum_t_kernel", "scatter_add_kernel"),
                   "k5": ("gather_t_kernel",)}
            if form == "dm" else None)
        if suffix == "":
            keep["ba_implicit"] = (p, solver, res)
        trials = sum(res["trials_per_iteration"])
        phase(f"launches{tag[len('main_path'):]}", layout=form,
              lm_trials=trials,
              cg_iterations_per_solve=f"{sum(res['cg_per_iteration']) / max(trials, 1):.2f}",
              cg_per_iteration=",".join(map(str, res["cg_per_iteration"])),
              **{f"{k}_per_lambda_trial": f"{launches[k] / max(trials, 1):.2f}"
                 for k in ONEHOT})
        # the dims-major S·v: one Schur rows launch per CG iteration, in
        # its shared-memory form (the cameras fit)
        cg = sum(res["cg_per_iteration"])
        if (launches["schur_rows_t"] != (cg if form == "dm" else 0)
                or launches["schur_rows_tiled_t"]):
            raise RuntimeError(f"{tag}: {launches['schur_rows_t']} Schur rows "
                               f"launches and {launches['schur_rows_tiled_t']}"
                               f" of its tiled form in {cg} CG iterations "
                               f"({form})")
        lt = implicit_layer_times(torch, g2o, p, solver, res["lambda_final"],
                                  explicit=suffix == "_runtime")
        phase(f"layers_ba_implicit{suffix}", **{
            k: f"{v:.3e}" if "residual" in k or "rel" in k or
            k.startswith("lam") else (f"{v:.3f}" if isinstance(v, float)
                                      else v) for k, v in lt.items()})
        by_path[tag] = launches
    return by_path


def tiled_path_phase(torch, g2o, wrappers):
    """A dims-major implicit Schur path past the Schur rows kernel's
    shared-memory camera cap: the benchmark's Final-13682 configuration
    (its solver, float32, Huber 1, its scene rules and the cold traffic's
    warm-up start) at ``TILED_PATH``'s counts, built as the benchmark builds
    it, ``TILED_PATH["iters"]`` LM iterations after a warm-up.  Every S·v
    Schur term must take the tiled form: its launches equal the CG
    iterations, none of the shared-memory form; every chi2 finite and the
    last below the first.  Returns the run's launch counts."""
    from portbench import bench
    from portbench import scene as scene_mod

    cfg = bench.load_json(os.path.join(
        HERE, "portbench", "configs", "bal-final-13682.json"))
    cfg.update({k: TILED_PATH[k]
                for k in ("cameras", "points", "observations")})
    traffic = bench.load_json(os.path.join(HERE, "portbench", "traffic",
                                           "cold.json"))
    scene = scene_mod.make_scene(cfg, 0, "cuda")
    x0 = scene_mod.job_start(scene, traffic, -1)
    p, solver, _ = bench.build_program(cfg, scene, x0, "cuda")
    est0 = {t: v.clone() for t, v in p.estimates.items()}
    tag = "main_path_ba_implicit_tiled"
    g2o.optimize_fused(p, solver, 2)                 # warm-up
    p.set_estimates({t: v.clone() for t, v in est0.items()})
    for w in wrappers.values():
        w.launches = 0
    res = g2o.optimize_fused(p, solver, TILED_PATH["iters"])
    launches = _launches(wrappers)
    chis = res["chi2_per_iteration"] + [res["chi2_final"]]
    cg = sum(res["cg_per_iteration"])
    trials = sum(res["trials_per_iteration"])
    phase("launches_ba_implicit_tiled", layout=solver._layout["form"],
          schur_rows=",".join(solver._layout["schur_rows"].values()),
          cameras=cfg["cameras"], points=cfg["points"],
          observations=cfg["observations"], iterations=res["iterations"],
          lm_trials=trials, cg_iterations_total=cg,
          chi2_0=f"{chis[0]:.4f}", chi2_final=f"{res['chi2_final']:.4f}",
          **{f"launches_{k}": launches[k] for k in ONEHOT})
    if not all(math.isfinite(c) for c in chis) or not chis[-1] < chis[0]:
        raise RuntimeError(f"{tag}: chi2 {chis}")
    if (set(solver._layout["schur_rows"].values()) != {"tiled"}
            or launches["schur_rows_tiled_t"] != cg
            or launches["schur_rows_t"]):
        raise RuntimeError(f"{tag}: {launches['schur_rows_tiled_t']} tiled "
                           f"and {launches['schur_rows_t']} shared-memory "
                           f"Schur rows launches in {cg} CG iterations "
                           f"({solver._layout['schur_rows']})")
    return {tag: launches}


def implicit_layer_times(torch, g2o, p, solver, lam, explicit=False):
    """Time each stage of the implicit Schur solve alone at the final
    estimates and λ (synchronized): linearize, the per-trial setup
    (landmark inverses and B, the reduced right-hand side, the
    preconditioner), one CG iteration, the back-substitution; and the
    relative residual ``‖b − (H + λ₀I)dx‖ / ‖b‖`` of one solve, through
    ``hvp_operator``, at λ₀ = 1e-5·max|H_jj|.  With ``explicit``, also the
    relative difference between the step of an implicit solve at
    ``tol=1e-10`` and the explicit ``SchurSolver``'s step, same
    linearization and λ₀."""
    from g2o_tpu_torch.core.optimizer import _max_abs_diag

    data, aux, parts = p.data, solver.aux, solver._parts
    out = {}
    out["linearize_ms"], lin = _wall_ms(
        torch, lambda: p.linearize_fn(data, p.estimates))
    out["landmark_system_ms"], ctx = _wall_ms(
        torch, lambda: parts["landmark_system"](data, lin, lam, aux))
    out["reduced_rhs_ms"], bs = _wall_ms(
        torch, lambda: parts["reduced_rhs"](ctx, data, lin, aux))
    out["preconditioner_ms"], (db, minv) = _wall_ms(
        torch, lambda: parts["preconditioner"](ctx, data, lin, lam, aux))
    out["per_trial_setup_ms"] = (out["landmark_system_ms"]
                                 + out["reduced_rhs_ms"]
                                 + out["preconditioner_ms"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dxp, st = parts["cg"](ctx, data, lin, bs, db, minv, aux)
    torch.cuda.synchronize()
    out["cg_iterations"] = st["cg_iterations"]
    out["cg_ms_per_iteration"] = ((time.perf_counter() - t0) * 1e3
                                  / max(st["cg_iterations"], 1))
    out["back_substitute_ms"], _ = _wall_ms(
        torch, lambda: parts["back_substitute"](ctx, data, lin, dxp, aux))
    out["solve_ms"], _ = _wall_ms(
        torch, lambda: solver._solve_full(data, lin, lam, aux))
    lam0 = 1e-5 * float(_max_abs_diag(p, lin))
    dx = solver._solve_full(data, lin, lam0, aux)[0]
    hvp = p.hvp_operator(data, lin)
    Hdx = p.join_tangent(hvp(p.split_tangent(dx))) + lam0 * dx
    rel = float((lin.b - Hdx).norm() / lin.b.norm())
    if not math.isfinite(rel):
        raise RuntimeError(f"non-finite implicit Schur solve at λ₀ = {lam0}")
    out["rel_residual_at_lam0"] = rel
    if explicit:
        tight = g2o.ImplicitSchurSolver(
            max_iter=100, tol=1e-10, precond="jacobi",
            layout="bucketed").setup(p)
        dx_i = tight._solve_full(data, lin, lam0, tight.aux)[0]
        dx_e = g2o.SchurSolver(use_pallas=True).setup(p).solve(data, lin,
                                                                lam0)
        out["rel_diff_to_explicit_at_lam0"] = float(
            (dx_i - dx_e).norm() / dx_e.norm())
    out["lam"] = lam
    out["lam0"] = lam0
    return out


def sba_graphs(scene=None):
    """The three sba problems of ba_demo's geometry, as ``create_ba_scene``
    builds it (focal 1000, (cx, cy) = (320, 240), cameras 0 and 1 fixed),
    from one ``create_ba_scene(**scene)``: ``({path: (Graph,
    bucket_landmarks)}, {point vid: anchor camera}, {point vid: true
    point})``.

    * ``inverse_depth``: as ``examples/ba_anchored_inverse_depth.py``
      builds it — each point anchored on the first camera that sees it,
      psi = (x/z, y/z, 1/z) of its noisy world point in that frame, one
      3-ary ``EDGE_PROJECT_PSI2UV`` per observation (the example draws the
      same noise in the same order as ``create_ba_scene``);
    * ``partial``: ``create_ba_scene``'s graph with every third point not
      marginalized;
    * ``mixed``: the same points, stereo edges (f, f, cx, cy, bf) from even
      cameras with u_right = u - bf/z of the true depth, mono edges (f, f,
      cx, cy) from odd ones; built with ``bucket_landmarks``."""
    import torch

    from g2o_tpu_torch.core.graph import Graph
    from g2o_tpu_torch.ops import lie
    from g2o_tpu_torch.parallel.worker import mixed_sba_graph
    from g2o_tpu_torch.sim.generators import create_ba_scene
    from g2o_tpu_torch.types import sba

    base, truth = create_ba_scene(**(scene or SBA_SCENE))
    verts = base.vertices()
    cams = [r for vid, r in sorted(verts.items()) if vid not in truth]
    pts = list(truth)
    vids = np.array([e.vids for e in base.edges()])       # (point, camera)
    meas = np.stack([e.measurement for e in base.edges()])
    cam_par = base.parameter(sba.CAM_PARAM_ID)

    def with_cameras(params):
        g = Graph()
        for pid, v in params.items():
            g.add_parameter(pid, v)
        for c in cams:
            g.add_vertex(c.vid, c.vtype, c.estimate, fixed=c.fixed)
        return g

    # edges are point-major in camera order: a point's first edge names
    # its anchor
    _, first = np.unique(vids[:, 0], return_index=True)
    anchor = vids[first, 1]
    cam_est = np.stack([c.estimate for c in cams])
    pa = lie.se3_act(torch.tensor(cam_est[anchor]), torch.tensor(
        np.stack([verts[v].estimate for v in pts]))).numpy()
    psi = np.stack([pa[:, 0] / pa[:, 2], pa[:, 1] / pa[:, 2],
                    1.0 / pa[:, 2]], axis=1)
    anchor_of = dict(zip(pts, anchor.tolist()))
    g_id = with_cameras({sba.CAM_PARAM_ID: cam_par})
    for v, x in zip(pts, psi):
        g_id.add_vertex(v, sba.VertexPointXYZ, x, marginalized=True)
    for (v, i), m in zip(vids.tolist(), meas):
        g_id.add_edge(sba.EdgeProjectPSI2UV, [v, i, anchor_of[v]], m,
                      np.eye(2), param_id=sba.CAM_PARAM_ID)

    # the sharded run of phase 15 builds the same map in its workers
    g_mx = mixed_sba_graph(base, truth, Graph, sba, SBA_BF)

    for j, v in enumerate(pts):
        if j % 3 == 0:
            base.set_marginalized(v, False)
    return ({"inverse_depth": (g_id, False), "partial": (base, False),
             "mixed": (g_mx, True)}, anchor_of, truth)


def load_sba(torch, scene=None, device="cuda"):
    """The sba problems on ``device``, f32 and f64: ``{path: dict(p32,
    p64, est32, est64)}``, plus ``"_anchors"`` / ``"_truth"``."""
    t0 = time.perf_counter()
    graphs, anchor_of, truth = sba_graphs(scene)
    t1 = time.perf_counter()
    out = {"_anchors": anchor_of, "_truth": truth}
    for path, (g, bucket) in graphs.items():
        ps = {dt: g.compile(dtype=getattr(torch, dt), device=device,
                            bucket_landmarks=bucket)
              for dt in ("float32", "float64")}
        p = ps["float64"]
        n_lm = int(p.marginalized["VERTEX_TRACKXYZ"].sum())
        phase(f"load_sba_{path}", cameras=p.counts["VERTEX_SE3:EXPMAP"],
              points=p.counts["VERTEX_TRACKXYZ"], marginalized_points=n_lm,
              observations=p.num_edges,
              edges=",".join(f"{k}:{b.vidx.shape[0]}"
                             for k, b in p.data.edges.items()),
              tangent_dims=p.total_dim,
              reduced_dims=p.total_dim - 3 * n_lm,
              bucket_landmarks=bucket)
        out[path] = dict(p32=ps["float32"], p64=p, est32={
            t: v.clone() for t, v in ps["float32"].estimates.items()},
            est64={t: v.clone() for t, v in p.estimates.items()})
    phase("load_sba", scene_seconds=f"{t1 - t0:.3f}",
          compile_seconds=f"{time.perf_counter() - t1:.3f}")
    return out


def sba_check(torch, g2o, path, p):
    """One f64 solve at the initial linearization and λ₀ = 1e-5·max|H_jj|
    (LM's first λ) against ``DenseSolver`` (relative difference ≤ 1e-7);
    on ``mixed`` also the bucketed step against the ``rows`` step (≤
    1e-10)."""
    from g2o_tpu_torch.core.optimizer import _max_abs_diag

    lin = p.linearize_fn(p.data, p.estimates)
    lam0 = 1e-5 * float(_max_abs_diag(p, lin))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dx_d = g2o.DenseSolver().setup(p).solve(p.data, lin, lam0)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    s = g2o.ImplicitSchurSolver(**SBA_CHECK_SOLVER).setup(p)
    t0 = time.perf_counter()
    dx, st = s._solve_full(p.data, lin, lam0, s.aux)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rel = float((dx - dx_d).norm() / dx_d.norm())
    facts = dict(layout=s._layout["form"], lam0=f"{lam0:.6e}",
                 rel_diff_to_dense=f"{rel:.3e}", limit="1e-7",
                 cg_iterations=st["cg_iterations"],
                 rel_residual=f"{math.sqrt(float(st['residual2']) / float(st['rhs2'])):.3e}",
                 implicit_ms=f"{ms:.1f}", dense_ms=f"{dense_ms:.1f}",
                 dense_dim=p.total_dim,
                 peak_device_gib=f"{peak_gb:.2f}")
    ok = math.isfinite(rel) and rel <= 1e-7
    if path == "mixed":
        r = g2o.ImplicitSchurSolver(**SBA_CHECK_SOLVER,
                                    layout="rows").setup(p)
        dx_r, st_r = r._solve_full(p.data, lin, lam0, r.aux)
        rel_r = float((dx - dx_r).norm() / dx_r.norm())
        facts.update(rel_diff_to_rows=f"{rel_r:.3e}", rows_limit="1e-10",
                     rows_cg_iterations=st_r["cg_iterations"],
                     rows_rel_diff_to_dense=
                     f"{float((dx_r - dx_d).norm() / dx_d.norm()):.3e}")
        ok = ok and rel_r <= 1e-10
    phase(f"check_sba_{path}", **facts)
    if not ok:
        raise RuntimeError(f"sba {path}: the f64 implicit step misses its "
                           f"bar: {facts}")


def median_world_error(p, anchor_of, truth):
    """examples/ba_anchored_inverse_depth.py's figure: the median distance
    of X = T_anchor^-1 (u, v, 1)/rho from the true point."""
    import torch

    from g2o_tpu_torch.ops import lie

    est = p.estimates_by_vid()
    v = list(truth)
    psi = np.stack([est[x] for x in v]).astype(np.float64)
    T = np.stack([est[anchor_of[x]] for x in v]).astype(np.float64)
    pc = np.stack([psi[:, 0], psi[:, 1], np.ones(len(v))], 1) / psi[:, 2:3]
    X = lie.se3_act(lie.se3_inverse(torch.tensor(T)), torch.tensor(pc))
    return float(np.median(np.linalg.norm(
        X.numpy() - np.stack([truth[x] for x in v]), axis=1)))


def sba_path_phase(torch, g2o, wrappers, sba):
    """The three sba paths: the f64 check against the dense solver, the
    f64 LM run, then the f32 LM run (``_run_lm``: its chi2 within 1% of
    the f64 run's and 10x below the first), traced; on ``mixed`` the same
    f32 run at ``layout="rows"`` beside it.  Returns the launch counts of
    each f32 run."""
    by_path = {}
    for path in SBA_PATHS:
        t0 = time.perf_counter()
        d = sba[path]
        p64, p32 = d["p64"], d["p32"]
        sba_check(torch, g2o, path, p64)
        res64 = g2o.optimize_fused(p64, g2o.ImplicitSchurSolver(**SBA_SOLVER),
                                   SBA_ITERS)
        chi64 = res64["chi2_final"]
        chi0 = res64["chi2_per_iteration"][0]
        tag = f"main_path_{path}"
        solver = g2o.ImplicitSchurSolver(**SBA_SOLVER).setup(p32)
        need = RUNTIME_ONE_OP if path == "mixed" else ()
        res, launches = _run_lm(
            torch, g2o, wrappers, p32, d["est32"], solver, tag, need=need,
            iters=SBA_ITERS, chi2_bound=min(chi64 * 1.01, chi0 / 10),
            watch={"k7": ("gather_rows_kernel", "gather_kernel"),
                   "k8": ("segment_sum_rows_kernel", "scatter_add_kernel")}
            if path == "mixed" else None, trace_iters=SBA_TRACE_ITERS,
            extra=dict(layout=solver._layout["form"],
                       f64_chi2_0=f"{chi0:.4f}",
                       f64_chi2_final=f"{chi64:.4f}",
                       f64_iterations=res64["iterations"],
                       f64_ms_per_lambda_trial=
                       f"{res64['wall_s'] * 1e3 / max(sum(res64['trials_per_iteration']), 1):.3f}"))
        if abs(res["chi2_final"] - chi64) > 0.01 * chi64:
            raise RuntimeError(f"{tag}: f32 chi2 {res['chi2_final']} not "
                               f"within 1% of the f64 run's {chi64}")
        trials = max(sum(res["trials_per_iteration"]), 1)
        facts = dict(layout=solver._layout["form"], lm_trials=trials,
                     cg_iterations_per_solve=
                     f"{sum(res['cg_per_iteration']) / trials:.2f}",
                     cg_per_iteration=",".join(map(str,
                                                   res["cg_per_iteration"])),
                     **{f"{k}_per_lambda_trial":
                        f"{launches[k] / trials:.2f}" for k in ONEHOT})
        if path == "inverse_depth":
            facts["median_world_point_error"] = "{:.4f}".format(
                median_world_error(p32, sba["_anchors"], sba["_truth"]))
            facts["anchored_points"] = len(sba["_truth"])
            facts["free_anchor_share"] = "{:.4f}".format(np.mean(
                [a >= 2 for a in sba["_anchors"].values()]))
        if path == "mixed":
            rows = g2o.ImplicitSchurSolver(**SBA_SOLVER, layout="rows")
            g2o.optimize_fused(p32, rows, 2)
            p32.set_estimates({t: v.clone() for t, v in d["est32"].items()})
            res_r = g2o.optimize_fused(p32, rows, SBA_ITERS)
            trials_r = max(sum(res_r["trials_per_iteration"]), 1)
            facts.update(
                rows_ms_per_lambda_trial=
                f"{res_r['wall_s'] * 1e3 / trials_r:.3f}",
                rows_ms_per_lm_iteration=
                f"{res_r['wall_s'] * 1e3 / max(res_r['iterations'], 1):.3f}",
                rows_cg_iterations_per_solve=
                f"{sum(res_r['cg_per_iteration']) / trials_r:.2f}",
                rows_chi2_final=f"{res_r['chi2_final']:.4f}")
            if abs(res_r["chi2_final"] - chi64) > 0.01 * chi64:
                raise RuntimeError(f"{tag} rows: f32 chi2 "
                                   f"{res_r['chi2_final']} not within 1% of "
                                   f"the f64 run's {chi64}")
        facts["phase_seconds"] = f"{time.perf_counter() - t0:.1f}"
        phase(f"launches_{path}", **facts)
        by_path[tag] = launches
    return by_path


def load_sphere_fixed(torch):
    """sphere2500 with Huber 1.0 and vertex 0 fixed — the reference CLI's
    gauge for a file without a FIX line (Dogleg's Gauss-Newton step solves
    at λ = 0, where the free gauge leaves H singular): ``{dtype name:
    (problem, initial estimates)}`` in f64 and f32 on the card."""
    from g2o_tpu_torch.io import g2o_format

    t0 = time.perf_counter()
    g = g2o_format.load(DATASET)
    g.set_robust_kernel("Huber", 1.0)
    g.set_fixed(0, True)
    out = {}
    for dt in ("float64", "float32"):
        p = g.compile(dtype=getattr(torch, dt), device="cuda")
        out[dt] = (p, {t: v.clone() for t, v in p.estimates.items()})
    torch.cuda.synchronize()
    phase("load_sphere_fixed", fixed_vertex=0, gauge_freedom=out[
        "float32"][0].gauge_freedom(),
          seconds=f"{time.perf_counter() - t0:.3f}")
    return out


def _reset(p, est0):
    p.set_estimates({t: v.clone() for t, v in est0.items()})


def _dogleg_run(torch, g2o, p, est0, iters):
    """``iters`` Dogleg iterations from ``est0`` over a fresh supernodal
    solver: ``(optimizer, step kinds, wall s)``."""
    _reset(p, est0)
    opt = g2o.SparseOptimizer(p, algorithm=g2o.Dogleg(),
                              solver=g2o.SupernodalCholeskySolver())
    kinds = []
    opt.post_iteration_actions.append(
        lambda o, it: kinds.append(o.algorithm._last_step))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.optimize(iters)
    torch.cuda.synchronize()
    return opt, kinds, time.perf_counter() - t0


def dogleg_phase(torch, g2o, wrappers, sphere):
    """Dogleg over the supernodal solver, f64 then f32 (the main path:
    counts reset just before it); returns the launch counts of the f32
    run."""
    finals = {}
    for dt in ("float64", "float32"):
        p, est0 = sphere[dt]
        _dogleg_run(torch, g2o, p, est0, 2)                 # warm-up
        if dt == "float32":
            for w in wrappers.values():
                w.launches = 0
        opt, kinds, wall = _dogleg_run(torch, g2o, p, est0, DOGLEG_ITERS)
        launches = _launches(wrappers)
        stats = opt.batch_statistics
        n = len(stats)
        chis = [s.chi2 for s in stats] + [opt.chi2()]
        trials = sum(s.levenberg_iterations for s in stats)
        finals[dt] = chis[-1]
        facts = dict(dtype=dt, iterations_requested=DOGLEG_ITERS,
                     iterations=n,
                     ms_per_iteration=f"{wall * 1e3 / max(n, 1):.3f}",
                     trials_per_iteration=f"{trials / max(n, 1):.3f}",
                     steps_gn=kinds.count("GN"), steps_sd=kinds.count("SD"),
                     steps_dl=kinds.count("DL"),
                     chi2_0=f"{chis[0]:.4f}",
                     chi2_10=f"{chis[min(10, n)]:.4f}",
                     chi2_final=f"{chis[-1]:.4f}",
                     delta_final=f"{opt.algorithm.delta:.6g}",
                     reference_lm_bound=f"{CHI2_BOUND:.2f}",
                     reaches_reference_lm_bound=chis[-1] <= CHI2_BOUND,
                     wall_s=f"{wall:.3f}")
        if dt == "float32":
            facts.update(f64_chi2_final=f"{finals['float64']:.4f}",
                         **{f"launches_{k}": v for k, v in launches.items()})
        phase("main_path_dogleg" if dt == "float32"
              else "main_path_dogleg_f64", **facts)
        if not all(math.isfinite(c) for c in chis):
            raise RuntimeError(f"dogleg {dt}: non-finite chi2 {chis}")
    if abs(finals["float32"] - finals["float64"]) > 0.01 * finals["float64"]:
        raise RuntimeError(f"dogleg: f32 final chi2 {finals['float32']} not "
                           f"within 1% of the f64 run's {finals['float64']}")
    if any(launches[k] < 1 for k in KERNELS[:3]):
        raise RuntimeError(f"dogleg: K1/K2/K3 not all launched: {launches}")
    # the busy share over TRACE_ITERS traced iterations of the f32 run
    p, est0 = sphere["float32"]
    ms = wall * 1e3 / max(n, 1)
    (opt, _, _), kern, n_launch = _profile(
        lambda: _dogleg_run(torch, g2o, p, est0, TRACE_ITERS))
    n5 = max(len(opt.batch_statistics), 1)
    dev_ms = sum(k[0] for k in kern) / 1e3 / n5
    phase("trace_main_path_dogleg", iterations=n5,
          device_ms_per_iteration=f"{dev_ms:.3f}",
          untraced_ms_per_iteration=f"{ms:.3f}",
          device_busy_share=f"{dev_ms / ms:.4f}",
          kernel_launches_per_iteration=f"{n_launch / n5:.1f}",
          top=_top(kern))
    if not kern:
        raise RuntimeError("the dogleg trace shows no device time")
    return launches


def fused_lm_phase(torch, g2o, wrappers, sphere):
    """``FusedLevenbergMarquardt`` through ``SparseOptimizer`` against
    ``optimize_fused`` on the same solver settings, 5 iterations each from
    the same start (the first counts the main path's launches).  Both run
    with PyTorch's deterministic algorithms: ``index_add_`` on the card
    otherwise adds in a run-dependent order, and two f32 runs of one
    algorithm then part by ~1e-5 within five iterations."""
    p, est0 = sphere["float32"]
    kw = dict(max_iter=50, tol=1e-1, precond="chunk2", chunk_size=16)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _fused_lm_pair(torch, g2o, wrappers, p, est0, kw)
    finally:
        torch.use_deterministic_algorithms(False)


def _fused_lm_pair(torch, g2o, wrappers, p, est0, kw):
    _reset(p, est0)
    for w in wrappers.values():
        w.launches = 0
    opt = g2o.SparseOptimizer(p, algorithm=g2o.FusedLevenbergMarquardt(),
                              solver=g2o.PCGSolver(**kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.optimize(5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(wrappers)
    chis = [s.chi2 for s in opt.batch_statistics] + [opt.current_chi2]
    _reset(p, est0)
    res = g2o.optimize_fused(p, g2o.PCGSolver(**kw), 5)
    ref = res["chi2_per_iteration"] + [res["chi2_final"]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(chis, ref))
    phase("fused_lm", iterations=len(opt.batch_statistics),
          ms_per_iteration=f"{wall * 1e3 / 5:.3f}",
          chi2=",".join(f"{c:.6f}" for c in chis),
          optimize_fused_chi2=",".join(f"{c:.6f}" for c in ref),
          max_rel_diff=f"{rel:.3e}", limit="1e-6",
          **{f"launches_{k}": v for k, v in launches.items()})
    if len(chis) != len(ref) or not rel <= 1e-6:
        raise RuntimeError(f"FusedLevenbergMarquardt {chis} against "
                           f"optimize_fused {ref}")
    return launches


def sparse_chol_phase(torch, g2o, wrappers, sphere):
    """``SparseCholeskySolver`` on the fixed sphere2500: 50 f32 LM
    iterations (``_run_lm``), then one f64 step at the run's final λ
    against ``SupernodalCholeskySolver``'s, at the f64 problem's initial
    estimates (as phase 10's f64 checks).  At the converged estimates,
    where the final λ is ~1e-16 of H's scale, the two direct solvers part
    by ~1e-8 on an NVIDIA H100: the optimum's conditioning times the
    rounding of a factor without refinement (the supernodal solver
    refines), which that point cannot hold steadily below a 1e-8 bar."""
    p, est0 = sphere["float32"]
    sc = g2o.SparseCholeskySolver()
    t0 = time.perf_counter()
    sc.setup(p)
    torch.cuda.synchronize()
    levels = sc.aux["levels"]
    phase("setup_sparse_chol", seconds=f"{time.perf_counter() - t0:.3f}",
          blocks=sc._n_blocks, off_diagonal_blocks=sc._sched["nnz"],
          levels=len(levels),
          updates=sum(int(lv["u_dst"].numel()) for lv in levels))
    res, launches = _run_lm(torch, g2o, wrappers, p, est0, sc,
                            "main_path_sparse_chol", need=())
    p64, est64 = sphere["float64"]
    final = p64.estimates
    _reset(p64, est64)
    lin = p64.linearize_fn(p64.data, p64.estimates)
    lam = res["lambda_final"]
    sc64 = g2o.SparseCholeskySolver().setup(p64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dx = sc64.solve(p64.data, lin, lam)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    dx_sn = g2o.SupernodalCholeskySolver().setup(p64).solve(p64.data, lin,
                                                           lam)
    rel = float((dx - dx_sn).norm() / dx_sn.norm())
    p64.set_estimates(final)
    trials = max(sum(res["trials_per_iteration"]), 1)
    phase("check_sparse_chol", lam=f"{lam:.6e}", f64_solve_ms=f"{ms:.3f}",
          rel_diff_to_supernodal=f"{rel:.3e}", limit="1e-8",
          levels=len(levels), lm_trials=trials)
    if not rel <= 1e-8:
        raise RuntimeError(f"sparse Cholesky f64 step {rel} from the "
                           f"supernodal step")
    return launches


def cgls_phase(torch, g2o, wrappers, implicit, sba):
    """CGLS on the dims-major ladybug problem (the main path: 10 f32
    iterations), then one f64 step per phase 10 problem against
    ``DenseSolver``."""
    p, _, est0 = implicit[""]
    solver = g2o.CGLSSolver(**CGLS_SOLVER)
    watch = {"k5": ("gather_t_kernel",),
             "k6": ("segment_sum_t_kernel", "scatter_add_kernel")}
    _reset(p, est0)
    g2o.optimize_fused(p, solver, 2)                 # warm-up
    _reset(p, est0)
    for w in wrappers.values():
        w.launches = 0
    solver.cg_iterations = solver.solves = 0
    res = g2o.optimize_fused(p, solver, 10)
    launches = _launches(wrappers)
    cg, solves = solver.cg_iterations, solver.solves
    chis = res["chi2_per_iteration"] + [res["chi2_final"]]
    n = res["iterations"]
    trials = max(sum(res["trials_per_iteration"]), 1)
    ms = res["wall_s"] * 1e3 / trials
    crossing = _first_at_or_below(chis, CGLS_BOUND)
    phase("main_path_cgls", iterations=n, lm_trials=trials,
          ms_per_lambda_trial=f"{ms:.3f}",
          ms_per_lm_iteration=f"{res['wall_s'] * 1e3 / max(n, 1):.3f}",
          cg_iterations_per_solve=f"{cg / max(solves, 1):.2f}",
          cg_iterations_total=cg, chi2_0=f"{chis[0]:.4f}",
          chi2_final=f"{res['chi2_final']:.4f}", bound=f"{CGLS_BOUND:.2f}",
          bound_crossed_at_iteration=crossing,
          **{f"{k}_per_lambda_trial": f"{launches[k] / trials:.2f}"
             for k in ONEHOT})
    if not all(math.isfinite(c) for c in chis):
        raise RuntimeError(f"CGLS: non-finite chi2 {chis}")
    if (launches["onehot_gather_t"] < cg
            or launches["onehot_scatter_add_t"] < cg):
        raise RuntimeError(f"CGLS: K5/K6 launched fewer times than the "
                           f"{cg} CG iterations: {launches}")
    if not res["chi2_final"] <= CGLS_BOUND:
        raise RuntimeError(f"CGLS: chi2 {res['chi2_final']} after {n} "
                           f"iterations; need <= {CGLS_BOUND}")
    trace(g2o, p, est0, solver, "main_path_cgls", ms, iters=3, watch=watch)
    for path in SBA_PATHS:
        p64 = sba[path]["p64"]
        _reset(p64, sba[path]["est64"])
        lin = p64.linearize_fn(p64.data, p64.estimates)
        dx_d = g2o.DenseSolver().setup(p64).solve(p64.data, lin,
                                                  CGLS_CHECK_LAM)
        torch.cuda.empty_cache()
        s = g2o.CGLSSolver(**CGLS_CHECK_SOLVER).setup(p64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dx = s.solve(p64.data, lin, CGLS_CHECK_LAM)
        torch.cuda.synchronize()
        rel = float((dx - dx_d).norm() / dx_d.norm())
        barred = path == CGLS_CHECK_PATH
        phase(f"check_cgls_{path}", lam=CGLS_CHECK_LAM,
              eta=CGLS_CHECK_SOLVER["eta"], cg_iterations=s.cg_iterations,
              cgls_ms=f"{(time.perf_counter() - t0) * 1e3:.1f}",
              rel_diff_to_dense=f"{rel:.3e}",
              limit="1e-6" if barred else "none",
              bucketed=bool(p64.bucket_specs))
        if barred and not rel <= 1e-6:
            raise RuntimeError(f"CGLS f64 step on {path}: {rel} from "
                               f"DenseSolver's")
    return launches


def _block_rel(a, b, vids):
    """max over ``vids`` of max|a − b| / max|b| per block."""
    return max(float(np.abs(a[v] - b[v]).max() / np.abs(b[v]).max())
               for v in vids)


def marginals_phase(torch, g2o, sphere):
    """The four marginal routes on the card: takahashi, sparse and the
    cross block on sphere2500 (f64), schur against dense on ladybug
    (f64)."""
    import io as _io

    from g2o_tpu_torch.core.marginals import (compute_cross_marginals,
                                              compute_marginals)
    from g2o_tpu_torch.core.optimizer import _max_abs_diag
    from g2o_tpu_torch.io import bal

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    p, est0 = sphere["float64"]
    _reset(p, est0)
    vids = sorted(p.vid_index)
    tk, tk_ms = timed(lambda: compute_marginals(
        p, vids, lam=MARGINAL_LAM, method="takahashi"))
    some = [vids[int(i)] for i in np.linspace(
        1, len(vids) - 1, MARGINAL_SPARSE_VERTICES)]
    sp, sp_ms = timed(lambda: compute_marginals(
        p, some, lam=MARGINAL_LAM, method="sparse"))
    a, b = some[3], some[4]
    cs, cs_ms = timed(lambda: compute_cross_marginals(
        p, a, b, lam=MARGINAL_LAM, method="sparse"))
    cd, cd_ms = timed(lambda: compute_cross_marginals(
        p, a, b, lam=MARGINAL_LAM, method="dense"))
    torch.cuda.empty_cache()
    rel_sp = _block_rel(sp, tk, some)
    rel_cross = float(np.abs(cs - cd).max() / np.abs(cd).max())
    finite = all(np.isfinite(tk[v]).all() for v in vids)

    with gzip.open(os.path.join(BAL, LADYBUG), "rt") as fh:
        pb = bal.load_bal_problem(_io.StringIO(fh.read()),
                                  fix_first_camera=False,
                                  dtype=torch.float64)
    lin = pb.linearize_fn(pb.data, pb.estimates)
    lam_ba = 1e-5 * float(_max_abs_diag(pb, lin))
    by_type = {}
    for vid, (t, i) in pb.vid_index.items():
        by_type.setdefault(t, []).append(vid)
    ba_vids = [v for t in ("VERTEX_CAMERA_BAL", "VERTEX_TRACKXYZ")
               for v in sorted(by_type[t])[::len(by_type[t])
                                           // MARGINAL_BA_VERTICES]
               [:MARGINAL_BA_VERTICES]]
    sc, sc_ms = timed(lambda: compute_marginals(pb, ba_vids, lam=lam_ba,
                                                method="schur"))
    dn, dn_ms = timed(lambda: compute_marginals(pb, ba_vids, lam=lam_ba,
                                                method="dense"))
    torch.cuda.empty_cache()
    rel_ba = _block_rel(sc, dn, ba_vids)
    phase("marginals", sphere_lam=MARGINAL_LAM,
          takahashi_blocks=len(vids), takahashi_ms=f"{tk_ms:.1f}",
          sparse_blocks=len(some), sparse_ms=f"{sp_ms:.1f}",
          sparse_rel_diff_to_takahashi=f"{rel_sp:.3e}",
          cross_pair=f"{a}-{b}", cross_sparse_ms=f"{cs_ms:.1f}",
          cross_dense_ms=f"{cd_ms:.1f}",
          cross_rel_diff_to_dense=f"{rel_cross:.3e}",
          ladybug_lam=f"{lam_ba:.6e}", ladybug_blocks=len(ba_vids),
          schur_ms=f"{sc_ms:.1f}", dense_ms=f"{dn_ms:.1f}",
          dense_dim=pb.total_dim,
          schur_rel_diff_to_dense=f"{rel_ba:.3e}", limit="1e-8")
    if not (finite and rel_sp <= 1e-8 and rel_cross <= 1e-8
            and rel_ba <= 1e-8):
        raise RuntimeError("the marginal routes disagree")


def api_phase(torch, g2o, wrappers, implicit, sba):
    """Phase 11; returns the launch counts of each of its main paths."""
    sphere = load_sphere_fixed(torch)
    by_path = {"main_path_dogleg": dogleg_phase(torch, g2o, wrappers,
                                                sphere),
               "fused_lm": fused_lm_phase(torch, g2o, wrappers, sphere),
               "main_path_sparse_chol": sparse_chol_phase(
                   torch, g2o, wrappers, sphere),
               "main_path_cgls": cgls_phase(torch, g2o, wrappers, implicit,
                                            sba)}
    marginals_phase(torch, g2o, sphere)
    return by_path


def _counts(items):
    """``name:count;...`` of an iterable of names, in first-seen order."""
    out = {}
    for k in items:
        out[k] = out.get(k, 0) + 1
    return ";".join(f"{k}:{v}" for k, v in out.items())


def load_sim(torch, g2o, name):
    """Phase 12, one scene: build it with the port's simulator, write it
    with the port's ``dumps`` and read it back with ``loads``; compile the
    reloaded graph in f64 and f32 on the card and move its estimates by
    the seeded start noise.  The reloaded graph must write the text it was
    read from (a fixed point, so a second round trip gives its chi2
    exactly), and its chi2 must be the generator's in-memory graph's
    within 1e-7: the text keeps 10 significant digits, each number moves
    by up to 5e-11 of itself.  Returns ``{"graph", "p64", "p32", "est64",
    "est32"}``."""
    from g2o_tpu_torch.io import g2o_format
    from g2o_tpu_torch.sim import generators

    make, kw = SIM_SCENES[name]
    t0 = time.perf_counter()
    g = getattr(generators, make)(**kw)
    t1 = time.perf_counter()
    text = g2o_format.dumps(g)
    t2 = time.perf_counter()
    g2 = g2o_format.loads(text)
    t3 = time.perf_counter()
    fixed_point = g2o_format.dumps(g2) == text
    p_orig = g.compile(dtype=torch.float64, device="cuda")
    chi_orig = float(p_orig.chi2_fn(p_orig.data, p_orig.estimates)[0])
    del p_orig
    t4 = time.perf_counter()
    p64 = g2.compile(dtype=torch.float64, device="cuda")
    p32 = g2.compile(dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    chi_back = float(p64.chi2_fn(p64.data, p64.estimates)[0])
    rng = np.random.default_rng(SIM_START_SEED)
    dx = torch.as_tensor(SIM_START_SIGMA[name] * rng.standard_normal(
        p64.total_dim), dtype=torch.float64, device="cuda")
    est64 = p64.apply_update_fn(p64.data, p64.estimates, dx)
    est32 = {t: v.to(torch.float32) for t, v in est64.items()}
    chi_start = float(p64.chi2_fn(p64.data, est64)[0])
    rel_orig = abs(chi_back - chi_orig) / chi_orig
    phase(f"load_{name}", vertices=g2.num_vertices, edges=g2.num_edges,
          tangent_dim=p64.total_dim, vertex_types=_counts(
              r.vtype.name for r in g2.vertices().values()),
          edge_types=_counts(e.etype.name for e in g2.edges()),
          parameters=len(g2.parameters()),
          fixed=sum(r.fixed for r in g2.vertices().values()),
          text_mb=f"{len(text) / 2 ** 20:.2f}",
          generate_s=f"{t1 - t0:.3f}", save_s=f"{t2 - t1:.3f}",
          reload_s=f"{t3 - t2:.3f}", check_s=f"{t4 - t3:.3f}",
          compile_s=f"{t5 - t4:.3f}", text_fixed_point=fixed_point,
          chi2_original=f"{chi_orig:.6f}", chi2_reloaded=f"{chi_back:.6f}",
          rel_diff_original=f"{rel_orig:.3e}", original_limit="1e-7",
          start_sigma=SIM_START_SIGMA[name], chi2_start=f"{chi_start:.4f}")
    if not (fixed_point and rel_orig <= 1e-7):
        raise RuntimeError(f"{name}: the reloaded graph (chi2 {chi_back}) "
                           f"against the generator's ({chi_orig}); text "
                           f"fixed point {fixed_point}")
    return dict(graph=g2, p64=p64, p32=p32, est64=est64, est32=est32)


def sim_check(torch, g2o, name, scene):
    """One f64 solve at the start's linearization and LM's first λ
    (1e-5·max|H_jj|) with the scene's solver against ``DenseSolver``
    (relative difference ≤ 1e-8); the 2D scene's PCG runs CG to its
    rounding floor."""
    from g2o_tpu_torch.core.optimizer import _max_abs_diag

    p = scene["p64"]
    _reset(p, scene["est64"])
    lin = p.linearize_fn(p.data, p.estimates)
    lam0 = 1e-5 * float(_max_abs_diag(p, lin))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dx_d = g2o.DenseSolver().setup(p).solve(p.data, lin, lam0)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    facts = {}
    if name == "sim3d":
        s = g2o.SupernodalCholeskySolver().setup(p)
        t0 = time.perf_counter()
        dx = s.solve(p.data, lin, lam0)
    else:
        s = g2o.PCGSolver(**SIM_PCG_CHECK).setup(p)
        t0 = time.perf_counter()
        dx, st = s._solve_fn(p.data, lin, lam0)
        facts = dict(cg_iterations=int(st["cg_iterations"]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    rel = float((dx - dx_d).norm() / dx_d.norm())
    phase(f"check_{name}", solver=type(s).__name__, lam0=f"{lam0:.6e}",
          rel_diff_to_dense=f"{rel:.3e}", limit="1e-8", **facts,
          solve_ms=f"{ms:.1f}", dense_ms=f"{dense_ms:.1f}",
          dense_dim=p.total_dim, peak_device_gib=f"{peak_gb:.2f}")
    if not (math.isfinite(rel) and rel <= 1e-8):
        raise RuntimeError(f"{name}: the f64 step is {rel} from the dense "
                           f"step")


def _sim_kernel_shapes(name, solver, coarse):
    """The (S, n, m) shapes at which the scene's main path launches K1/K2/K3
    and which kernels each shape times: the supernodal group with the most
    factorization work (its diagonal panels, below-panel block and sweep
    column), or the chunk2 coarse level (B = I)."""
    if name == "sim2d":
        n = coarse[0].shape[0]
        return {(1, n, n): KERNELS[:2]}
    d = solver.meta["d"]
    groups = [g for g in solver._static["groups"] if g["spb"] * d > 96]
    if not groups:
        return {}
    g = max(groups, key=lambda g: g["S"] * g["spb"] ** 3)
    S, sd, md = g["S"], g["spb"] * d, g["mpb"] * d
    out = {(S, sd, sd): KERNELS[:1], (S, sd, 1): KERNELS[1:3]}
    if md:
        out[(S, sd, md)] = KERNELS[1:2]
    return out


def sim_path_phase(torch, g2o, ck, wrappers, name, scene, times):
    """Phase 12's runs on one scene: the f64 check, the f64 supernodal
    yardstick, then the main path — f32 ``optimize_fused`` with the
    scene's solver (``_run_lm``: its chi2 within 1% of the yardstick's
    and 10x below the first, every chi2 finite, the scene's kernels
    launched), traced — and K1/K2/K3 at the shapes it gave them.  Returns
    the launch counts of the main path."""
    t_phase = time.perf_counter()
    sim_check(torch, g2o, name, scene)
    p64, p32 = scene["p64"], scene["p32"]
    _reset(p64, scene["est64"])
    res_y = g2o.optimize_fused(p64, g2o.SupernodalCholeskySolver(),
                               SIM_YARDSTICK_ITERS)
    chi_y = res_y["chi2_final"]
    chi0 = res_y["chi2_per_iteration"][0]
    trials_y = max(sum(res_y["trials_per_iteration"]), 1)
    phase(f"yardstick_{name}", solver="SupernodalCholeskySolver",
          dtype="float64", iterations=res_y["iterations"],
          chi2_0=f"{chi0:.4f}", chi2_final=f"{chi_y:.6f}",
          ms_per_lambda_trial=f"{res_y['wall_s'] * 1e3 / trials_y:.3f}")
    if not all(math.isfinite(c) for c in res_y["chi2_per_iteration"]):
        raise RuntimeError(f"{name}: non-finite chi2 on the yardstick run")
    coarse = None
    if name == "sim3d":
        solver = g2o.SupernodalCholeskySolver().setup(p32)
        need, watch = KERNELS[:3], {"k3": ("solve_upper",)}
    else:
        solver = g2o.PCGSolver(**SIM_PCG).setup(p32)
        coarse = _keep_first_coarse(solver)
        need, watch = KERNELS[:2], None
    res, launches = _run_lm(
        torch, g2o, wrappers, p32, scene["est32"], solver,
        f"main_path_{name}", need=need, iters=SIM_ITERS,
        chi2_bound=min(chi_y * 1.01, chi0 / 10), watch=watch,
        per_trial=need, extra=dict(yardstick_chi2=f"{chi_y:.4f}"))
    if abs(res["chi2_final"] - chi_y) > 0.01 * chi_y:
        raise RuntimeError(f"{name}: f32 chi2 {res['chi2_final']} not "
                           f"within 1% of the yardstick's {chi_y}")
    if coarse is not None:
        del solver._assemble_coarse
        coarse_matrix_check(torch, coarse[0])
    rng = np.random.default_rng(12)
    for shape, timed in _sim_kernel_shapes(name, solver, coarse).items():
        for dtype in (torch.float32, torch.float64):
            res_k = chol_shape_check(torch, ck, rng, dtype, shape, timed,
                                     tag=f"kernels_{name}")
            if res_k:
                times[_shape(*shape)] = res_k
    phase(f"done_{name}", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return launches


def _unit(rng, E, k):
    v = rng.standard_normal((E, k))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _rand_se3(rng, E, scale=2.0):
    q = _unit(rng, E, 4)
    q[q[:, 3] < 0] *= -1.0
    return np.concatenate([scale * rng.standard_normal((E, 3)), q], 1)


def _rand_line3d(rng, E):
    d = _unit(rng, E, 3)
    return np.concatenate([np.cross(3 * rng.standard_normal((E, 3)), d), d],
                          1)


def _rand_plane(rng, E):
    return np.concatenate([_unit(rng, E, 3), rng.uniform(-5, 5, (E, 1))], 1)


def _rand_sim3(rng, E):
    return np.concatenate([_rand_se3(rng, E),
                           np.exp(0.3 * rng.standard_normal((E, 1)))], 1)


def _rand_angle(rng, E):
    return rng.uniform(-np.pi, np.pi, (E, 1))


_CHECK_STATES = {
    "VERTEX_SE3:QUAT": _rand_se3, "VERTEX3": _rand_se3,
    "VERTEX_TRACKXYZ": lambda rng, E: 3 * rng.standard_normal((E, 3)),
    "VERTEX_PLANE": _rand_plane, "VERTEX_LINE3D": _rand_line3d,
    "VERTEX_SE2": lambda rng, E: np.concatenate(
        [3 * rng.standard_normal((E, 2)), _rand_angle(rng, E)], 1),
    "VERTEX_XY": lambda rng, E: 3 * rng.standard_normal((E, 2)),
    "VERTEX_SEGMENT2D": lambda rng, E: 3 * rng.standard_normal((E, 4)),
    "VERTEX_LINE2D": lambda rng, E: np.concatenate(
        [_rand_angle(rng, E), rng.uniform(0, 5, (E, 1)),
         -np.ones((E, 2))], 1),
    "VERTEX_ODOM_DIFFERENTIAL": lambda rng, E: np.array(
        [1.0, 1.0, 0.5]) + 0.05 * rng.standard_normal((E, 3)),
    "VERTEX_SIM3:EXPMAP": lambda rng, E: np.concatenate(
        [_rand_sim3(rng, E), np.tile([300.0, 310.0, 160.0, 120.0], (E, 2))
         + rng.standard_normal((E, 8))], 1),
}
_CHECK_STATES["VERTEX_SIM3:EXPMAP:FIXSCALE"] = \
    _CHECK_STATES["VERTEX_SIM3:EXPMAP"]


def _in_front(rng, E):
    """Points at depth 2-8 on the optical axis' side of a camera frame."""
    return np.concatenate([rng.standard_normal((E, 2)),
                           rng.uniform(2, 8, (E, 1))], 1)


def _check_inputs(torch, et, rng, E):
    """Valid random ``(states, measurement, parameter)`` of ``E`` edges of
    ``et`` (float64 numpy): unit quaternions, Plücker lines, unit plane
    normals, positive scales, points in front of their camera."""
    from g2o_tpu_torch.ops import lie

    states = [_CHECK_STATES[vt.name](rng, E) for vt in et.vertex_types]
    meas = {7: _rand_se3, 8: _rand_sim3}.get(et.meas_dim, lambda r, n: (
        r.standard_normal((n, et.meas_dim))))(rng, E)
    if et.name == "EDGE_SE3_LINE3D":
        meas = _rand_line3d(rng, E)
    elif et.name == "EDGE_SE3_PLANE_CALIB":
        meas = _rand_plane(rng, E)
    elif et.name == "EDGE_SE2_ODOM_DIFFERENTIAL_CALIB":
        meas[:, 2] = rng.uniform(0.1, 1.0, E)        # dt
        meas[::10, 1] = meas[::10, 0]                # straight motion
    param = np.zeros((E, 0))
    if et.param_dim:
        cam = np.tile([300.0, 310.0, 160.0, 120.0], (E, 1))
        param = {7: lambda: _rand_se3(rng, E, 0.2),
                 14: lambda: np.concatenate([_rand_se3(rng, E, 0.2),
                                             _rand_se3(rng, E, 0.2)], 1),
                 11: lambda: np.concatenate([_rand_se3(rng, E, 0.2), cam],
                                            1)}[et.param_dim]()
    T = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    if et.name in ("EDGE_PROJECT_DEPTH", "EDGE_PROJECT_DISPARITY"):
        # landmark = (X O) * p_camera
        sensor = lie.se3_compose(T(states[0]), T(param[:, :7]))
        states[1] = lie.se3_act(sensor, T(_in_front(rng, E))).numpy()
    elif et.name == "EDGE_PROJECT_SIM3_XYZ:EXPMAP":
        s = T(states[1][:, :8])
        states[0] = lie.sim3_act(lie.sim3_inverse(s),
                                 T(_in_front(rng, E))).numpy()
    elif et.name == "EDGE_PROJECT_INVERSE_SIM3_XYZ:EXPMAP":
        states[0] = lie.sim3_act(T(states[1][:, :8]),
                                 T(_in_front(rng, E))).numpy()
    return states, meas, param


def _sim3_w_inputs(torch, rng, E):
    """EDGE_SIM3 inputs whose error ``Z S1 S2^-1`` is ``exp(xi)`` with
    ``(|sigma|, |omega|)`` of each case of ``SIM3_W_CASES`` (``E`` edges
    each, random signs and axes), and the ``xi``."""
    from g2o_tpu_torch.ops import lie

    T = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    xi = []
    for sig, om in SIM3_W_CASES:
        x = np.concatenate([om * _unit(rng, E, 3),
                            0.1 * rng.standard_normal((E, 3)),
                            sig * rng.choice([-1.0, 1.0], (E, 1))], 1)
        xi.append(x)
    xi = np.concatenate(xi)
    n = xi.shape[0]
    s1 = _CHECK_STATES["VERTEX_SIM3:EXPMAP"](rng, n)
    s2 = _CHECK_STATES["VERTEX_SIM3:EXPMAP"](rng, n)
    z = lie.sim3_compose(lie.sim3_exp(T(xi)), lie.sim3_compose(
        T(s2[:, :8]), lie.sim3_inverse(T(s1[:, :8]))))
    return [s1, s2], z.numpy(), np.zeros((n, 0)), xi


def check_types_phase(torch):
    """``[check_types]``: every edge type of this slice's libraries —
    residual and ``torch.func`` Jacobians at ``CHECK_TYPES_EDGES`` random
    valid edges on the card in f64 against the same function on CPU
    tensors, within 1e-10 relative (max |Δ| over max |CPU|), and every
    value finite; then the Sim3 edge at errors on both sides of
    ``_sim3_W``'s 1e-7 thresholds, within ``SIM3_W_LIMIT``."""
    from g2o_tpu_torch.core.problem import residuals_and_jacobians
    from g2o_tpu_torch.core.types import EdgeType
    from g2o_tpu_torch.types import (icp, sclam2d, sim3, slam2d_addons,
                                     slam3d, slam3d_addons)

    t0 = time.perf_counter()
    types = [slam3d.EdgeSE3PointXYZ, slam3d.EdgePointXYZ,
             slam3d.EdgeXYZPrior, slam3d.EdgeSE3Offset,
             slam3d.EdgeSE3PointXYZDepth, slam3d.EdgeSE3PointXYZDisparity,
             slam3d.make_edge_se3_lots_of_xyz(2)]
    for mod in (slam3d_addons, slam2d_addons, sclam2d, icp, sim3):
        types += [v for v in vars(mod).values() if isinstance(v, EdgeType)]
    rng = np.random.default_rng(SIM_START_SEED + 1)
    cases = [(et.name, et, _check_inputs(torch, et, rng, CHECK_TYPES_EDGES))
             for et in dict.fromkeys(types)]
    w_in = _sim3_w_inputs(torch, rng, 1000)
    cases.append(("EDGE_SIM3:EXPMAP@W_thresholds", sim3.EdgeSim3, w_in[:3]))

    def run(et, inp, dev):
        states, meas, param = (tuple(torch.as_tensor(a, dtype=torch.float64,
                                                     device=dev)
                                     for a in inp[0]),) + tuple(
            torch.as_tensor(a, dtype=torch.float64, device=dev)
            for a in inp[1:])
        e, Js = residuals_and_jacobians(et, states, meas, param)
        return [e.cpu()] + [J.cpu() for J in Js]

    errs = {}
    for label, et, inp in cases:
        got, want = run(et, inp, "cuda"), run(et, inp, "cpu")
        rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-300)) for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(a).all()) for a in got + want)
        errs[label] = rel if finite else math.inf
    w_rel = errs.pop("EDGE_SIM3:EXPMAP@W_thresholds")
    worst = max(errs.values())
    e_w = run(sim3.EdgeSim3, w_in[:3], "cuda")[0].numpy()
    xi_err = float(np.abs(e_w - w_in[3]).max())
    phase("check_types", types=len(errs), edges_per_type=CHECK_TYPES_EDGES,
          max_rel_diff=f"{worst:.3e}", limit="1e-10",
          worst=max(errs, key=errs.get),
          sim3_w_cases=";".join(f"{s:g}/{o:g}" for s, o in SIM3_W_CASES),
          sim3_w_rel_diff=f"{w_rel:.3e}", sim3_w_limit=SIM3_W_LIMIT,
          sim3_w_log_error=f"{xi_err:.3e}",
          seconds=f"{time.perf_counter() - t0:.1f}",
          per_type=";".join(f"{k}:{v:.1e}" for k, v in errs.items()))
    if not (worst <= 1e-10 and w_rel <= SIM3_W_LIMIT):
        raise RuntimeError(f"[check_types] card against CPU: {errs}, "
                           f"Sim3 thresholds {w_rel}")


def sim_phase(torch, g2o, ck, wrappers, times, keep):
    """Phase 12; returns the launch counts of its two main paths and keeps
    the 2D scene's graph for phase 14 under ``keep["sim2d_graph"]``."""
    check_types_phase(torch)
    by_path = {}
    for name in SIM_SCENES:
        scene = load_sim(torch, g2o, name)
        by_path[f"main_path_{name}"] = sim_path_phase(
            torch, g2o, ck, wrappers, name, scene, times)
        if name == "sim2d":
            keep["sim2d_graph"] = scene["graph"]
        del scene
        torch.cuda.empty_cache()
    return by_path


def _cli(cli, args):
    """``cli.main(args)`` in this process with its standard output and
    error captured; raises unless it returns 0.  Returns ``(stdout,
    stderr, seconds)``."""
    import contextlib
    import io as _io

    out, err = _io.StringIO(), _io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = cli.main(args)
    except SystemExit as exc:          # argparse refused the arguments
        rc = exc.code
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli {args} returned {rc}: "
                           f"{err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue(), dt


def _final_chi2(err):
    import re

    m = re.search(r"final chi2= (\S+) \(([^)]*)\)", err)
    if m is None:
        raise RuntimeError(f"no final chi2 line in: {err[-2000:]}")
    return float(m.group(1)), m.group(2)


def cli_sphere_phase(torch, g2o, cli, wrappers, tmp):
    """``[cli_sphere]``: sphere2500 through the CLI on supernodal, f32."""
    from g2o_tpu_torch.io import g2o_format

    out, stats, summary = (os.path.join(tmp, f) for f in
                           ("sphere_out.g2o", "stats.jsonl", "summary.jsonl"))
    args = ["-i", "50", "-solver", "lm_supernodal", "-robustKernel", "Huber",
            "-robustKernelWidth", "1", "-fused", "-o", out, "-stats", stats,
            "-summary", summary, DATASET]
    for w in wrappers.values():
        w.launches = 0
    _, err, wall = _cli(cli, args)
    launches = _launches(wrappers)
    rows = [json.loads(r) for r in open(stats)]
    summ = json.loads(open(summary).read().splitlines()[-1])
    # the same command again: its first λ-trials no longer pay the
    # supernodal path's first-call costs (phase 4's runs follow a warm-up)
    warm_stats = os.path.join(tmp, "warm_stats.jsonl")
    _cli(cli, args[:-7] + ["-stats", warm_stats, "-summary", summary,
                           DATASET])
    warm = json.loads(open(summary).read().splitlines()[-1])
    warm_trials = max(sum(json.loads(r)["levenberg_iterations"]
                          for r in open(warm_stats)), 1)
    chis = [r["chi2"] for r in rows] + [summ["final_chi2"]]
    trials = max(sum(r["levenberg_iterations"] for r in rows), 1)
    g = g2o_format.load(out)
    g.set_robust_kernel("Huber", 1.0)
    p = g.compile(dtype=torch.float32, device="cuda")
    chi_back = float(p.chi2_fn(p.data, p.estimates)[0])
    rel = abs(chi_back - summ["final_chi2"]) / summ["final_chi2"]
    phase("cli_sphere", iterations=summ["iterations"], lm_trials=trials,
          chi2_0=f"{chis[0]:.4f}", chi2_final=f"{summ['final_chi2']:.4f}",
          bound=f"{CHI2_BOUND:.2f}",
          ms_per_lambda_trial=f"{summ['wall_s'] * 1e3 / trials:.3f}",
          warm_ms_per_lambda_trial=(
              f"{warm['wall_s'] * 1e3 / warm_trials:.3f}"),
          warm_lm_trials=warm_trials,
          warm_chi2_final=f"{warm['final_chi2']:.4f}",
          cli_wall_s=f"{wall:.3f}", reload_chi2=f"{chi_back:.4f}",
          reload_rel_diff=f"{rel:.3e}", gauge=err.count("fixed by node 0"),
          **{f"{k}_per_lambda_trial": f"{launches[k] / trials:.2f}"
             for k in KERNELS[:3]},
          **{f"launches_{k}": launches[k] for k in KERNELS[:3]})
    if not all(math.isfinite(c) for c in chis):
        raise RuntimeError(f"cli_sphere: non-finite chi2 {chis}")
    if not summ["final_chi2"] <= CHI2_BOUND:
        raise RuntimeError(f"cli_sphere: chi2 {summ['final_chi2']} above "
                           f"{CHI2_BOUND}")
    if any(launches[k] < 1 for k in KERNELS[:3]):
        raise RuntimeError(f"cli_sphere: K1/K2/K3 not all launched: "
                           f"{launches}")
    if not rel <= 1e-6:
        raise RuntimeError(f"cli_sphere: the written file's chi2 {chi_back} "
                           f"is not the summary's {summ['final_chi2']}")
    return launches


def cli_inc_phase(torch, g2o, cli, ck, wrappers, times, path):
    """``[cli_inc_manhattan]``: the incremental replay of manhattan3500
    through the CLI, f32, held to a cold batch run, to the reference's
    gn_var and, in ATE, to the reference's optimum; then K1/K2 at every
    shape the replay launched them at that no phase before holds
    (``[kernels_inc]``).  Returns ``(launches, recompiles, replay s)``."""
    import re

    from g2o_tpu_torch.io import g2o_format

    out = path.replace(".g2o", "_inc.g2o")
    chol_wrappers = (ck.chol_batched, ck.solve_lower_batched)
    for w in wrappers.values():
        w.launches = 0
    for w in chol_wrappers:
        w.shapes.clear()
    sout, err, wall = _cli(cli, CLI_INC_ARGS + [
        "-gt", MANHATTAN_REF_OPT, "-o", out, path])
    launches = _launches(wrappers)
    shapes = {w.__name__: dict(w.shapes) for w in chol_wrappers}
    chi, facts = _final_chi2(err)
    m = re.search(r"(\d+) vertices, (\d+) recompiles, (\S+) s", facts)
    n_vertices, recompiles, inc_s = int(m[1]), int(m[2]), float(m[3])
    ate = re.search(r"ATE\(rmse\)= (\S+)\s+RPE\(rmse\)= (\S+)", sout)
    updates = n_vertices // 10

    # the cold batch run over the same final graph: the manhattan path's
    # every_k LM from the file's estimates
    g = g2o_format.load(path)
    p = g.compile(dtype=torch.float32, device="cuda")
    batch = g2o.optimize_fused(p, g2o.PCGSolver(
        max_iter=32, tol=1e-2, precond="chunk2", chunk_size=16,
        precond_mode="every_k", precond_refresh_every=8), 60)
    rel = abs(chi - batch["chi2_final"]) / batch["chi2_final"]
    from g2o_tpu_torch.utils.metrics import ate as ate_fn
    ref = g2o_format.load(MANHATTAN_REF_OPT)
    est = p.estimates_by_vid()
    vids = sorted(est)
    batch_ate = ate_fn(np.stack([est[v] for v in vids]),
                       np.stack([ref.vertex(v).estimate for v in vids]))
    gn_bound = INC_GN_FACTOR * MANHATTAN_GN
    phase("cli_inc_manhattan", vertices=n_vertices, updates=updates,
          recompiles=recompiles, chi2_final=f"{chi:.4f}",
          batch_chi2=f"{batch['chi2_final']:.4f}", rel_diff=f"{rel:.3e}",
          limit="1e-2", gn_bound=f"{gn_bound:.4f}",
          ate_rmse=ate[1] if ate else None, ate_limit=INC_ATE_LIMIT,
          rpe_rmse=ate[2] if ate else None,
          batch_ate_rmse=f"{batch_ate:.6f}",
          ms_per_update=f"{inc_s * 1e3 / max(updates, 1):.3f}",
          inc_wall_s=f"{inc_s:.3f}", cli_wall_s=f"{wall:.3f}",
          coarse_shapes=";".join(f"{n}:{c}" for (_, n, _), c in sorted(
              shapes["chol_batched"].items())),
          **{f"launches_{k}": launches[k] for k in KERNELS[:3]})
    if not math.isfinite(chi) or rel > 1e-2:
        raise RuntimeError(f"cli_inc_manhattan: chi2 {chi} not within 1% of "
                           f"the batch run's {batch['chi2_final']}")
    if not chi <= gn_bound:
        raise RuntimeError(f"cli_inc_manhattan: chi2 {chi} above {gn_bound}")
    if any(launches[k] < 1 for k in KERNELS[:2]):
        raise RuntimeError(f"cli_inc_manhattan: K1/K2 not launched: "
                           f"{launches}")
    if ate is None:
        raise RuntimeError("cli_inc_manhattan: no ATE/RPE line")
    if not float(ate[1]) <= INC_ATE_LIMIT:
        raise RuntimeError(f"cli_inc_manhattan: ATE {ate[1]} above "
                           f"{INC_ATE_LIMIT}")
    # K1/K2 at every shape the replay gave them that no phase holds yet,
    # each checked in f32 and f64 and timed in f32
    new = sorted({sh for by in shapes.values() for sh in by} - set(SHAPES))
    rng = np.random.default_rng(13)
    for shape in new:
        for dtype in (torch.float32, torch.float64):
            res_k = chol_shape_check(torch, ck, rng, dtype, shape,
                                     KERNELS[:2], tag="kernels_inc")
            if res_k:
                times[_shape(*shape)] = res_k
    return launches, recompiles, inc_s


def trace_inc_phase(torch, g2o, path, recompiles, inc_s):
    """``[trace_cli_inc]``: the ``-inc`` update path over a window of
    manhattan3500, driven through :class:`IncrementalOptimizer` as the CLI
    drives it (edges by their largest vertex id, an update every 10 new
    vertices, one LM iteration on the CLI's frozen chunk2 PCG).  Times each
    update, apart those that recompiled, and splits the CLI replay's wall
    time by that; then ``torch.profiler`` over a few updates, each alone,
    keeping those that did not recompile."""
    from g2o_tpu_torch.core.incremental import IncrementalOptimizer
    from g2o_tpu_torch.io import g2o_format

    g = g2o_format.load(path)
    inc = IncrementalOptimizer(
        solver_factory=lambda: g2o.PCGSolver(
            max_iter=100, tol=1e-8, precond="chunk2", chunk_size=16,
            precond_mode="frozen"),
        dtype=torch.float32, device="cuda")
    vrecs = g.vertices()
    edges = iter(sorted(g.edges(), key=lambda e: max(e.vids)))
    added = set()

    def add_until(n_vertices):
        """Add edges (and their new vertices) until ``n_vertices`` are in."""
        for e in edges:
            for vid in e.vids:
                if vid not in added:
                    r = vrecs[vid]
                    inc.add_vertex(vid, r.vtype, r.estimate, fixed=r.fixed)
                    added.add(vid)
            inc.add_edge(e.etype, e.vids, e.measurement, e.information,
                         kernel=e.kernel, delta=e.delta, param_id=e.param_id,
                         level=e.level, active=e.active)
            if len(added) >= n_vertices:
                return

    def update():
        add_until(len(added) + 10)
        inc.optimize(1)

    add_until(INC_WINDOW_START)
    inc.optimize(10)
    plain, recompiling = [], []
    for _ in range(INC_WINDOW_TIMED):
        r0 = inc.recompiles
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update()
        torch.cuda.synchronize()
        (recompiling if inc.recompiles > r0 else plain).append(
            (time.perf_counter() - t0) * 1e3)
    by_kernel, launches, traced, skipped = {}, 0, 0, 0
    while traced < INC_WINDOW_TRACED and skipped <= INC_WINDOW_TRACED:
        r0 = inc.recompiles
        _, kern, n = _profile(update)
        torch.cuda.synchronize()
        if inc.recompiles > r0:
            skipped += 1
            continue
        traced += 1
        launches += n
        for us, key, count in kern:
            tot = by_kernel.setdefault(key, [0.0, 0])
            tot[0] += us
            tot[1] += count
    kern = sorted(((us, key, c) for key, (us, c) in by_kernel.items()),
                  reverse=True)
    plain_ms = float(np.median(plain))
    extra_ms = float(np.mean(recompiling)) - plain_ms if recompiling else None
    dev_ms = sum(k[0] for k in kern) / 1e3 / max(traced, 1)
    phase("trace_cli_inc", window_vertices=f"{INC_WINDOW_START}-{len(added)}",
          timed_updates=INC_WINDOW_TIMED, recompiles_in_window=len(
              recompiling),
          ms_per_update=f"{plain_ms:.3f}",
          ms_per_recompiling_update=(f"{np.mean(recompiling):.3f}"
                                     if recompiling else None),
          recompile_ms=f"{extra_ms:.3f}" if recompiling else None,
          cli_recompile_share=(f"{recompiles * extra_ms / 1e3 / inc_s:.4f}"
                               if recompiling else None),
          traced_updates=traced,
          recompiling_updates_not_traced=skipped,
          device_ms_per_update=f"{dev_ms:.3f}",
          device_busy_share=f"{dev_ms / plain_ms:.4f}",
          kernel_launches_per_update=f"{launches / max(traced, 1):.1f}",
          device_ops_per_update=(
              f"{sum(k[2] for k in kern) / max(traced, 1):.1f}"),
          top=_top(kern))
    if not kern:
        raise RuntimeError("the trace_cli_inc trace shows no device time")
    if not math.isfinite(float(inc.chi2())):
        raise RuntimeError("trace_cli_inc: non-finite chi2")


def guess_linear_phase(torch, g2o, cli, wrappers, path):
    """``[guess_linear_manhattan]``: -guessLinear then GN on the host
    Cholesky, f64, to the reference's gn_var fixed point; and the linear
    initialization on the card against the CPU."""
    from g2o_tpu_torch.core.slam2d_linear import solve_slam2d_linear
    from g2o_tpu_torch.io import g2o_format

    for w in wrappers.values():
        w.launches = 0
    _, err, wall = _cli(cli, ["-guessLinear", "-solver", "gn_host_chol",
                              "-fp64", "-i", "8", path])
    launches = _launches(wrappers)
    chi, _ = _final_chi2(err)
    poses, secs = {}, {}
    for dev in ("cuda", "cpu"):
        g = g2o_format.load(path)
        t0 = time.perf_counter()
        solve_slam2d_linear(g, dtype=torch.float64, device=dev)
        secs[dev] = time.perf_counter() - t0
        poses[dev] = np.stack([g.vertex(v).estimate
                               for v in sorted(g.vertices())])
    rel = float(np.abs(poses["cuda"] - poses["cpu"]).max()
                / np.abs(poses["cpu"]).max())
    bound = MANHATTAN_GN + 0.25
    phase("guess_linear_manhattan", chi2_final=f"{chi:.6f}",
          bound=f"{bound:.6f}", cli_wall_s=f"{wall:.3f}",
          linear_card_s=f"{secs['cuda']:.3f}",
          linear_cpu_s=f"{secs['cpu']:.3f}",
          linear_card_vs_cpu_rel=f"{rel:.3e}", limit="1e-8")
    if not chi <= bound:
        raise RuntimeError(f"guess_linear: chi2 {chi} above {bound}")
    if not rel <= 1e-8:
        raise RuntimeError(f"guess_linear: card poses {rel} from the CPU's")
    return launches


def structure_only_phase(torch, wrappers):
    """``[structure_only_ladybug]``: every ladybug point's own LM at once,
    f64, on the card against the CPU.  Each landmark's chi2 is held to the
    CPU's within 1e-10, the points within ``STRUCTURE_POINTS_LIMIT``."""
    import io as _io

    from g2o_tpu_torch.core.structure_only import structure_only_refine
    from g2o_tpu_torch.io import bal

    with gzip.open(os.path.join(BAL, LADYBUG), "rt") as fh:
        text = fh.read()
    t = "VERTEX_TRACKXYZ"

    def run(dev):
        p = bal.load_bal_problem(_io.StringIO(text), huber=0.0,
                                 fix_first_camera=False,
                                 dtype=torch.float64, device=dev)
        rng = np.random.default_rng(STRUCTURE_SEED)
        x = p.estimates[t].cpu().numpy() + STRUCTURE_SIGMA * \
            rng.standard_normal(tuple(p.estimates[t].shape))
        est = dict(p.estimates)
        est[t] = torch.as_tensor(x, dtype=torch.float64, device=dev)
        p.set_estimates(est)
        if dev == "cuda":
            for w in wrappers.values():
                w.launches = 0
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        (before, after), = structure_only_refine(
            p, n_iters=STRUCTURE_ITERS).values()
        secs = time.perf_counter() - t0
        return before, after, p.estimates[t].cpu().numpy(), secs

    before, after, pts, ms_card = run("cuda")
    launches = _launches(wrappers)
    _, after_cpu, pts_cpu, ms_cpu = run("cpu")

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    rel_pts, rel_chi = rel(pts, pts_cpu), rel(after, after_cpu)
    cut = before.sum() / after.sum()
    phase("structure_only_ladybug", points=len(after),
          iterations=STRUCTURE_ITERS, chi2_before=f"{before.sum():.4f}",
          chi2_after=f"{after.sum():.4f}", cut=f"{cut:.2f}",
          landmarks_up=int((after > before).sum()),
          chi2_card_vs_cpu_rel=f"{rel_chi:.3e}", chi2_limit="1e-10",
          points_card_vs_cpu_rel=f"{rel_pts:.3e}",
          points_limit=STRUCTURE_POINTS_LIMIT,
          ms=f"{ms_card * 1e3:.3f}", cpu_ms=f"{ms_cpu * 1e3:.3f}")
    if (after > before).any() or not cut >= 10:
        raise RuntimeError(f"structure_only: chi2 {before.sum()} -> "
                           f"{after.sum()}, {(after > before).sum()} up")
    if not rel_chi <= 1e-10:
        raise RuntimeError(f"structure_only: card chi2 {rel_chi} from the "
                           f"CPU's")
    if not rel_pts <= STRUCTURE_POINTS_LIMIT:
        raise RuntimeError(f"structure_only: card points {rel_pts} from the "
                           f"CPU's")
    return launches


def write_debug_phase(torch, g2o, tmp):
    """``[write_debug]``: an exactly-converged pose graph on the card (chi2
    0), so every LM trial is rejected and the failed step is dumped."""
    from g2o_tpu_torch.types.slam2d import EdgeSE2, VertexSE2

    g = g2o.Graph()
    g.add_vertex(0, VertexSE2, np.zeros(3), fixed=True)
    g.add_vertex(1, VertexSE2, [1.0, 0.0, 0.0])
    g.add_vertex(2, VertexSE2, [2.0, 1.0, 0.0])
    g.add_edge(EdgeSE2, [0, 1], [1.0, 0.0, 0.0], np.eye(3))
    g.add_edge(EdgeSE2, [1, 2], [1.0, 1.0, 0.0], np.eye(3))
    p = g.compile(dtype=torch.float32, device="cuda")
    opt = g2o.SparseOptimizer(
        p, algorithm=g2o.LevenbergMarquardt(max_trials_after_failure=2),
        solver=g2o.DenseSolver())
    opt.write_debug = os.path.join(tmp, "debug")
    import contextlib
    import io as _io

    with contextlib.redirect_stderr(_io.StringIO()):
        done = opt.optimize(3)
    files = sorted(os.listdir(opt.write_debug))
    keys = set(np.load(os.path.join(opt.write_debug, files[0])).files) \
        if files else set()
    phase("write_debug", iterations_done=done, files=",".join(files),
          keys=",".join(sorted(keys)), jax_keys=keys == DEBUG_KEYS)
    if done != 0 or files != ["g2o_tpu_debug_it0.npz"] or keys != DEBUG_KEYS:
        raise RuntimeError(f"write_debug: {done} iterations, {files}, "
                           f"{sorted(keys)}")


def cli_phase(torch, g2o, ck, wrappers, times):
    """Phase 13; returns the launch counts of each of its paths."""
    from g2o_tpu_torch.apps import cli
    from g2o_tpu_torch.io import g2o_format
    from g2o_tpu_torch.sim.generators import create_manhattan

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        by_path = {"cli_sphere": cli_sphere_phase(torch, g2o, cli, wrappers,
                                                  tmp)}
        path = os.path.join(tmp, "manhattan3500.g2o")
        g2o_format.save(create_manhattan(n_poses=3500, seed=0), path)
        by_path["cli_inc_manhattan"], recompiles, inc_s = cli_inc_phase(
            torch, g2o, cli, ck, wrappers, times, path)
        trace_inc_phase(torch, g2o, path, recompiles, inc_s)
        by_path["guess_linear_manhattan"] = guess_linear_phase(
            torch, g2o, cli, wrappers, path)
        by_path["structure_only_ladybug"] = structure_only_phase(torch,
                                                                 wrappers)
        write_debug_phase(torch, g2o, tmp)
    phase("done_cli", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return by_path


# --------------------------------------------------------------------- #
# phase 14: the fast loader, the apps, the FLOP model and the examples
# --------------------------------------------------------------------- #

def _same_problem_arrays(torch, pa, pb):
    """The fields in which two problems' tensors differ (bit for bit)."""
    def torch_equal(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and bool(
            torch.equal(a, b))

    bad = []
    if list(pa.estimates) != list(pb.estimates) or \
            dict(pa.vid_index) != dict(pb.vid_index):
        bad.append("layout")
    for t in pb.estimates:
        if not torch_equal(pa.estimates[t], pb.estimates[t]):
            bad.append(f"estimates[{t}]")
        if not torch_equal(pa.data.fixed[t], pb.data.fixed[t]):
            bad.append(f"fixed[{t}]")
        if not np.array_equal(pa.marginalized[t], pb.marginalized[t]):
            bad.append(f"marginalized[{t}]")
    if list(pa.data.edges) != list(pb.data.edges):
        bad.append("edge types")
    for name, b in pb.data.edges.items():
        for f in b._fields:
            if not torch_equal(getattr(pa.data.edges[name], f),
                               getattr(b, f)):
                bad.append(f"{name}.{f}")
    return bad


def fast_load_phase(torch, g2o, wrappers):
    """``[fast_load]``: ``g2o_fast.load_problem`` on sphere2500 (Huber 1.0,
    no gauge added, as phase 4 loads it) and on the reference's manhattan
    optimum, each against the object loader's ``compile`` bit for bit;
    then ``[fast_sphere]``: phase 4's f32 chunk2 LM from the fast-loaded
    problem (timed, its launches counted), and the same LM from the
    fast-loaded and from the object-loaded problem under PyTorch's
    deterministic algorithms, the chi2 histories within
    ``FAST_CHI2_RTOL``.  Returns the launches of the fast-loaded run and
    ``(problem, solver, result)`` for the FLOP model."""
    from g2o_tpu_torch import native
    from g2o_tpu_torch.io import g2o_fast, g2o_format

    lib = native.get_fastparse_lib()
    if lib is None:
        raise RuntimeError("fast_load: the native tokenizer did not build")
    loaded = {}
    for path, kernel in ((DATASET, "Huber"), (MANHATTAN_REF_OPT, None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pf, aux = g2o_fast.load_problem(path, dtype=torch.float32,
                                        device="cuda", kernel=kernel,
                                        delta=1.0, fix_first_if_free=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g = g2o_format.load(path)
        if kernel:
            g.set_robust_kernel(kernel, 1.0)
        po = g.compile(dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        bad = _same_problem_arrays(torch, pf, po)
        phase("fast_load", file=os.path.basename(path),
              native=os.path.basename(lib._name), vertices=g.num_vertices,
              edges=g.num_edges, fixed=sum(int(f.sum())
                                           for f in pf.data.fixed.values()),
              fast_s=f"{t1 - t0:.3f}", object_s=f"{t2 - t1:.3f}",
              speedup=f"{(t2 - t1) / (t1 - t0):.2f}",
              bit_equal=not bad, differ=",".join(bad) or "-")
        if "params" not in aux:
            raise RuntimeError("fast_load: the object loader answered")
        if bad:
            raise RuntimeError(f"fast_load: {path} differs in {bad}")
        loaded[path] = (pf, po)

    pf, po = loaded[DATASET]
    est0 = {t: v.clone() for t, v in pf.estimates.items()}

    def lm(p):
        solver = g2o.PCGSolver(max_iter=50, tol=1e-1, precond="chunk2",
                               chunk_size=16)
        g2o.optimize_fused(p, solver, 2)                 # warm-up
        _reset(p, est0)
        for w in wrappers.values():
            w.launches = 0
        return g2o.optimize_fused(p, solver, FAST_ITERS), solver

    res, solver = lm(pf)
    launches = _launches(wrappers)
    # the pair under PyTorch's deterministic algorithms: otherwise the
    # card's index_add_ adds in a run-dependent order, and two f32 runs
    # from the same arrays part by up to 1.4e-4 on the way down
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        pair = {which: lm(p)[0] for which, p in (("object", po),
                                                  ("fast", pf))}
    finally:
        torch.use_deterministic_algorithms(False)
    hist = {k: r["chi2_per_iteration"] + [r["chi2_final"]]
            for k, r in pair.items()}
    rel = max(abs(a - b) / b for a, b in zip(hist["fast"], hist["object"]))
    ca = res["chi2_per_iteration"] + [res["chi2_final"]]
    trials = max(sum(res["trials_per_iteration"]), 1)
    phase("fast_sphere", iterations=res["iterations"], lm_trials=trials,
          ms_per_lambda_trial=f"{res['wall_s'] * 1e3 / trials:.3f}",
          chi2_final=f"{res['chi2_final']:.4f}", bound=f"{CHI2_BOUND:.2f}",
          deterministic_iterations=pair["fast"]["iterations"],
          deterministic_object_iterations=pair["object"]["iterations"],
          deterministic_chi2_final=f"{pair['fast']['chi2_final']:.4f}",
          deterministic_max_rel_diff=f"{rel:.3e}", limit=FAST_CHI2_RTOL,
          **{f"{k}_per_lambda_trial": f"{launches[k] / trials:.2f}"
             for k in KERNELS[:2]},
          **{f"launches_{k}": v for k, v in launches.items()})
    if not all(math.isfinite(c) for c in ca):
        raise RuntimeError("fast_sphere: non-finite chi2")
    if any(launches[k] < 1 for k in KERNELS[:2]):
        raise RuntimeError(f"fast_sphere: K1/K2 not launched: {launches}")
    if not res["chi2_final"] <= CHI2_BOUND:
        raise RuntimeError(f"fast_sphere: final chi2 {res['chi2_final']}")
    if len(hist["fast"]) != len(hist["object"]) or \
            not rel <= FAST_CHI2_RTOL:
        raise RuntimeError(f"fast_sphere: chi2 {hist['fast']} against the "
                           f"object-loaded run's {hist['object']}")
    return launches, (pf, solver, res)


def _hier_graph(name):
    from g2o_tpu_torch.io import g2o_format
    from g2o_tpu_torch.sim.generators import create_manhattan

    if name == "manhattan":
        return create_manhattan(n_poses=3500, seed=0)
    g = g2o_format.load(DATASET)
    g.set_robust_kernel("Huber", 1.0)
    g.set_fixed(0, True)         # the fast loader's gauge
    return g


def hierarchical_phase(torch, g2o, wrappers):
    """``[hierarchical_<scene>]``: ``optimize_hierarchical`` with its
    defaults in f32 on the card, on ``create_manhattan(3500, seed=0)`` and
    on sphere2500 (Huber 1.0, vertex 0 fixed as the fast loader fixes it):
    the final chi2 below half the start's and within ``HIER_FLAT_FACTOR``
    of 30 flat LM iterations from the same start
    (``tests/test_hierarchical.py``'s bar), the seconds of each stage
    (``utils.tictoc``), and the stars and the skeleton's size as a CPU
    run's (the host's BFS decides them; on sphere2500 the CPU run makes one
    LM iteration a stage, ``HIER_CPU_COUNT_ITERS``).  On manhattan3500 also
    an f64 card run against the f64 CPU run, final chi2 within
    ``HIER_F64_RTOL``.  Returns the launches of each f32 card run."""
    from g2o_tpu_torch.apps.hierarchical import optimize_hierarchical
    from g2o_tpu_torch.utils import tictoc

    os.environ["G2O_ENABLE_TICTOC"] = "1"
    by_path = {}
    keys = ("n_stars", "levels", "skeleton_vertices", "skeleton_edges")
    short = dict(star_iterations=HIER_CPU_COUNT_ITERS,
                 skeleton_iterations=HIER_CPU_COUNT_ITERS,
                 refine_iterations=HIER_CPU_COUNT_ITERS)
    try:
        for name in ("manhattan", "sphere"):
            g = _hier_graph(name)
            p = g.compile(dtype=torch.float32, device="cuda")
            chi0 = float(p.chi2_fn(p.data, p.estimates)[0])
            t0 = time.perf_counter()
            flat = g2o.SparseOptimizer(
                p, solver=g2o.PCGSolver(max_iter=100, tol=1e-8))
            flat.optimize(30)
            chi_flat = flat.chi2()
            flat_s = time.perf_counter() - t0
            del p, flat
            plan = [("f32", torch.float32, "cuda", {})]
            plan += ([("f64", torch.float64, "cuda", {}),
                      ("cpu", torch.float64, "cpu", {})]
                     if name == "manhattan"
                     else [("cpu", torch.float64, "cpu", short)])
            runs = {}
            for tag, dtype, device, kw in plan:
                g = _hier_graph(name)
                tictoc._STATS.clear()
                for w in wrappers.values():
                    w.launches = 0
                t0 = time.perf_counter()
                r = optimize_hierarchical(g, dtype=dtype, device=device,
                                          **kw)
                secs = time.perf_counter() - t0
                runs[tag] = (r, secs, {k[len("hierarchical_"):]: v["total"]
                                       for k, v in tictoc.stats().items()},
                             _launches(wrappers))
            r, secs, stages, launches = runs["f32"]
            r_cpu = runs["cpu"][0]
            same = all(r[k] == r_cpu[k] for k in keys)
            f64 = {}
            if "f64" in runs:
                r64 = runs["f64"][0]
                same = same and all(r64[k] == r_cpu[k] for k in keys)
                rel64 = abs(r64["final_chi2"] - r_cpu["final_chi2"]) / \
                    r_cpu["final_chi2"]
                f64 = dict(f64_chi2=f"{r64['final_chi2']:.6f}",
                           cpu_f64_chi2=f"{r_cpu['final_chi2']:.6f}",
                           f64_rel_diff=f"{rel64:.3e}",
                           f64_limit=HIER_F64_RTOL,
                           f64_seconds=f"{runs['f64'][1]:.2f}")
            phase(f"hierarchical_{name}", **{k: r[k] for k in keys},
                  chi2_start=f"{chi0:.4f}",
                  chi2_final=f"{r['final_chi2']:.4f}",
                  flat_chi2=f"{chi_flat:.4f}",
                  flat_limit=f"{HIER_FLAT_FACTOR * chi_flat:.4f}",
                  seconds=f"{secs:.2f}", flat_seconds=f"{flat_s:.2f}",
                  **{f"{k}_s": f"{v:.2f}" for k, v in stages.items()},
                  counts_as_cpu=same, cpu_seconds=f"{runs['cpu'][1]:.2f}",
                  **f64)
            if not same:
                raise RuntimeError(f"hierarchical {name}: card {r} against "
                                   f"CPU {r_cpu}")
            if not (r["final_chi2"] < 0.5 * chi0 and
                    r["final_chi2"] <= HIER_FLAT_FACTOR * chi_flat):
                raise RuntimeError(f"hierarchical {name}: chi2 "
                                   f"{r['final_chi2']} from {chi0}, flat "
                                   f"{chi_flat}")
            if f64 and not rel64 <= HIER_F64_RTOL:
                raise RuntimeError(f"hierarchical {name}: f64 card "
                                   f"{r64['final_chi2']} against CPU "
                                   f"{r_cpu['final_chi2']}")
            by_path[f"hierarchical_{name}"] = launches
    finally:
        os.environ.pop("G2O_ENABLE_TICTOC", None)
    return by_path


def _protocol_2d(g, every, n_poses=None):
    """A 2D pose graph as an online session's protocol lines: each pose,
    then the edges that close on it, ``SOLVE_STATE`` after every
    ``every`` poses and at the end; the first ``n_poses`` poses only when
    given."""
    vids = sorted(g.vertices())[:n_poses]
    closing = {}
    for e in g.edges():
        closing.setdefault(max(e.vids), []).append(e)
    iu = np.triu_indices(3)
    lines, k = [], 0
    for j, vid in enumerate(vids, 1):
        x = g.vertex(vid).estimate
        lines.append(f"ADD VERTEX_XYT {vid} "
                     + " ".join(f"{v:.17g}" for v in x) + ";")
        for e in closing.get(vid, ()):
            nums = (f"{v:.17g}" for v in (*e.measurement,
                                          *e.information[iu]))
            lines.append(" ".join(["ADD EDGE_XYT", str(k),
                                   *map(str, e.vids), *nums]) + ";")
            k += 1
        if j % every == 0:
            lines.append("SOLVE_STATE;")
    if len(vids) % every:
        lines.append("SOLVE_STATE;")
    return lines + ["QUERY_STATE;"]


def _protocol_3d(g):
    """A quaternion SE3 graph as ``VERTEX_XYZRPY`` / ``EDGE_XYZRPY`` lines
    (roll-pitch-yaw, the information in the Euler basis), one
    ``SOLVE_STATE`` at the end."""
    from g2o_tpu_torch.apps.interactive import _quat_to_rpy
    from g2o_tpu_torch.types.slam3d_addons import _edge3_info_to_io

    lines = []
    for vid in sorted(g.vertices()):
        x = g.vertex(vid).estimate
        v = (*x[:3], *_quat_to_rpy(x[3:7]))
        lines.append(f"ADD VERTEX_XYZRPY {vid} "
                     + " ".join(f"{a:.17g}" for a in v) + ";")
    iu = np.triu_indices(6)
    for k, e in enumerate(g.edges()):
        m = e.measurement
        info = _edge3_info_to_io(e.information, m)[iu]
        nums = (f"{a:.17g}" for a in (*m[:3], *_quat_to_rpy(m[3:7]), *info))
        lines.append(" ".join(["ADD EDGE_XYZRPY", str(k), *map(str, e.vids),
                               *nums]) + ";")
    return lines + ["SOLVE_STATE;", "QUERY_STATE;"]


def _first_poses(line, n):
    """Whether a protocol line stays in a replay cut to vertices ``< n``."""
    tok = line.rstrip(";").split()
    if tok[0] != "ADD":
        return True
    ids = tok[2:3] if tok[1].startswith("VERTEX") else tok[3:5]
    return all(int(v) < n for v in ids)


def _replay(srv, lines):
    """Feed the protocol lines; returns (the last response, ms of each
    SOLVE_STATE)."""
    import torch

    solve_ms, resp = [], None
    for ln in lines:
        if ln.startswith("SOLVE"):
            t0 = time.perf_counter()
            srv.handle_line(ln)
            torch.cuda.synchronize()
            solve_ms.append((time.perf_counter() - t0) * 1e3)
        else:
            r = srv.handle_line(ln)
            resp = r if r is not None else resp
    return resp, solve_ms


def _query_error(srv, text):
    """Largest |printed - estimate| / max(1, |estimate|) over a
    ``QUERY_STATE`` response, each vertex read back as its printed
    coordinates."""
    from g2o_tpu_torch.apps.interactive import _quat_to_rpy

    worst = 0.0
    rows = text.splitlines()
    if rows[0] != "BEGIN" or rows[-1] != "END":
        raise RuntimeError(f"interactive: malformed response {rows[:2]}")
    for row in rows[1:-1]:
        tok = row.split()
        vid, vals = int(tok[1]), np.array([float(x) for x in tok[2:]])
        est = srv.inc.get_estimate(vid).astype(np.float64)
        if tok[0] == "VERTEX_XYZRPY":
            est = np.concatenate([est[:3], _quat_to_rpy(est[3:7])])
        worst = max(worst, float(np.max(np.abs(vals - est)
                                        / np.maximum(1.0, np.abs(est)))))
    return worst, len(rows) - 2


def interactive_phase(torch, g2o, wrappers):
    """``[interactive_<scene>]``: ``create_manhattan(3500, seed=0)`` as
    ``VERTEX_XYT`` / ``EDGE_XYT`` lines with ``SOLVE_STATE`` every
    ``INTER_EVERY`` poses, and sphere2500 as ``VERTEX_XYZRPY`` /
    ``EDGE_XYZRPY`` lines with one ``SOLVE_STATE``, through
    ``InteractiveSlam.handle_line`` in f32 on the card (5 LM iterations a
    solve): the final ``QUERY_STATE`` read back matches the estimates to
    the printed digits (``INTER_PRINT_RTOL``) and the chi2 fell; then each
    replay cut to its first ``INTER_F64_POSES`` poses in f64 on the card
    and on the CPU, the final chi2 within ``INTER_F64_RTOL``.  Returns the
    launches of each f32 replay."""
    from g2o_tpu_torch.apps.interactive import InteractiveSlam
    from g2o_tpu_torch.io import g2o_format
    from g2o_tpu_torch.sim.generators import create_manhattan

    scenes = {"manhattan": create_manhattan(n_poses=3500, seed=0),
              "sphere": g2o_format.load(DATASET)}
    by_path = {}
    for name, g in scenes.items():
        if name == "manhattan":
            lines = _protocol_2d(g, INTER_EVERY)
            cut = _protocol_2d(g, INTER_EVERY, INTER_F64_POSES)
        else:
            lines = _protocol_3d(g)
            cut = [ln for ln in lines if _first_poses(ln, INTER_F64_POSES)]
        for w in wrappers.values():
            w.launches = 0
        srv = InteractiveSlam(dtype=torch.float32, device="cuda")
        t0 = time.perf_counter()
        resp, solve_ms = _replay(srv, lines)
        secs = time.perf_counter() - t0
        launches = _launches(wrappers)
        err, n_rows = _query_error(srv, resp)
        chi = srv.inc.chi2()
        chi_f64 = {}
        for device in ("cuda", "cpu"):
            s = InteractiveSlam(dtype=torch.float64, device=device)
            _replay(s, cut)
            chi_f64[device] = s.inc.chi2()
        rel = abs(chi_f64["cuda"] - chi_f64["cpu"]) / chi_f64["cpu"]
        p0 = g.compile(dtype=torch.float64, device="cuda")
        chi0 = float(p0.chi2_fn(p0.data, p0.estimates)[0])
        phase(f"interactive_{name}", lines=len(lines),
              solves=len(solve_ms), vertices=n_rows,
              seconds=f"{secs:.2f}",
              ms_per_solve=f"{np.mean(solve_ms):.1f}",
              last_solve_ms=f"{solve_ms[-1]:.1f}",
              recompiles=srv.inc.recompiles, chi2_start=f"{chi0:.4f}",
              chi2_final=f"{chi:.4f}", query_rel_err=f"{err:.3e}",
              query_limit=INTER_PRINT_RTOL,
              f64_poses=INTER_F64_POSES,
              f64_chi2=f"{chi_f64['cuda']:.6f}",
              cpu_f64_chi2=f"{chi_f64['cpu']:.6f}",
              f64_rel_diff=f"{rel:.3e}", f64_limit=INTER_F64_RTOL,
              **{f"launches_{k}": v for k, v in launches.items() if v})
        if n_rows != g.num_vertices or not err <= INTER_PRINT_RTOL:
            raise RuntimeError(f"interactive {name}: {n_rows} rows, "
                               f"printed estimates {err} off")
        if not (math.isfinite(chi) and chi < chi0):
            raise RuntimeError(f"interactive {name}: chi2 {chi0} -> {chi}")
        if not rel <= INTER_F64_RTOL:
            raise RuntimeError(f"interactive {name}: f64 card {chi_f64}")
        by_path[f"interactive_{name}"] = launches
    return by_path


def segment_apps_phase(torch, g2o, wrappers, g2d):
    """``[convert_segment_line]`` and ``[anonymize]`` on phase 12's 2D
    simulator graph: the converted graph compiles on the card and 5 f32 LM
    iterations cut its chi2; the anonymized graph detaches as many
    endpoints as the JAX package's rule counts.  Returns the launches of
    the converted graph's LM run."""
    from g2o_tpu_torch.apps import anonymize, convert_segment_line

    t0 = time.perf_counter()
    out = convert_segment_line.convert(g2d)
    conv_s = time.perf_counter() - t0
    p = out.compile(dtype=torch.float32, device="cuda")
    chi0 = float(p.chi2_fn(p.data, p.estimates)[0])
    for w in wrappers.values():
        w.launches = 0
    opt = g2o.SparseOptimizer(p, solver=g2o.PCGSolver(max_iter=100,
                                                      tol=1e-8))
    t0 = time.perf_counter()
    opt.optimize(SEG_ITERS)
    chi = opt.chi2()
    lm_s = time.perf_counter() - t0
    launches = _launches(wrappers)
    phase("convert_segment_line", vertices=out.num_vertices,
          edges=out.num_edges,
          vertex_types=_counts(r.vtype.name for r in out.vertices().values()),
          edge_types=_counts(e.etype.name for e in out.edges()),
          convert_s=f"{conv_s:.2f}", iterations=SEG_ITERS,
          chi2_start=f"{chi0:.4f}", chi2_final=f"{chi:.4f}",
          lm_s=f"{lm_s:.2f}")
    if not (math.isfinite(chi) and chi < chi0) or any(
            "SEGMENT" in r.vtype.name for r in out.vertices().values()):
        raise RuntimeError(f"convert_segment_line: chi2 {chi0} -> {chi}")
    # the JAX package's rule, counted before the graph is changed
    want = sum(1 for e in g2d.edges()
               if (e.etype.name in anonymize.LANDMARK_EDGES
                   and e.vids[1] != anonymize.UNASSIGNED)
               or (e.etype.name in anonymize.POSE_EDGES
                   and anonymize.UNASSIGNED not in e.vids
                   and abs(e.vids[0] - e.vids[1]) > 1))
    t0 = time.perf_counter()
    n = anonymize.anonymize(g2d)
    anon_s = time.perf_counter() - t0
    left = sum(1 for e in g2d.edges()
               if e.etype.name in anonymize.LANDMARK_EDGES
               and e.vids[1] != anonymize.UNASSIGNED)
    phase("anonymize", edges=g2d.num_edges, detached=n, expected=want,
          landmark_endpoints_left=left, seconds=f"{anon_s:.2f}")
    if n != want or left:
        raise RuntimeError(f"anonymize: {n} detached, {want} expected, "
                           f"{left} left")
    return launches


def flops_phase(torch, card, runs):
    """``[flops]``: the analytic FLOP model (``utils.flops``) of each run,
    its achieved rate and share of the card's published peak for the
    run's dtype; the share must lie in (0, 1)."""
    from g2o_tpu_torch.utils import flops

    for name, (p, solver, res) in runs.items():
        rep = flops.mfu_report(p, solver, res)
        if rep is None:
            raise RuntimeError(f"flops {name}: no model or no peak for "
                               f"{torch.cuda.get_device_name(0)}")
        phase("flops", run=name, card=card.replace(" ", "_"),
              dtype=rep["peak_dtype"],
              algorithmic_flops=f"{rep['algorithmic_flops']:.6e}",
              wall_s=f"{res['wall_s']:.4f}",
              achieved_flops_per_s=f"{rep['achieved_flops_per_s']:.6e}",
              peak_flops_per_s=f"{rep['peak_flops_per_s']:.3e}",
              share_of_peak=f"{rep['mfu_vs_peak']:.3e}")
        if not 0.0 < rep["mfu_vs_peak"] < 1.0:
            raise RuntimeError(f"flops {name}: share {rep['mfu_vs_peak']}")


def examples_phase(torch, wrappers, tmp):
    """``[examples]``: every script of ``g2o_tpu_torch/examples`` in this
    process with ``-device cuda``, at its own size (the file-reading ones
    on sphere2500 and the reference's manhattan optimum), then with
    ``-device cpu``; what each prints (and returns) held to the CPU run's
    within its tolerance in ``EXAMPLES``
    (``g2o_tpu_torch.examples.output_difference``).  Returns the launches of
    the card runs."""
    import contextlib
    import importlib
    import io
    import shutil

    from g2o_tpu_torch.examples import output_difference

    shutil.copy(DATASET, os.path.join(tmp, "sphere2500.g2o"))
    shutil.copy(MANHATTAN_REF_OPT, os.path.join(tmp, "manhattan.g2o"))
    for w in wrappers.values():
        w.launches = 0
    card_launches = {k: 0 for k in wrappers}
    total = {"cuda": 0.0, "cpu": 0.0}
    for name, args, rtol in EXAMPLES:
        mod = importlib.import_module(f"g2o_tpu_torch.examples.{name}")
        out = {}
        for device in ("cuda", "cpu"):
            d = os.path.join(tmp, f"{name}_{device}")
            os.makedirs(d, exist_ok=True)
            a = [x.replace("{tmp}", tmp).replace("{dir}", d) for x in args]
            buf = io.StringIO()
            cwd = os.getcwd()
            os.chdir(d)
            try:
                for w in wrappers.values():
                    w.launches = 0
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    ret = mod.main([*a, "-device", device])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
            if device == "cuda":
                for k, w in wrappers.items():
                    card_launches[k] += w.launches
            text = buf.getvalue().replace(d, "{dir}")
            out[device] = (ret, text, secs)
            total[device] += secs
        (rc, tc, sc), (rp, tp, sp) = out["cuda"], out["cpu"]
        diff = output_difference(tc, tp, rtol)
        if diff is None and isinstance(rp, np.ndarray):
            if not np.allclose(rc, rp, rtol=0, atol=1e-9):
                diff = f"returned {rc} / {rp}"
        elif diff is None and rc != rp:
            diff = f"returned {rc} / {rp}"
        last = [ln for ln in tc.splitlines() if ln.strip()][-1]
        phase("examples", name=name, seconds=f"{sc:.2f}",
              cpu_seconds=f"{sp:.2f}", same_as_cpu=diff is None,
              rtol=rtol, last=last.replace(" ", "_")[:100])
        if diff is not None:
            raise RuntimeError(f"example {name}: card against CPU: {diff}")
    phase("examples_total", count=len(EXAMPLES),
          seconds=f"{total['cuda']:.1f}", cpu_seconds=f"{total['cpu']:.1f}")
    return card_launches


def apps_phase(torch, g2o, wrappers, card, keep):
    """Phase 14; returns the launch counts of each of its paths."""
    t_phase = time.perf_counter()
    by_path = {}
    by_path["fast_sphere"], fast_run = fast_load_phase(torch, g2o, wrappers)
    by_path.update(hierarchical_phase(torch, g2o, wrappers))
    by_path.update(interactive_phase(torch, g2o, wrappers))
    by_path["convert_segment_line"] = segment_apps_phase(
        torch, g2o, wrappers, keep.pop("sim2d_graph"))
    flops_phase(torch, card, {"fast_sphere": fast_run,
                              "ba_implicit": keep.pop("ba_implicit")})
    with tempfile.TemporaryDirectory() as tmp:
        by_path["examples"] = examples_phase(torch, wrappers, tmp)
    phase("done_apps", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return by_path


def _spawn_workers(nproc, backend, cases, out, timeout=PARALLEL_TIMEOUT):
    """Run ``python -m g2o_tpu_torch.parallel.worker`` as ``nproc``
    processes on the card (every rank's tensors on ``cuda:0``) and wait
    for them; a process that exits non-zero fails the phase.  Returns rank
    0's results and the kernel launches of every rank."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("LOCAL_WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "g2o_tpu_torch.parallel.worker",
         "--init-method", f"tcp://127.0.0.1:{port}", "--nproc", str(nproc),
         "--pid", str(r), "--device", "cuda", "--backend", backend,
         "--case", cases, "--iters", str(SHARDED_ITERS),
         "--sba-iters", str(SHARDED_SBA_ITERS), "--sba-scene",
         ",".join(str(SBA_SCENE[k]) for k in ("n_cameras", "n_points",
                                                "seed")),
         "--n-poses", str(SHARDED_MANHATTAN_POSES), "--g2o", DATASET,
         "--bal", os.path.join(BAL, LADYBUG), "--out", out],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(nproc)]
    try:
        logs = [pr.communicate(timeout=timeout)[0] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for r, (pr, log) in enumerate(zip(procs, logs)):
        if pr.returncode != 0:
            raise RuntimeError(f"parallel worker rank {r} ({backend}, "
                               f"{cases}) exited {pr.returncode}:\n"
                               f"{log[-4000:]}")
    with open(out) as fh:
        res = json.load(fh)
    ranks = [res["launches"]]
    for r in range(1, nproc):
        with open(f"{out}.rank{r}") as fh:
            ranks.append(json.load(fh)["launches"])
    return res, ranks


def _rank_sum(ranks, path):
    """A path's launches, summed over the ranks."""
    out = {}
    for launches in ranks:
        for k, v in launches.get(path, {}).items():
            out[k] = out.get(k, 0) + v
    return out


def _need_launched(path, launches, kernels):
    if any(launches.get(k, 0) < 1 for k in kernels):
        raise RuntimeError(f"{path}: a kernel was not launched in the "
                           f"ranks' run: {launches}")


def _need_launched_every_rank(path, ranks, kernels):
    """Each rank's run of ``path`` launched every kernel of ``kernels``."""
    for r, launches in enumerate(ranks):
        _need_launched(f"{path} rank {r}", launches.get(path, {}), kernels)


def rowmajor_kernel_rows(torch, oh, rng, ids, S, widths, tag):
    """K7 (the row-major gather, ``onehot_gather``) and K8 (the row-major
    segment sum, ``onehot_scatter_add``) at one rank's held camera ids of a
    sharded path: against their plain versions (float32 and float64; the
    gather bit for bit), then K7 at the gathered width and K8 at both
    widths timed in float32 beside the plain version and the library call
    (``index_select`` / ``index_add`` over a zero row past the table), in
    turns, with the bound and the device µs and operations of one call.
    Returns ``{shape: {kernel: facts}}``."""
    out = {}
    N = ids.shape[0]
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        for D in widths:
            table = torch.as_tensor(rng.standard_normal((S, D)), dtype=dtype,
                                    device="cuda")
            rows = torch.as_tensor(rng.standard_normal((N, D)), dtype=dtype,
                                   device="cuda")
            fns = {"onehot_gather": (
                       lambda: oh.onehot_gather(ids, table),
                       lambda: oh.onehot_gather_plain(ids, table)),
                   "onehot_scatter_add": (
                       lambda: oh.onehot_scatter_add(ids, rows, S),
                       lambda: oh.onehot_scatter_add_plain(ids, rows, S))}
            rel, err = {}, {}
            for k, (kern, plain) in fns.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                err[k] = (got - want).abs().max().item()
                rel[k] = err[k] / max(want.abs().max().item(), 1e-300)
            same = torch.equal(fns["onehot_gather"][0](),
                               fns["onehot_gather"][1]())
            shape = f"{N}x{D}<->{S}"
            ok = rel["onehot_scatter_add"] <= TOL[dname] and same
            phase("kernels", kernel="gather+segment_sum", dtype=dname,
                  shape=shape, ids=tag,
                  **{f"{k}_rel_err": f"{v:.3e}" for k, v in rel.items()},
                  gather_bit_equal=same, tol=TOL[dname], ok=ok)
            if not ok:
                raise RuntimeError(f"a row-major kernel disagrees with its "
                                   f"plain version at {tag} {dname} {shape}: "
                                   f"{rel}, gather bit-equal {same}")
            if dtype != torch.float32:
                continue
            tz = torch.cat([table, table.new_zeros((1, D))])
            Z = tz.new_zeros((S + 1, D))
            lib = {"onehot_gather": lambda: torch.index_select(tz, 0, ids),
                   "onehot_scatter_add": lambda: torch.index_add(
                       Z, 0, ids, rows)}
            for k, (kern, plain) in fns.items():
                if k == "onehot_gather" and D != widths[0]:
                    continue          # the paths gather the cameras' states
                t = _in_turns(torch, {"plain_ms": plain,
                                      "library_ms": lib[k], "ms": kern},
                              reps=200, rounds=6)
                dev_us, ops = device_profile(torch, kern)
                b_ms, b_by = bound(k, (N, D, S))
                out[f"{tag}:{k}:{shape}"] = {k: dict(
                    max_abs_err=err[k], ms=t["ms"], plain_ms=t["plain_ms"],
                    library_ms=t["library_ms"], bound_ms=b_ms,
                    bound_by=b_by, device_us_per_call=dev_us,
                    device_ops_per_call=ops)}
                phase("kernel_times", kernel=k, path=tag, shape=shape,
                      dtype="float32", ms=f"{t['ms']:.4f}",
                      plain_ms=f"{t['plain_ms']:.4f}",
                      library_ms=f"{t['library_ms']:.4f}",
                      bound_ms=f"{b_ms:.4f}", bound_by=b_by,
                      device_us_per_call=f"{dev_us:.2f}",
                      device_ops_per_call=ops)
    return out


def sharded_kernel_phase(torch, sk, oh, k4, k56, k78):
    """K4 at one rank's pair batch of the sharded explicit Schur run; K5
    (the dims-major gather) and K6 (the dims-major segment sum) at one
    rank's slab rows of each sharded dims-major run (``k56``: ``(inputs,
    tag, widths)``: the implicit run at D = 9 and 81, CGLS at 9); K7 and K8
    (row-major) at one rank's held rows of each sharded runtime-bucketed or
    multi-observer batch (``k78``: ``(ids, S, widths, tag)``), each with
    that run's own ids: against their plain versions (float32, and float64
    for the gathers' bits and the sums' tolerance), then timed in float32
    beside the plain version and the library call, in turns, with the
    bound and the device µs and operations of one call.  Returns
    ``{shape: {kernel: facts}}``."""
    rng = np.random.default_rng(15)
    out = {}
    M, ids, S = k4["M"], k4["ids"], int(k4["S"])
    N, D = M.shape
    got, want = sk.segment_sum(M, ids, S), sk.segment_sum_plain(M, ids, S)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    shape = f"{N}x{D}->{S}"
    phase("kernels", kernel="segment_sum", dtype="float32", shape=shape,
          ids="sharded_schur_rank0", rel_err=f"{rel:.3e}",
          tol=TOL["float32"], ok=rel <= TOL["float32"])
    if not rel <= TOL["float32"]:
        raise RuntimeError(f"segment_sum disagrees with its plain version "
                           f"at the sharded pairs {shape}: {rel}")
    Z = torch.zeros((S, D), dtype=M.dtype, device="cuda")
    t = _in_turns(torch, {
        "plain_ms": lambda: sk.segment_sum_plain(M, ids, S),
        "library_ms": lambda: torch.index_add(Z, 0, ids, M),
        "ms": lambda: sk.segment_sum(M, ids, S)})
    b_ms, b_by = bound("segment_sum", (N, D, S))
    dev_us, ops = device_profile(torch, lambda: sk.segment_sum(M, ids, S))
    out[shape] = {"segment_sum": dict(
        max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
        library_ms=t["library_ms"], bound_ms=b_ms, bound_by=b_by,
        device_us_per_call=dev_us, device_ops_per_call=ops)}
    phase("kernel_times", kernel="segment_sum", path="sharded_schur_rank0",
          shape=shape, dtype="float32", ms=f"{t['ms']:.4f}",
          plain_ms=f"{t['plain_ms']:.4f}",
          library_ms=f"{t['library_ms']:.4f}", bound_ms=f"{b_ms:.4f}",
          bound_by=b_by, device_us_per_call=f"{dev_us:.2f}",
          device_ops_per_call=ops)
    for k56_, tag, widths in k56:
        out.update(dims_major_kernel_rows(torch, oh, rng, k56_, tag, widths))
    for ids, S, widths, tag in k78:
        out.update(rowmajor_kernel_rows(torch, oh, rng, ids, S, widths, tag))
    return out


def dims_major_kernel_rows(torch, oh, rng, k56, tag, widths):
    """K5 (the dims-major gather) and K6 (the dims-major segment sum) at
    one rank's slab-row ids of a sharded path, as
    :func:`rowmajor_kernel_rows` holds and times K7/K8."""
    out = {}
    ids, S = k56["ids"], int(k56["S"])
    N = ids.shape[0]
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        for D in widths:
            table = torch.as_tensor(rng.standard_normal((S, D)), dtype=dtype,
                                    device="cuda")
            rows_t = torch.as_tensor(rng.standard_normal((D, N)),
                                     dtype=dtype, device="cuda")
            fns = {"onehot_gather_t": (
                       lambda: oh.onehot_gather_t(ids, table),
                       lambda: oh.onehot_gather_t_plain(ids, table)),
                   "onehot_scatter_add_t": (
                       lambda: oh.onehot_scatter_add_t(ids, rows_t, S),
                       lambda: oh.onehot_scatter_add_t_plain(ids, rows_t,
                                                              S))}
            rel, err = {}, {}
            for k, (kern, plain) in fns.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                err[k] = (got - want).abs().max().item()
                rel[k] = err[k] / max(want.abs().max().item(), 1e-300)
            same = torch.equal(fns["onehot_gather_t"][0](),
                               fns["onehot_gather_t"][1]())
            shape = f"{N}x{D}<->{S}"
            ok = rel["onehot_scatter_add_t"] <= TOL[dname] and same
            phase("kernels", kernel="gather_t+segment_sum_t", dtype=dname,
                  shape=shape, ids=tag,
                  **{f"{k}_rel_err": f"{v:.3e}" for k, v in rel.items()},
                  gather_bit_equal=same, tol=TOL[dname], ok=ok)
            if not ok:
                raise RuntimeError(f"a dims-major kernel disagrees with its "
                                   f"plain version at {dname} {shape}: "
                                   f"{rel}, gather bit-equal {same}")
            if dtype != torch.float32:
                continue
            tzt = torch.cat([table, table.new_zeros((1, D))]).T.contiguous()
            Zt = tzt.new_zeros((D, S + 1))
            lib = {"onehot_gather_t": lambda: torch.index_select(tzt, 1, ids),
                   "onehot_scatter_add_t": lambda: torch.index_add(
                       Zt, 1, ids, rows_t)}
            for k, (kern, plain) in fns.items():
                if k == "onehot_gather_t" and D != widths[0]:
                    continue          # the paths gather the (49, 9) states
                t = _in_turns(torch, {"plain_ms": plain,
                                      "library_ms": lib[k], "ms": kern},
                              reps=200, rounds=6)
                dev_us, ops = device_profile(torch, kern)
                entry = ("onehot_gather" if "gather" in k
                         else "onehot_scatter_add")
                b_ms, b_by = bound(entry, (N, D, S))
                out[f"{tag}:{k}:{shape}"] = {entry: dict(
                    max_abs_err=err[k], ms=t["ms"], plain_ms=t["plain_ms"],
                    library_ms=t["library_ms"], bound_ms=b_ms,
                    bound_by=b_by, device_us_per_call=dev_us,
                    device_ops_per_call=ops)}
                phase("kernel_times", kernel=k, path=tag,
                      shape=shape, dtype="float32", ms=f"{t['ms']:.4f}",
                      plain_ms=f"{t['plain_ms']:.4f}",
                      library_ms=f"{t['library_ms']:.4f}",
                      bound_ms=f"{b_ms:.4f}", bound_by=b_by,
                      device_us_per_call=f"{dev_us:.2f}",
                      device_ops_per_call=ops)
    return out


def mixed_phase(torch, g2o, ck, wrappers, times):
    """``[mixed_manhattan]``: ``create_manhattan(3500, seed=0)`` compiled
    three ways — float64, ``dtype=float32, state_dtype=float64`` (mixed)
    and float32 — and ``MIXED_ITERS`` Gauss-Newton iterations
    (``optimize_fused_gn``) with ``SupernodalCholeskySolver`` from the
    original estimates on each; the mixed run goes on in blocks of
    ``MIXED_ITERS`` until its chi2 is within ``MIXED_RTOL`` of the float64
    run's (``MIXED_MAX_ITERS`` at most, else the phase fails).  Prints all
    three beside the reference's gn_var, the mixed run's chi2 after
    ``MIXED_ITERS`` and the iterations it took, ms per iteration; then
    K1/K2/K3 held and timed at the shapes the mixed run gave them, if any:
    manhattan3500's supernodal panels are at most 96 columns wide, which
    the solver factors with ``torch.linalg`` (no hand-written kernel on
    this path, as on phase 9's supernodal run).  Returns the mixed run's
    launches (all its blocks)."""
    from g2o_tpu_torch.sim.generators import create_manhattan

    g = create_manhattan(n_poses=3500, seed=0)
    runs, launches, chi_f64 = {}, None, None
    for name, kw in (("f64", dict(dtype=torch.float64)),
                     ("mixed", dict(dtype=torch.float32,
                                    state_dtype=torch.float64)),
                     ("f32", dict(dtype=torch.float32))):
        p = g.compile(device="cuda", **kw)
        est0 = {t: v.clone() for t, v in p.estimates.items()}
        sn = g2o.SupernodalCholeskySolver().setup(p)
        g2o.optimize_fused_gn(p, sn, 1)                    # warm-up
        p.set_estimates(est0)
        for w in wrappers.values():
            w.launches = 0
        res = g2o.optimize_fused_gn(p, sn, MIXED_ITERS)
        run = dict(chi2_first_block=res["chi2_final"],
                   iterations=res["iterations"], wall_s=res["wall_s"],
                   chi2=res["chi2_final"])
        while (name == "mixed" and run["iterations"] < MIXED_MAX_ITERS
               and abs(run["chi2"] - chi_f64) > MIXED_RTOL * chi_f64
               and res["iterations"] == MIXED_ITERS):
            res = g2o.optimize_fused_gn(p, sn, MIXED_ITERS)
            run["iterations"] += res["iterations"]
            run["wall_s"] += res["wall_s"]
            run["chi2"] = res["chi2_final"]
        if name == "f64":
            chi_f64 = run["chi2"]
        if name == "mixed":
            launches = {k: w.launches for k, w in wrappers.items()}
            solver = sn
        runs[name] = run
    chi = {k: r["chi2"] for k, r in runs.items()}
    rel = abs(chi["mixed"] - chi["f64"]) / chi["f64"]
    phase("mixed_manhattan", solver="SupernodalCholeskySolver",
          **{f"chi2_{k}_after_{MIXED_ITERS}": f"{r['chi2_first_block']:.6f}"
             for k, r in runs.items()},
          mixed_iterations=runs["mixed"]["iterations"],
          chi2_mixed=f"{chi['mixed']:.6f}", gn_var=f"{MANHATTAN_GN:.6f}",
          **{f"{k}_minus_gn_var": f"{v - MANHATTAN_GN:.6f}"
             for k, v in chi.items()},
          mixed_rel_diff_f64=f"{rel:.3e}", bar=MIXED_RTOL,
          **{f"ms_per_iteration_{k}":
             f"{r['wall_s'] * 1e3 / max(r['iterations'], 1):.3f}"
             for k, r in runs.items()},
          **{f"launches_{k}": v for k, v in launches.items() if v})
    if not all(math.isfinite(c) for c in chi.values()):
        raise RuntimeError(f"mixed_manhattan: a non-finite chi2 {chi}")
    if not rel <= MIXED_RTOL:
        raise RuntimeError(f"mixed_manhattan: mixed chi2 {chi['mixed']} "
                           f"not within {MIXED_RTOL} of f64 {chi['f64']} "
                           f"after {runs['mixed']['iterations']} iterations")
    rng = np.random.default_rng(16)
    for shape, timed in _sim_kernel_shapes("mixed", solver, None).items():
        for dtype in (torch.float32, torch.float64):
            res_k = chol_shape_check(torch, ck, rng, dtype, shape, timed,
                                     tag="kernels_mixed")
            if res_k:
                times[_shape(*shape)] = res_k
    return launches


def parallel_phase(torch, g2o, ck, sk, oh, wrappers, times):
    """Phase 15; returns the launch counts of each of its paths (the
    sharded ones summed over the ranks)."""
    t_phase = time.perf_counter()
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        res, ranks = _spawn_workers(PARALLEL_WORLD, "gloo", GLOO_CASES,
                                    os.path.join(tmp, "gloo.json"))
        nccl, nccl_ranks = _spawn_workers(1, "nccl", NCCL_CASES,
                                          os.path.join(tmp, "nccl.json"))

        k4 = _saved(torch, tmp, "k4")
        k56c, k78 = bucketed_kernel_inputs(torch, tmp)
        k56 = [(_saved(torch, tmp, "k56"), "sharded_implicit_rank0", (9, 81)),
               k56c]
    sph, sph1 = res["sphere"], nccl["sphere"]
    for pre in ("chunk2", "jacobi"):
        for run in (sph, sph1):
            st = run[f"step_{pre}"]
            if not (st["max_abs_diff"] <= SHARDED_EST_ATOL
                    and st["chi2_rel_diff"] <= SHARDED_CHI2_RTOL):
                raise RuntimeError(f"sharded_sphere {pre} ({run['backend']} "
                                   f"x{run['world']}): {st}")
    u, g2, n1 = sph["lm_unsharded"], sph["lm_sharded"], sph1["lm_sharded"]
    launches = _rank_sum(ranks + nccl_ranks, "sharded_sphere")
    phase("sharded_sphere", ranks=PARALLEL_WORLD,
          **{f"step_{pre}_{k}": (f"{v:.3e}" if isinstance(v, float) else v)
             for pre in ("chunk2", "jacobi")
             for k, v in sph[f"step_{pre}"].items()},
          **{f"nccl1_step_{pre}_{k}": (f"{v:.3e}" if isinstance(v, float)
                                       else v)
             for pre in ("chunk2", "jacobi")
             for k, v in sph1[f"step_{pre}"].items()},
          est_atol=SHARDED_EST_ATOL, chi2_rtol=SHARDED_CHI2_RTOL,
          lm_iterations=u["iterations"],
          ms_per_trial_unsharded=f"{u['ms_per_trial']:.3f}",
          ms_per_trial_gloo2=f"{g2['ms_per_trial']:.3f}",
          ms_per_trial_nccl1=f"{n1['ms_per_trial']:.3f}",
          chi2_final_unsharded=f"{u['chi2_final']:.4f}",
          chi2_final_gloo2=f"{g2['chi2_final']:.4f}",
          chi2_final_nccl1=f"{n1['chi2_final']:.4f}",
          allreduce_calls_per_trial_gloo2=
          f"{g2['allreduce_calls_per_trial']:.1f}",
          allreduce_host_ms_per_call_gloo2=
          f"{g2['allreduce_ms_per_call']:.4f}",
          allreduce_kb_per_call_gloo2=
          f"{g2['allreduce_bytes_per_call'] / 1e3:.1f}",
          allreduce_host_ms_per_call_nccl1=
          f"{n1['allreduce_ms_per_call']:.4f}",
          **{f"launches_{k}": v for k, v in launches.items() if v})
    _need_launched("sharded_sphere", launches, KERNELS[:2])
    by_path["sharded_sphere"] = launches

    man = res["manhattan"]
    one, shd = man["one_process"], man["sharded"]
    hist_rel = float(np.max(np.abs(np.subtract(
        shd["chi2_per_iteration"], one["chi2_per_iteration"]))
        / np.abs(one["chi2_per_iteration"])))
    launches = _rank_sum(ranks, "sharded_manhattan")
    phase("sharded_manhattan", poses=SHARDED_MANHATTAN_POSES,
          mesh="x".join(f"{k}={v}" for k, v in man["mesh_shape"].items()),
          iterations=shd["iterations"],
          iterations_one_process=one["iterations"],
          cg_equal=shd["cg_per_iteration"] == one["cg_per_iteration"],
          chi2_hist_max_rel_diff=f"{hist_rel:.3e}", bar=SHARDED_HIST_RTOL,
          chi2_final=f"{shd['chi2_final']:.6f}",
          wall_s=f"{shd['wall_s']:.3f}",
          wall_s_one_process=f"{one['wall_s']:.3f}",
          allreduce_calls=shd["allreduce_calls"],
          allreduce_host_ms_per_call=f"{shd['allreduce_ms_per_call']:.4f}")
    if not (shd["iterations"] == one["iterations"]
            and hist_rel <= SHARDED_HIST_RTOL):
        raise RuntimeError(f"sharded_manhattan: {shd} against {one}")
    by_path["sharded_manhattan"] = launches

    sch = res["schur"]
    st, u, g2 = sch["step"], sch["lm_unsharded"], sch["lm_sharded"]
    launches = _rank_sum(ranks, "sharded_schur_ladybug")
    phase("sharded_schur_ladybug", ranks=PARALLEL_WORLD,
          step_dx_max_abs_diff=f"{st['max_abs_diff']:.3e}",
          bar=SHARDED_SCHUR_DX_ATOL, pairs=st["n_pairs"],
          pairs_per_rank=st["n_pairs_rank"], camera_pairs=st["n_uniq"],
          iterations=g2["iterations"], chi2_final=f"{g2['chi2_final']:.4f}",
          chi2_bound=SHARDED_SCHUR_BOUND,
          chi2_final_unsharded=f"{u['chi2_final']:.4f}",
          ms_per_trial_gloo2=f"{g2['ms_per_trial']:.3f}",
          ms_per_trial_unsharded=f"{u['ms_per_trial']:.3f}",
          allreduce_calls_per_trial=f"{g2['allreduce_calls_per_trial']:.1f}",
          allreduce_host_ms_per_call=f"{g2['allreduce_ms_per_call']:.4f}",
          allreduce_kb_per_call=f"{g2['allreduce_bytes_per_call'] / 1e3:.1f}",
          **{f"launches_{k}": v for k, v in launches.items() if v})
    if not (st["max_abs_diff"] <= SHARDED_SCHUR_DX_ATOL
            and g2["chi2_final"] <= SHARDED_SCHUR_BOUND):
        raise RuntimeError(f"sharded_schur_ladybug: {st}, {g2}")
    _need_launched("sharded_schur_ladybug", launches, ("segment_sum",))
    by_path["sharded_schur_ladybug"] = launches

    imp = res["implicit"]
    launches = _rank_sum(ranks, "sharded_implicit_ladybug")
    phase("sharded_implicit_ladybug", ranks=PARALLEL_WORLD,
          layout=imp["layout"],
          est_max_rel_diff=f"{imp['max_rel_diff']:.3e}",
          bar=SHARDED_IMPLICIT_RTOL,
          chi2_rel_diff=f"{imp['chi2_rel_diff']:.3e}",
          step_ms=f"{imp['step_ms']:.2f}",
          allreduce_calls=imp["allreduce_calls"],
          allreduce_host_ms_per_call=f"{imp['allreduce_ms_per_call']:.4f}",
          **{f"launches_{k}": v for k, v in launches.items() if v})
    if not (imp["layout"] == "dm"
            and imp["max_rel_diff"] <= SHARDED_IMPLICIT_RTOL):
        raise RuntimeError(f"sharded_implicit_ladybug: {imp}")
    _need_launched("sharded_implicit_ladybug", launches,
                   ("onehot_gather_t", "onehot_scatter_add_t"))
    by_path["sharded_implicit_ladybug"] = launches

    by_path.update(bucketed_runs(res, nccl, ranks, nccl_ranks))
    times.update(sharded_kernel_phase(torch, sk, oh, k4, k56, k78))
    by_path["mixed_manhattan"] = mixed_phase(torch, g2o, ck, wrappers, times)
    phase("done_parallel", seconds=f"{time.perf_counter() - t_phase:.1f}",
          **{f"rank0_seconds_{case}": f"{res[case]['seconds']:.1f}"
             for case in GLOO_CASES.split(",")},
          **{f"rank0_seconds_nccl_{case}": f"{nccl[case]['seconds']:.1f}"
             for case in NCCL_CASES.split(",")})
    return by_path


def _saved(torch, tmp, tag):
    """Kernel inputs rank 0 of the Gloo spawn saved in ``tmp``."""
    return torch.load(os.path.join(tmp, f"gloo.json.{tag}.pt"),
                      map_location="cuda")


def bucketed_kernel_inputs(torch, tmp):
    """The bucketed runs' kernel inputs at rank 0's rows: the CGLS run's
    K5/K6 entry ``(inputs, tag, widths)`` and the K7/K8 entries ``(ids, S,
    widths, tag)`` of the runtime run and of each mixed-map batch."""
    k78r, k78m = _saved(torch, tmp, "k78"), _saved(torch, tmp, "k78m")
    k78 = [(k78r["ids"], int(k78r["S"]), tuple(k78r["widths"]),
            "sharded_runtime_rank0")]
    for name, ids in k78m["ids"].items():
        kind = "stereo" if "STEREO" in name else "mono"
        k78.append((ids, int(k78m["S"]), tuple(k78m["widths"]),
                    f"sharded_mixed_{kind}_rank0"))
    return (_saved(torch, tmp, "k56c"), "sharded_cgls_rank0", (9,)), k78


# the bucketed runs: (worker case, phase tag, the kernels every rank must
# have launched, the f32 chi2 bound)
BUCKETED = {"runtime": ("sharded_runtime_ladybug",
                        ("onehot_gather", "onehot_scatter_add"),
                        SHARDED_SCHUR_BOUND),
            "cgls": ("sharded_cgls_ladybug",
                     ("onehot_gather_t", "onehot_scatter_add_t"),
                     SHARDED_SCHUR_BOUND),
            "mixed_sba": ("sharded_mixed_sba",
                          ("onehot_gather", "onehot_scatter_add"),
                          SHARDED_MIXED_BOUND)}


def bucketed_runs(res, nccl, ranks, nccl_ranks):
    """``[sharded_runtime_ladybug]``, ``[sharded_cgls_ladybug]``,
    ``[sharded_mixed_sba]``: the landmark-bucketed layouts at two Gloo ranks
    and one NCCL rank — the float64 step (CGLS: the solve) against one
    process's, the float32 LM runs' chi2 against their bound, ms per
    λ-trial of one process, two ranks and one NCCL rank, all-reduces per
    trial with their host ms and KB per call, and each path's kernels
    launched on every rank.  Returns the launches of each path, summed over
    the Gloo ranks."""
    by_path = {}
    for case in BUCKETED_RUNS:
        tag, kernels, chi_bound = BUCKETED[case]
        g, n = res[case], nccl[case]
        u, g2, n1 = g["lm_unsharded"], g["lm_sharded"], n["lm_sharded"]
        if case == "cgls":
            step = {f"{k}_dx_rel_diff": r["dx_rel_diff"]
                    for k, r in (("gloo2", g), ("nccl1", n))}
            ok_step = all(v <= SHARDED_STEP_RTOL for v in step.values())
        else:
            step = {f"{k}_{f}": r[f] for k, r in (("gloo2", g), ("nccl1", n))
                    for f in ("max_rel_diff", "chi2_rel_diff")}
            ok_step = all(r["max_rel_diff"] <= SHARDED_STEP_RTOL
                          and r["chi2_rel_diff"] <= SHARDED_STEP_CHI2_RTOL
                          and r["form"] == g["form"] for r in (g, n))
            step["form"] = g["form"]
        launches = _rank_sum(ranks, tag)
        chis = {"unsharded": u["chi2_final"], "gloo2": g2["chi2_final"],
                "nccl1": n1["chi2_final"]}
        phase(tag, ranks=PARALLEL_WORLD,
              **{k: (f"{v:.3e}" if isinstance(v, float) else v)
                 for k, v in step.items()},
              step_rtol=SHARDED_STEP_RTOL,
              step_chi2_rtol=SHARDED_STEP_CHI2_RTOL,
              lm_iterations=g2["iterations"],
              **{f"chi2_final_{k}": f"{v:.4f}" for k, v in chis.items()},
              chi2_bound=chi_bound,
              ms_per_trial_unsharded=f"{u['ms_per_trial']:.3f}",
              ms_per_trial_gloo2=f"{g2['ms_per_trial']:.3f}",
              ms_per_trial_nccl1=f"{n1['ms_per_trial']:.3f}",
              cg_per_solve_gloo2=f"{g2['cg_per_solve']:.2f}",
              cg_per_solve_unsharded=f"{u['cg_per_solve']:.2f}",
              allreduce_calls_per_trial_gloo2=
              f"{g2['allreduce_calls_per_trial']:.1f}",
              allreduce_host_ms_per_call_gloo2=
              f"{g2['allreduce_ms_per_call']:.4f}",
              allreduce_kb_per_call_gloo2=
              f"{g2['allreduce_bytes_per_call'] / 1e3:.1f}",
              allreduce_host_ms_per_call_nccl1=
              f"{n1['allreduce_ms_per_call']:.4f}",
              **{f"launches_{k}": v for k, v in launches.items() if v},
              **{f"launches_rank{r}_{k}": rk[tag][k]
                 for r, rk in enumerate(ranks) for k in kernels})
        if not ok_step:
            raise RuntimeError(f"{tag}: the float64 step against one "
                               f"process's: {step}")
        if not all(math.isfinite(c) and c <= chi_bound
                   for c in chis.values()):
            raise RuntimeError(f"{tag}: float32 chi2 {chis} against the "
                               f"bound {chi_bound}")
        _need_launched_every_rank(tag, ranks, kernels)
        _need_launched_every_rank(tag, nccl_ranks, kernels)
        by_path[tag] = launches
    return by_path


def main():
    import torch

    t_start = time.perf_counter()
    card = device_phase(torch)
    sys.path.insert(0, HERE)
    import g2o_tpu_torch as g2o
    from g2o_tpu_torch.ops import chol_kernels as ck
    from g2o_tpu_torch.ops import onehot as oh
    from g2o_tpu_torch.ops import segment_kernels as sk

    t0 = time.perf_counter()
    ck.build()                 # every library, one nvcc each, in parallel
    ck._load()
    sk._load()
    oh._load()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          flags=" ".join(ck.NVCC_FLAGS).replace(" ", "_"))
    wrappers = {"chol_batched": ck.chol_batched,
                "solve_lower_batched": ck.solve_lower_batched,
                "solve_upper_batched": ck.solve_upper_batched,
                "segment_sum": sk.segment_sum,
                **{k: getattr(oh, k) for k in ONEHOT}}
    times = kernel_phase(torch, ck)
    ba = load_ba(torch, g2o)
    seg_times = segment_kernel_phase(torch, sk, ba)
    implicit = load_implicit(torch, g2o)
    sba = load_sba(torch)
    onehot_times = onehot_kernel_phase(torch, oh, implicit, sba)
    schur_rows_times = schur_rows_phase(torch, oh, {
        **{f"{kind}": schur_rows_path_inputs(torch, *implicit[suffix][:2])
           for kind, suffix in (("ladybug_dm", ""), ("stress_dm", "_stress"),
                                ("venice", "_venice"))},
        "venice1778": schur_rows_synthetic(torch, *SCHUR_ROWS_VENICE),
        "final13682": schur_rows_synthetic(torch, *SCHUR_ROWS_FINAL)})
    by_path = main_path_phase(torch, g2o, wrappers)
    by_path.update(ba_main_path_phase(torch, g2o, wrappers, ba))
    keep = {}
    by_path.update(implicit_main_path_phase(torch, g2o, wrappers, implicit,
                                            keep))
    by_path.update(tiled_path_phase(torch, g2o, wrappers))
    by_path.update(manhattan_path_phase(torch, g2o, wrappers))
    by_path.update(sba_path_phase(torch, g2o, wrappers, sba))
    by_path.update(api_phase(torch, g2o, wrappers, implicit, sba))
    by_path.update(sim_phase(torch, g2o, ck, wrappers, times, keep))
    by_path.update(cli_phase(torch, g2o, ck, wrappers, times))
    by_path.update(apps_phase(torch, g2o, wrappers, card, keep))
    by_path.update(parallel_phase(torch, g2o, ck, sk, oh, wrappers, times))
    # a new kernel's launches are its wrappers' launches
    for counts in by_path.values():
        for k, ws in NEW_KERNELS.items():
            counts[k] = sum(counts[w] for w in ws)

    lay = ba["ladybug"][1]._layout
    times.update(seg_times)
    times.update(onehot_times)
    times.update(schur_rows_times)
    n_venice = _path_ids(implicit, sba)["venice"][0].shape[0]
    shape_key = {k: _shape(*sh) for k, sh in PRIMARY.items()}
    shape_key["segment_sum"] = (f"{lay['n_pairs']}x{lay['dp'] ** 2}->"
                                f"{lay['n_uniq']}")
    for k in NEW_KERNELS:
        shape_key[k] = f"venice:{k}_t:{n_venice}x9<->800"
    shape_key["schur_rows"] = next(
        k for k in schur_rows_times
        if k.startswith("venice1778:schur_rows_t:"))
    shape_key["schur_rows_tiled"] = next(
        k for k in schur_rows_times if k.startswith("final13682:"))
    chol_src = "g2o_tpu_torch/csrc/batched_chol.cu"
    onehot_src = "g2o_tpu_torch/csrc/gather_segment.cu"
    experimental = "scripts/pallas_onehot_experimental.py"
    source = {"chol_batched": chol_src, "solve_lower_batched": chol_src,
              "solve_upper_batched": chol_src,
              "segment_sum": "g2o_tpu_torch/csrc/segment_sum.cu",
              "onehot_gather": onehot_src, "onehot_scatter_add": onehot_src,
              "schur_rows": onehot_src, "schur_rows_tiled": onehot_src}
    replaces = {"chol_batched": "g2o_tpu/ops/pallas_chol.py:89",
                "solve_lower_batched": "g2o_tpu/ops/pallas_chol.py:188",
                "solve_upper_batched": "g2o_tpu/ops/pallas_chol.py:194",
                "segment_sum": "g2o_tpu/ops/pallas_kernels.py:59",
                "onehot_gather": (
                    f"{experimental}:80 gather_t_mxu (K5); :143 "
                    f"gather_mxu_rows (K7); :364 gather_t_mxu2 (K10)"),
                "onehot_scatter_add": (
                    f"{experimental}:112 segment_sum_t_mxu (K6); :172 "
                    f"segment_sum_rows_mxu (K8); :274 segment_sum_t_mxu2 "
                    f"(K9)"),
                "schur_rows": "none: fuses K5, the PyTorch products and "
                              "slab sums around it, and K6",
                "schur_rows_tiled": "none: the Schur rows kernel past its "
                                    "shared-memory camera cap"}

    phase("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": source[k],
         "replaces": replaces[k],
         "launches": sum(c[k] for c in by_path.values()),
         "launches_by_path": {path: c[k] for path, c in by_path.items()},
         "shape": shape_key[k], **times[shape_key[k]][k],
         "by_shape": {sh: t[k] for sh, t in times.items() if k in t}}
        for k in KERNELS + tuple(NEW_KERNELS)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
