"""The port's multi-process paths (``g2o_tpu_torch.parallel``) against the
JAX package's unsharded results and the port's own, float64 on the CPU.

One module fixture starts the two-process Gloo worker
(``python -m g2o_tpu_torch.parallel.worker --case tests``) once; it runs
the scenes of the JAX package's sharding tests (``test_sharded_schur.py``,
``test_sim_and_sharding.py::test_sharded_step_matches_single_device``,
``test_multiprocess.py``) with every edge batch split over the two
processes, while this process computes the unsharded references.

Tolerances are the JAX tests': explicit Schur and chunk2 PCG solves
``atol=1e-9``; implicit Schur steps ``rtol=1e-9, atol=1e-11`` (rows
layout, and the general path against the port's unsharded step) and
``rtol=1e-8, atol=1e-10`` (bucketed), their chi2
``rtol=1e-12``; the PCG step on the sphere ``atol=1e-8`` with chi2
``rel=1e-10``; the two-process LM run equal iteration counts and chi2
``rtol=1e-9``; the manhattan step through the global mesh ``rtol=1e-9,
atol=1e-11``, chi2 ``rtol=1e-12`` (and ``atol=1e-20``: that graph
starts at its noise-free truth, where chi2 ~1e-25 is rounding noise).
The solvers the JAX tests do not
shard (Dense, supernodal and sparse Cholesky, CGLS, the host Cholesky,
Dogleg) and the structure-only refinement are held to the sphere step's
``atol=1e-8`` (chi2 ``rel=1e-10``; Dogleg's after 3 iterations
``rel=1e-9``) against the port's own unsharded runs and, the direct
steps, against the JAX package's dense step.  The landmark-bucketed
layouts — CGLS on a ``bucket_landmarks=True`` problem, the implicit
runtime-bucketed layout and the implicit multi-observer form (mono and
stereo edges on one point type) — are held to the bucketed bars
(``rtol=1e-8, atol=1e-10``, chi2 ``rtol=1e-12``) against the JAX
package's unsharded step in the same layout and the port's.  A world of
one process gives the unsharded results bit for bit.

``initialize_distributed`` raises when an explicit launch fails; the JAX
package's (``g2o_tpu/parallel/multihost.py:57-61``) swallows every
``RuntimeError``/``ValueError`` of ``jax.distributed.initialize``, so a
wrong coordinator address or process count runs quietly as one host
(ROADMAP C.6).
"""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch as tg2o
from g2o_tpu import parallel as jparallel
from g2o_tpu.core.lm_fused import optimize_fused as j_optimize_fused
from g2o_tpu.core.solvers import DenseSolver as JDense
from g2o_tpu.core.solvers import PCGSolver as JPCG
from g2o_tpu.core.graph import Graph as JGraph
from g2o_tpu.core.solvers import SchurSolver as JSchur
from g2o_tpu.core.solvers.cgls import CGLSSolver as JCGLS
from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver as JImpl
from g2o_tpu.io import g2o_format as jio
from g2o_tpu.sim import generators as jgen
from g2o_tpu.types import sba as jsba
from g2o_tpu_torch import parallel as tparallel
from g2o_tpu_torch.core.graph import Graph as TGraph
from g2o_tpu_torch.core.structure_only import structure_only_refine
from g2o_tpu_torch.io import g2o_format as tio
from g2o_tpu_torch.parallel import worker as tworker
from g2o_tpu_torch.sim import generators as tgen
from g2o_tpu_torch.types import sba as tsba

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs six worker processes on a shared
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


SPHERE = dict(nodes_per_level=8, laps=3, radius=10.0, seed=4)
# the BA scene of the JAX package's bucketed sharding test
BA = dict(n_cameras=6, n_points=80, pixel_noise=0.5, point_noise=0.2, seed=3)


@pytest.fixture(scope="module")
def sphere_file(tmp_path_factory):
    """The JAX package's noisy sphere as a .g2o file, read by both packages
    (the generators draw their noise differently)."""
    path = str(tmp_path_factory.mktemp("sphere") / "sphere.g2o")
    jio.save(jgen.create_sphere(**SPHERE), path)
    return path


@pytest.fixture(scope="module")
def sharded(tmp_path_factory, sphere_file):
    """The worker's results, read on first use (the two processes run
    while the tests compute their references)."""
    out = str(tmp_path_factory.mktemp("parallel") / "tests.json")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "g2o_tpu_torch.parallel.worker",
         "--init-method", f"tcp://127.0.0.1:{port}", "--nproc", str(WORLD),
         "--pid", str(r), "--device", "cpu", "--backend", "gloo",
         "--case", "tests", "--g2o", sphere_file, "--out", out],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    box = {}

    def get():
        if "res" not in box:
            try:
                logs = [pr.communicate(timeout=600)[0] for pr in procs]
            finally:
                for pr in procs:
                    if pr.poll() is None:
                        pr.kill()
            for pr, log in zip(procs, logs):
                assert pr.returncode == 0, log[-4000:]
            with open(out) as fh:
                box["res"] = json.load(fh)["tests"]
        return box["res"]

    yield get
    for pr in procs:
        if pr.poll() is None:
            pr.kill()


def _cpu(g, **kw):
    return g.compile(dtype=torch.float64, device="cpu", **kw)


def _np(est):
    return {t: np.asarray(v) for t, v in est.items()}


def _port_step(p, solver, lam):
    solver.setup(p)
    e, c, _ = tparallel.make_fused_step(p, solver)(p.data, p.estimates, lam)
    return {t: v.numpy() for t, v in e.items()}, float(c)


def _jax_step(p, solver, lam):
    solver.setup(p)
    e, c, _ = jparallel.make_fused_step(p, solver, donate=False)(
        p.data, p.estimates, jnp.asarray(lam, p.dtype))
    return _np(e), float(c)


def _close(got, want, **tol):
    for t in want:
        np.testing.assert_allclose(np.asarray(got[t]), want[t], **tol)


def test_exports_every_name_of_the_jax_parallel_package():
    assert set(jparallel.__all__) <= set(tparallel.__all__)
    for name in tparallel.__all__:
        assert getattr(tparallel, name) is not None


def test_sharded_schur_matches_single(sharded):
    kw = dict(n_cameras=10, n_points=150, pixel_noise=0.5, point_noise=0.3,
              seed=21)
    jp = jgen.create_ba_scene(**kw)[0].compile()
    dx_j = np.asarray(JSchur().setup(jp).solve(
        jp.data, jp.linearize_jit(jp.data, jp.estimates), 1e-3))
    tp = _cpu(tgen.create_ba_scene(**kw)[0])
    s = tg2o.SchurSolver().setup(tp)
    dx_t = s.solve(tp.data, tp.linearize_fn(tp.data, tp.estimates),
                   1e-3).numpy()
    got = np.asarray(sharded()["schur_step"]["dx"])
    assert got.shape == dx_j.shape
    np.testing.assert_allclose(got, dx_j, atol=1e-9)
    np.testing.assert_allclose(got, dx_t, atol=1e-9)


def test_sharded_schur_full_lm(sharded):
    kw = dict(n_cameras=10, n_points=150, pixel_noise=0.0, point_noise=0.3,
              seed=22)
    jp = jgen.create_ba_scene(**kw)[0].compile(pad_edges_to_multiple=WORLD)
    jres = j_optimize_fused(jp, JSchur(), 10)
    tp = _cpu(tgen.create_ba_scene(**kw)[0], pad_edges_to_multiple=WORLD)
    tres = tg2o.optimize_fused(tp, tg2o.SchurSolver(), 10)
    got = sharded()["schur_lm"]
    for res in (got, jres, tres):
        assert res["chi2_final"] < 1e-6 * max(res["chi2_per_iteration"][0],
                                              1.0)
    np.testing.assert_allclose(got["chi2_per_iteration"][0],
                               jres["chi2_per_iteration"][0], rtol=1e-12)
    np.testing.assert_allclose(got["chi2_per_iteration"][:3],
                               tres["chi2_per_iteration"][:3], rtol=1e-9)


@pytest.mark.parametrize("case, bucket, tol", [
    ("implicit_rows", False, dict(rtol=1e-9, atol=1e-11)),
    ("implicit_bucketed", True, dict(rtol=1e-8, atol=1e-10))])
def test_sharded_implicit_schur_matches_unsharded(sharded, case, bucket,
                                                  tol):
    kw = dict(n_cameras=6, n_points=80, pixel_noise=0.5, point_noise=0.2,
              seed=3)
    jp = jgen.create_ba_scene(**kw)[0].compile(
        bucket_landmarks=bucket, pad_edges_to_multiple=WORLD)
    e_j, c_j = _jax_step(jp, JImpl(max_iter=30, tol=1e-10), 1e-3)
    tp = _cpu(tgen.create_ba_scene(**kw)[0], bucket_landmarks=bucket,
              pad_edges_to_multiple=WORLD)
    solver = tg2o.ImplicitSchurSolver(max_iter=30, tol=1e-10)
    e_t, c_t = _port_step(tp, solver, 1e-3)
    assert solver._layout["form"] == ("dm" if bucket else "rows")
    got = sharded()[case]
    for e, c in ((e_j, c_j), (e_t, c_t)):
        np.testing.assert_allclose(got["chi2"], c, rtol=1e-12)
        _close(got["estimates"], e, **tol)


def test_sharded_implicit_general_path_matches_unsharded(sharded):
    """Every third point kept out of the marginalization: the general
    path's step on sharded data against the port's own unsharded step."""
    g, truth = tgen.create_ba_scene(n_cameras=6, n_points=80, pixel_noise=0.5,
                                    point_noise=0.2, seed=3)
    for j, vid in enumerate(truth):
        if j % 3 == 0:
            g.set_marginalized(vid, False)
    tp = _cpu(g, pad_edges_to_multiple=WORLD)
    solver = tg2o.ImplicitSchurSolver(max_iter=150, tol=1e-10)
    e_t, c_t = _port_step(tp, solver, 1e-3)
    assert solver._layout["form"] == "general"
    got = sharded()["implicit_general"]
    np.testing.assert_allclose(got["chi2"], c_t, rtol=1e-12)
    _close(got["estimates"], e_t, rtol=1e-9, atol=1e-11)


def test_sharded_runtime_bucketed_layout_raises(sharded):
    """The runtime-bucketed layout (``layout="bucketed"`` on a problem built
    without ``bucket_landmarks``; this layout raised on sharded data before
    it ran there) against the JAX package's unsharded step in the same
    layout and the port's, with the bars of ``test_sharded_schur.py``'s
    bucketed case."""
    jp = jgen.create_ba_scene(**BA)[0].compile(pad_edges_to_multiple=WORLD)
    e_j, c_j = _jax_step(jp, JImpl(max_iter=30, tol=1e-10,
                                   layout="bucketed"), 1e-3)
    tp = _cpu(tgen.create_ba_scene(**BA)[0], pad_edges_to_multiple=WORLD)
    solver = tg2o.ImplicitSchurSolver(max_iter=30, tol=1e-10,
                                      layout="bucketed")
    e_t, c_t = _port_step(tp, solver, 1e-3)
    got = sharded()["implicit_runtime"]
    assert got["form"] == solver._layout["form"] == "runtime_bucketed"
    for e, c in ((e_j, c_j), (e_t, c_t)):
        np.testing.assert_allclose(got["chi2"], c, rtol=1e-12)
        _close(got["estimates"], e, rtol=1e-8, atol=1e-10)


def test_sharded_multi_observer_matches_unsharded(sharded):
    """One landmark type observed by mono and stereo edges
    (``bucket_landmarks=True``): the multi-observer form's sharded step
    against the JAX package's and the port's unsharded steps."""
    jp = tworker.mixed_sba_graph(*jgen.create_ba_scene(
        **tworker.MIXED_TEST_SCENE), JGraph, jsba).compile(
        bucket_landmarks=True, pad_edges_to_multiple=WORLD)
    e_j, c_j = _jax_step(jp, JImpl(max_iter=150, tol=1e-10), 1e-3)
    tp = _cpu(tworker.mixed_sba_graph(*tgen.create_ba_scene(
        **tworker.MIXED_TEST_SCENE), TGraph, tsba), bucket_landmarks=True,
        pad_edges_to_multiple=WORLD)
    solver = tg2o.ImplicitSchurSolver(max_iter=150, tol=1e-10)
    e_t, c_t = _port_step(tp, solver, 1e-3)
    got = sharded()["implicit_multi_observer"]
    assert got["form"] == solver._layout["form"] == "multi_observer"
    for e, c in ((e_j, c_j), (e_t, c_t)):
        np.testing.assert_allclose(got["chi2"], c, rtol=1e-12)
        _close(got["estimates"], e, rtol=1e-8, atol=1e-10)


def test_multihost_helpers_global_mesh_step(sharded):
    jp = jgen.create_manhattan(n_poses=64, seed=21).compile(
        pad_edges_to_multiple=WORLD)
    e_j, c_j = _jax_step(jp, JPCG(max_iter=30, tol=1e-10), 1e-4)
    tp = _cpu(tgen.create_manhattan(n_poses=64, seed=21),
              pad_edges_to_multiple=WORLD)
    e_t, c_t = _port_step(tp, tg2o.PCGSolver(max_iter=30, tol=1e-10), 1e-4)
    got = sharded()["multihost_step"]
    for e, c in ((e_j, c_j), (e_t, c_t)):
        # the start is the noise-free truth: chi2 ~1e-25 is rounding
        # noise, which another summation order moves by ~20% (1.17e-25
        # sharded, 9.78e-26 unsharded); held to 1e-20 absolute beside the
        # JAX test's rtol=1e-12
        np.testing.assert_allclose(got["chi2"], c, rtol=1e-12, atol=1e-20)
        _close(got["estimates"], e, rtol=1e-9, atol=1e-11)


def test_sharded_chunk2_pcg_matches_single(sharded):
    kw = dict(max_iter=25, tol=1e-10, precond="chunk2", chunk_size=8)
    jp = jgen.create_manhattan(n_poses=120, seed=3).compile()
    dx_j = np.asarray(JPCG(**kw).setup(jp).solve(
        jp.data, jp.linearize_jit(jp.data, jp.estimates), 1e-3))
    tp = _cpu(tgen.create_manhattan(n_poses=120, seed=3))
    dx_t = tg2o.PCGSolver(**kw).setup(tp).solve(
        tp.data, tp.linearize_fn(tp.data, tp.estimates), 1e-3).numpy()
    got = np.asarray(sharded()["chunk2_solve"]["dx"])
    assert got.shape == dx_j.shape
    np.testing.assert_allclose(got, dx_j, atol=1e-9)
    np.testing.assert_allclose(got, dx_t, atol=1e-9)


@pytest.fixture(scope="module")
def sphere_refs(sphere_file):
    """The sphere's unsharded steps: the JAX package's PCG and dense steps,
    and the port's step with each solver the worker shards."""
    jp = jio.load(sphere_file).compile(pad_edges_to_multiple=WORLD)
    for b in jp.data.edges.values():
        assert b.vidx.shape[0] % WORLD == 0
    refs = {"jax_pcg": _jax_step(jp, JPCG(max_iter=100, tol=1e-10), 1e-3),
            "jax_dense": _jax_step(jp, JDense(), 1e-3)}
    tp = _cpu(tio.load(sphere_file), pad_edges_to_multiple=WORLD)
    for name, solver in (
            ("pcg", tg2o.PCGSolver(max_iter=100, tol=1e-10)),
            ("dense", tg2o.DenseSolver()),
            ("supernodal", tg2o.SupernodalCholeskySolver()),
            ("sparse_chol", tg2o.SparseCholeskySolver()),
            ("cgls", tg2o.CGLSSolver(max_iter=200, eta=1e-12))):
        refs[name] = _port_step(tp, solver, 1e-3)
    est0 = dict(tp.estimates)
    res = tg2o.optimize_gn_host(tp, tg2o.HostCholSolver(), 2)
    refs["host_chol"] = ({t: v.numpy() for t, v in tp.estimates.items()},
                         res["chi2_per_iteration"])
    tp.set_estimates(est0)
    opt = tg2o.SparseOptimizer(tp, algorithm=tg2o.Dogleg(),
                               solver=tg2o.DenseSolver())
    opt.optimize(3)
    refs["dogleg"] = opt.chi2()
    return refs


def test_sharded_step_matches_single_device(sharded, sphere_refs):
    got = sharded()["sphere_pcg"]
    for e, c in (sphere_refs["jax_pcg"], sphere_refs["pcg"]):
        assert got["chi2"] == pytest.approx(c, rel=1e-10)
        _close(got["estimates"], e, atol=1e-8)


@pytest.mark.parametrize("solver", ["dense", "supernodal", "sparse_chol"])
def test_sharded_direct_solvers_match_unsharded(sharded, sphere_refs,
                                                solver):
    got = sharded()[f"sphere_{solver}"]
    for e, c in (sphere_refs["jax_dense"], sphere_refs[solver]):
        assert got["chi2"] == pytest.approx(c, rel=1e-10)
        _close(got["estimates"], e, atol=1e-8)


def test_sharded_dogleg_matches_unsharded(sharded, sphere_refs):
    assert sharded()["sphere_dogleg"]["chi2"] == pytest.approx(
        sphere_refs["dogleg"], rel=1e-9)


def test_sharded_cgls_and_host_cholesky_match_unsharded(sharded,
                                                        sphere_refs):
    got = sharded()["sphere_cgls"]
    e, c = sphere_refs["cgls"]
    assert got["chi2"] == pytest.approx(c, rel=1e-10)
    _close(got["estimates"], e, atol=1e-8)
    got = sharded()["sphere_host_chol"]
    np.testing.assert_allclose(got["chi2_per_iteration"],
                               sphere_refs["host_chol"][1], rtol=1e-10)
    _close(got["estimates"], sphere_refs["host_chol"][0], atol=1e-8)


def test_sharded_structure_only_matches_unsharded(sharded):
    tp = _cpu(tgen.create_ba_scene(n_cameras=6, n_points=80, pixel_noise=0.5,
                                   point_noise=0.2, seed=3)[0],
              pad_edges_to_multiple=WORLD)
    chis = structure_only_refine(tp, 5)
    got = sharded()["structure_only"]
    for t, (before, after) in chis.items():
        np.testing.assert_allclose(got["chi2"][t][0], before, rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(got["chi2"][t][1], after, rtol=1e-9,
                                   atol=1e-12)
    _close(got["estimates"], {t: v.numpy() for t, v in tp.estimates.items()},
           atol=1e-8)


def test_sharded_bucketed_cgls_raises(sharded):
    """CGLS on a ``bucket_landmarks=True`` problem (which raised on sharded
    data before it ran there): the sharded step against the JAX package's
    unsharded ``CGLSSolver`` step and the port's, with the bucketed bars
    of the implicit solver's cases."""
    kw = dict(max_iter=200, eta=1e-12)
    jp = jgen.create_ba_scene(**BA)[0].compile(
        bucket_landmarks=True, pad_edges_to_multiple=WORLD)
    e_j, c_j = _jax_step(jp, JCGLS(**kw), 1e-3)
    tp = _cpu(tgen.create_ba_scene(**BA)[0], bucket_landmarks=True,
              pad_edges_to_multiple=WORLD)
    assert tp.bucket_specs
    e_t, c_t = _port_step(tp, tg2o.CGLSSolver(**kw), 1e-3)
    got = sharded()["cgls_bucketed"]
    for e, c in ((e_j, c_j), (e_t, c_t)):
        np.testing.assert_allclose(got["chi2"], c, rtol=1e-12)
        _close(got["estimates"], e, rtol=1e-8, atol=1e-10)


def test_two_process_distributed_matches_single(sharded):
    res = sharded()["multiprocess"]
    assert res["process_count"] == WORLD and res["n_devices"] == WORLD
    assert res["mesh_shape"] == {"hosts": WORLD, "edges": 1}
    jp = jgen.create_manhattan(n_poses=200, seed=7).compile(
        pad_edges_to_multiple=WORLD)
    jref = j_optimize_fused(jp, JPCG(max_iter=100, tol=1e-10), 10)
    tp = _cpu(tgen.create_manhattan(n_poses=200, seed=7),
              pad_edges_to_multiple=WORLD)
    tref = tg2o.optimize_fused(tp, tg2o.PCGSolver(max_iter=100, tol=1e-10),
                               10)
    for ref in (jref, tref):
        assert res["iterations"] == ref["iterations"]
        np.testing.assert_allclose(res["chi2_per_iteration"],
                                   ref["chi2_per_iteration"], rtol=1e-9)
        np.testing.assert_allclose(res["chi2_final"], ref["chi2_final"],
                                   rtol=1e-9)
    assert res["cg_per_iteration"] == tref["cg_per_iteration"]


@pytest.fixture
def no_group():
    """No default process group before and after the test."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("layout", ["runtime_bucketed", "multi_observer",
                                    "cgls_bucketed", "dm", "dm_tiled"])
def test_world_of_one_bucketed_layouts_are_bit_equal(no_group, monkeypatch,
                                                     layout):
    """The bucketed layouts sharded over a world of one process (each
    process's slab rows, its zero-padded slab buffers and one all-reduce
    per sum) give the unsharded step bit for bit.  The ``dm`` form's
    unsharded ``S·v`` goes through the Schur rows wrapper (``dm_tiled``:
    past its camera cap, patched down, the tiled form's), its sharded one
    through the slab sums and the all-reduce, never the wrapper."""
    from g2o_tpu_torch.core.solvers import schur_implicit
    from g2o_tpu_torch.ops import onehot

    calls = []
    monkeypatch.setattr(schur_implicit, "schur_rows_t", lambda *a: (
        calls.append(1), onehot.schur_rows_t(*a))[1])
    if layout == "dm_tiled":
        monkeypatch.setattr(schur_implicit, "schur_rows_fits",
                            lambda *a: False)
        monkeypatch.setattr(schur_implicit, "schur_rows_tiled_t",
                            lambda *a: (calls.append(1),
                                        onehot.schur_rows_tiled_t(*a))[1])
    tparallel.initialize_distributed(backend="gloo")
    mesh = tparallel.make_mesh()
    if layout.startswith("dm"):
        p = _cpu(tgen.create_ba_scene(**BA)[0], bucket_landmarks=True)
        solver = tg2o.ImplicitSchurSolver(max_iter=30, tol=1e-10)
    elif layout == "multi_observer":
        p = _cpu(tworker.mixed_sba_graph(*tgen.create_ba_scene(
            **tworker.MIXED_TEST_SCENE), TGraph, tsba), bucket_landmarks=True)
        solver = tg2o.ImplicitSchurSolver(max_iter=150, tol=1e-10)
    elif layout == "runtime_bucketed":
        p = _cpu(tgen.create_ba_scene(**BA)[0])
        solver = tg2o.ImplicitSchurSolver(max_iter=30, tol=1e-10,
                                          layout="bucketed")
    else:
        p = _cpu(tgen.create_ba_scene(**BA)[0], bucket_landmarks=True)
        solver = tg2o.CGLSSolver(max_iter=200, eta=1e-12)
    solver.setup(p)
    if layout != "cgls_bucketed":
        assert solver._layout["form"] == layout.split("_tiled")[0]
    step = tparallel.make_fused_step(p, solver)
    e0, c0, _ = step(p.data, p.estimates, 1e-3)
    unsharded = len(calls)
    assert (unsharded > 0) == layout.startswith("dm")
    data = tparallel.shard_problem_data(p.data, mesh)
    assert data.group is not None
    e1, c1, _ = step(data, tparallel.replicate_estimates(p.estimates, mesh),
                     1e-3)
    assert len(calls) == unsharded
    assert torch.equal(c0, c1)
    for t in e0:
        assert torch.equal(e0[t], e1[t]), t


def test_initialize_distributed_raises_on_a_failed_launch(no_group):
    with pytest.raises((RuntimeError, ValueError)):
        tparallel.initialize_distributed(
            num_processes=1, process_id=0, backend="gloo",
            init_method="nosuchscheme://localhost")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_method"):
        tparallel.initialize_distributed(num_processes=2, process_id=0,
                                         backend="gloo")


def test_world_of_one_is_bit_equal(no_group):
    """A world of one: the sharded paths run (an all-reduce over one
    process each) and give the unsharded results bit for bit; a second
    ``initialize_distributed`` is a no-op."""
    tparallel.initialize_distributed(backend="gloo")
    group = dist.group.WORLD
    tparallel.initialize_distributed(backend="gloo")
    assert dist.group.WORLD is group and dist.get_world_size() == 1
    mesh = tparallel.make_mesh()
    assert tparallel.edge_partition_spec(mesh) == ("edges",)
    gmesh = tparallel.make_global_mesh(hosts_axis=True)
    assert tparallel.edge_partition_spec(gmesh) == ("hosts", "edges")
    sphere = _cpu(tgen.create_sphere(**SPHERE))
    ba = _cpu(tgen.create_ba_scene(n_cameras=6, n_points=80, seed=3)[0],
              bucket_landmarks=True)
    for p, solver in (
            (sphere, tg2o.PCGSolver(max_iter=25, tol=1e-10,
                                    precond="chunk2", chunk_size=8)),
            (sphere, tg2o.DenseSolver()),
            (sphere, tg2o.SupernodalCholeskySolver()),
            (ba, tg2o.SchurSolver(mesh=mesh)),
            (ba, tg2o.ImplicitSchurSolver(max_iter=30, tol=1e-10))):
        solver.setup(p)
        step = tparallel.make_fused_step(p, solver)
        e0, c0, _ = step(p.data, p.estimates, 1e-3)
        data = tparallel.shard_problem_data_global(p.data, gmesh)
        assert data.group is not None
        e1, c1, _ = step(data, tparallel.replicate_estimates(
            p.estimates, mesh), 1e-3)
        assert torch.equal(c0, c1), type(solver).__name__
        for t in e0:
            assert torch.equal(e0[t], e1[t]), (type(solver).__name__, t)
