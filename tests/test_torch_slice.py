"""The port's slice end to end against the JAX package, float64 on the CPU.

A small Huber sphere is written by the JAX package's ``g2o_format`` and read
by both loaders; 10 fused-LM iterations with the two-level (``chunk2``)
preconditioner give the same chi2 trajectory to rtol 1e-6 (the bound of
``tests/test_lm_parity.py``).  With 100 poses and ``chunk_size=4`` the
coarse system has 192 columns, so the K1/K2 dispatch (plain versions here)
is on the path."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from g2o_tpu.core.lm_fused import optimize_fused as j_optimize_fused
from g2o_tpu.core.solvers import PCGSolver as JPCG
from g2o_tpu.io import g2o_format as jio
from g2o_tpu.sim.generators import create_sphere as j_create_sphere
import g2o_tpu_torch
from g2o_tpu_torch.io import g2o_format as tio
from g2o_tpu_torch.ops import chol_kernels
from g2o_tpu_torch.sim.generators import create_sphere as t_create_sphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _solver_kw():
    return dict(max_iter=400, tol=1e-12, precond="chunk2", chunk_size=4,
                absolute_tolerance=False)


@pytest.fixture(scope="module")
def text():
    g = j_create_sphere(nodes_per_level=10, laps=10, seed=5)
    g.set_robust_kernel("Huber", 1.0)
    return jio.dumps(g)


def test_fused_lm_trajectory_matches_jax(text):
    jg = jio.loads(text)
    jg.set_robust_kernel("Huber", 1.0)
    jp = jg.compile()
    jres = j_optimize_fused(jp, JPCG(**_solver_kw()), 10)

    tg = tio.loads(text)
    tg.set_robust_kernel("Huber", 1.0)
    tp = tg.compile(dtype=torch.float64, device="cpu")
    tres = g2o_tpu_torch.optimize_fused(tp, g2o_tpu_torch.PCGSolver(
        **_solver_kw()), 10)

    assert tres["iterations"] == jres["iterations"] == 10
    np.testing.assert_allclose(tres["chi2_per_iteration"],
                               jres["chi2_per_iteration"], rtol=1e-6)
    np.testing.assert_allclose(tres["chi2_final"], jres["chi2_final"],
                               rtol=1e-6)
    assert tres["trials_per_iteration"] == jres["trials_per_iteration"]
    assert tres["chi2_final"] < 0.1 * tres["chi2_per_iteration"][0]

    # the port's save, read back by the JAX loader, carries its estimates
    out = tio.dumps(tg, estimates_by_vid=tp.estimates_by_vid())
    back = jio.loads(out)
    est = tp.estimates_by_vid()
    for vid, rec in back.vertices().items():
        np.testing.assert_allclose(rec.estimate, est[vid], rtol=1e-9,
                                   atol=1e-9)
    assert [e.vids for e in back.edges()] == [e.vids for e in jg.edges()]
    assert back.vertex(0).fixed


def test_host_loop_lm_matches_fused(text):
    """SparseOptimizer + LevenbergMarquardt and optimize_fused implement the
    same rules: with stateless solves their trajectories agree."""
    tg = tio.loads(text)
    tg.set_robust_kernel("Huber", 1.0)
    tp = tg.compile(dtype=torch.float64)
    est0 = {t: v.clone() for t, v in tp.estimates.items()}
    opt = g2o_tpu_torch.SparseOptimizer(
        tp, algorithm=g2o_tpu_torch.LevenbergMarquardt(),
        solver=g2o_tpu_torch.PCGSolver(**_solver_kw()))
    opt.optimize(6)
    host = [s.chi2 for s in opt.batch_statistics]
    host_final = opt.chi2()
    tp.set_estimates(est0)
    res = g2o_tpu_torch.optimize_fused(
        tp, g2o_tpu_torch.PCGSolver(**_solver_kw()), 6)
    np.testing.assert_allclose(res["chi2_per_iteration"], host, rtol=1e-6)
    np.testing.assert_allclose(res["chi2_final"], host_final, rtol=1e-6)


def test_loader_reads_what_jax_reads(text):
    jg = jio.loads(text)
    tg = tio.loads(text)
    assert sorted(tg.vertices()) == sorted(jg.vertices())
    for vid, rec in jg.vertices().items():
        np.testing.assert_array_equal(tg.vertex(vid).estimate, rec.estimate)
        assert tg.vertex(vid).fixed == rec.fixed
    for te, je in zip(tg.edges(), jg.edges(), strict=True):
        assert te.vids == je.vids
        np.testing.assert_array_equal(te.measurement, je.measurement)
        np.testing.assert_array_equal(te.information, je.information)
    assert tio.dumps(tg) == jio.dumps(jg)


@pytest.mark.parametrize("line,msg", [
    ("VERTEX_SE3:QUAT 3 1 2 3 0 0 0", "line 2"),
    ("EDGE_SE3:QUAT 0 1 0 0 0 0 0 0 1 " + " ".join(["1"] * 20), "line 2"),
    ("NOT_A_TAG 1 2", "line 2: unknown tag"),
    ("EDGE_SE3:QUAT 0 9 0 0 0 0 0 0 1 " + " ".join(["1"] * 21), "line 2"),
    ("FIX 4", "line 2: FIX of unknown vertex 4"),
])
def test_loader_errors_name_the_line(line, msg):
    text = "VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\n" + line + "\n"
    with pytest.raises(ValueError, match=msg):
        tio.loads(text)


def test_edge3_information_is_upper_triangular():
    vals = np.arange(1, 22, dtype=float)
    text = ("VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\nVERTEX_SE3:QUAT 1 1 0 0 0 0 0 1\n"
            "EDGE_SE3:QUAT 0 1 1 0 0 0 0 0 1 "
            + " ".join(str(v) for v in vals) + "\n")
    info = tio.loads(text).edges()[0].information
    np.testing.assert_array_equal(info, jio.loads(text).edges()[0].information)
    assert info[0, 5] == 6 and info[5, 0] == 6 and info[1, 1] == 7
    assert info[5, 5] == 21


def test_create_sphere_matches_jax_without_noise():
    kw = dict(nodes_per_level=6, laps=4, trans_noise=(0.0,) * 3,
              rot_noise=(0.0,) * 3)
    with np.errstate(divide="ignore"):
        jg = j_create_sphere(**kw)
        tg = t_create_sphere(**kw)
    for vid, rec in jg.vertices().items():
        np.testing.assert_allclose(tg.vertex(vid).estimate, rec.estimate,
                                   rtol=1e-12, atol=1e-12)
        assert tg.vertex(vid).fixed == rec.fixed
    for te, je in zip(tg.edges(), jg.edges(), strict=True):
        assert te.vids == je.vids
        np.testing.assert_allclose(te.measurement, je.measurement,
                                   rtol=1e-12, atol=1e-12)


def test_create_sphere_noise_is_seeded():
    a = t_create_sphere(nodes_per_level=5, laps=3, seed=7)
    b = t_create_sphere(nodes_per_level=5, laps=3,
                        generator=torch.Generator().manual_seed(7))
    c = t_create_sphere(nodes_per_level=5, laps=3, seed=8)
    ma = np.stack([e.measurement for e in a.edges()])
    np.testing.assert_array_equal(ma, np.stack([e.measurement
                                                for e in b.edges()]))
    assert not np.array_equal(ma, np.stack([e.measurement
                                            for e in c.edges()]))


def test_port_imports_neither_jax_nor_g2o_tpu():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['g2o_tpu'] = None; import g2o_tpu_torch, "
            "g2o_tpu_torch.io.g2o_format, g2o_tpu_torch.sim.generators, "
            "g2o_tpu_torch.ops.chol_kernels")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "g2o_tpu_torch")):
        if "_build" in dirs:        # build output, not the package's source
            dirs.remove("_build")
        for f in files:
            if f.endswith((".py", ".cu")):
                with open(os.path.join(dirpath, f)) as fh:
                    src = fh.read()
                assert not re.search(
                    r"^\s*(import|from)\s+(jax|g2o_tpu)\b", src, re.M), f


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_tensors_never_launch_kernels(text):
    before = (chol_kernels.chol_batched.launches,
              chol_kernels.solve_lower_batched.launches)
    tg = tio.loads(text)
    tp = tg.compile(dtype=torch.float64)
    g2o_tpu_torch.optimize_fused(tp, g2o_tpu_torch.PCGSolver(
        max_iter=20, tol=1e-3, precond="chunk2", chunk_size=4), 2)
    assert (chol_kernels.chol_batched.launches,
            chol_kernels.solve_lower_batched.launches) == before
