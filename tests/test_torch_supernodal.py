"""Port parity: the supernodal multifrontal Cholesky solver.

* the symbolic phase builds the SAME schedule as the JAX package's on
  ``data/sphere2500.g2o`` itself (host only, exact equality);
* one solve at λ = 1e-3 on a small Huber sphere whose schedule still has
  144-column diagonal panels (so the K1/K2/K3 dispatch — plain versions on
  the CPU — is on the path) matches the JAX solver's to rtol 1e-9, with and
  without a fixed vertex, and with an edge that binds one vertex twice;
* 10 fused-LM iterations match the JAX run: chi2 trajectory to rtol 1e-6
  and the same trials per iteration (the bounds of ``test_torch_slice.py``);
* the host-loop ``SparseOptimizer`` agrees with ``optimize_fused``.

Everything here is float64 on the CPU."""

import os

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from g2o_tpu.core.lm_fused import optimize_fused as j_optimize_fused
from g2o_tpu.core.solvers import sparse_chol as jsc
from g2o_tpu.core.solvers import supernodal as jsn
from g2o_tpu.io import g2o_format as jio
from g2o_tpu.sim.generators import create_sphere as j_create_sphere
import g2o_tpu_torch
from g2o_tpu_torch.core.solvers import sparse_chol as tsc
from g2o_tpu_torch.core.solvers import supernodal as tsn
from g2o_tpu_torch.io import g2o_format as tio
from g2o_tpu_torch.ops import chol_kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPHERE2500 = os.path.join(ROOT, "data", "sphere2500.g2o")
LAM = 1e-3

# an EDGE_SE3:QUAT whose two slots bind vertex 7 (the same-vertex H blocks
# H_ab + H_abᵀ belong to that vertex's diagonal block)
SELF_EDGE = ("EDGE_SE3:QUAT 7 7 0.05 -0.02 0.01 0.01 0 0.02 0.9997 "
             + " ".join("2" if i in (0, 6, 11, 15, 18, 20) else "0"
                        for i in range(21)) + "\n")


def _pairs(p):
    """Unique undirected vertex pairs of a one-vertex-type problem."""
    s = set()
    for batch in p.data.edges.values():
        for a, b in np.asarray(batch.vidx):
            if a != b:
                s.add((min(int(a), int(b)), max(int(a), int(b))))
    return np.asarray(sorted(s), dtype=np.int64)


@pytest.fixture(scope="module")
def text():
    g = j_create_sphere(nodes_per_level=10, laps=10, seed=5)
    g.set_robust_kernel("Huber", 1.0)
    return jio.dumps(g)


def _both(text, *, unfix=False):
    """The JAX and the port problem from one ``.g2o`` text (Huber 1.0)."""
    out = []
    for io, kw in ((jio, {}), (tio, dict(dtype=torch.float64, device="cpu"))):
        g = io.loads(text)
        g.set_robust_kernel("Huber", 1.0)
        if unfix:
            for vid, rec in g.vertices().items():
                if rec.fixed:
                    g.set_fixed(vid, False)
        out.append(g.compile(**kw))
    return out


def test_schedule_identical_to_jax_on_sphere2500():
    jp = jio.load(SPHERE2500).compile()
    tp = tio.load(SPHERE2500).compile(dtype=torch.float64, device="cpu")
    n = jp.counts["VERTEX_SE3:QUAT"]
    pairs = _pairs(jp)
    np.testing.assert_array_equal(_pairs(tp), pairs)
    jsym = jsc.symbolic_factorization(n, pairs)
    tsym = tsc.symbolic_factorization(n, pairs)
    for key in ("perm", "inv", "parent", "depth", "colptr", "rows_flat"):
        np.testing.assert_array_equal(tsym[key], jsym[key], err_msg=key)
    _, jst, jmeta = jsn.build_supernodal_schedule(jsym, d=6)
    _, tst, tmeta = tsn.build_supernodal_schedule(tsym, d=6)
    np.testing.assert_array_equal(tmeta["starts"], jmeta["starts"])
    assert len(tmeta["rowsets"]) == len(jmeta["rowsets"])
    for a, b in zip(tmeta["rowsets"], jmeta["rowsets"]):
        np.testing.assert_array_equal(a, b)
    assert len(tst["groups"]) == len(jst["groups"])
    for a, b in zip(tst["groups"], jst["groups"]):
        for key in ("level", "spb", "mpb", "S", "ks", "off"):
            assert a[key] == b[key], key
    assert tst["levels"] == jst["levels"]
    assert tst["pairs"] == jst["pairs"]
    assert tst["acc_T"] == jst["acc_T"] == 775_719
    assert (tmeta["n_supernodes"], tmeta["n_levels"], len(tst["groups"])) \
        == (154, 13, 33)
    big = [g for g in tst["groups"] if g["spb"] * 6 == 144]
    assert len(big) == 17
    # the solver's own setup (pairs from the compiled problem) agrees
    meta = g2o_tpu_torch.SupernodalCholeskySolver().setup(tp).meta
    np.testing.assert_array_equal(meta["starts"], jmeta["starts"])


def test_symbolic_python_matches_jax():
    jp = j_create_sphere(nodes_per_level=8, laps=6, seed=1).compile()
    n = jp.counts["VERTEX_SE3:QUAT"]
    pairs = _pairs(jp)
    for min_size in (4, 32):
        got = tsc._symbolic_python(n, pairs, min_size)
        want = jsc._symbolic_python(n, pairs, min_size)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)


def test_schedule_has_kernel_sized_panels(text):
    """The small sphere of the numeric tests reaches the K1/K2/K3 dispatch:
    it has diagonal panels past 96 columns, a multiple of d = 6."""
    _, tp = _both(text)
    groups = g2o_tpu_torch.SupernodalCholeskySolver().setup(tp)._static[
        "groups"]
    assert sum(g["spb"] * 6 == 144 for g in groups) == 2


@pytest.mark.parametrize("case", ["fixed", "unfixed", "self_edge"])
def test_solve_matches_jax(text, case):
    if case == "self_edge":
        text = text + SELF_EDGE
    jp, tp = _both(text, unfix=case == "unfixed")
    fixed = any(bool(np.asarray(f).any()) for f in jp.data.fixed.values())
    assert fixed == (case != "unfixed")
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    js = jsn.SupernodalCholeskySolver().setup(jp)
    ts = g2o_tpu_torch.SupernodalCholeskySolver().setup(tp)
    if case == "self_edge":
        assert ts.aux["asm_self"] and js.aux["asm_self"]
    before = (chol_kernels.chol_batched.launches,
              chol_kernels.solve_lower_batched.launches,
              chol_kernels.solve_upper_batched.launches)
    dj = np.asarray(js.solve(jp.data, jl, LAM))
    dt = ts.solve(tp.data, tl, LAM)
    assert dt.dtype == torch.float64 and dt.shape == (tp.total_dim,)
    np.testing.assert_allclose(dt.numpy(), dj, rtol=1e-9,
                               atol=1e-9 * np.abs(dj).max())
    # CPU tensors never count as kernel launches
    assert (chol_kernels.chol_batched.launches,
            chol_kernels.solve_lower_batched.launches,
            chol_kernels.solve_upper_batched.launches) == before


def test_solve_is_exact_without_refinement(text):
    """In float64 the factor alone solves (H + λI) dx = b: the residual of
    ``refine=0`` is at rounding level, from the port's own H·v."""
    _, tp = _both(text)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    dx = g2o_tpu_torch.SupernodalCholeskySolver(refine=0).setup(tp).solve(
        tp.data, tl, LAM)
    hvp = tp.hvp_operator(tp.data, tl, precision="highest")
    xb = tp.split_tangent(dx)
    hv = hvp(xb)
    Ax = {}
    for t in tp.vertex_types:
        fx = tp.data.fixed[t].double()[:, None]
        Ax[t] = hv[t] + LAM * xb[t] * (1 - fx) + xb[t] * fx
    r = tl.b - tp.join_tangent(Ax)
    assert float(r.norm() / tl.b.norm()) < 1e-10


def test_hvp_operator_precision_keyword(text):
    _, tp = _both(text)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    v = tp.split_tangent(torch.linspace(-1, 1, tp.total_dim,
                                        dtype=torch.float64))
    hv = tp.hvp_operator(tp.data, tl)(v)
    for prec in ("highest", "default"):
        hp = tp.hvp_operator(tp.data, tl, precision=prec)(v)
        for t in hv:
            assert torch.equal(hp[t], hv[t])
    with pytest.raises(ValueError, match="precision"):
        tp.hvp_operator(tp.data, tl, precision="bf16")


def test_fused_lm_trajectory_matches_jax(text):
    jp, tp = _both(text)
    jres = j_optimize_fused(jp, jsn.SupernodalCholeskySolver(), 10)
    solver = g2o_tpu_torch.SupernodalCholeskySolver()
    # the stateless protocol: no carried solver state
    assert not hasattr(solver, "_solve_state_fn")
    tres = g2o_tpu_torch.optimize_fused(tp, solver, 10)
    assert tres["iterations"] == jres["iterations"] == 10
    np.testing.assert_allclose(tres["chi2_per_iteration"],
                               jres["chi2_per_iteration"], rtol=1e-6)
    np.testing.assert_allclose(tres["chi2_final"], jres["chi2_final"],
                               rtol=1e-6)
    assert tres["trials_per_iteration"] == jres["trials_per_iteration"]
    assert tres["cg_per_iteration"] == [0] * 10
    assert tres["chi2_final"] < 0.01 * tres["chi2_per_iteration"][0]


def test_host_loop_lm_matches_fused(text):
    _, tp = _both(text)
    est0 = {t: v.clone() for t, v in tp.estimates.items()}
    opt = g2o_tpu_torch.SparseOptimizer(
        tp, algorithm=g2o_tpu_torch.LevenbergMarquardt(),
        solver=g2o_tpu_torch.SupernodalCholeskySolver())
    assert opt.optimize(6) == 6
    host = [s.chi2 for s in opt.batch_statistics]
    host_final = opt.chi2()
    tp.set_estimates(est0)
    res = g2o_tpu_torch.optimize_fused(
        tp, g2o_tpu_torch.SupernodalCholeskySolver(), 6)
    np.testing.assert_allclose(res["chi2_per_iteration"], host, rtol=1e-6)
    np.testing.assert_allclose(res["chi2_final"], host_final, rtol=1e-6)


def test_setup_is_cached_per_problem(text):
    _, tp = _both(text)
    s = g2o_tpu_torch.SupernodalCholeskySolver()
    s.setup(tp)
    aux = s.aux
    assert s.setup(tp).aux is aux
    assert s.setup(tp, force=True).aux is not aux


def test_backward_sweep_shapes_on_sphere2500(monkeypatch):
    """The shapes the supernodal solve hands K3 on ``data/sphere2500.g2o``,
    recorded at the kernel wrapper (on the CPU it runs the plain version):
    per sweep, 17 single-column (S, 144, 1) batches in the backward
    sweep's order, S in {1, 2, 3, 12, 55} and ten of them a single matrix;
    ``refine=1`` sweeps twice.  ``chip_smoke.py`` times K3 at these batch sizes."""
    seen = []
    wrapped = chol_kernels.solve_upper_batched

    def record(L, B):
        seen.append((tuple(L.shape), tuple(B.shape)))
        return wrapped(L, B)

    monkeypatch.setattr(chol_kernels, "solve_upper_batched", record)
    g = tio.load(SPHERE2500)
    g.set_robust_kernel("Huber", 1.0)
    tp = g.compile(dtype=torch.float32, device="cpu")
    solver = g2o_tpu_torch.SupernodalCholeskySolver().setup(tp)
    assert solver.refine == 1
    dx = solver.solve(tp.data, tp.linearize_fn(tp.data, tp.estimates), LAM)
    assert bool(torch.isfinite(dx).all())
    # levels from the root down, each level's groups in order
    sweep = [1, 1, 2, 1, 2, 1, 3, 1, 2, 1, 1, 12, 1, 1, 2, 55, 1]
    want = [((S, 144, 144), (S, 144, 1)) for S in sweep]
    assert seen == want + want
    assert sum(S == 1 for S in sweep) == 10
