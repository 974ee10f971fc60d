"""Port parity: ``ImplicitSchurSolver`` against the JAX package's, float64
on the CPU, where the gather and segment-sum wrappers run their plain
versions.

* one solve's ``dx`` for every layout — ``rows``, runtime-bucketed
  (``layout="bucketed"`` on a plain problem), and the dims-major ``dm``
  layout of a ``bucket_landmarks=True`` problem — with ``jacobi`` and
  ``schur_jacobi``, with and without gauge deflation, at ``tol=1e-13``:
  rtol 1e-8 of the largest entry (CG on a free-gauge system whose
  undeflated condition reaches ~1e9 at λ = 1e-3; deflated solves agree to
  ~1e-13);
* the 10-iteration fused-LM chi2 trajectory at ``bench.py``'s settings
  (``tol=1e-2``, ``max_iter=100``): rtol 1e-8, with the same CG iterations
  and λ-trials per iteration, with and without Huber;
* the Schur rows wrapper's plain version (``onehot.schur_rows_t_plain``,
  the Schur term per camera, which the ``dm`` form's ``S·v`` calls once
  per CG iteration on unsharded data) against the same product by index
  ops in natural row order, and the route: taken once per ``S·v`` on the
  ``dm`` form (BAL's and sba's widths), never on the other forms; and
  ``onehot.schur_rows_fits`` against the kernel's source (its constants,
  widths and shared-memory test).

Inputs: the committed C20 file (one bucket) and a small file from the
port's stress generator (several buckets, a non-identity reorder)."""

import gzip
import io
import os

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from g2o_tpu.core.lm_fused import optimize_fused as j_optimize_fused
from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver as JImpl
from g2o_tpu.io import bal as jbal
from g2o_tpu.types.bal import bal_gauge_basis as j_gauge_basis
import g2o_tpu_torch
from g2o_tpu_torch.core import problem as tproblem
from g2o_tpu_torch.core.solvers import schur_implicit
from g2o_tpu_torch.core.types import EdgeType, TypeRegistry
from g2o_tpu_torch.io import bal as tbal
from g2o_tpu_torch.ops import onehot, robust
from g2o_tpu_torch.parallel import worker as tworker
from g2o_tpu_torch.sim import generators as tgen
from g2o_tpu_torch.types import sba as tsba
from g2o_tpu_torch.types.bal import VertexCameraBAL, bal_gauge_basis
from g2o_tpu_torch.types.slam3d import VertexPointXYZ

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C20 = os.path.join(ROOT, "data", "bal_cache", "bal-C20-P800-K5-N1-S0.txt.gz")
NAME = "EDGE_OBSERVATION_BAL"
BENCH = dict(max_iter=100, tol=1e-2, matvec_precision="highest")
# layout name -> (load with bucket_landmarks, solver layout, expected form)
LAYOUTS = {"rows": (False, "rows", "rows"),
           "runtime_bucketed": (False, "bucketed", "runtime_bucketed"),
           "dm": (True, "auto", "dm")}


def _close(a, b, rtol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.fixture(scope="module")
def c20_text():
    with gzip.open(C20, "rt") as fh:
        return fh.read()


@pytest.fixture(scope="module")
def small_text():
    return tbal.make_stress_bal(n_cameras=8, n_points=120,
                                mean_obs_per_point=4, seed=2)


def _pair(text, bucket, **kw):
    return (jbal.load_bal_problem(io.StringIO(text), bucket_landmarks=bucket,
                                  **kw),
            tbal.load_bal_problem(io.StringIO(text), bucket_landmarks=bucket,
                                  device="cpu", **kw))


@pytest.fixture(scope="module")
def linearized(small_text):
    out = {}
    for bucket in (False, True):
        jp, tp = _pair(small_text, bucket, huber=1.0)
        out[bucket] = (jp, tp, jp.linearize_jit(jp.data, jp.estimates),
                       tp.linearize_fn(tp.data, tp.estimates))
    return out


@pytest.mark.parametrize("deflate", [False, True])
@pytest.mark.parametrize("precond", ["jacobi", "schur_jacobi"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_step_matches_jax(linearized, layout, precond, deflate):
    bucket, lay, form = LAYOUTS[layout]
    jp, tp, jl, tl = linearized[bucket]
    kw = dict(max_iter=500, tol=1e-13, precond=precond, layout=lay)
    js = JImpl(**kw, deflate_basis=j_gauge_basis(jp) if deflate else None
               ).setup(jp)
    ts = g2o_tpu_torch.ImplicitSchurSolver(
        **kw, deflate_basis=bal_gauge_basis(tp) if deflate else None
    ).setup(tp)
    assert ts._layout["form"] == form
    jdx, jst = js._solve_full_jit(jp.data, jl, 1e-3, js.aux)
    tdx, tst = ts._solve_full(tp.data, tl, 1e-3, ts.aux)
    _close(tdx, jdx, 1e-8)
    if deflate:
        _close(tdx, jdx, 1e-11)
        assert tst["cg_iterations"] == int(jst["cg_iterations"])
    assert float(tst["residual2"]) <= 1e-24 * float(tst["rhs2"])


@pytest.mark.parametrize("huber", [0.0, 1.0])
@pytest.mark.parametrize("layout,precond", [("dm", "jacobi"),
                                            ("runtime_bucketed",
                                             "schur_jacobi")])
def test_fused_lm_trajectory_matches_jax(c20_text, layout, precond, huber):
    bucket, lay, _ = LAYOUTS[layout]
    jp, tp = _pair(c20_text, bucket, huber=huber)
    kw = dict(BENCH, precond=precond, layout=lay)
    jres = j_optimize_fused(jp, JImpl(**kw), 10)
    tres = g2o_tpu_torch.optimize_fused(
        tp, g2o_tpu_torch.ImplicitSchurSolver(**kw), 10)
    assert tres["iterations"] == jres["iterations"] == 10
    np.testing.assert_allclose(tres["chi2_per_iteration"],
                               jres["chi2_per_iteration"], rtol=1e-8)
    np.testing.assert_allclose(tres["chi2_final"], jres["chi2_final"],
                               rtol=1e-8)
    assert tres["cg_per_iteration"] == [int(c) for c in
                                        jres["cg_per_iteration"]]
    assert tres["trials_per_iteration"] == [int(c) for c in
                                            jres["trials_per_iteration"]]
    assert tres["chi2_final"] < 0.8 * tres["chi2_per_iteration"][0]


def test_layouts_agree_on_one_problem(linearized):
    """``rows`` on a bucketed problem (its dims-major leaves) gives the
    ``dm`` layout's step."""
    _, tp, _, tl = linearized[True]
    kw = dict(max_iter=500, tol=1e-13, precond="schur_jacobi",
              deflate_basis=bal_gauge_basis(tp))
    a = g2o_tpu_torch.ImplicitSchurSolver(**kw).setup(tp)
    b = g2o_tpu_torch.ImplicitSchurSolver(**kw, layout="rows").setup(tp)
    assert (a._layout["form"], b._layout["form"]) == ("dm", "rows")
    _close(a._solve_fn(tp.data, tl, 1e-3), b._solve_fn(tp.data, tl, 1e-3),
           1e-11)


def test_matches_explicit_schur_and_dense(linearized):
    """At λ = 1 (a well-conditioned damped system) the implicit step
    converges to the explicit Schur solver's and the dense solver's."""
    _, tp, _, tl = linearized[False]
    lam = 1.0
    dx_i = g2o_tpu_torch.ImplicitSchurSolver(
        max_iter=500, tol=1e-13, layout="bucketed").setup(tp)._solve_fn(
            tp.data, tl, lam)
    dx_e = g2o_tpu_torch.SchurSolver().setup(tp).solve(tp.data, tl, lam)
    dx_d = g2o_tpu_torch.DenseSolver().setup(tp).solve(tp.data, tl, lam)
    _close(dx_i, dx_e, 1e-9)
    _close(dx_i, dx_d, 1e-9)


@pytest.mark.parametrize("bucket", [False, True])
def test_step_matches_jax_index_route(small_text, bucket):
    """Past ``onehot_max_segments`` cameras the JAX solver takes index ops
    on the camera side; the port's gather and segment sum serve every
    camera count, and its step equals that route's."""
    jp, tp = _pair(small_text, bucket, huber=1.0)
    jp.assembly_onehot_max = 0
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    kw = dict(max_iter=500, tol=1e-13, precond="schur_jacobi",
              layout="bucketed")
    js = JImpl(**kw, onehot_max_segments=0).setup(jp)
    ts = g2o_tpu_torch.ImplicitSchurSolver(**kw).setup(tp)
    jdx, _ = js._solve_full_jit(jp.data, jl, 1e-2, js.aux)
    _close(ts._solve_fn(tp.data, tl, 1e-2), jdx, 1e-8)


@pytest.mark.parametrize("layout", ["runtime_bucketed", "dm"])
def test_kernel_inputs_are_contiguous_int32(linearized, monkeypatch,
                                            layout):
    """Every call a CUDA run would send to the gather and segment-sum
    kernels carries contiguous values and contiguous int32 ids (the
    wrappers raise otherwise); on the CPU the same calls are checked here
    and then run their plain versions."""
    bucket = LAYOUTS[layout][0]
    _, tp, _, _ = linearized[bucket]
    calls = []

    def spy(fn):
        def wrapped(idx, src, *a, **k):
            calls.append(fn.__name__)
            assert idx.dtype == torch.int32 and idx.is_contiguous()
            assert src.is_contiguous()
            return fn(idx, src, *a, **k)
        return wrapped

    for mod in (tproblem, schur_implicit):
        for name in ("onehot_gather", "onehot_gather_t", "onehot_scatter_add",
                     "onehot_scatter_add_t"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, spy(getattr(onehot, name)))
    g2o_tpu_torch.optimize_fused(tp, g2o_tpu_torch.ImplicitSchurSolver(
        precond="schur_jacobi", layout=LAYOUTS[layout][1], **dict(
            BENCH, tol=1e-3)), 2)
    want = ({"onehot_gather_t", "onehot_scatter_add_t"} if bucket
            else {"onehot_gather", "onehot_scatter_add"})
    assert want <= set(calls)


def test_fixed_landmarks_stay_pinned_on_dm(small_text):
    """Fixed landmarks are all-zero Hll blocks on the ``dm`` path, made
    unit blocks: their step is exactly 0, and the other vertices get the
    rows layout's step."""
    g = tbal.load_bal(io.StringIO(small_text), huber=1.0)
    fixed = [8 + 3, 8 + 40]
    for vid in fixed:
        g.set_fixed(vid, True)
    pb = g.compile(bucket_landmarks=True, device="cpu")
    p0 = g.compile(device="cpu")
    lb = pb.linearize_fn(pb.data, pb.estimates)
    l0 = p0.linearize_fn(p0.data, p0.estimates)
    kw = dict(max_iter=500, tol=1e-13, precond="schur_jacobi")
    dxb = g2o_tpu_torch.ImplicitSchurSolver(**kw).setup(pb)._solve_fn(
        pb.data, lb, 5e-3)
    dx0 = g2o_tpu_torch.ImplicitSchurSolver(**kw).setup(p0)._solve_fn(
        p0.data, l0, 5e-3)
    eb, e0 = pb.split_tangent(dxb), p0.split_tangent(dx0)
    for vid, (t, i) in p0.vid_index.items():
        t2, i2 = pb.vid_index[vid]
        _close(eb[t2][i2], e0[t][i], 1e-6)
    for vid in fixed:
        t2, i2 = pb.vid_index[vid]
        assert torch.equal(eb[t2][i2], torch.zeros(3, dtype=torch.float64))


def test_pose_pose_edges_enter_the_reduced_system(small_text):
    """A camera-camera edge adds Hpp couplings to S·v: the implicit step,
    in the rows and the ``dm`` layout, equals the dense solver's."""
    def pair_residual(states, meas, param):
        return states[1] - states[0] - meas

    reg = TypeRegistry()
    for vt in (VertexCameraBAL, VertexPointXYZ):
        reg.register_vertex(vt)
    reg.register_edge(tbal.EdgeObservationBAL)
    pair = reg.register_edge(EdgeType(
        name="TEST_CAMERA_PAIR", vertex_types=(VertexCameraBAL,
                                               VertexCameraBAL),
        residual_dim=9, residual=pair_residual, meas_dim=9))
    obs, cams, pts = tbal._parse(small_text)
    C, P, O = len(cams), len(pts), len(obs)
    vb = {VertexCameraBAL.name: (np.arange(C), cams, np.zeros(C, bool),
                                 np.zeros(C, bool)),
          VertexPointXYZ.name: (C + np.arange(P), pts, np.zeros(P, bool),
                                np.ones(P, bool))}
    rng = np.random.default_rng(0)
    ca = np.arange(C - 1)
    eb = {NAME: (np.stack([obs[:, 0], C + obs[:, 1]], 1).astype(np.int64),
                 obs[:, 2:4], np.tile(np.eye(2), (O, 1, 1)),
                 np.full(O, robust.NONE), np.ones(O), np.ones(O, bool),
                 np.zeros((O, 0))),
          pair.name: (np.stack([ca, ca + 1], 1), 0.01 * rng.standard_normal(
              (C - 1, 9)), np.tile(np.eye(9), (C - 1, 1, 1)),
              np.full(C - 1, robust.NONE), np.ones(C - 1),
              np.ones(C - 1, bool), np.zeros((C - 1, 0)))}
    lam = 1e-2
    for bucket in (False, True):
        p = tproblem.build_problem(vb, eb, device="cpu", registry=reg,
                                   bucket_landmarks=bucket)
        assert (NAME in p.bucket_specs) == bucket
        lin = p.linearize_fn(p.data, p.estimates)
        dx_d = g2o_tpu_torch.DenseSolver().setup(p).solve(p.data, lin, lam)
        s = g2o_tpu_torch.ImplicitSchurSolver(
            max_iter=1000, tol=1e-13, precond="schur_jacobi").setup(p)
        assert s._layout["form"] == ("dm" if bucket else "rows")
        _close(s._solve_fn(p.data, lin, lam), dx_d, 1e-8)


def test_stateful_protocol_carries_the_residual_floor(linearized):
    _, tp, _, tl = linearized[True]
    s = g2o_tpu_torch.ImplicitSchurSolver(max_iter=100, tol=1e-2).setup(tp)
    assert float(s.state0) == -1.0
    dx, carry, st = s._solve_state_fn(tp.data, tl, 1e-3, s.state0)
    assert float(carry) == pytest.approx(0.5 * float(st["residual2"]))
    # a floor above the initial residual stops CG before its first step
    _, _, st2 = s._solve_state_fn(tp.data, tl, 1e-3,
                                  torch.tensor(1e30, dtype=torch.float64))
    assert st2["cg_iterations"] == 0
    # solve() threads the floor itself; without absolute_tolerance the
    # state passes through untouched
    assert torch.equal(s.solve(tp.data, tl, 1e-3), dx)
    off = g2o_tpu_torch.ImplicitSchurSolver(
        max_iter=100, tol=1e-2, absolute_tolerance=False).setup(tp)
    assert off.state0 is None
    _, state, _ = off._solve_state_fn(tp.data, tl, 1e-3, "untouched")
    assert state == "untouched"
    assert torch.equal(off.solve(tp.data, tl, 1e-3), dx)


def test_setup_is_cached_and_options_are_checked(linearized):
    _, tp, _, _ = linearized[True]
    s = g2o_tpu_torch.ImplicitSchurSolver()
    assert s.setup(tp) is s and s.setup(tp)._setup_for is tp
    fn = s._solve_full
    assert s.setup(tp)._solve_full is fn
    assert s.setup(tp, force=True)._solve_full is not fn
    for kw in (dict(layout="dense"), dict(precond="chunk"),
               dict(matvec_precision="bf16")):
        with pytest.raises(ValueError):
            g2o_tpu_torch.ImplicitSchurSolver(**kw)
    for mp in ("auto", "default", "highest"):
        g2o_tpu_torch.ImplicitSchurSolver(matvec_precision=mp)


def test_general_path_raises(small_text):
    """Partial marginalization takes the general path, whose step equals
    the JAX package's; a graph without marginalized vertices raises."""
    from g2o_tpu.io import bal as jbal_io

    jg = jbal_io.load_bal(io.StringIO(small_text))
    g = tbal.load_bal(io.StringIO(small_text))
    for gr in (jg, g):
        gr.set_marginalized(8, False)         # the first point
    jp, tp = jg.compile(), g.compile(device="cpu")
    kw = dict(max_iter=500, tol=1e-13, precond="schur_jacobi")
    js, ts = JImpl(**kw).setup(jp), g2o_tpu_torch.ImplicitSchurSolver(
        **kw).setup(tp)
    assert ts._layout["form"] == "general"
    jdx, _ = js._solve_full_jit(jp.data, jp.linearize_jit(jp.data,
                                                          jp.estimates),
                                1e-3, js.aux)
    tdx, _ = ts._solve_full(tp.data, tp.linearize_fn(tp.data, tp.estimates),
                            1e-3, ts.aux)
    _close(tdx, jdx, 1e-8)
    for vid in range(8, 8 + 120):
        g.set_marginalized(vid, False)
    with pytest.raises(ValueError, match="no marginalized"):
        g2o_tpu_torch.ImplicitSchurSolver().setup(g.compile(device="cpu"))


@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_inv_small_t_matches_jax(r):
    from g2o_tpu.ops.smallblocks import inv_small_t as j_inv_small_t
    from g2o_tpu_torch.ops.smallblocks import inv_small_t
    rng = np.random.default_rng(r)
    M = rng.standard_normal((7, r, r))
    A = np.einsum("nij,nkj->nik", M, M) + r * np.eye(r)
    At = np.ascontiguousarray(A.transpose(1, 2, 0))      # (r, r, n)
    got = inv_small_t(torch.tensor(At))
    _close(got, j_inv_small_t(At), 1e-12)
    _close(torch.einsum("ijn,jkn->ikn", got, torch.tensor(At)),
           np.broadcast_to(np.eye(r)[:, :, None], At.shape), 1e-10)


def _dm_scene(kind, small_text, c20_text):
    """A ``dm`` problem on the CPU, float64: the stress file (several
    buckets), C20 (one bucket), an sba scene (widths 6/3) or the stress
    file with two landmarks fixed (all-zero landmark blocks)."""
    if kind == "sba":
        g = tgen.create_ba_scene(n_cameras=6, n_points=60, seed=0)[0]
        return g.compile(bucket_landmarks=True, device="cpu",
                         dtype=torch.float64)
    if kind == "fixed":
        g = tbal.load_bal(io.StringIO(small_text), huber=1.0)
        for vid in (8 + 3, 8 + 40):
            g.set_fixed(vid, True)
        return g.compile(bucket_landmarks=True, device="cpu")
    text = small_text if kind == "stress" else c20_text
    return tbal.load_bal_problem(io.StringIO(text), bucket_landmarks=True,
                                 huber=1.0, device="cpu")


def _schur_rows_by_index(counts, degrees, Bt, idx, DinvT, v):
    """The Schur term per camera by index ops in natural row order: each
    slab row's bucket-order landmark, ``Bᵀv[idx]`` summed per landmark by
    ``index_add``, ``Dinv`` per landmark, ``B s`` per row and its sum per
    camera by ``index_add``."""
    seg = torch.cat([off + torch.arange(n).repeat(d) for off, n, d in zip(
        np.cumsum((0,) + tuple(counts[:-1])), counts, degrees)])
    ok = (idx >= 0) & (idx < v.shape[0])
    cam = torch.where(ok, idx, 0).long()
    u = torch.where(ok[:, None], v[cam], 0.0)
    t = torch.zeros((sum(counts), Bt.shape[1]), dtype=Bt.dtype).index_add_(
        0, seg, torch.einsum("acn,na->nc", Bt, u))
    s = torch.einsum("ijk,kj->ki", DinvT, t)
    rows = torch.einsum("acn,nc->na", Bt, s[seg])
    return torch.zeros_like(v).index_add_(0, cam, rows * ok[:, None])


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("kind", ["stress", "c20", "sba", "fixed"])
def test_schur_rows_plain_matches_index_ops(small_text, c20_text, kind,
                                            dtype, tol):
    """The plain Schur term on a solve's own ``Bt``, ids and ``DinvT``
    (padding rows with W = 0, fixed landmarks' unit blocks) equals the
    product by index ops, entry by entry within 1e-12 (float64) or 1e-5
    (float32, against the float64 product) of the same product of absolute
    values: the rounding bound of its sums, which cancel at λ = 1e-3."""
    p = _dm_scene(kind, small_text, c20_text)
    s = g2o_tpu_torch.ImplicitSchurSolver(max_iter=50, tol=1e-8).setup(p)
    assert s._layout["form"] == "dm"
    lin = p.linearize_fn(p.data, p.estimates)
    ctx = s._parts["landmark_system"](p.data, lin, 1e-3, s.aux)
    (name, Bt), = ctx["Bt"].items()
    spec = p.bucket_specs[name]
    idx = s._rows_here(p.data, name)[2]
    DinvT = ctx["DinvT"][name]
    pt = p.edge_types[name].vertex_types[spec.pose_slot]
    v = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (p.counts[pt.name], pt.tangent_dim)))
    want = _schur_rows_by_index(spec.counts, spec.degrees, Bt, idx, DinvT,
                                v)
    got = onehot.schur_rows_t_plain(spec.counts, spec.degrees, Bt.to(dtype),
                                    idx, DinvT.to(dtype), v.to(dtype))
    assert got.shape == v.shape and got.dtype == dtype
    scale = _schur_rows_by_index(spec.counts, spec.degrees, Bt.abs(), idx,
                                 DinvT.abs(), v.abs())
    assert torch.all((got.double() - want).abs() <= tol * scale)
    assert torch.equal(onehot.schur_rows_t(
        spec.counts, spec.degrees, Bt, idx, DinvT, v),
        onehot.schur_rows_t_plain(spec.counts, spec.degrees, Bt, idx, DinvT,
                                  v))


def _form_scene(form, small_text):
    if form == "multi_observer":
        return tworker.mixed_sba_graph(*tgen.create_ba_scene(
            **tworker.MIXED_TEST_SCENE), g2o_tpu_torch.Graph, tsba).compile(
                bucket_landmarks=True, device="cpu", dtype=torch.float64)
    if form == "dm_sba":
        return _dm_scene("sba", small_text, None)
    return tbal.load_bal_problem(io.StringIO(small_text), huber=1.0,
                                 device="cpu",
                                 bucket_landmarks=form == "dm")


@pytest.mark.parametrize("form,layout", [
    ("dm", "auto"), ("dm_sba", "auto"), ("runtime_bucketed", "bucketed"),
    ("rows", "rows"), ("multi_observer", "auto")])
def test_schur_rows_route_engages_on_dm_only(small_text, monkeypatch, form,
                                             layout):
    """``S·v`` calls the Schur rows wrapper once per CG iteration on the
    ``dm`` form, with the inputs its kernel takes (int32 contiguous ids, B
    contiguous along the edge axis, a contiguous v, widths and a camera
    count it fits), and never on the runtime-bucketed, rows and
    multi-observer forms."""
    calls = []

    def spy(counts, degrees, Bt, idx, DinvT, v):
        assert idx.dtype == torch.int32 and idx.is_contiguous()
        assert Bt.stride(2) == 1 and v.is_contiguous()
        assert onehot.schur_rows_fits(v.shape[0], Bt.shape[0], Bt.shape[1],
                                      Bt.dtype)
        calls.append(Bt.shape[-1])
        return onehot.schur_rows_t(counts, degrees, Bt, idx, DinvT, v)

    monkeypatch.setattr(schur_implicit, "schur_rows_t", spy)
    p = _form_scene(form, small_text)
    s = g2o_tpu_torch.ImplicitSchurSolver(max_iter=50, tol=1e-8,
                                          layout=layout).setup(p)
    assert s._layout["form"] == form.split("_sba")[0]
    _, st = s._solve_full(p.data, p.linearize_fn(p.data, p.estimates), 1e-3,
                          s.aux)
    assert st["cg_iterations"] > 0
    assert len(calls) == (st["cg_iterations"] if form.startswith("dm")
                          else 0)
    assert set(calls) <= set(s._layout["slab_rows"].values())


@pytest.mark.parametrize("form,layout", [
    ("dm", "auto"), ("dm_sba", "auto"), ("runtime_bucketed", "bucketed"),
    ("rows", "rows"), ("multi_observer", "auto")])
def test_schur_rows_tiled_route_engages_on_dm_only(small_text, monkeypatch,
                                                   form, layout):
    """Past the shared-memory camera cap (``schur_rows_fits`` patched
    false) ``S·v`` calls the tiled form once per CG iteration on the ``dm``
    form, with its camera order, and never on the other forms."""
    calls = []

    def spy(counts, degrees, Bt, idx, DinvT, v, order):
        rows, starts = order
        assert rows.dtype == starts.dtype == torch.int32
        assert rows.shape == idx.shape and starts.shape == (v.shape[0] + 1,)
        calls.append(Bt.shape[-1])
        return onehot.schur_rows_tiled_t(counts, degrees, Bt, idx, DinvT, v,
                                         order)

    monkeypatch.setattr(schur_implicit, "schur_rows_fits", lambda *a: False)
    monkeypatch.setattr(schur_implicit, "schur_rows_tiled_t", spy)
    p = _form_scene(form, small_text)
    s = g2o_tpu_torch.ImplicitSchurSolver(max_iter=50, tol=1e-8,
                                          layout=layout).setup(p)
    assert s._layout["form"] == form.split("_sba")[0]
    _, st = s._solve_full(p.data, p.linearize_fn(p.data, p.estimates), 1e-3,
                          s.aux)
    assert st["cg_iterations"] > 0
    assert len(calls) == (st["cg_iterations"] if form.startswith("dm")
                          else 0)


def _schur_rows_source():
    """The Schur rows kernel's constants and its launcher's shared-memory
    formula (``csrc/gather_segment.cu``), and the widths its entry point
    dispatches."""
    import re
    with open(os.path.join(os.path.dirname(os.path.dirname(
            onehot.__file__)), "csrc", "gather_segment.cu")) as f:
        src = f.read()
    consts = {}
    for name, expr in re.findall(r"constexpr int (SROWS_\w+) = ([^;]+);",
                                 src):
        consts[name] = eval(expr, {}, dict(consts))
    smem = " ".join(re.search(r"const size_t smem =([^;]+);", src[
        src.index("int schur_rows("):]).group(1).split())
    widths = tuple((int(a), int(b)) for a, b in re.findall(
        r"if \(dp == (\d+) && dl == (\d+)\)", src))
    return consts, smem, widths


@pytest.mark.parametrize("dtype,dp,dl", [
    (torch.float32, 9, 3), (torch.float64, 9, 3), (torch.float32, 6, 3),
    (torch.float64, 6, 3)])
def test_schur_rows_fits_follows_the_kernel_source(dtype, dp, dl):
    """``schur_rows_fits`` and the wrapper's constants say what the kernel's
    source says: its widths, its most buckets and, at the largest camera
    count it admits and one more, its launcher's shared-memory test."""
    consts, smem, widths = _schur_rows_source()
    assert widths == onehot.SCHUR_ROWS_WIDTHS
    assert (consts["SROWS_THREADS"], consts["SROWS_WLD"],
            consts["SROWS_MAX_BUCKETS"], consts["SROWS_SMEM"]) == (
        onehot.SCHUR_ROWS_THREADS, onehot.SCHUR_ROWS_WLD,
        onehot.SCHUR_ROWS_MAX_BUCKETS, onehot.SCHUR_ROWS_SMEM)
    size = torch.finfo(dtype).bits // 8
    expr = smem.replace("(size_t)", "").replace("sizeof(T)", str(size)) \
        .replace("sizeof(int)", "4")

    def kernel_fits(c):
        return eval(expr, {}, dict(consts, C=c, DP=dp, DL=dl)) <= \
            consts["SROWS_SMEM"]

    most = max(c for c in range(1, 20000) if kernel_fits(c))
    assert onehot.schur_rows_fits(most, dp, dl, dtype)
    assert not onehot.schur_rows_fits(most + 1, dp, dl, dtype)
