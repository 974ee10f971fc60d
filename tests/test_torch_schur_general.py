"""Port parity: the implicit Schur solver's general path (n-ary observation
edges, partial marginalization) and its multi-observer bucketed branch (one
landmark type observed by mono and stereo edges) against the JAX package
and the port's ``DenseSolver``, float64 on the CPU.

Scenes, small and the same numbers for either package:
* ``psi_fixed`` / ``psi_free``: anchored inverse-depth BA, 3-ary
  ``EDGE_PROJECT_PSI2UV`` edges; every point anchored on the fixed camera 0,
  or on camera ``k % n`` — most anchors free, and each point's anchor also
  observes it (one free vertex in two slots of an edge);
* ``partial``: ``create_ba_scene`` with every third point kept in the
  reduced system (per-vertex partial marginalization);
* ``intrinsics``: ``EDGE_PROJECT_P2MC_INTRINSICS`` (point, SBA camera,
  shared intrinsics vertex);
* ``mixed``: ``create_ba_scene``'s observations as ORB-SLAM stereo edges
  from even cameras and mono edges from odd ones, one point type.

Bars: one solve's ``dx`` at λ = 1e-3 and ``tol=1e-13`` within 1e-7
(relative norm) of the JAX package's and of the dense solve; 8-iteration
fused-LM trajectories within rtol 1e-9 of the JAX package's, with the same
CG iterations and λ-trials per iteration, at ``max_iter=150, tol=1e-6``.
(At the example's ``tol=1e-8`` the residual carry brings the late solves of
``psi_free`` down to the rounding floor of CG, where the two packages'
summation orders stop them one iteration apart; chi2 still agrees to
1e-13.)"""

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from g2o_tpu.core.graph import Graph as JGraph
from g2o_tpu.core.lm_fused import optimize_fused as j_optimize_fused
from g2o_tpu.core.solvers import DenseSolver as JDense
from g2o_tpu.core.solvers.schur_implicit import ImplicitSchurSolver as JImpl
from g2o_tpu.types import sba as jsba
import g2o_tpu_torch
from g2o_tpu_torch.core import problem as tproblem
from g2o_tpu_torch.core.graph import Graph as TGraph
from g2o_tpu_torch.core.solvers import schur_implicit
from g2o_tpu_torch.ops import onehot
from g2o_tpu_torch.sim.generators import create_ba_scene
from g2o_tpu_torch.types import sba as tsba

FOCAL, CX, CY, BF = 1000.0, 320.0, 240.0, 75.0
STEREO = "EDGE_STEREO_SE3_PROJECT_XYZ:EXPMAP"
MONO = "EDGE_SE3_PROJECT_XYZ:EXPMAP"


def _line_cameras(g, t, n):
    """ba_demo's cameras: R = I, centres along x; 0 and 1 fixed."""
    cams = []
    for i in range(n):
        Tcw = np.array([1.0 - i * 0.04, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
        cams.append(Tcw)
        g.add_vertex(i, t.VertexSE3Expmap, Tcw, fixed=(i < 2))
    return cams


def psi_scene(G, t, free, n_cams=6, n_points=40, seed=0):
    """Anchored inverse-depth BA (the JAX package's test scene, every
    camera observing every point); ``free`` anchors point k on camera
    ``k % n_cams`` instead of on the fixed camera 0."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, n_points),
                    rng.uniform(-0.5, 0.5, n_points),
                    rng.uniform(4, 8, n_points)], axis=1)
    g = G()
    g.add_parameter(t.CAM_PARAM_ID, np.array([FOCAL, CX, CY, 0.0]))
    cams = _line_cameras(g, t, n_cams)
    for k in range(n_points):
        anchor = k % n_cams if free else 0
        noisy = pts[k] + rng.normal(scale=0.5, size=3)
        pa = noisy + cams[anchor][:3]
        g.add_vertex(n_cams + k, t.VertexPointXYZ,
                     [pa[0] / pa[2], pa[1] / pa[2], 1.0 / pa[2]],
                     marginalized=True)
        for i in range(n_cams):
            pc = pts[k] + cams[i][:3]
            obs = np.array([FOCAL * pc[0] / pc[2] + CX,
                            FOCAL * pc[1] / pc[2] + CY])
            g.add_edge(t.EdgeProjectPSI2UV, [n_cams + k, i, anchor],
                       obs + rng.normal(size=2), np.eye(2),
                       param_id=t.CAM_PARAM_ID)
    return g


def _ba_arrays(n_cameras, n_points, seed):
    g, truth = create_ba_scene(n_cameras=n_cameras, n_points=n_points,
                               seed=seed)
    verts = {vid: (r.estimate, r.fixed) for vid, r in g.vertices().items()}
    edges = [(e.vids, e.measurement) for e in g.edges()]
    return verts, edges, truth


def partial_scene(G, t, n_cameras=6, n_points=60, seed=5):
    """``create_ba_scene`` with every third point not marginalized."""
    verts, edges, truth = _ba_arrays(n_cameras, n_points, seed)
    keep = set(list(truth)[::3])
    g = G()
    g.add_parameter(t.CAM_PARAM_ID, np.array([FOCAL, CX, CY, 0.0]))
    for vid, (est, fixed) in verts.items():
        if vid < n_cameras:
            g.add_vertex(vid, t.VertexSE3Expmap, est, fixed=fixed)
        else:
            g.add_vertex(vid, t.VertexPointXYZ, est,
                         marginalized=vid not in keep)
    for vids, meas in edges:
        g.add_edge(t.EdgeProjectXYZ2UV, vids, meas, np.eye(2),
                   param_id=t.CAM_PARAM_ID)
    return g


def mixed_scene(G, t, n_cameras=6, n_points=60, seed=1):
    """``create_ba_scene``'s points and observations: stereo edges (f, f,
    cx, cy, bf) from even cameras, with u_right = u - bf/z of the true
    depth; mono edges (f, f, cx, cy) from odd ones."""
    verts, edges, truth = _ba_arrays(n_cameras, n_points, seed)
    g = G()
    g.add_parameter(1, np.array([FOCAL, FOCAL, CX, CY]))
    g.add_parameter(2, np.array([FOCAL, FOCAL, CX, CY, BF]))
    for vid, (est, fixed) in verts.items():
        if vid < n_cameras:
            g.add_vertex(vid, t.VertexSE3Expmap, est, fixed=fixed)
        else:
            g.add_vertex(vid, t.VertexPointXYZ, est, marginalized=True)
    for (pt, cam), meas in edges:
        if cam % 2 == 0:
            g.add_edge(t.EdgeStereoSE3ProjectXYZ, [pt, cam],
                       [meas[0], meas[1], meas[0] - BF / truth[pt][2]],
                       np.eye(3), param_id=2)
        else:
            g.add_edge(t.EdgeSE3ProjectXYZ, [pt, cam], meas, np.eye(2),
                       param_id=1)
    return g


def intrinsics_scene(G, t, n_cams=5, n_points=30, seed=2):
    """SBA cameras (0 and 1 fixed) and one shared intrinsics vertex,
    started off its truth; 3-ary ``EDGE_PROJECT_P2MC_INTRINSICS``."""
    rng = np.random.default_rng(seed)
    K = np.array([FOCAL, FOCAL * 1.01, CX, CY])
    pts = np.stack([rng.uniform(-2, 2, n_points),
                    rng.uniform(-1, 1, n_points),
                    rng.uniform(4, 8, n_points)], axis=1)
    g = G()
    for i in range(n_cams):
        c = np.array([i * 0.2 - 0.4, 0.05 * i, 0.0])
        g.add_vertex(i, t.VertexCam, np.concatenate(
            [c, [0.0, 0.0, 0.0, 1.0], K, [0.1]]), fixed=(i < 2))
    g.add_vertex(50, t.VertexIntrinsics,
                 np.concatenate([K + rng.normal(scale=2.0, size=4), [0.1]]))
    for k in range(n_points):
        g.add_vertex(100 + k, t.VertexPointXYZ,
                     pts[k] + rng.normal(scale=0.1, size=3),
                     marginalized=True)
        for i in range(n_cams):
            pn = pts[k] - np.array([i * 0.2 - 0.4, 0.05 * i, 0.0])
            uv = np.array([K[0] * pn[0] / pn[2] + K[2],
                           K[1] * pn[1] / pn[2] + K[3]])
            g.add_edge(t.EdgeProjectP2MCIntrinsics, [100 + k, i, 50],
                       uv + rng.normal(scale=0.5, size=2), np.eye(2))
    return g


SCENES = {"psi_fixed": lambda G, t: psi_scene(G, t, free=False),
          "psi_free": lambda G, t: psi_scene(G, t, free=True),
          "partial": partial_scene, "intrinsics": intrinsics_scene,
          "mixed": mixed_scene}


def _pair(scene, bucket=False):
    jg, tg = SCENES[scene](JGraph, jsba), SCENES[scene](TGraph, tsba)
    return (jg.compile(bucket_landmarks=bucket),
            tg.compile(device="cpu", bucket_landmarks=bucket))


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def linearized():
    cache = {}

    def get(scene, bucket=False):
        if (scene, bucket) not in cache:
            jp, tp = _pair(scene, bucket)
            cache[scene, bucket] = (
                jp, tp, jp.linearize_jit(jp.data, jp.estimates),
                tp.linearize_fn(tp.data, tp.estimates))
        return cache[scene, bucket]
    return get


@pytest.mark.parametrize("precond", ["jacobi", "schur_jacobi"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_step_matches_jax_and_dense(linearized, scene, precond):
    jp, tp, jl, tl = linearized(scene)
    kw = dict(max_iter=3000, tol=1e-13, precond=precond)
    js = JImpl(**kw).setup(jp)
    ts = g2o_tpu_torch.ImplicitSchurSolver(**kw).setup(tp)
    assert ts._layout["form"] == ("rows" if scene == "mixed" else "general")
    jdx, _ = js._solve_full_jit(jp.data, jl, 1e-3, js.aux)
    tdx, st = ts._solve_full(tp.data, tl, 1e-3, ts.aux)
    ddx = g2o_tpu_torch.DenseSolver().setup(tp).solve(tp.data, tl, 1e-3)
    assert _rel(tdx, jdx) < 1e-7
    assert _rel(tdx, ddx) < 1e-7
    assert _rel(ddx, JDense().setup(jp).solve(jp.data, jl, 1e-3)) < 1e-9
    assert 0 < st["cg_iterations"] < 3000


@pytest.mark.parametrize("scene,precond", [
    ("psi_fixed", "schur_jacobi"), ("psi_free", "schur_jacobi"),
    ("partial", "jacobi"), ("intrinsics", "schur_jacobi"),
    ("mixed", "schur_jacobi")])
def test_lm_trajectory_matches_jax(scene, precond):
    """8 iterations; the mixed scene on its bucketed multi-observer
    layout."""
    bucket = scene == "mixed"
    jp, tp = _pair(scene, bucket)
    kw = dict(max_iter=150, tol=1e-6, precond=precond)
    jres = j_optimize_fused(jp, JImpl(**kw), 8)
    ts = g2o_tpu_torch.ImplicitSchurSolver(**kw)
    tres = g2o_tpu_torch.optimize_fused(tp, ts, 8)
    assert ts._layout["form"] == ("multi_observer" if bucket else "general")
    assert tres["iterations"] == jres["iterations"]
    np.testing.assert_allclose(tres["chi2_per_iteration"],
                               jres["chi2_per_iteration"], rtol=1e-9)
    np.testing.assert_allclose(tres["chi2_final"], jres["chi2_final"],
                               rtol=1e-9)
    assert tres["cg_per_iteration"] == [int(c) for c in
                                        jres["cg_per_iteration"]]
    assert tres["trials_per_iteration"] == [int(c) for c in
                                            jres["trials_per_iteration"]]
    assert tres["chi2_final"] < 0.1 * tres["chi2_per_iteration"][0]


# (bucket_landmarks, layout) -> the port's form
MIXED_LAYOUTS = {(False, "rows"): "rows", (False, "bucketed"): "multi_observer",
                 (False, "auto"): "rows", (True, "rows"): "rows",
                 (True, "bucketed"): "multi_observer",
                 (True, "auto"): "multi_observer"}


@pytest.mark.parametrize("bucket,layout", list(MIXED_LAYOUTS))
def test_mixed_mono_stereo_layouts(linearized, bucket, layout):
    """Mono and stereo edges on one point type, in every layout and
    ``bucket_landmarks`` setting: the JAX package's step, the dense step,
    and (bucketed) the same step as the rows layout."""
    jp, tp, jl, tl = linearized("mixed", bucket)
    assert set(tp.bucket_specs) == ({STEREO, MONO} if bucket else set())
    kw = dict(max_iter=3000, tol=1e-13, precond="schur_jacobi", layout=layout)
    js = JImpl(**kw).setup(jp)
    ts = g2o_tpu_torch.ImplicitSchurSolver(**kw).setup(tp)
    assert ts._layout["form"] == MIXED_LAYOUTS[bucket, layout]
    jdx, _ = js._solve_full_jit(jp.data, jl, 1e-3, js.aux)
    tdx = ts._solve_fn(tp.data, tl, 1e-3)
    assert _rel(tdx, jdx) < 1e-8
    rows = g2o_tpu_torch.ImplicitSchurSolver(
        **dict(kw, layout="rows")).setup(tp)._solve_fn(tp.data, tl, 1e-3)
    assert _rel(tdx, rows) < 1e-10
    ddx = g2o_tpu_torch.DenseSolver().setup(tp).solve(tp.data, tl, 1e-3)
    assert _rel(tdx, ddx) < 1e-7


def test_mixed_kernel_inputs_are_contiguous_int32(linearized, monkeypatch):
    """The calls a CUDA run of the multi-observer branch sends to the
    row-major gather and segment sum carry contiguous values and contiguous
    int32 ids; the dims-major kernels stay out of its solve."""
    _, tp, _, tl = linearized("mixed", True)
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
    s = g2o_tpu_torch.ImplicitSchurSolver(max_iter=20, tol=1e-8).setup(tp)
    s._solve_fn(tp.data, tl, 1e-3)
    assert {"onehot_gather", "onehot_scatter_add"} == set(calls)
    calls.clear()
    tp.linearize_fn(tp.data, tp.estimates)
    assert set(calls) == {"onehot_gather", "onehot_scatter_add_t"}


def test_general_path_raises_as_jax_does(linearized):
    """``layout="bucketed"`` on a general graph and ``deflate_basis`` on the
    general path raise in both packages."""
    jp, tp, _, _ = linearized("psi_free")
    for Impl, p in ((JImpl, jp), (g2o_tpu_torch.ImplicitSchurSolver, tp)):
        with pytest.raises(NotImplementedError, match="layout='bucketed'"):
            Impl(layout="bucketed").setup(p)
        d = p.vertex_types["VERTEX_SE3:EXPMAP"].tangent_dim
        basis = {"VERTEX_SE3:EXPMAP": np.zeros(
            (p.counts["VERTEX_SE3:EXPMAP"], d, 1))}
        with pytest.raises(NotImplementedError, match="deflate_basis"):
            Impl(deflate_basis=basis).setup(p)
