"""The implicit Schur path at BAL Final's sizes, on the CPU at small ones.

Past ``2^31`` elements on the edge axis the bucketed linearization's
camera blocks (``Σ JᵀWJ``, ``b`` and the off-diagonal ``B``) and the
implicit Schur preconditioner's (``Σ B D⁻¹ Bᵀ``) are summed over edge
chunks (``core/problem.py::edge_chunks``); past the Schur rows kernel's
shared-memory camera cap the ``dm`` form's ``S·v`` takes the kernel's
tiled form.  With ``EDGE_CHUNK_ELEMS`` patched down, so that both stages
run in at least three chunks on a scene of 40 cameras and 2,000 points
drawn by the benchmark's generator and built by its ``build_program``:

* the camera blocks equal the one-chunk path's (float64 and float32) and
  the plain reference's (``portbench/reference``, float64);
* no tensor of either stage is larger than the patched limit;
* a 3-iteration ``optimize_fused`` job with forced chunks and the tiled
  route follows the reference's Levenberg-Marquardt path under the
  Final cell's judgement;
* the route: the shared-memory Schur rows kernel up to its camera cap, the
  tiled form past it, neither on the other forms."""

import json
import os
import sys

import pytest
import torch

import g2o_tpu_torch
from g2o_tpu_torch.core import problem as tproblem
from g2o_tpu_torch.core.solvers import schur_implicit
from g2o_tpu_torch.ops import onehot
from g2o_tpu_torch.utils import tictoc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import bench, scene as scene_mod  # noqa: E402
from portbench.reference import check  # noqa: E402
from portbench.reference.bal import linearize as ref_linearize  # noqa: E402
from portbench.reference.schur import Reduced  # noqa: E402

NAME = "EDGE_OBSERVATION_BAL"
CAM, PT = "VERTEX_CAMERA_BAL", "VERTEX_TRACKXYZ"
SIZES = dict(cameras=40, points=2000, observations=13000)
SEED = 2 ** 31 + 12345
LAM = 1e-3
# the limit that puts the widest per-edge temporaries (the linearization's
# 162 values an edge, the preconditioner's 243) into 5 and 7 chunks; every
# other tensor of the two stages holds at most 36 values an edge
PER_EDGE = 40


def _config(**over):
    with open(os.path.join(ROOT, "portbench", "configs",
                           "bal-final-13682.json")) as f:
        cfg = json.load(f)
    cfg.update(SIZES, **over)
    return cfg


def _traffic(**over):
    with open(os.path.join(ROOT, "portbench", "traffic", "cold.json")) as f:
        return dict(json.load(f), **over)


def _build(dtype, sizes=None):
    cfg = _config(dtype=dtype, **(sizes or {}))
    scene = scene_mod.make_scene(cfg, SEED, "cpu")
    x0 = scene_mod.job_start(scene, _traffic(), 0)
    problem, solver, order = bench.build_program(cfg, scene, x0, "cpu")
    return cfg, scene, x0, problem, solver, order


def _stages(problem, solver):
    """The linearization and the preconditioner's camera blocks (before
    their inverse) at the problem's estimates and ``LAM``."""
    lin = problem.linearize_fn(problem.data, problem.estimates)
    ctx = solver._parts["landmark_system"](problem.data, lin, LAM,
                                           solver.aux)
    _, blocks = solver._parts["preconditioner"](ctx, problem.data, lin, LAM,
                                                solver.aux)
    return lin, blocks


def _limit(problem):
    return PER_EDGE * problem.bucket_specs[NAME].n_rows


@pytest.fixture
def counted(monkeypatch):
    """Spans on (``G2O_ENABLE_TICTOC``), their counts from zero."""
    monkeypatch.setenv("G2O_ENABLE_TICTOC", "1")
    tictoc.reset()
    yield
    tictoc.reset()


@pytest.mark.parametrize("against,dtype,tol", [
    # the same adds regrouped per chunk: float64 rounding, far below 1e-12
    ("one_chunk", "float64", 1e-12),
    # float32: 16 units in the last place (2^-23) of the largest entry, for
    # sums of a few hundred rows a camera regrouped per chunk
    ("one_chunk", "float32", 2e-6),
    # the reference's autograd Jacobians and its own order of adds
    ("reference", "float64", 1e-10)])
def test_chunked_camera_blocks(monkeypatch, counted, against, dtype, tol):
    """The camera ``b`` and diagonal blocks of the linearization, its
    off-diagonal ``B`` and the preconditioner's camera blocks, summed over
    at least three edge chunks a stage, equal the one-chunk path's (or
    the plain reference's) within ``tol`` of their largest entry; each
    chunk pass is one ``edge_chunk`` span."""
    _, scene, x0, p, s, _ = _build(dtype)
    monkeypatch.setattr(schur_implicit, "inv_small", lambda x: x)
    E = p.bucket_specs[NAME].n_rows
    if against == "one_chunk":
        lin, pre = _stages(p, s)
        want = dict(b=p.split_tangent(lin.b)[CAM], H=lin.diag[CAM],
                    B=lin.extras[NAME]["Bt"], M=pre[CAM])
        assert tictoc.stats()["edge_chunk"]["count"] == 2
    else:
        ref = ref_linearize(x0, scene.obs, 1.0)
        red = Reduced(ref, LAM, scene.obs, check.Arith(torch.float64))
        want = dict(b=ref.bc, H=ref.Hc, M=torch.linalg.inv(red.Minv))
    tictoc.reset()
    monkeypatch.setattr(tproblem, "EDGE_CHUNK_ELEMS", _limit(p))
    n_lin = len(tproblem.edge_chunks(E, 2 * 9 * 9))
    n_pre = len(tproblem.edge_chunks(E, 9 * 9 * 3))
    assert n_lin >= 3 and n_pre >= 3
    lin, pre = _stages(p, s)
    assert tictoc.stats()["edge_chunk"]["count"] == n_lin + n_pre
    got = dict(b=p.split_tangent(lin.b)[CAM], H=lin.diag[CAM],
               B=lin.extras[NAME]["Bt"], M=pre[CAM])
    # M = H + λI - Σ B D⁻¹ Bᵀ cancels: both terms are bounded by H (S and
    # Σ B D⁻¹ Bᵀ are positive semidefinite), so H's largest entry is the
    # scale of its rounding
    scale = dict(want, M=want["H"])
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        err = (got[k].double() - w.double()).abs().max()
        assert err <= tol * scale[k].double().abs().max(), (k, float(err))


def test_no_edge_tensor_passes_the_chunk_limit(monkeypatch):
    """With the limit patched down, no tensor that the linearization, the
    landmark system, the preconditioner or a whole solve makes holds more
    elements than it: at the real limit (2^31 - 1) nothing on the edge
    axis reaches 2^31 elements at Final's 29.0M observations."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, _, _, p, s, _ = _build("float64")
    limit = _limit(p)
    monkeypatch.setattr(tproblem, "EDGE_CHUNK_ELEMS", limit)
    monkeypatch.setattr(schur_implicit, "schur_rows_fits",
                        lambda *a: False)
    s.setup(p, force=True)
    assert s._layout["schur_rows"] == {NAME: "tiled"}

    class Largest(TorchDispatchMode):
        most = (0, None)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(o, torch.Tensor) and o.numel() > self.most[0]:
                    self.most = (o.numel(), (str(func), tuple(o.shape)))
            return out

    with Largest() as seen:
        lin = p.linearize_fn(p.data, p.estimates)
        _, st = s._solve_full(p.data, lin, LAM, s.aux)
    assert st["cg_iterations"] > 0
    assert 0 < seen.most[0] <= limit, seen.most


def test_forced_chunks_follow_the_reference_path(monkeypatch):
    """A 3-iteration job of the Final cell's program in float32, every
    chunked stage in at least three chunks and ``S·v`` on the tiled
    route, judged trial by trial by the plain reference within the cell's
    limits."""
    calls = []
    monkeypatch.setattr(schur_implicit, "schur_rows_fits", lambda *a: False)
    monkeypatch.setattr(schur_implicit, "schur_rows_tiled_t", lambda *a: (
        calls.append(1), onehot.schur_rows_tiled_t(*a))[1])
    cfg, scene, x0, p, s, order = _build("float32")
    monkeypatch.setattr(tproblem, "EDGE_CHUNK_ELEMS", _limit(p))
    assert s._layout["schur_rows"] == {NAME: "tiled"}
    inst = bench.Instrument(p, s, False)
    inst.current = []
    res = g2o_tpu_torch.optimize_fused(p, s, 3)
    rec = bench.to_record(p, order, x0, inst.current, p.estimates, res)
    assert len(calls) == sum(res["cg_per_iteration"]) > 0
    gaps = check.judge(rec, scene.obs, cfg["huber_delta"],
                       cfg["reference_solver"], 3)
    limits = cfg["check_limits"]
    assert all(gaps[n] <= limits[n] for n in limits), gaps


@pytest.mark.parametrize("cameras,route", [
    (1778, "shared"),          # Venice
    (5915, "shared"),          # the cap in float32 at dp = 9
    (5916, "tiled"),
    (13682, "tiled")])         # Final
def test_schur_rows_route_past_the_camera_cap(monkeypatch, cameras, route):
    """The ``dm`` form's ``S·v`` calls the shared-memory Schur rows kernel
    once per CG iteration up to its camera cap (``schur_rows_fits``), its
    tiled form past it, and never both."""
    counts = {"shared": [], "tiled": []}
    monkeypatch.setattr(schur_implicit, "schur_rows_t", lambda *a: (
        counts["shared"].append(1), onehot.schur_rows_t(*a))[1])
    monkeypatch.setattr(schur_implicit, "schur_rows_tiled_t", lambda *a: (
        counts["tiled"].append(1), onehot.schur_rows_tiled_t(*a))[1])
    _, _, _, p, s, _ = _build("float32", dict(
        cameras=cameras, points=600, observations=2400))
    assert s._layout["form"] == "dm"
    assert s._layout["schur_rows"] == {NAME: route}
    assert onehot.schur_rows_fits(cameras, 9, 3, torch.float32) == (
        route == "shared")
    _, st = s._solve_full(p.data, p.linearize_fn(p.data, p.estimates), LAM,
                          s.aux)
    assert st["cg_iterations"] > 0
    assert len(counts[route]) == st["cg_iterations"]
    assert not counts["tiled" if route == "shared" else "shared"]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-6)])
def test_schur_rows_order_sorts_rows_by_camera(dtype, tol):
    """``schur_rows_order``: each camera's rows, in slab order, between its
    first place and the next camera's (ids out of range outside every
    camera's), and summing them gives the segment sum."""
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(-2, 52, (5000,), generator=g, dtype=torch.int32)
    rows = torch.randn((5000, 9), generator=g, dtype=dtype)
    order, starts = onehot.schur_rows_order(ids, 50)
    assert order.dtype == starts.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(5000))
    want = onehot.onehot_scatter_add_plain(ids, rows, 50)
    for c in range(50):
        mine = order[int(starts[c]):int(starts[c + 1])].long()
        assert torch.equal(mine, torch.nonzero(ids == c).flatten())
        assert (rows[mine].sum(0) - want[c]).abs().max() <= \
            tol * want.abs().max()
