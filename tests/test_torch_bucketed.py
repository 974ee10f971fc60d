"""Port parity: the landmark-bucketed layout (``g2o_tpu_torch.ops.bucketed``
and ``build_problem(bucket_landmarks=True)``) against the JAX package,
float64 on the CPU.

* the host plans (``bucket_by_segment``) are the JAX package's arrays
  exactly, on the committed C20, ladybug and stress files' observation ids,
  on empty segments and under the bucket-merge cap;
* a bucketed BAL problem has the JAX package's layout exactly (bucket
  specs, landmark reorder, ``vid_index``, ``fixed_flat``, edge rows) and
  its linearization — ``b``, diagonal blocks, chi2, the dims-major leaves
  and ``extras`` — agrees to rtol 1e-10 of the largest entry (the same
  formulas, summed in another order).

The C20 file gives every point degree 5 (one bucket, an identity
reorder); a small file from the port's stress generator gives several
buckets and a non-identity reorder."""

import gzip
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from g2o_tpu.core.solvers import DenseSolver as JDense
from g2o_tpu.io import bal as jbal
from g2o_tpu.ops import bucketed as jbucketed
import g2o_tpu_torch
from g2o_tpu_torch.io import bal as tbal
from g2o_tpu_torch.ops import bucketed as tbucketed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "data", "bal_cache")
FILES = {
    "c20": "bal-C20-P800-K5-N1-S0.txt.gz",
    "ladybug": "bal-C49-P7000-K5-N1-S0.txt.gz",
    "stress": "balstress-depth_sigma0.8-estimate_noise1-hub_boost10-"
              "hub_fraction0.1-mean_obs_per_point6-n_cameras120-"
              "n_points30000-outlier_fraction0.07-pixel_noise1-seed0.txt.gz",
}
NAME = "EDGE_OBSERVATION_BAL"
RTOL = 1e-10


def _close(a, b, rtol=RTOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


def _assert_same_plan(got, want):
    for f in ("perm_src", "seg_perm", "seg_perm_full"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert got.degrees == want.degrees and got.counts == want.counts
    assert (got.num_segments, got.num_rows) == (want.num_segments,
                                                want.num_rows)
    assert got.pad_ratio == want.pad_ratio


@pytest.fixture(scope="module")
def small_text():
    return tbal.make_stress_bal(n_cameras=8, n_points=120,
                                mean_obs_per_point=4, seed=2)


@pytest.mark.parametrize("which", list(FILES))
def test_plans_of_the_committed_files_equal_jax(which):
    with gzip.open(os.path.join(CACHE, FILES[which]), "rt") as fh:
        obs, cams, pts = tbal._parse(fh.read())
    seg = obs[:, 1].astype(np.int64)
    for mb in (10, 3):
        _assert_same_plan(
            tbucketed.bucket_by_segment(seg, len(pts), max_buckets=mb),
            jbucketed.bucket_by_segment(seg, len(pts), max_buckets=mb))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_plans_equal_jax(seed):
    rng = np.random.default_rng(seed)
    S = int(rng.integers(3, 60))
    seg = rng.integers(0, S, size=int(rng.integers(0, 400)))
    _assert_same_plan(tbucketed.bucket_by_segment(seg, S),
                      jbucketed.bucket_by_segment(seg, S))


def test_empty_segments_and_merge_cap_equal_jax():
    seg = np.array([5, 5, 5, 9])
    _assert_same_plan(tbucketed.bucket_by_segment(seg, 12),
                      jbucketed.bucket_by_segment(seg, 12))
    rng = np.random.default_rng(3)
    seg = np.repeat(np.arange(500), rng.integers(1, 200, size=500))
    got = tbucketed.bucket_by_segment(seg, 500, max_buckets=4)
    _assert_same_plan(got, jbucketed.bucket_by_segment(seg, 500,
                                                       max_buckets=4))
    assert len(got.degrees) <= 4 and got.pad_ratio < 2.0


@pytest.mark.parametrize("max_deg", [1, 5, 128, 129, 300, 1000])
def test_bucket_ladder_equals_jax(max_deg):
    assert tbucketed._bucket_ladder(max_deg) == \
        jbucketed._bucket_ladder(max_deg)


def test_bucket_reduce_and_broadcast_match_jax():
    rng = np.random.default_rng(7)
    seg = rng.integers(0, 20, size=150)
    plan = tbucketed.bucket_by_segment(seg, 20)
    rows = rng.normal(size=(150, 3))
    padded = np.concatenate([rows, np.zeros((1, 3))])[plan.perm_src]
    _close(tbucketed.bucket_reduce(plan, torch.as_tensor(padded)),
           jbucketed.bucket_reduce(plan, jnp.asarray(padded)), rtol=1e-14)
    ref = np.zeros((20, 3))
    np.add.at(ref, seg, rows)
    _close(tbucketed.bucket_reduce(plan, torch.as_tensor(padded)),
           ref[plan.seg_perm], rtol=1e-14)
    sv = rng.normal(size=(len(plan.seg_perm), 2))
    np.testing.assert_array_equal(
        tbucketed.bucket_broadcast(plan, torch.as_tensor(sv)).numpy(),
        np.asarray(jbucketed.bucket_broadcast(plan, jnp.asarray(sv))))


def _pair(text, **kw):
    return (jbal.load_bal_problem(io.StringIO(text), bucket_landmarks=True,
                                  **kw),
            tbal.load_bal_problem(io.StringIO(text), bucket_landmarks=True,
                                  device="cpu", **kw))


@pytest.mark.parametrize("which", ["c20", "small"])
@pytest.mark.parametrize("kw", [dict(), dict(huber=1.0),
                                dict(pad_edges_to_multiple=64)])
def test_bucketed_layout_equals_jax(which, kw, small_text):
    if which == "c20":
        with gzip.open(os.path.join(CACHE, FILES["c20"]), "rt") as fh:
            text = fh.read()
    else:
        text = small_text
    jp, tp = _pair(text, **kw)
    assert tp.bucket_specs == jp.bucket_specs
    spec = tp.bucket_specs[NAME]
    assert spec.seg_identity and (spec.pose_slot, spec.lm_slot) == (0, 1)
    if which == "small":
        assert len(spec.degrees) > 1
    assert tp.vid_index == jp.vid_index
    assert tp.num_edges == jp.num_edges
    assert tp.uniform_kernel == jp.uniform_kernel
    for t in jp.vertex_types:
        np.testing.assert_array_equal(tp.estimates[t].numpy(),
                                      np.asarray(jp.estimates[t]))
        np.testing.assert_array_equal(tp.marginalized[t], jp.marginalized[t])
    eb_t, eb_j = tp.estimates_by_vid(), jp.estimates_by_vid()
    assert sorted(eb_t) == sorted(eb_j)
    for vid in eb_j:
        np.testing.assert_array_equal(eb_t[vid], eb_j[vid])
    jb, tb = jp.data.edges[NAME], tp.data.edges[NAME]
    for f in ("vidx", "meas", "info", "kernel", "delta", "active", "param"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    plan_t, plan_j = tp.data.plans[NAME], jp.data.plans[NAME]
    for f in ("segp", "meas_t", "info_t", "free_mask", "free_mask_t"):
        np.testing.assert_array_equal(plan_t[f].numpy(),
                                      np.asarray(plan_j[f]), err_msg=f)
    np.testing.assert_array_equal(plan_t["ids32"].numpy(),
                                  np.asarray(jb.vidx).T)
    for f, v in plan_t.items():
        assert v.is_contiguous(), f     # the kernels take contiguous tensors


@pytest.mark.parametrize("huber", [0.0, 1.0])
def test_bucketed_linearize_matches_jax(small_text, huber):
    jp, tp = _pair(small_text, huber=huber, pad_edges_to_multiple=32)
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    _close(tl.b, jl.b)
    for t in jp.vertex_types:
        _close(tl.diag[t], jl.diag[t])
    _close(tl.chi2, jl.chi2)
    _close(tl.chi2_robust, jl.chi2_robust)
    for k in ("Bt", "bl_bucket_t", "Hll_bucket_t", "bl_bucket",
              "Hll_bucket"):
        _close(tl.extras[NAME][k], jl.extras[NAME][k])
    # dims-major leaves, and the row-major views of the accessors
    for a, b in zip(tl.jacs[NAME], jl.jacs[NAME], strict=True):
        assert a.shape == b.shape
        _close(a, b)
    _close(tl.weights[NAME], jl.weights[NAME])
    _close(tl.errors[NAME], jl.errors[NAME])
    for a, b in zip(tp.edge_jacs(tl, NAME), jp.edge_jacs(jl, NAME)):
        _close(a, b)
    _close(tp.edge_weights(tl, NAME), jp.edge_weights(jl, NAME))
    _close(tp.edge_errors(tl, NAME), jp.edge_errors(jl, NAME))
    # chi2, H·v and the dense Hessian through the accessors
    for a, b in zip(tp.chi2_fn(tp.data, tp.estimates),
                    jp.chi2_fn(jp.data, jp.estimates)):
        _close(a, b)
    v = np.random.default_rng(0).standard_normal(tp.total_dim)
    hv_t = tp.hvp_operator(tp.data, tl)(tp.split_tangent(torch.as_tensor(v)))
    hv_j = jp.hvp_operator(jp.data, jl)(jp.split_tangent(jnp.asarray(v)))
    for t in jp.vertex_types:
        _close(hv_t[t], hv_j[t])
    _close(tp.dense_hessian_fn(tp.data, tl), jp.dense_hessian_fn(jp.data, jl))


def test_bucketed_linearize_equals_plain_layout(small_text):
    """Bucketing is invisible to the math: per vertex id, the same ``b``
    and diagonal blocks as the plain layout of the same file."""
    tb = tbal.load_bal_problem(io.StringIO(small_text), huber=1.0,
                               bucket_landmarks=True, device="cpu")
    tp = tbal.load_bal_problem(io.StringIO(small_text), huber=1.0,
                               device="cpu")
    assert any(tb.vid_index[v] != tp.vid_index[v] for v in tp.vid_index)
    lb = tb.linearize_fn(tb.data, tb.estimates)
    lp = tp.linearize_fn(tp.data, tp.estimates)
    bb, bp = tb.split_tangent(lb.b), tp.split_tangent(lp.b)
    for vid, (t, i) in tp.vid_index.items():
        tb_, ib = tb.vid_index[vid]
        _close(bb[tb_][ib], bp[t][i], rtol=1e-12)
        _close(lb.diag[tb_][ib], lp.diag[t][i], rtol=1e-12)
    _close(lb.chi2_robust, lp.chi2_robust, rtol=1e-13)


def _graph_with_fixed_points(text, fixed):
    gt = tbal.load_bal(io.StringIO(text))
    gj = jbal.load_bal(io.StringIO(text))
    for vid in fixed:
        gt.set_fixed(vid, True)
        gj.set_fixed(vid, True)
    return gj, gt


def test_fixed_landmark_with_bucket_reorder(small_text):
    """``fixed_flat`` and the free masks follow the landmark reorder (the
    JAX package's round-5 regression ``d947849``): fixed landmarks of a
    reordered type keep their unit diagonal and do not move, and every
    other vertex gets the plain layout's step."""
    fixed = [8 + 0, 8 + 7, 8 + 50]            # point vertex ids (C = 8)
    gj, gt = _graph_with_fixed_points(small_text, fixed)
    jb = gj.compile(bucket_landmarks=True)
    tb = gt.compile(bucket_landmarks=True, device="cpu")
    tp = gt.compile(device="cpu")
    assert any(tb.vid_index[v] != tp.vid_index[v] for v in fixed)
    np.testing.assert_array_equal(tb.data.fixed_flat.numpy(),
                                  np.asarray(jb.data.fixed_flat))
    for t in jb.vertex_types:
        np.testing.assert_array_equal(tb.data.fixed[t].numpy(),
                                      np.asarray(jb.data.fixed[t]))
    lam = 1e-2
    lt = tb.linearize_fn(tb.data, tb.estimates)
    lj = jb.linearize_jit(jb.data, jb.estimates)
    _close(lt.b, lj.b)
    dxb = g2o_tpu_torch.DenseSolver().setup(tb).solve(tb.data, lt, lam)
    _close(dxb, JDense().setup(jb).solve(jb.data, lj, lam), rtol=1e-8)
    lp = tp.linearize_fn(tp.data, tp.estimates)
    dxp = g2o_tpu_torch.DenseSolver().setup(tp).solve(tp.data, lp, lam)
    eb, ep = tb.split_tangent(dxb), tp.split_tangent(dxp)
    for vid, (t, i) in tp.vid_index.items():
        t2, i2 = tb.vid_index[vid]
        _close(eb[t2][i2], ep[t][i], rtol=1e-8)
    for vid in fixed:
        t2, i2 = tb.vid_index[vid]
        assert torch.equal(eb[t2][i2], torch.zeros(3, dtype=torch.float64))


def test_graph_compile_bucketed_equals_array_loader(small_text):
    g = tbal.load_bal(io.StringIO(small_text), huber=1.0)
    a = g.compile(bucket_landmarks=True, device="cpu")
    b = tbal.load_bal_problem(io.StringIO(small_text), huber=1.0,
                              bucket_landmarks=True, device="cpu")
    assert a.bucket_specs == b.bucket_specs and a.vid_index == b.vid_index
    for t in a.vertex_types:
        np.testing.assert_array_equal(a.estimates[t].numpy(),
                                      b.estimates[t].numpy())


def test_bucketed_cpu_linearize_launches_no_kernel(small_text):
    from g2o_tpu_torch.ops import onehot

    wrappers = (onehot.onehot_gather, onehot.onehot_gather_t,
                onehot.onehot_scatter_add, onehot.onehot_scatter_add_t)
    before = [w.launches for w in wrappers]
    _, tp = _pair(small_text)
    tp.linearize_fn(tp.data, tp.estimates)
    tp.chi2_fn(tp.data, tp.estimates)
    assert [w.launches for w in wrappers] == before


def test_linearize_matches_jax_index_route(small_text):
    """Past ``assembly_onehot_max`` cameras the JAX package gathers and sums
    the camera side with index ops; the port's gather and segment sum serve
    every camera count and give that route's b, diagonal and chi2."""
    jp, tp = _pair(small_text, huber=1.0)
    jp.assembly_onehot_max = 0
    jl = jp.linearize_jit(jp.data, jp.estimates)
    tl = tp.linearize_fn(tp.data, tp.estimates)
    _close(tl.b, jl.b)
    for t in jp.vertex_types:
        _close(tl.diag[t], jl.diag[t])
    _close(tl.chi2_robust, jl.chi2_robust)
    _close(tp.chi2_fn(tp.data, tp.estimates)[0],
           jp.chi2_fn(jp.data, jp.estimates)[0])


@pytest.mark.parametrize("kw", [dict(), dict(pad_edges_to_multiple=64)])
def test_bucketed_states_are_the_row_gather(small_text, kw):
    """A bucketed batch's per-edge states — landmarks broadcast per slab,
    cameras through the row-major gather — are ``estimates[vidx]`` exactly,
    padded rows included."""
    _, tp = _pair(small_text, **kw)
    et, batch = tp.edge_types[NAME], tp.data.edges[NAME]
    got = tp._states(et, batch, tp.estimates, NAME, tp.data.plans)
    for s, vt in enumerate(et.vertex_types):
        assert torch.equal(got[s], tp.estimates[vt.name][batch.vidx[:, s]])
