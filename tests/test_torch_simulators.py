"""Port parity: ``create_simulator2d`` / ``create_simulator3d`` against the
JAX package, float64 on the CPU.

* both generators, for every sensor alone (with odometry) and all nine
  together, give the JAX package's graph bit for bit: vertex ids, types,
  estimates and fixed flags, parameter ids and values, edge order, types,
  vertex ids, parameter ids, measurements and information matrices; the
  port's ``dumps`` of it is the JAX package's text;
* zero noise: chi2 = 0 at the generated estimates for every sensor, the
  bounds of ``tests/test_simulator_sensors.py`` (1e-12 in 2D, 1e-10 in 3D);
* 10 LM iterations on one mixed scene per dimension, from the generator's
  estimates moved by the same seeded tangent noise in both packages:
  ``SupernodalCholeskySolver`` on the 3D scene (SE3 / XYZ / plane / line
  blocks, a fixed calibration vertex, the 3-ary plane edge),
  ``PCGSolver(precond="chunk2")`` on the 2D scene: the chi2 histories
  agree to 1e-9 until LM stops at the rounding floor (the iteration at
  which it stops there depends on the last bits), the final chi2 and
  estimates to 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
import g2o_tpu_torch
from g2o_tpu import PCGSolver as JPCG
from g2o_tpu import SupernodalCholeskySolver as JSupernodal
from g2o_tpu.core.lm_fused import optimize_fused as j_optimize_fused
from g2o_tpu.io import g2o_format as jio
from g2o_tpu.sim import generators as jgen
from g2o_tpu_torch.io import g2o_format as tio
from g2o_tpu_torch.sim import generators as tgen

SENSORS_2D = ("odometry", "pose", "pointxy", "bearing", "pointxy_offset",
              "segment", "segment_line", "segment_pointline", "line2d")
SENSORS_3D = ("odometry", "pose", "pose_offset", "se3prior", "trackxyz",
              "depth", "disparity", "line3d", "plane")


def _make(mod, dim, sensors, noise=1.0, seed=7):
    if dim == 2:
        return mod.create_simulator2d(
            n_poses=40, n_landmarks=25, sensors=sensors, n_segments=10,
            n_lines=8, noise_scale=noise, seed=seed)
    return mod.create_simulator3d(
        n_poses=30, n_landmarks=40, sensors=sensors, n_lines=8, n_planes=6,
        noise_scale=noise, seed=seed)


CASES = ([(2, (s,) if s == "odometry" else ("odometry", s))
          for s in SENSORS_2D] + [(2, SENSORS_2D)]
         + [(3, (s,) if s == "odometry" else ("odometry", s))
            for s in SENSORS_3D] + [(3, SENSORS_3D)])


def _id(case):
    dim, sensors = case
    return f"{dim}d-{'all' if len(sensors) == 9 else sensors[-1]}"


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_simulator_identical_to_jax(case):
    dim, sensors = case
    jg, tg = _make(jgen, dim, sensors), _make(tgen, dim, sensors)
    assert list(tg.vertices()) == list(jg.vertices())
    for vid, j in jg.vertices().items():
        t = tg.vertex(vid)
        assert t.vtype.name == j.vtype.name and t.fixed == j.fixed
        assert t.estimate.dtype == j.estimate.dtype
        np.testing.assert_array_equal(t.estimate, j.estimate)
    assert sorted(tg.parameters()) == sorted(jg._parameters)
    for pid, v in jg._parameters.items():
        np.testing.assert_array_equal(tg.parameter(pid), v)
    assert tg.num_edges == jg.num_edges > 0
    for t, j in zip(tg.edges(), jg.edges()):
        assert t.etype.name == j.etype.name and t.vids == j.vids
        assert t.param_id == j.param_id
        np.testing.assert_array_equal(t.measurement, j.measurement)
        np.testing.assert_array_equal(t.information, j.information)
    assert tio.dumps(tg) == jio.dumps(jg)


ZERO_CASES = [(2, s) for s in SENSORS_2D[1:]] + [(3, s)
                                                 for s in SENSORS_3D[1:]]


@pytest.mark.parametrize("dim,sensor", ZERO_CASES,
                         ids=[f"{d}d-{s}" for d, s in ZERO_CASES])
def test_zero_noise_chi2_is_zero(dim, sensor):
    g = _make(tgen, dim, ("odometry", sensor), noise=0.0)
    p = g.compile(dtype=torch.float64, device="cpu")
    assert p.num_edges > (40 if dim == 2 else 30)
    chi = float(p.chi2_fn(p.data, p.estimates)[0])
    assert chi == pytest.approx(0.0, abs=1e-12 if dim == 2 else 1e-10)


# --------------------------------------------------------------------------- #
# 10 LM iterations per dimension
# --------------------------------------------------------------------------- #

def _pcg_kw():
    return dict(max_iter=400, tol=1e-12, precond="chunk2", chunk_size=4,
                absolute_tolerance=False)


LM_SCENES = {
    3: (dict(n_poses=30, n_landmarks=30, world_size=8.0, n_lines=6,
             n_planes=4, seed=2,
             sensors=("odometry", "pose_offset", "trackxyz", "line3d",
                      "plane")),
        JSupernodal, g2o_tpu_torch.SupernodalCholeskySolver),
    2: (dict(n_poses=60, n_landmarks=30, n_segments=10, n_lines=8, seed=1,
             sensors=SENSORS_2D),
        lambda: JPCG(**_pcg_kw()),
        lambda: g2o_tpu_torch.PCGSolver(**_pcg_kw())),
}


@pytest.mark.parametrize("dim", [3, 2])
def test_lm_trajectory_matches_jax(dim):
    kw, j_solver, t_solver = LM_SCENES[dim]
    make = "create_simulator3d" if dim == 3 else "create_simulator2d"
    text = jio.dumps(getattr(jgen, make)(**kw))
    jp = jio.loads(text).compile()
    tp = tio.loads(text).compile(dtype=torch.float64, device="cpu")
    assert tp.counts == jp.counts and tp.total_dim == jp.total_dim
    dx = 0.05 * np.random.default_rng(100).normal(size=jp.total_dim)
    jp.set_estimates(jp.apply_jit(jp.data, jp.estimates, jnp.asarray(dx)))
    tp.set_estimates(tp.apply_update_fn(tp.data, tp.estimates,
                                        torch.tensor(dx)))
    jres = j_optimize_fused(jp, j_solver(), 10)
    tres = g2o_tpu_torch.optimize_fused(tp, t_solver(), 10)
    jc, tc = jres["chi2_per_iteration"], tres["chi2_per_iteration"]
    n = min(len(jc), len(tc))
    assert n >= 4 and tc[0] > 10 * tres["chi2_final"]
    np.testing.assert_allclose(tc[:n], jc[:n], rtol=1e-9)
    np.testing.assert_allclose(tres["chi2_final"], jres["chi2_final"],
                               rtol=1e-9)
    for t in jp.vertex_types:
        est = tp.estimates[t].numpy()
        np.testing.assert_allclose(est, np.asarray(jp.estimates[t]),
                                   rtol=0, atol=1e-9 * np.abs(est).max())
