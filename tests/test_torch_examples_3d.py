"""Port parity of the 3D landmark examples ``line_slam`` and
``plane_slam`` (``g2o_tpu_torch/examples``) against the JAX package's
scripts in ``examples/``: each run in-process at its own size, the JAX
script with ``sys.argv`` patched, the port's with ``-device cpu``, both in
float64.

Tolerances: the printed lines equal with the run's times taken out,
every printed number within rtol 1e-6 of the JAX script's or one unit of
its last printed digit (the LM loop's ``iteration=`` lines by their
chi2, which past its floor may run an iteration longer in one package:
``_example_runs.assert_same_output``) (the LM loop's chi2 to 6 decimals,
the errors to 4–5). The line and plane helpers the scripts build their
scenes with (``line3d_*``, ``plane_*``, the SE3 group) hold the JAX
package's values to 1e-12."""

import numpy as np
import pytest
import torch

import g2o_tpu.types  # noqa: F401
from _example_runs import assert_same_output, run


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs six worker processes on a shared host, where every process's
    default thread pool oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["line_slam", "plane_slam"])
def test_example_matches_jax(tmp_path, name):
    res = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        res[pkg] = run(pkg, name, [], str(d))
    assert res["torch"][0] == res["jax"][0] == 0
    assert_same_output(res["torch"][1], res["jax"][1])
    assert "iteration= 14" in res["torch"][1]


def test_scene_helpers_match_jax():
    import jax.numpy as jnp

    from g2o_tpu.types import slam3d_addons as ja
    from g2o_tpu_torch.examples import line_slam
    from g2o_tpu_torch.types import slam3d_addons as ta

    rng = np.random.default_rng(5)
    ln = line_slam.pluecker_from_points(rng.normal(size=3),
                                        rng.normal(size=3))
    x = np.concatenate([rng.normal(size=3), rng.normal(size=4)])
    x[3:] /= np.linalg.norm(x[3:])
    pl = np.concatenate([rng.normal(size=3), [1.5]])
    pl[:3] /= np.linalg.norm(pl[:3])
    d4 = rng.normal(scale=0.1, size=4)
    d3 = rng.normal(scale=0.1, size=3)
    t = torch.as_tensor
    pairs = [
        (ta.line3d_oplus(t(ln), t(d4)), ja.line3d_oplus(jnp.asarray(ln),
                                                        jnp.asarray(d4))),
        (ta.line3d_transform(t(x), t(ln)),
         ja.line3d_transform(jnp.asarray(x), jnp.asarray(ln))),
        (ta.plane_transform(t(x), t(pl)),
         ja.plane_transform(jnp.asarray(x), jnp.asarray(pl))),
        (ta.plane_oplus(t(pl), t(d3)),
         ja.plane_oplus(jnp.asarray(pl), jnp.asarray(d3))),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)
