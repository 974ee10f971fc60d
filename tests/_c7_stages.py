"""Fault C.7, stage by stage: the float32 supernodal solve of a mixed
(``dtype=float32, state_dtype=float64``) manhattan problem in the JAX
package and in the port, on the CPU.  Prints, for each seed:

* the first linearization's chi2 in both packages (or, with ``--after K``,
  the chi2 after K of the JAX package's mixed Gauss-Newton iterations,
  both packages linearizing those estimates);
* the assembled frontal array: the packages' largest difference over its
  scale, and each one's relative Frobenius distance from the float64
  assembly;
* the panel factor of ONE assembly (the JAX package's) in both packages:
  the largest relative difference of the diagonal factors per level, and
  the first level and frontal (if any) where either factor of either
  assembly is not finite;
* the sweeps on one factor (the JAX package's) in both packages;
* each package's whole step (with its one refinement sweep, and with 0 and
  2) against the float64 dense step, relative;
* the float32 Cholesky of random SPD matrices in both packages against the
  float64 factor (forward and backward error, median of 64).

    JAX_PLATFORMS=cpu python tests/_c7_stages.py --poses 1000 --seeds 0,1
    JAX_PLATFORMS=cpu python tests/_c7_stages.py --poses 3500 --after 2

(``--after 2`` at 3500 poses runs the JAX package's GN eagerly through the
factor: about ten minutes.)
"""

import argparse
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import g2o_tpu.types  # noqa: E402,F401
import g2o_tpu_torch as tg2o  # noqa: E402
from g2o_tpu.core.lm_fused import optimize_fused_gn as j_gn  # noqa: E402
from g2o_tpu.core.solvers import DenseSolver as JDense  # noqa: E402
from g2o_tpu.core.solvers import SupernodalCholeskySolver as JSN  # noqa: E402
from g2o_tpu.core.solvers import supernodal as jsn  # noqa: E402
from g2o_tpu.sim import generators as jgen  # noqa: E402
from g2o_tpu_torch.core.solvers import supernodal as tsn  # noqa: E402
from g2o_tpu_torch.sim import generators as tgen  # noqa: E402

F32, F64 = torch.float32, torch.float64


def _captured(module):
    """Wrap ``module.factorize_frontal`` so that each call keeps its
    assembled array in ``box["ACC"]`` (numpy, the spare slot dropped)."""
    box, inner = {}, module.factorize_frontal

    def wrapped(ACC, *a, **k):
        box["ACC"] = (np.asarray(ACC) if isinstance(ACC, jax.Array)
                      else ACC[:-1].numpy().copy())
        return inner(ACC, *a, **k)

    module.factorize_frontal = wrapped
    return box, inner


def _first_nonfinite(factors, to_np):
    for li, lv in enumerate(factors):
        for gi, (Ld, _) in enumerate(lv):
            if not np.isfinite(to_np(Ld)).all():
                return f"level {li} frontal group {gi} {tuple(Ld.shape)}"
    return "none"


def stages(n_poses, seed, after):
    gj = jgen.create_manhattan(n_poses=n_poses, seed=seed)
    gt = tgen.create_manhattan(n_poses=n_poses, seed=seed)
    jpm = gj.compile(dtype=jnp.float32, state_dtype=jnp.float64)
    jp64 = gj.compile(dtype=jnp.float64)
    tpm = gt.compile(dtype=F32, state_dtype=F64, device="cpu")
    if after:
        res = j_gn(jpm, JSN(), after)
        print(f"  JAX mixed GN x{after}: {res['chi2_per_iteration']}")
        est = {t: np.asarray(v) for t, v in jpm.estimates.items()}
        tpm.set_estimates({t: torch.as_tensor(v) for t, v in est.items()})
        jp64.set_estimates({t: jnp.asarray(v) for t, v in est.items()})
    jl = jpm.linearize_jit(jpm.data, jpm.estimates)
    tl = tpm.linearize_fn(tpm.data, tpm.estimates)
    jl64 = jp64.linearize_jit(jp64.data, jp64.estimates)
    print(f"  chi2 JAX {float(jl.chi2)!r} port {float(tl.chi2)!r}")

    jbox, jf = _captured(jsn)
    tbox, tf = _captured(tsn)
    try:
        js = JSN().setup(jpm)
        ts = tg2o.SupernodalCholeskySolver().setup(tpm)
        js._factor_fn(jpm.data, jl, 0.0, js.aux)
        ts._factor_fn(tpm.data, tl, 0.0, ts.aux)
        A, B = jbox["ACC"], tbox["ACC"]
        js64 = JSN().setup(jp64)
        js64._factor_fn(jp64.data, jl64, 0.0, js64.aux)
        A64 = jbox["ACC"]
    finally:
        jsn.factorize_frontal, tsn.factorize_frontal = jf, tf
    fro = np.linalg.norm(A64)
    print(f"  assembly: max|JAX - port| / scale "
          f"{np.abs(A - B).max() / np.abs(A).max():.3e}; from f64 "
          f"JAX {np.linalg.norm(A - A64) / fro:.3e} "
          f"port {np.linalg.norm(B - A64) / fro:.3e}")

    def factor_j(acc):
        return jf(jnp.asarray(acc), js.aux, js._static, 3, 0.0,
                  js.aux["gfixed"], js.aux["gvalid"])

    def factor_t(acc):
        acc = torch.as_tensor(np.concatenate(
            [acc, np.zeros((1,) + acc.shape[1:], acc.dtype)]))
        return tf(acc, ts.aux, ts._static, 3, 0.0, ts.aux["gfixed"],
                  ts.aux["gvalid"])

    fj, ft = factor_j(A), factor_t(A)
    per_level = []
    for lj, lt in zip(fj, ft):
        worst = 0.0
        for (Lj, _), (Lt, _) in zip(lj, lt):
            Lj, Lt = np.asarray(Lj), Lt.numpy()
            worst = max(worst, float(np.nanmax(np.abs(Lj - Lt)))
                        / max(float(np.nanmax(np.abs(Lj))), 1e-30))
        per_level.append(worst)
    print(f"  factor of JAX's assembly: Ld max rel diff per level, first "
          f"{per_level[0]:.3e}, last {per_level[-1]:.3e}, max "
          f"{max(per_level):.3e} ({len(per_level)} levels)")
    print(f"  first non-finite factor: JAX of JAX's assembly "
          f"{_first_nonfinite(fj, np.asarray)}; JAX of port's "
          f"{_first_nonfinite(factor_j(B), np.asarray)}; port of JAX's "
          f"{_first_nonfinite(ft, lambda x: x.numpy())}; port of port's "
          f"{_first_nonfinite(factor_t(B), lambda x: x.numpy())}")
    b = np.asarray(jl.b).reshape(-1, 3)
    fjt = [[(torch.as_tensor(np.array(L)), torch.as_tensor(np.array(P)))
            for L, P in lv] for lv in fj]
    xj = np.asarray(jsn.solve_supernodal(
        fj, jnp.asarray(b)[np.asarray(js.aux["perm"])], js.aux["levels"], 3))
    xt = tsn.solve_supernodal(fjt, torch.as_tensor(b)[ts.aux["perm"]],
                              ts.aux["levels"], 3).numpy()
    print(f"  sweeps on JAX's factor: max rel diff "
          f"{np.abs(xj - xt).max() / np.abs(xj).max():.3e}")

    ref = np.asarray(JDense().setup(jp64).solve(jp64.data, jl64, 0.0))
    for refine in (0, 1, 2):
        dj = np.asarray(JSN(refine=refine).setup(jpm).solve(jpm.data, jl,
                                                             0.0))
        dt = tg2o.SupernodalCholeskySolver(refine=refine).setup(tpm).solve(
            tpm.data, tl, 0.0).numpy()
        rel = [np.linalg.norm(d.astype(np.float64) - ref)
               / np.linalg.norm(ref) for d in (dj, dt)]
        print(f"  step (refine={refine}) from the f64 dense step: JAX "
              f"{rel[0]:.3e} port {rel[1]:.3e}")


def cholesky_errors():
    rng = np.random.default_rng(0)
    for n, kappa in ((24, 1e3), (72, 1e5), (72, 1e7)):
        Q = np.linalg.qr(rng.standard_normal((64, n, n)))[0]
        ev = np.exp(np.linspace(0, np.log(kappa), n))
        A = (Q * ev[None, None, :]) @ Q.transpose(0, 2, 1)
        A = ((A + A.transpose(0, 2, 1)) / 2).astype(np.float32)
        L64 = np.linalg.cholesky(A.astype(np.float64))
        out = []
        for L in (np.asarray(jnp.linalg.cholesky(jnp.asarray(A))),
                  torch.linalg.cholesky(torch.as_tensor(A)).numpy()):
            L = L.astype(np.float64)
            fwd = (np.linalg.norm(L - L64, axis=(1, 2))
                   / np.linalg.norm(L64, axis=(1, 2)))
            bwd = (np.linalg.norm(A - L @ L.transpose(0, 2, 1), axis=(1, 2))
                   / np.linalg.norm(A, axis=(1, 2)))
            out.append((np.median(fwd), np.median(bwd)))
        print(f"f32 Cholesky n={n} kappa={kappa:.0e}: forward JAX "
              f"{out[0][0]:.2e} port {out[1][0]:.2e}; backward JAX "
              f"{out[0][1]:.2e} port {out[1][1]:.2e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--poses", type=int, default=1000)
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--after", type=int, default=0,
                    help="JAX mixed GN iterations before the comparison")
    args = ap.parse_args()
    for seed in (int(s) for s in args.seeds.split(",")):
        print(f"create_manhattan({args.poses}, seed={seed})")
        stages(args.poses, seed, args.after)
    cholesky_errors()


if __name__ == "__main__":
    main()
