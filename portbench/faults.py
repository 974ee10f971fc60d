"""Faults planted under the timed entry, for the readings that set the
judgement's limits (``control.py --trials --faults``) and for the tests
that see ``correct`` come out false.

``planted(name, run)`` wraps ``run``, a function with the signature of
``optimize_fused(problem, solver, iterations, **options)``:

* ``lambda0_x10``: the first damping ten times g2o's (``tau = 1e-4``);
* ``cg_tol_x2``: the implicit solver's CG stops at twice its tolerance;
* ``lm_one_short``: the job returns after one LM iteration fewer;
* ``answer_altered``: the returned answer has a point moved by 0.05;
* ``chi2_stale``: the returned chi2 is the last iteration's starting one.
"""

POINT_TYPE = "VERTEX_TRACKXYZ"
NAMES = ("lambda0_x10", "cg_tol_x2", "lm_one_short", "answer_altered",
         "chi2_stale")


def planted(name, run):
    """``run`` with fault ``name`` planted under it."""
    if name not in NAMES:
        raise ValueError(f"no fault {name!r}")

    def broken(problem, solver, iterations, **options):
        if name == "lambda0_x10":
            return run(problem, solver, iterations, tau=1e-4, **options)
        if name == "lm_one_short":
            return run(problem, solver, iterations - 1, **options)
        if name == "cg_tol_x2":
            tol = solver.tol
            solver.tol = 2.0 * tol
            try:
                return run(problem, solver, iterations, **options)
            finally:
                solver.tol = tol
        res = run(problem, solver, iterations, **options)
        if name == "chi2_stale":
            res = dict(res, chi2_final=res["chi2_per_iteration"][-1])
        else:
            est = dict(problem.estimates)
            pts = est[POINT_TYPE].clone()
            pts[0] += 0.05
            est[POINT_TYPE] = pts
            problem.set_estimates(est)
        return res

    return broken
