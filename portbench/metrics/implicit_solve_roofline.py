"""Share (%) of the least time of the window's implicit solves, counted by
``work.implicit_solve`` from the sizes and the CG iterations each solve
took, in the device time launched inside the solve spans."""


def read(ctx):
    t = ctx.trace
    if ctx.config.get("solve_layer") != "implicit" or t is None:
        return None
    dev_s = t.span_device_s.get("lm.solve")
    solves = sum(sum(r["trials_per_iteration"]) for r in ctx.jobs)
    cg = sum(sum(r["cg_per_iteration"]) for r in ctx.jobs)
    if not dev_s or solves != t.span_calls.get("lm.solve"):
        return None
    s = ctx.sizes
    per_solve = ctx.work.implicit_solve(s["C"], s["P"], s["O"], 0)
    per_iter = [a - b for a, b in zip(
        ctx.work.implicit_solve(s["C"], s["P"], s["O"], 1), per_solve)]
    least = ctx.work.least_seconds(solves * per_solve[0] + cg * per_iter[0],
                                   solves * per_solve[1] + cg * per_iter[1],
                                   ctx.device_name)
    return None if least is None else 100.0 * least / dev_s
