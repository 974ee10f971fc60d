"""Share (%) of the least time of the window's explicit solves, counted by
``work.explicit_solve`` from the sizes, in the device time launched inside
the solve spans."""


def read(ctx):
    t = ctx.trace
    if ctx.config.get("solve_layer") != "explicit" or t is None:
        return None
    dev_s = t.span_device_s.get("lm.solve")
    solves = t.span_calls.get("lm.solve")
    if not dev_s or not solves:
        return None
    s = ctx.sizes
    nbytes, ops = ctx.work.explicit_solve(s["C"], s["P"], s["O"],
                                          s["unordered_pairs"])
    least = ctx.work.least_seconds(solves * nbytes, solves * ops,
                                   ctx.device_name)
    return None if least is None else 100.0 * least / dev_s
