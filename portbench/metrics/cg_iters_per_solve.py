"""CG iterations per solve, from ``optimize_fused``'s ``cg_per_iteration``
over its trials; only where the configuration's solve is iterative."""


def read(ctx):
    if ctx.config.get("solve_layer") != "implicit":
        return None
    cg = sum(sum(r["cg_per_iteration"]) for r in ctx.jobs)
    trials = sum(sum(r["trials_per_iteration"]) for r in ctx.jobs)
    return cg / trials if trials else None
