"""LM trials (solve + linearize) per iteration, from ``optimize_fused``'s
``trials_per_iteration`` over the window's jobs."""


def read(ctx):
    trials = sum(sum(r["trials_per_iteration"]) for r in ctx.jobs)
    iters = sum(r["iterations"] for r in ctx.jobs)
    return trials / iters if iters else None
