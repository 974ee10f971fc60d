"""Wall seconds per job: the whole window over the jobs it completed, each
ending at its synchronize (time to a solution)."""


def read(ctx):
    return ctx.window_s / len(ctx.jobs)
