"""Seconds from the process's start to the measured window: imports, the
scene, the problem and solver build, the kernel builds and a warm job."""


def read(ctx):
    return ctx.setup_s
