"""Device ms per solve of the explicit Schur solver: the kernels launched
inside the benchmark's span around each solve."""


def read(ctx):
    if ctx.config.get("solve_layer") != "explicit":
        return None
    return ctx.span_device_ms("lm.solve")
