"""Device ms per ``linearize_fn`` call: the kernels launched inside the
benchmark's span around it."""


def read(ctx):
    return ctx.span_device_ms("lm.linearize")
