"""Share (%) of the least time of the window's S v Schur terms in the
device time of the tiled Schur rows kernel that computes them: the trace's
device operations whose name holds ``schur_rows_tiled_kernel``, one call a
CG iteration.  The least time counts the work the algorithm needs
(``portbench/work_schur_rows.py``).  Nothing where the trace holds no such
kernel (its shared-memory form, a composition of other kernels, or a
program without it).  It reads the trace summary's ``device_ops``, which
``portbench/trace.py`` cuts to the ``TOP`` (10) kernels of most device
time: a tiled kernel that falls out of those reads as absent, so a large
enough gain in it turns this metric silent, not higher."""

KERNEL = "schur_rows_tiled_kernel"


def read(ctx):
    from portbench import work_schur_rows

    t = ctx.trace
    if t is None:
        return None
    dev_s = sum(s for name, s in t.device_ops if KERNEL in name)
    calls = sum(sum(r["cg_per_iteration"]) for r in ctx.jobs)
    if not dev_s or not calls:
        return None
    s = ctx.sizes
    least = work_schur_rows.schur_rows_seconds(
        s["C"], s["P"], s["O"], calls, ctx.device_name)
    return None if least is None else 100.0 * least / dev_s
