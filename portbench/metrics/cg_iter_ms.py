"""Host wall ms per CG iteration of the implicit Schur solver: the port's
``cg.iter`` span (an iteration and the stop test after it), timed by the
port while a profiler records (``g2o_tpu_torch.utils.tictoc.stats()``:
the traced window's alone).  Nothing where the port has no such span, or
where its count is not the window's CG iterations (``G2O_ENABLE_TICTOC``
set, or another run in the process)."""


def read(ctx):
    from g2o_tpu_torch.utils import tictoc

    st = tictoc.stats().get("cg.iter")
    if not st or st["count"] != sum(sum(r["cg_per_iteration"])
                                    for r in ctx.jobs):
        return None
    return 1e3 * st["total"] / st["count"]
