"""Device-to-host reads of the LM loop per λ-trial: calls of the port's
``read.*`` spans over calls of its ``lm.trial`` span, counted by the port
while a profiler records (``g2o_tpu_torch.utils.tictoc.stats()``: the
traced window's alone).  Nothing where the port has no such spans, or
where the count of trials is not the window's (``G2O_ENABLE_TICTOC`` set,
or another run in the process)."""


def read(ctx):
    from g2o_tpu_torch.utils import tictoc

    st = tictoc.stats()
    trials = st.get("lm.trial", {}).get("count")
    if not trials or trials != sum(sum(r["trials_per_iteration"])
                                   for r in ctx.jobs):
        return None
    return sum(v["count"] for k, v in st.items()
               if k.startswith("read.")) / trials
