"""``kappa_share.content``: the kappa regression's share of an EM
iteration, in percent: the summed host length of the ``mstep.kappa``
spans over that of the ``fit.iteration`` span, in one iteration recorded
by the program with ``trace.recording()`` and no profiler
(``strutopy_tpu_torch/utils/trace.py``).  None for a program that keeps
no such span."""


def read(ctx):
    rec = ctx.get("record")
    if rec is None:
        return None
    wall = sum(s.t1 - s.t0 for s in rec.spans if s.name == "fit.iteration")
    kappa = [s.t1 - s.t0 for s in rec.spans if s.name == "mstep.kappa"]
    if wall <= 0 or not kappa:
        return None
    return 100.0 * sum(kappa) / wall
