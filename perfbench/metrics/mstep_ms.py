"""``mstep_ms``: host wall of the M-step's beta update,
``models/em.py::m_step_beta`` (the LDA row normalization), called alone
on the E-step's statistics, each call ending in a device synchronize:
all calls over all their time."""


def read(ctx):
    t = ctx.get("timings", {}).get("mstep")
    return 1e3 * sum(t) / len(t) if t else None
