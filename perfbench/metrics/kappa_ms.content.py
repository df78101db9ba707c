"""``kappa_ms.content``: host wall of the content model's beta update,
``models/em.py::m_step_beta`` (the kappa regression and the softmax),
called alone on the statistics of an E-step from the window's end state
and warm-started from its kappa, each call ending in a device
synchronize: all calls over all their time."""


def read(ctx):
    t = ctx.get("timings", {}).get("kappa")
    return 1e3 * sum(t) / len(t) if t else None
