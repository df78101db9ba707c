"""``estep_ms``: host wall of one E-step, ``models/em.py::local_estep_stats``
called alone from the window's final state, each call ending when the
summed bound is read to the host: all calls over all their time."""


def read(ctx):
    t = ctx.get("timings", {}).get("estep")
    return 1e3 * sum(t) / len(t) if t else None
