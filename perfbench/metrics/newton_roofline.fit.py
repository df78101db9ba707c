"""``newton_roofline.fit``: the Newton stage kernels' share of their
roofline over one profiled steady EM iteration.

Numerator: the least time of every chunk-step's f/g/H, CG and Armijo
sweep (B1-B3), each from its own call's shape (``perfbench/roofline.py``;
the calls recorded from the benchmark's side while the profiler ran).
Denominator: the device time of the B1-B3 kernel groups in the trace.
No kernel runs faster than its least time, so the share is at most 100%.
"""

from perfbench import roofline, trace


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "fit" or tr is None:
        return None
    least, _ops = roofline.total(ctx["calls"], ("fgh", "cg", "linesearch"))
    device = sum(s for g, (s, _n) in tr.by_group().items() if g in trace.NEWTON_GROUPS)
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device
