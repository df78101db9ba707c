"""``em_iter_mfu``: the whole EM iteration's share of the chip's peak.

Numerator: the least compute time of one profiled steady iteration's
counted work at the published peaks (989 TFLOP/s for the bf16 Hessian
products, 67 TFLOP/s for float32): every Newton chunk-step's f/g/H, CG
and sweep, and the finalize's per-document float32 Hessian and (K-1)³/3
Cholesky, each from its recorded call's shape.  The M-step's small
(K, P) algebra is left out.  Denominator: the mean wall of the window's
iterations, timed without the profiler.
"""

from perfbench import roofline


def read(ctx):
    if ctx.get("kind") != "fit" or ctx.get("trace") is None or not ctx.get("iter_walls"):
        return None
    _least, ops = roofline.total(ctx["calls"], ("fgh", "cg", "linesearch", "_finalize_chunk"))
    walls = ctx["iter_walls"]
    return 100.0 * roofline.compute_s(ops) / (sum(walls) / len(walls))
