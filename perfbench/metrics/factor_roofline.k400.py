"""``factor_roofline.k400``: the finalize's factor F's share of its
roofline over one profiled steady EM iteration.

Numerator: the documents F ran on, the ``plan.factor.*`` counts of the
iteration's ``fit.iteration`` trace record (found and lined up with the
trace by ``host_syncs.fit.py``), times one document's least time at P =
K-1 (``perfbench/roofline_factor.py``).  The count is held against the
rows of the ``_finalize_chunk`` calls recorded from the benchmark's side:
where the two differ the share is not read.  Denominator: the device time
of F's kernel (``cholesky_pd_inverse_kernel``) in the trace.  No kernel
runs faster than its least time, so the share is at most 100%.  None for
a program that keeps no such counts."""

from pathlib import Path

from perfbench import roofline_factor, spec

KERNEL = "cholesky_pd_inverse_kernel"
_record = spec._load_module(Path(__file__).with_name("host_syncs.fit.py"),
                            "perfbench_metric_host_syncs_fit").profiled_record


def read(ctx):
    found = _record(ctx)
    if found is None:
        return None
    c = found[0].counters
    docs = sum(v for k, v in c.items() if k.startswith("plan.factor.") and v)
    shapes = [args[1][0] for name, args, _kw in ctx.get("calls", []) if name == "_finalize_chunk"]
    if not docs or docs != sum(B for B, _K, _L in shapes) or len({K for _B, K, _L in shapes}) != 1:
        return None
    P = shapes[0][1] - 1
    device = sum(e["dur"] for e in ctx["trace"].device if KERNEL in e["name"]) / 1e6
    if device <= 0:
        return None
    return 100.0 * docs * roofline_factor.least_s(1, P) / device
