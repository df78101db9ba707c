"""``newton_roofline.k400``: the Newton stage kernels' share of their
roofline over one profiled steady EM iteration of ``k400_fit``, computed
as ``newton_roofline.fit.py`` computes it (``perfbench/roofline.py``).
It also prints the iteration's ``plan.*`` counts (the documents each
kernel launched on each of its plans) and B2's share on ``plan.cg.h_l2``
to standard error, where the program keeps them."""

import sys
from pathlib import Path

from perfbench import spec

_fit = spec._load_module(Path(__file__).with_name("newton_roofline.fit.py"),
                         "perfbench_metric_newton_roofline_fit").read
_record = spec._load_module(Path(__file__).with_name("host_syncs.fit.py"),
                            "perfbench_metric_host_syncs_fit").profiled_record


def plans(ctx):
    """The profiled record's ``plan.*`` counts, or None."""
    found = _record(ctx)
    if found is None:
        return None
    return {k: v for k, v in found[0].counters.items() if k.startswith("plan.")} or None


def read(ctx):
    counts = plans(ctx)
    if counts:
        cg = sum(counts.get(k) or 0 for k in ("plan.cg.h_smem", "plan.cg.h_l2"))
        l2 = f"{100.0 * (counts.get('plan.cg.h_l2') or 0) / cg:.1f}%" if cg else "none"
        print(f"plans of the profiled iteration: {counts}; B2's documents on plan.cg.h_l2: "
              f"{l2}", file=sys.stderr, flush=True)
    return _fit(ctx)
