"""``kappa_roofline.content``: the kappa regression's share of its
roofline over one profiled EM iteration.

Numerator: the least time of the kappa Newton's counted work, one word
slot's least time (``perfbench/roofline_kappa.py``, from the kappa
design's shape) times the iteration's ``kappa.slot_steps``.
Denominator: the device's busy time (the union of kernel and copy
intervals) inside the ``mstep.kappa`` spans of the iteration's
``fit.iteration`` trace record, put on the trace's clock by
``host_syncs.fit.py``.  No step runs faster than its least time, so the
share is at most 100%.  None for a program that keeps no such span."""

from pathlib import Path

from perfbench import roofline_kappa, spec, trace

SPAN = "mstep.kappa"
_record = spec._load_module(Path(__file__).with_name("host_syncs.fit.py"),
                            "perfbench_metric_host_syncs_fit").profiled_record


def read(ctx):
    found = _record(ctx)
    if found is None or "kappa_shape" not in ctx:
        return None
    rec, offset = found
    tr = ctx["trace"]
    length, spans = trace.union((s.t0 / 1e3 + offset, s.t1 / 1e3 + offset)
                                for s in rec.spans if s.name == SPAN)
    slots = rec.resolve().counters.get("kappa.slot_steps")
    if length <= 0 or not slots:
        return None
    # busy inside the spans: |spans| + |busy| - |spans and busy together|
    both, _merged = trace.union([tuple(m) for m in spans + tr.merged])
    busy_s = (length + tr.busy_s * 1e6 - both) / 1e6
    if busy_s <= 0:
        return None
    R, P = ctx["kappa_shape"]
    return 100.0 * roofline_kappa.least_s(R, P, slots) / busy_s
