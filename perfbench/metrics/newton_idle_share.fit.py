"""``newton_idle_share.fit``: the device's idle share inside the E-step's Newton passes
over one profiled steady EM iteration, in percent: 1 - (the device's busy
time, the union of kernel and copy intervals, inside the union of the
``estep.newton`` spans / that union's length).  The spans are the host
intervals of the iteration's ``fit.iteration`` trace record
(``strutopy_tpu_torch/utils/trace.py``), put on the trace's clock by
``host_syncs.fit.py``.  None for a program that keeps no such record."""

from pathlib import Path

from perfbench import spec, trace

SPAN = "estep.newton"
_record = spec._load_module(Path(__file__).with_name("host_syncs.fit.py"),
                            "perfbench_metric_host_syncs_fit").profiled_record


def read(ctx):
    found = _record(ctx)
    if found is None:
        return None
    rec, offset = found
    tr = ctx["trace"]
    length, spans = trace.union((s.t0 / 1e3 + offset, s.t1 / 1e3 + offset)
                                for s in rec.spans if s.name == SPAN)
    if length <= 0:
        return None
    # busy inside the spans: |spans| + |busy| - |spans and busy together|
    both, _merged = trace.union([tuple(m) for m in spans + tr.merged])
    return 100.0 * (1.0 - (length + tr.busy_s * 1e6 - both) / length)
