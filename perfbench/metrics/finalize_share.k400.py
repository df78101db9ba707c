"""``finalize_share.k400``: the E-step finalize's share of one profiled
steady EM iteration, in percent: the union of the ``estep.finalize``
spans over the ``fit.iteration`` span, both on the device's clock (the
CUDA events each span records at its ends) of the iteration's trace
record, found and lined up with the trace by ``host_syncs.fit.py``.
None for a program that keeps no such record."""

from pathlib import Path

from perfbench import spec, trace

_record = spec._load_module(Path(__file__).with_name("host_syncs.fit.py"),
                            "perfbench_metric_host_syncs_fit").profiled_record


def _device(rec, name):
    return [s.device for s in rec.spans if s.name == name and s.device is not None]


def read(ctx):
    found = _record(ctx)
    if found is None:
        return None
    rec = found[0]
    it, fin = _device(rec, "fit.iteration"), _device(rec, "estep.finalize")
    if len(it) != 1 or not fin or it[0][1] <= it[0][0]:
        return None
    length, _merged = trace.union(fin)
    return 100.0 * length / (it[0][1] - it[0][0])
