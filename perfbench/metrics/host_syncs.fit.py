"""``host_syncs.fit``: the blocking device-to-host reads of one profiled
steady EM iteration, summed over the program's sites: the ``syncs`` of
its ``fit.iteration`` trace record (``strutopy_tpu_torch/utils/trace.py``).

:func:`profiled_record`, which the other readers of that record load from
here, finds the record made under the profiler and lines it up with the
trace: the record's CUDA event records (``marks``: host ns just before and
just after each) are paired in order with the trace's runtime calls that
record them, equal in count, and one offset must put every call inside its
mark within ``TOL_US``.  With torch 2.11 and CUDA 12.8 on the H100 the
profiler keeps those calls as ``cudaEventRecordWithFlags`` and none of
them as ``cudaEventRecord``, the name a library's own events (cuSOLVER's)
take there.  None for a program that keeps no such record, or a record
that does not line up."""

ANCHORS = ("cudaEventRecordWithFlags", "cudaEventRecord")
TOL_US = 50.0


def align(marks, host_events):
    """The offset in us from the record's host clock (``marks``) to the
    trace's (``host_events``, ``ts`` in us), or None: for the first name
    of ``ANCHORS`` whose calls are as many as the marks, the middle of the
    offsets that put every call inside its mark, if they leave at most
    ``2 * TOL_US`` between them."""
    for name in ANCHORS:
        ts = sorted(e["ts"] for e in host_events if e.get("name") == name)
        if not ts or len(ts) != len(marks):
            continue
        lo = max(t - after / 1e3 for t, (_before, after) in zip(ts, marks))
        hi = min(t - before / 1e3 for t, (before, _after) in zip(ts, marks))
        if lo - hi <= 2 * TOL_US:
            return (lo + hi) / 2
    return None


def profiled_record(ctx):
    """(the last ``fit.iteration`` record made under the profiler, its
    offset to the trace's clock in us), or None."""
    if ctx.get("kind") != "fit" or ctx.get("trace") is None:
        return None
    try:
        from strutopy_tpu_torch.utils import trace as program_trace
    except ImportError:
        return None
    found = [r for r in program_trace.records() if r.name == "fit.iteration" and r.profiled]
    if not found:
        return None
    offset = align(found[-1].marks, ctx["trace"].host)
    return None if offset is None else (found[-1], offset)


def read(ctx):
    found = profiled_record(ctx)
    if found is None:
        return None
    return float(sum(n for n, _s in found[0].syncs.values()))
