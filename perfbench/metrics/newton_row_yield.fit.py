"""``newton_row_yield.fit``: the share of the Newton stage kernels'
row-steps spent on documents that moved, over one profiled steady EM
iteration: 100 x ``newton.doc_steps`` (the documents' advances, the sum of
the loops' own iteration counts) / ``newton.row_steps`` (chunk steps x
rows) of its ``fit.iteration`` trace record
(``strutopy_tpu_torch/utils/trace.py``), found and lined up with the trace
by ``host_syncs.fit.py``.  Done rows and padding are the waste.  None for
a program that keeps no such record."""

from pathlib import Path

from perfbench import spec

_record = spec._load_module(Path(__file__).with_name("host_syncs.fit.py"),
                            "perfbench_metric_host_syncs_fit").profiled_record


def read(ctx):
    found = _record(ctx)
    if found is None:
        return None
    c = found[0].counters
    rows, moved = c.get("newton.row_steps"), c.get("newton.doc_steps")
    if not rows or moved is None:
        return None
    return 100.0 * moved / rows
