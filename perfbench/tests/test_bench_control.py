"""The control of every cell, at a size a test run holds: the reference
computed in TF32 and put in the program's place fails at least one of
the cell's limits, while the program passes all of them.  (The same
readings at the cells' own sizes come from ``perfbench/calibrate.py``
on the card; ``PERF.md`` gives them beside each limit.)"""

import pytest

from perfbench import calibrate, compare, spec


def _fails(numbers: dict, limits: dict) -> list:
    return [k for k, c in compare.judge(numbers, limits)[1].items() if not compare.passes(c)]


@pytest.mark.parametrize("cell", ["k100_fit"])
def test_control_fails_and_program_passes(cell):
    c = spec.load_cell(cell)
    rec = calibrate.fit_seed(c, 11, 0.3, True, "cpu", True)
    assert not _fails(rec["program"], c.limits)
    assert _fails(rec["control"], c.limits)
    for fault in ("fault.unchanged", "fault.half", "fault.altered"):
        assert _fails(rec[fault], c.limits), fault
