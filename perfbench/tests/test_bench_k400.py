"""``k400_fit`` rehearsed (``run.py --device cpu`` at the configuration's
toy sizes on the program's plain kernels): a sound run holds the
per-document checks and beta, and a run with the timed path broken in
each way ``test_bench_faults.py`` breaks it fails one of them; the cell's
readers read nothing without a trace.  The M-step's sums and the summed
bound are read, not held, at the toy's 48 documents
(``tests/test_torch_k400.py`` says why)."""

import math

import pytest

from perfbench import spec
from perfbench.tests.test_bench_faults import _after_warm_up, _altered, _half, _run, _unchanged
from strutopy_tpu_torch.models import em

CELL = "k400_fit"
HELD = ("init.beta_rel", "init.state_max", "last.gap_max", "last.gap_mean", "last.gap_p50",
        "last.gap_p90", "last.beta_rel")


def _held_failed(out):
    return [k for k in HELD if not (math.isfinite(out["checks"][k]["value"])
                                    and out["checks"][k]["value"] <= out["checks"][k]["limit"])]


def test_a_sound_run_holds_the_per_document_checks(capsys):
    out = _run(capsys, CELL, seed=3000000001)
    assert not _held_failed(out), out["checks"]
    assert out["metrics"] == {} and out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("where,fault", [("em_iteration", _unchanged), ("run_estep", _half),
                                         ("run_estep", _altered)])
def test_a_broken_fit_fails_a_per_document_check(capsys, monkeypatch, where, fault):
    monkeypatch.setattr(em, where, _after_warm_up(fault)(getattr(em, where)))
    out = _run(capsys, CELL, seed=3000000001)
    assert out["correct"] is False and _held_failed(out)


def test_the_readers_read_nothing_without_a_trace():
    for name, read in spec.load_cell(CELL).readers().items():
        assert read({"kind": "fit", "trace": None, "calls": []}) is None, name
