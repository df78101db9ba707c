"""The content cell at toy size on the CPU: a whole run is correct and
comes out not correct under each planted fault (the fit's step returning
its state unchanged, half of the batch left out, one answer altered, the
kappa regression leaving kappa at its input); the control fails a limit
while the program passes; the cell's readers on synthetic records."""

import importlib.util
import json
import types

import numpy as np
import pytest

from perfbench import calibrate_content, compare, roofline_kappa, run, spec, trace
from perfbench.tests.test_bench_faults import _after_warm_up, _altered, _half, _unchanged
from strutopy_tpu_torch.models import em
from strutopy_tpu_torch.ops import mstep

CELL = "poliblog_content_fit"


def _run(capsys, seed=2**31 + 9, trace_on=0):
    assert run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
                     "--trace", str(trace_on), "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_sound_run_is_correct(capsys):
    out = _run(capsys, trace_on=1)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"] == {} and out["device"]["platform"] == "cpu"
    # the rehearsal reads every per-layer metric but the device trace's
    assert set(out["rehearsal"]) == {"kappa_ms.content", "kappa_share.content",
                                     "kappa_word_yield.content"}
    assert {k for k in out["checks"]} >= {"last.kgap_max", "last.beta_rel", "last.gap_max"}


def _kappa_at_input(orig, beta_ss, wcounts, kappa_design, alpha=250.0, iters=40, kappa0=None,
                    *a, **k):
    """The regression runs no Newton step: kappa stays at its input."""
    return orig(beta_ss, wcounts, kappa_design, alpha, 0, kappa0, *a, **k)


@pytest.mark.parametrize("module,where,fault", [
    (em, "em_iteration", _unchanged), (em, "run_estep", _half), (em, "run_estep", _altered),
    (mstep, "update_beta_content", _kappa_at_input)])
def test_a_broken_fit_is_not_correct(capsys, monkeypatch, module, where, fault):
    monkeypatch.setattr(module, where, _after_warm_up(fault)(getattr(module, where)))
    assert _run(capsys)["correct"] is False


def test_control_fails_and_program_passes():
    c = spec.load_cell(CELL)
    rec, = calibrate_content.fit_seed(c, 11, {9}, True, "cpu", True, lambda r: None)

    def fails(numbers):
        return [k for k, v in compare.judge(numbers, c.limits)[1].items()
                if not compare.passes(v)]

    assert not fails(rec["program"])
    assert fails(rec["control"])
    for fault in ("fault.unchanged", "fault.half", "fault.altered", "fault.kappa"):
        assert fails(rec[fault]), fault


def _reader(name):
    s = importlib.util.spec_from_file_location(name, spec.HERE / "metrics" / f"{name}.py")
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


def _span(name, t0_us, t1_us):
    return types.SimpleNamespace(name=name, t0=int(t0_us * 1e3), t1=int(t1_us * 1e3))


class _Rec:
    def __init__(self, spans, counters):
        self.spans, self.counters = spans, counters

    def resolve(self):
        return self


REC = _Rec([_span("fit.iteration", 0, 1000), _span("mstep.kappa", 600, 700),
            _span("mstep.kappa", 800, 900)],
           {"kappa.slot_steps": 4096 * 5, "kappa.word_steps": 1024 * 5,
            "kappa.chunk_steps": 5})


def test_share_and_yield_readers():
    assert _reader("kappa_share.content").read({"record": REC}) == pytest.approx(20.0)
    assert _reader("kappa_word_yield.content").read({"record": REC}) == pytest.approx(25.0)
    assert _reader("kappa_ms.content").read({"timings": {"kappa": [0.01, 0.03]}}) == \
        pytest.approx(20.0)
    # a program that records no kappa span or counter: no reading, no error
    bare = _Rec([_span("fit.iteration", 0, 1000)], {})
    for name in ("kappa_share.content", "kappa_word_yield.content"):
        assert _reader(name).read({"record": bare}) is None
        assert _reader(name).read({}) is None
    assert _reader("kappa_ms.content").read({}) is None


def test_roofline_reader_cannot_pass_100(monkeypatch):
    R, P = 40, 62
    least_us = roofline_kappa.least_s(R, P, REC.counters["kappa.slot_steps"]) * 1e6
    mod = _reader("kappa_roofline.content")
    for busy_scale in (1.0, 1.5, 10.0):
        # one kernel a span, each half the least time times the scale
        dur = least_us / 2 * busy_scale
        events = [{"cat": "kernel", "name": "k", "ts": 600.0, "dur": dur},
                  {"cat": "kernel", "name": "k", "ts": 800.0, "dur": dur},
                  {"cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 1000.0}]
        ctx = {"kind": "fit", "trace": trace.Trace(events, 1e-3), "kappa_shape": (R, P)}
        monkeypatch.setattr(mod, "_record", lambda c: (REC, 0.0))
        share = mod.read(ctx)
        assert share <= 100.0 + 1e-9
        if busy_scale == 1.0:
            assert share == pytest.approx(100.0, rel=1e-6)
    monkeypatch.setattr(mod, "_record", lambda c: None)
    assert mod.read(ctx) is None


def test_slot_step_is_compute_bound_and_scales():
    n_bytes, ops = roofline_kappa.slot_step(40, 62)
    assert roofline_kappa.roofline.least_s(n_bytes, ops)[1] == "operations"
    assert roofline_kappa.least_s(40, 62, 200) == pytest.approx(
        2 * roofline_kappa.least_s(40, 62, 100))


def test_the_window_wraps_to_the_kept_state_bit_for_bit():
    """Past the fit's last iteration the window puts back the state kept
    after set-up: the iteration after the wrap repeats the cycle's first
    bit for bit (a toy fit of 8 iterations, so the wrap comes early)."""
    from perfbench.drivers import fit_content as C

    c = spec.load_cell(CELL)
    fit = C.ContentFit(c, 2**31 + 21, "cpu", True)
    fit.cfg = fit.cfg.replace(max_em_iter=8)
    fit.warm(c.traffic["warm_iters"])
    first = fit.first
    states = []
    for _ in range(8 - first + 2):
        prev = fit.kept if fit.it == fit.cfg.max_em_iter else fit.model._state
        fit.iterate()
        states.append((fit.it - 1, prev, fit.params()))
    its = [s[0] for s in states]
    assert its == list(range(first, 8)) + [first, first + 1]
    n = 8 - first
    assert states[0][1] is fit.kept and states[n][1] is fit.kept
    for a, b in ((states[0], states[n]), (states[1], states[n + 1])):
        for k, v in a[2].items():
            assert np.array_equal(v, b[2][k]), (a[0], k)
