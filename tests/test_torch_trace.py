"""The port's spans and counters (``strutopy_tpu_torch/utils/trace.py``) at
toy size on the CPU, and the benchmark's readers of them
(``perfbench/metrics/host_syncs.fit.py``, ``newton_row_yield.fit.py``,
``newton_idle_share.fit.py``, ``finalize_idle_share.fit.py``) on a
synthetic profiler trace and record."""

import logging

import numpy as np
import pytest
import torch

from perfbench import spec
from perfbench import trace as bench_trace
from strutopy_tpu_torch import STM, STMConfig
from strutopy_tpu_torch.models.serving import infer_theta
from strutopy_tpu_torch.ops import estep, stages
from strutopy_tpu_torch.utils import trace
from torch_world import one_thread

K, V, N, B = 4, 50, 48, 8
SCHEDULES = {
    "single": dict(newton_pass1_iters=0),
    "two-pass": dict(newton_pass1_iters=2, newton_straggler_frac=0.25),
    "fused": dict(newton_pass1_iters=2, newton_straggler_frac=0.25, two_pass_fused=True),
}
STATE = ("beta", "eta", "theta", "sigma", "mu", "gamma")


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file
    (tests/torch_world.py::one_thread)."""
    with one_thread():
        yield


def _docs(seed=0):
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.full(V, 0.2), size=K)
    docs = []
    for _ in range(N):
        draw = rng.multinomial(int(rng.integers(30, 80)), rng.dirichlet(np.full(K, 0.5)) @ beta)
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    return docs, rng.integers(0, 2, N).astype(np.float64)


def _model(schedule: str, max_em_iter: int = 2) -> STM:
    """A toy fit in one length bucket (six chunks of B) whose every
    iteration runs ``schedule``."""
    docs, X = _docs()
    cfg = STMConfig(K=K, init_type="random", max_em_iter=max_em_iter, batch_size=B,
                    convergence_threshold=0.0, newton_warmup_iters=0, auto_bucket=False,
                    **SCHEDULES[schedule])
    beta0 = np.random.RandomState(1).gamma(0.1, 1.0, (K, V)) + 1e-3
    return STM(docs, K=K, X=X, config=cfg, init_beta=beta0, device="cpu")


@pytest.fixture(scope="module")
def recorded():
    """schedule -> a toy fit of two iterations made under ``recording()``."""
    out = {}
    for schedule in SCHEDULES:
        m = _model(schedule)
        with trace.recording():
            m.expectation_maximization()
        out[schedule] = m
    return out


def _chunk(seed=0, Bc=B, L=12):
    """A Newton chunk: beta_doc with positive columns, counts, mu = eta0 = 0
    and a diagonal siginv."""
    g = torch.Generator().manual_seed(seed)
    bd = torch.rand(Bc, K, L, generator=g) + 0.05
    bd = bd / bd.sum(dim=2, keepdim=True)
    counts = torch.randint(1, 6, (Bc, L), generator=g).float()
    counts[:, -2:] = 0.0
    zeros = torch.zeros(Bc, K - 1)
    return bd, counts, zeros, zeros.clone(), 0.05 * torch.eye(K - 1)


def _by_pass(rec, name):
    out = {}
    for s in rec.spans:
        if s.name == name:
            out[s.attrs.get("pass")] = out.get(s.attrs.get("pass"), 0) + 1
    return out


# ---------------------------------------------------------------------------
# spans and counters of a fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_span_tree_of_one_iteration(recorded, schedule):
    """One record an iteration: fit.iteration over em.estep, em.mstep and
    fit.readback; the E-step's spans under em.estep, one a chunk a pass,
    and the finalize's factor and scatter under each estep.finalize."""
    m = recorded[schedule]
    assert [r.attrs for r in m.trace] == [{"it": 0, "schedule": schedule},
                                          {"it": 1, "schedule": schedule}]
    rec = m.trace[-1]
    names = [s.name for s in rec.spans]
    assert rec.name == names[0] == "fit.iteration" and rec.spans[0].parent is None
    assert [s.name for s in rec.spans if s.parent == 0] == ["em.estep", "em.mstep", "fit.readback"]
    estep_i = names.index("em.estep")
    for s in rec.spans:
        assert s.t0 <= s.t1 and s.device is None  # no CUDA event on the CPU
        if s.name.startswith("estep."):
            assert s.parent == estep_i
        if s.name.startswith("finalize."):
            assert rec.spans[s.parent].name == "estep.finalize"
    n_fin = names.count("estep.finalize")
    assert names.count("finalize.factor") == names.count("finalize.scatter") == n_fin
    overflow = rec.counters.get("estep.overflow", 0)
    want = {"single": {"estep.gather": {"single": 6}, "estep.newton": {"single": 6},
                       "estep.finalize": {"single": 6}},
            "two-pass": {"estep.gather": {"1": 6, "2": 2, "3": 6},
                         "estep.newton": {"1": 6, "2": 2}, "estep.finalize": {"3": 6}},
            "fused": {"estep.gather": {"1": 6, "2": 2}, "estep.newton": {"1": 6, "2": 2},
                      "estep.finalize": {"1": 6, "2": 2}}}[schedule]
    if schedule == "fused" and overflow:
        want["estep.gather"]["overflow"] = want["estep.finalize"]["overflow"] = 6
    for name, by_pass in want.items():
        assert _by_pass(rec, name) == by_pass, name
    assert names.count("estep.budget") == (schedule != "single")
    assert rec.syncs["fit.bound"][0] == rec.syncs["fit.synchronize"][0] == 1
    assert ("fit.overflow" in rec.syncs) == (schedule != "single")
    assert ("estep.overflow" in rec.syncs) == (schedule == "fused")
    assert rec.syncs["finalize.rung"][0] == rec.syncs["finalize.cholesky_inverse"][0] == n_fin
    assert sum(rec.counters["finalize.rungs"]) == N  # each real document once


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_doc_steps_are_the_returned_newton_iters(recorded, schedule):
    """newton.doc_steps is the sum of the iteration's own Newton counts;
    row_steps is chunk steps x rows; each real document not done at the
    end of its last pass is capped, and pass 2 admits at most its budget."""
    m = recorded[schedule]
    c = m.trace[-1].counters
    assert c["newton.doc_steps"] == int(m._state.opt_iters.sum())
    assert c["newton.row_steps"] == B * c["newton.chunk_steps"] > 0
    # the stage path's glue kernels are counted; on CPU tensors they run plain
    assert c["launch.direction"] == c["launch.accept"] == 0
    assert 0 <= c["newton.capped"] <= N and c["newton.stalled"] >= 0
    if schedule != "single":
        assert c["estep.stragglers"] <= 2 * B
        assert c["estep.overflow"] == m.straggler_overflow
    assert 0 <= c["finalize.unconverged"] <= N


@pytest.mark.parametrize("max_iters,fixed", [(24, False), (3, False), (3, True)])
def test_newton_done_syncs_equal_the_loop_checks(max_iters, fixed):
    """One bool(torch.all(done)) a check: a loop that stops early checks
    once more than it steps, one that runs to its cap once a step, one with
    fixed_iters never; doc_steps is the sum of the returned n_iters."""
    bd, counts, mu, eta0, siginv = _chunk()
    cfg = estep.NewtonConfig(max_iters=max_iters, fixed_iters=fixed)
    with trace.recording(), trace.span("test") as rec:
        _eta, n_iters, _done = estep._batched_newton(bd, counts, mu, eta0, siginv, cfg)
    rec.resolve()
    steps = rec.counters["newton.chunk_steps"]
    assert steps == max_iters if fixed else int(n_iters.max()) <= steps <= max_iters
    checks = 0 if fixed else min(steps + 1, max_iters)
    assert rec.syncs.get("newton.done", (0, 0.0))[0] == checks
    assert rec.counters["newton.doc_steps"] == int(n_iters.sum())
    assert rec.counters["newton.row_steps"] == steps * B


@pytest.mark.parametrize("plant", [False, True])
def test_finalize_rungs_and_a_planted_non_pd_hessian(monkeypatch, plant):
    """finalize.rungs counts the weighted documents by rung and sums to
    them; a Hessian made negative definite lands in rung >= 2 and its chunk
    in repair_chunks; unconverged counts max|g| > grad_tol, weighted."""
    bd, counts, mu, eta, _ = _chunk(seed=3)
    siginv = torch.eye(K - 1)  # every document's Hessian positive definite
    doc_w = torch.ones(B)
    doc_w[-1] = 0.0
    real = stages.f_g_H_batched

    def planted(*args, **kw):
        f, g, H, theta, phi = real(*args, **kw)
        H = H.clone()
        H[2] = -H[2]
        return f, g, H, theta, phi

    if plant:
        monkeypatch.setattr(stages, "f_g_H_batched", planted)
    with trace.recording(), trace.span("test") as rec:
        estep._finalize_chunk(eta, bd, counts, mu, doc_w, siginv, torch.tensor(0.0),
                              counts.sum(dim=1), grad_tol=1e-5)
    rec.resolve()
    rungs = rec.counters["finalize.rungs"]
    assert len(rungs) == 4 and sum(rungs) == B - 1
    assert rec.counters["finalize.repair_chunks"] == int(plant)
    assert rungs[0] == B - 1 - int(plant)
    if plant:
        _f, _g, H, *_ = planted(eta, bd, counts, mu, siginv, counts.sum(dim=1), bf16=False)
        assert int(stages.chol_pd_inverse(H, inverse=False)[2][2]) >= 2
    _f, g, *_ = real(eta, bd, counts, mu, siginv, counts.sum(dim=1), bf16=False)
    want = int(((g.abs().amax(dim=1) > 1e-5) & (doc_w > 0)).sum())
    assert rec.counters["finalize.unconverged"] == want > 0


@pytest.mark.parametrize("pallas_iter", [False, True])
def test_a_chunk_built_to_stall_counts_in_stalled(monkeypatch, pallas_iter):
    """A sweep that passes no step size stops every unconverged document at
    its first step: the stage path counts each in newton.stalled; the fused
    iteration (a kernel on the card) records None."""
    bd, counts, mu, eta0, siginv = _chunk(seed=5)

    def no_step(eta, p, ts, *args):
        return torch.full((eta.shape[0], ts.shape[0]), float("inf"))

    monkeypatch.setattr(stages, "linesearch", no_step)
    monkeypatch.setattr(stages, "linesearch_plain", no_step)
    cfg = estep.NewtonConfig(pallas_iter=pallas_iter)
    with trace.recording(), trace.span("test") as rec:
        eta, n_iters, done = estep._batched_newton(bd, counts, mu, eta0, siginv, cfg)
    rec.resolve()
    assert bool(done.all()) and torch.equal(eta, eta0)
    _f, g, *_ = stages.f_g_H_batched(eta0, bd, counts, mu, siginv, counts.sum(dim=1), False)
    moving = int((g.abs().amax(dim=1) > cfg.grad_tol).sum())
    assert moving > 0 and rec.counters["newton.chunk_steps"] == 1
    assert rec.counters["newton.stalled"] == (None if pallas_iter else moving)
    assert rec.counters["newton.doc_steps"] == int(n_iters.sum()) == moving


def test_a_fit_warns_once_of_stalls(monkeypatch, caplog):
    """While recording the fit logs a trace line an iteration and warns
    once when documents stall."""
    monkeypatch.setattr(stages, "linesearch_plain",
                        lambda eta, p, ts, *a: torch.full((eta.shape[0], ts.shape[0]), 1e30))
    m = _model("single", max_em_iter=3)
    with caplog.at_level(logging.INFO, logger="strutopy_tpu_torch.models.stm"), \
            trace.recording():
        m.expectation_maximization()
    lines = [r.getMessage() for r in caplog.records]
    assert sum("trace:" in s and "host syncs" in s for s in lines) == 3
    assert sum("no Armijo step passed" in s for s in lines) == 1
    assert all(r.counters["newton.stalled"] > 0 for r in m.trace)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_recording_changes_no_bit_and_off_leaves_no_record(monkeypatch, schedule):
    """A fit recorded and one not give the same state bit for bit, the
    same bounds, the same launch deltas and the same host reads; off, the
    fit keeps no record and leaves the last session's records as they
    were."""
    calls = []
    real_read = trace.read

    def counted(site, fn, *args):
        calls.append(site)
        return real_read(site, fn, *args)

    monkeypatch.setattr(trace, "read", counted)
    with trace.recording(), trace.span("earlier session"):
        pass
    runs = {}
    for mode in ("off", "on"):
        calls.clear()
        m = _model(schedule)
        launched = dict(stages.LAUNCHES)
        if mode == "on":
            with trace.recording():
                m.expectation_maximization()
        else:
            m.expectation_maximization()
            assert [r.name for r in trace.records()] == ["earlier session"]
        runs[mode] = (m, {k: stages.LAUNCHES[k] - launched[k] for k in launched}, list(calls))
    (off, launch_off, reads_off), (on, launch_on, reads_on) = runs["off"], runs["on"]
    for name in STATE:
        np.testing.assert_array_equal(getattr(off, name), getattr(on, name), err_msg=name)
    assert off.last_bounds == on.last_bounds
    assert launch_off == launch_on and reads_off == reads_on
    assert sum(r.n_syncs for r in on.trace) == len(reads_on)
    assert off.trace == [] and len(on.trace) == 2
    assert [r.name for r in trace.records()] == ["fit.iteration"] * 2


FULL_ONLY = ("newton.stalled", "newton.capped", "estep.stragglers", "estep.overflow",
             "finalize.rungs", "finalize.unconverged")


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_a_profiler_alone_records_what_the_readers_read(schedule):
    """Under a profiler alone a fit records its spans, syncs, launch
    deltas and Newton step counts, and none of the device-side counts
    that only recording() asks for; it reads no count inside the
    iteration (records() does); state and launches are the unrecorded
    fit's bit for bit."""
    off = _model(schedule)
    launched = dict(stages.LAUNCHES)
    off.expectation_maximization()
    launch_off = {k: stages.LAUNCHES[k] - launched[k] for k in launched}
    m = _model(schedule)
    launched = dict(stages.LAUNCHES)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        m.expectation_maximization()
    assert {k: stages.LAUNCHES[k] - launched[k] for k in launched} == launch_off
    for name in STATE:
        np.testing.assert_array_equal(getattr(off, name), getattr(m, name), err_msg=name)
    assert len(m.trace) == 2
    for rec in m.trace:
        assert rec.profiled and not rec.full
        assert "newton.doc_steps" in rec._pending  # held on the device, unread
        assert not any(k in rec.counters for k in FULL_ONLY)
    rec = trace.records()[-1]
    assert rec is m.trace[-1] and not rec._pending
    assert rec.counters["newton.doc_steps"] == int(m._state.opt_iters.sum())
    assert rec.counters["newton.row_steps"] == B * rec.counters["newton.chunk_steps"] > 0
    assert rec.syncs["fit.bound"][0] == 1 and "newton.done" in rec.syncs
    assert {s.name for s in rec.spans} >= {"fit.iteration", "em.estep", "estep.newton",
                                            "estep.finalize", "finalize.factor"}


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_cuda_events_only_on_the_spans_whose_device_time_is_read(monkeypatch, how):
    """The spans that ask for CUDA events: the iteration, the Newton
    passes and the finalize; inside recording() the finalize's factor as
    well (its device interval, PERF.md's question on cholesky_inverse)."""
    asked = set()
    real = trace.Span.__init__

    def init(self, name, device=None, attrs=None):
        if device is not None:
            asked.add(name)
        real(self, name, device, attrs)

    monkeypatch.setattr(trace.Span, "__init__", init)
    m = _model("fused")
    if how == "profiler":
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            m.expectation_maximization()
    else:
        with trace.recording():
            m.expectation_maximization()
    want = {"fit.iteration", "estep.newton", "estep.finalize"}
    assert asked == (want if how == "profiler" else want | {"finalize.factor"})


def test_serving_spans():
    """infer_theta under recording: one serve.request record over
    serve.prepare and the E-step's spans, the answer read back once."""
    m = _model("two-pass")
    m.expectation_maximization()
    docs, _X = _docs(seed=7)
    with trace.recording():
        theta, _eta = infer_theta(m.beta, m.sigma, np.zeros((N, K - 1), np.float32), docs,
                                  m.config, device="cpu")
    (rec,) = trace.records()
    assert rec.name == "serve.request" and rec.attrs == {"docs": N}
    assert [s.name for s in rec.spans if s.parent == 0] == ["serve.prepare", "em.estep"]
    assert rec.syncs["serve.readback"][0] == 1 and theta.shape == (N, K)
    assert _by_pass(rec, "estep.newton") == {"1": 6, "2": 6}  # full convergence: budget 1


def test_records_are_the_last_session_s():
    """A recording() context is one session; under it every fit's records
    are kept; the next session replaces them; a record opened outside any
    session is a session of its own."""
    a, b = _model("single"), _model("two-pass")
    with trace.recording():
        a.expectation_maximization()
        b.expectation_maximization()
        assert len(trace.records()) == 4
    assert [r.attrs["schedule"] for r in trace.records()] == ["single"] * 2 + ["two-pass"] * 2
    with trace.recording():
        with trace.span("one"):
            pass
        with trace.span("two"):
            pass
    assert [r.name for r in trace.records()] == ["one", "two"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace.on()
        with trace.span("alone"):
            trace.count("x", 2)
            trace.count("x", torch.tensor(3))
    (rec,) = trace.records()
    assert rec.name == "alone" and rec.profiled and rec.counters["x"] == 5
    with trace.span("off"):
        assert trace.active() is None
    assert [r.name for r in trace.records()] == ["alone"]


# ---------------------------------------------------------------------------
# the benchmark's readers, on a synthetic trace and record
# ---------------------------------------------------------------------------

OFFSET_US = 5e6
READERS = ("host_syncs.fit", "newton_row_yield.fit", "newton_idle_share.fit",
           "finalize_idle_share.fit")
# by hand: newton spans [1000, 1100] and [1300, 1400] us, finalize [1500, 1600];
# kernels [1000, 1050], [1350, 1450], [1500, 1510]: newton busy 50 + 50 of 200,
# finalize 10 of 100; syncs 7 + 3; doc_steps 30 of 120 row-steps
BY_HAND = {"host_syncs.fit": 10.0, "newton_row_yield.fit": 25.0,
           "newton_idle_share.fit": 50.0, "finalize_idle_share.fit": 90.0}


def _synthetic(scenario):
    rec = trace.Record("fit.iteration", {"it": 7, "schedule": "two-pass"})
    rec.profiled = scenario != "not profiled"
    spans = [("fit.iteration", None, 900, 1700), ("estep.newton", 0, 1000, 1100),
             ("estep.newton", 0, 1300, 1400), ("estep.finalize", 0, 1500, 1600)]
    for name, parent, t0, t1 in spans:
        sp = trace.Span(name)
        sp.parent, sp.t0, sp.t1 = parent, t0 * 1000, t1 * 1000
        rec.spans.append(sp)
        if parent is not None:  # each event record takes the host 4 us
            rec.marks += [((t0 - 5) * 1000, (t0 - 1) * 1000), ((t1 + 1) * 1000, (t1 + 5) * 1000)]
    rec.syncs = {"newton.done": (7, 0.01), "finalize.rung": (3, 0.002)}
    rec.counters = {"newton.doc_steps": 30, "newton.row_steps": 120}
    # where inside its mark each call lies: the fitted offset is OFFSET_US
    inside = [1.0, 3.0, 0.5, 2.0, 3.5, 2.5]
    ts = [b / 1e3 + OFFSET_US + j for (b, _a), j in zip(rec.marks, inside)]
    if scenario == "counts differ":
        ts = ts[:-1]
    if scenario == "offset misfit":
        ts[-1] += 120.0
    events = [{"cat": "cuda_runtime", "name": "cudaEventRecordWithFlags", "ts": t, "dur": 2.0}
              for t in ts]
    # a library's own event records (cuSOLVER's) under the other name are not anchors
    events += [{"cat": "cuda_runtime", "name": "cudaEventRecord", "ts": OFFSET_US + t,
                "dur": 2.0} for t in (940, 960)]
    events += [{"cat": "cpu_op", "name": "aten::mul", "ts": OFFSET_US + 950, "dur": 5.0}]
    events += [{"cat": "kernel", "name": f"k{i}", "ts": OFFSET_US + a, "dur": b - a}
               for i, (a, b) in enumerate([(1000, 1050), (1350, 1450), (1500, 1510)])]
    return rec, bench_trace.Trace(events, wall_s=1e-3)


@pytest.mark.parametrize("scenario", ["by hand", "counts differ", "offset misfit",
                                      "not profiled"])
@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_trace(monkeypatch, name, scenario):
    """Each reader gives the value computed by hand from the record lined
    up with the trace, and None where the event counts differ, where no
    offset within 50 us fits every pair, or where no record was made under
    the profiler."""
    rec, tr = _synthetic(scenario)
    monkeypatch.setattr(trace, "_records", [rec])
    read = spec.load_cell("k100_fit").readers()[name]
    got = read({"kind": "fit", "trace": tr})
    if scenario == "by hand":
        assert got == pytest.approx(BY_HAND[name], abs=1e-9)
        assert read({"kind": "serve", "trace": tr}) is None
        assert read({"kind": "fit", "trace": None}) is None
    else:
        assert got is None
