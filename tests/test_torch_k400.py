"""The 400-topic configuration of the benchmark (``perfbench/configs/
stm_k400_v50k.json``, cell ``k400_fit``) and what it reads of the port.

On the CPU: the configuration's toy fit against the float64 plain
reference (``perfbench/reference/stm_ref.py``) on seeded weights; the
cell's rehearsal (``perfbench/run.py --device cpu``); the kernel wrappers'
plan counts (``plan.cg.*``, ``plan.factor.*``, ``plan.finalize.*``: none on
CPU tensors, none while recording is off); F's roofline
(``perfbench/roofline_factor.py``) and the cell's three readers on a
synthetic trace and record.  On the card (the ``cuda`` tests): F at
P=399 and Z at K=400 against their plain versions, and the plan counts of
their large-K branches.

This file imports no JAX: on the card it runs with
``python -m pytest --noconftest tests/test_torch_k400.py -m cuda``."""

import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
from perfbench import roofline_factor, spec, trace as bench_trace
from perfbench.drivers import fit as fit_driver
from strutopy_tpu_torch.ops import estep, stages
from strutopy_tpu_torch.utils import trace
from torch_world import one_thread

CELL = "k400_fit"
PLAN_KEYS = ("plan.cg.h_smem", "plan.cg.h_l2", "plan.factor.smem", "plan.factor.global",
             "plan.finalize.staged", "plan.finalize.unstaged")


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    with one_thread():
        yield


def _reader(name):
    return spec._load_module(spec.HERE / "metrics" / f"{name}.py",
                             "test_k400_" + name.replace(".", "_"))


# ---------------------------------------------------------------------------
# the configuration and its toy
# ---------------------------------------------------------------------------


def test_the_configuration_has_its_sizes_and_its_cut():
    cell = spec.load_cell(CELL)
    cfg = cell.config
    assert (cfg["K"], cfg["V"], cfg["N"], cfg["doc_tokens"]) == (400, 50000, 32768, 300)
    assert cfg["reduced"] == ["N"] and "N" in cfg["reduced_from"]
    assert set(cfg["assumed"]) == {"K", "V", "doc_tokens"}
    k100 = spec.load_cell("k100_fit").config
    assert cfg["stm"] == k100["stm"] and cfg["corpus"]["dgp"] == k100["corpus"]["dgp"]
    toy = cfg["toy"]
    assert toy["K"] <= 13 and toy["stm"]["batch_size"] <= 16 and toy["N"] <= 60
    assert cell.chips == 1 and cell.traffic == spec.load_cell("k100_fit").traffic
    names = {m["name"] for m in cell.per_layer}
    assert names == {"factor_roofline.k400", "finalize_share.k400", "newton_roofline.k400"}


@pytest.mark.parametrize("seed", [5, 3000000001])
def test_toy_fit_matches_the_reference(seed):
    """The port's toy fit (the cell's set-up at its toy sizes, seeded
    weights) against the float64 reference over one more EM iteration from
    the same state: every document's objective within 1e-4 nats of the
    reference's optimum, 1e-6 on average; beta's worst topic, sigma,
    gamma and the bound within 1e-4 relative."""
    cell = spec.load_cell(CELL)
    fit = fit_driver.setup(cell, seed, "cpu", toy=True)
    prev = fit.model._state
    fit.iterate()
    (_prefix, inputs, outputs), = fit.judged(prev, fit.model._state)
    nums = fit_driver.reference_numbers(fit, inputs, [outputs], "cpu")[0]
    assert nums["gap_max"] <= 1e-4 and nums["gap_mean"] <= 1e-6, nums
    assert max(nums[k] for k in ("beta_rel", "sigma_rel", "gamma_rel", "bound_rel")) <= 1e-4, nums
    # the reference moved the same state: its bound is the program's within float32
    assert np.isfinite(outputs["bound"])


# At the toy's 48 documents the M-step's sums (sigma, gamma) and the summed
# bound carry a few documents' float32 stopping error (a flat direction of a
# document's objective leaves eta ~1e-3 off at max|g| 1e-5, which moves its
# bound by up to ~0.06 nats): they read up to ~8x the cell's limits there,
# which the card's readings at 32,768 documents draw (PERF.md, section 6).
# The per-document checks and beta hold at the toy as on the card.
TOY_HELD = ("init.beta_rel", "init.state_max", "last.gap_max", "last.gap_mean", "last.gap_p50",
            "last.gap_p90", "last.beta_rel")
TOY_READ = ("last.sigma_rel", "last.gamma_rel", "last.bound_rel")


def _failed(numbers, limits, keys):
    return [k for k in keys if not (np.isfinite(numbers.get(k, np.nan))
                                    and numbers[k] <= limits[k])]


def test_the_limits_split_into_held_and_read_at_the_toy():
    assert set(TOY_HELD) | set(TOY_READ) == set(spec.load_cell(CELL).limits)


@pytest.mark.parametrize("trace_on", [0, 1])
def test_the_rehearsal_runs_and_holds_the_per_document_checks(trace_on):
    """``run.py --device cpu`` on the cell, in a process of its own (this
    one has JAX loaded, which a run refuses): it ends with a result, no
    device metric (with ``--trace 1`` every reader of the cell reads
    nothing on the CPU), every limit compared with a finite reading, and
    the per-document checks and beta within the cell's limits."""
    done = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload", CELL, "--seed", "3000000001",
         "--seconds", "0.5", "--trace", str(trace_on), "--device", "cpu"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    numbers = {k: c["value"] for k, c in out["checks"].items()}
    assert set(numbers) == set(TOY_HELD) | set(TOY_READ)
    assert all(np.isfinite(v) for v in numbers.values()), numbers
    assert not _failed(numbers, spec.load_cell(CELL).limits, TOY_HELD), out["checks"]
    assert out["metrics"] == {} and out["device"]["platform"] == "cpu"
    # the host's numbers: the end-to-end ones, or with --trace 1 the readers' (none here)
    assert set(out["rehearsal"]) == (set() if trace_on else {"fit_docs_per_s", "setup_s"})
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_the_control_and_each_fault_fail_a_held_check():
    """At the toy (``perfbench/calibrate.py``'s readings): the program
    passes the held checks; the control (the reference in TF32 in the
    program's place) and each fault fail at least one of them."""
    from perfbench import calibrate

    cell = spec.load_cell(CELL)
    rec = calibrate.fit_seed(cell, 11, 0.3, True, "cpu", True)
    assert not _failed(rec["program"], cell.limits, TOY_HELD)
    last = [k for k in TOY_HELD if k.startswith("last.")]
    for name in ("control", "fault.unchanged", "fault.half", "fault.altered"):
        assert _failed(rec[name], cell.limits, last), name


# ---------------------------------------------------------------------------
# the plan counts
# ---------------------------------------------------------------------------


def _toy_chunk(B=6, K=5, L=12, seed=0):
    return cs.finalize_inputs(torch, B, K, L, seed, device="cpu")


def test_plan_counts_stay_zero_on_cpu_tensors():
    """A recorded toy fit on the CPU runs the plain versions: no plan count."""
    cell = spec.load_cell(CELL)
    fit = fit_driver.setup(cell, 11, "cpu", toy=True)
    with trace.recording():
        fit.iterate()
    recs = trace.records()
    assert recs and all(k not in r.counters for r in recs for k in PLAN_KEYS)


def _as_if_on_a_card(monkeypatch, cg_smem, factor_smem, staged):
    """The wrappers' CUDA route on CPU tensors: no launch, the plans given."""
    monkeypatch.setattr(stages, "_use_plain", lambda *a, **k: False)
    monkeypatch.setattr(stages, "_launch", lambda *a, **k: None)
    monkeypatch.setattr(stages, "cg_plan", lambda *a: {"bytes": 0, "h_smem": cg_smem})
    monkeypatch.setattr(stages, "factor_plan", lambda *a: {"threads": 0, "bytes": 0,
                                                           "in_smem": factor_smem})
    monkeypatch.setattr(stages, "finalize_plan", lambda *a: {"stage": staged})


@pytest.mark.parametrize("small", [True, False])
def test_plan_counts_take_each_launch_on_its_plan(monkeypatch, small):
    """Each launch counts its documents under the plan the C side chose
    (here given), and nothing is counted while recording is off."""
    eta, bd, c, mu, w, siginv, _se, Nd = _toy_chunk()
    B, K = bd.shape[0], bd.shape[1]
    H = torch.eye(K - 1).repeat(B, 1, 1)
    _as_if_on_a_card(monkeypatch, small, small, small)

    def launches():
        stages.cg(H, eta, 3)
        stages.chol_pd_inverse(H)
        stages.finalize_terms(eta, bd, c, mu, w, siginv, Nd)

    launches()  # recording off: no record to count in
    assert trace.active() is None
    with trace.recording(), trace.span("test") as rec:
        launches()
        launches()
    want = {"plan.cg.h_smem" if small else "plan.cg.h_l2": 2 * B,
            "plan.factor.smem" if small else "plan.factor.global": 2 * B,
            "plan.finalize.staged" if small else "plan.finalize.unstaged": 2 * B}
    assert {k: v for k, v in rec.counters.items() if k.startswith("plan.")} == want


def test_plan_counts_are_kept_under_a_profiler_alone(monkeypatch):
    """Under ``torch.profiler`` alone (no ``recording()``) the record keeps
    the plan counts: the traced run's readers see them."""
    eta, bd, c, mu, w, siginv, _se, Nd = _toy_chunk()
    B = bd.shape[0]
    _as_if_on_a_card(monkeypatch, False, False, True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("test") as rec:
            stages.finalize_terms(eta, bd, c, mu, w, siginv, Nd)
            stages.chol_pd_inverse(torch.eye(bd.shape[1] - 1).repeat(B, 1, 1))
    assert not rec.full
    assert rec.counters["plan.finalize.staged"] == rec.counters["plan.factor.global"] == B


# ---------------------------------------------------------------------------
# F's roofline and the cell's readers
# ---------------------------------------------------------------------------


def test_roofline_factor_at_the_k100_chunk_and_at_k400():
    """P=99, B=256: 30 MB (9.0 µs at 3.35 TB/s) against P³ operations
    (3.7 µs at 67 TFLOP/s), bytes-bound (PERF.md's F row); P=399: bound by
    its operations, 243 µs a chunk."""
    n_bytes, ops = roofline_factor.cost(256, 99)
    assert round(n_bytes / 1e6, 1) == 30.1
    assert round(ops["f32"] / 67e12 * 1e6, 1) == 3.7
    assert round(roofline_factor.least_s(256, 99) * 1e6, 1) == 9.0
    assert round(roofline_factor.least_s(256, 399) * 1e6) == 243
    assert roofline_factor.least_s(256, 399) == pytest.approx(256 * roofline_factor.least_s(1, 399))


def _span(name, device):
    return types.SimpleNamespace(name=name, device=device, t0=0, t1=0)


def _ctx(finalize_rows, factor_us, counts):
    """A traced iteration: _finalize_chunk calls of ``finalize_rows`` rows at
    K=400 and F's kernel taking ``factor_us`` µs a call."""
    calls = [("_finalize_chunk", [((B, 399), "f32"), ((B, 400, 300), "torch.float32")], {})
             for B in finalize_rows]
    events, t = [], 0.0
    for _ in finalize_rows:
        events.append({"cat": "kernel", "name": "void cholesky_pd_inverse_kernel<true, false>",
                       "ts": t, "dur": factor_us})
        t += factor_us + 5.0
    rec = types.SimpleNamespace(counters=counts, spans=[
        _span("fit.iteration", (0.0, 2.0)), _span("estep.finalize", (0.5, 1.0)),
        _span("estep.finalize", (0.9, 1.3)), _span("estep.newton", (0.1, 0.4))])
    return {"kind": "fit", "calls": calls, "trace": bench_trace.Trace(events, t / 1e6)}, rec


def test_factor_roofline_cannot_pass_100_and_checks_its_count():
    mod = _reader("factor_roofline.k400")
    least_us = roofline_factor.least_s(256, 399) * 1e6
    ctx, rec = _ctx([256, 256, 100], least_us, {"plan.factor.global": 612})
    mod._record = lambda c: (rec, 0.0)
    exact = 100.0 * 612 / (3 * 256)  # the 100-row call takes a 256-row call's time
    assert mod.read(ctx) == pytest.approx(exact)
    for slow in (1.0, 1.5, 7.0):
        ctx, rec = _ctx([256, 256], least_us * slow, {"plan.factor.global": 512})
        assert mod.read(ctx) <= 100.0 + 1e-9
    ctx, rec = _ctx([256, 256], least_us, {"plan.factor.global": 500})  # the counts disagree
    assert mod.read(ctx) is None
    ctx, rec = _ctx([256], least_us, {})  # a program that keeps no plan counts
    assert mod.read(ctx) is None
    mod._record = lambda c: None
    assert mod.read(ctx) is None


def test_finalize_share_is_the_union_of_its_spans_over_the_iteration():
    mod = _reader("finalize_share.k400")
    ctx, rec = _ctx([256], 10.0, {})
    mod._record = lambda c: (rec, 0.0)
    assert mod.read(ctx) == pytest.approx(100.0 * 0.8 / 2.0)
    rec.spans = [s for s in rec.spans if s.name != "estep.finalize"]
    assert mod.read(ctx) is None
    mod._record = lambda c: None
    assert mod.read(ctx) is None


def test_newton_roofline_k400_is_the_fit_reader_and_prints_the_plans(capsys):
    mod = _reader("newton_roofline.k400")
    fit = _reader("newton_roofline.fit")
    B, K, L = 256, 400, 300
    calls = [("fgh", [((B, K - 1), "f32"), ((B, K, L), "torch.float32")], {"bf16": True}),
             ("cg", [((B, K - 1, K - 1), "f32"), ((B, K - 1), "f32"), 6], {"bf16": True})]
    events = [{"cat": "kernel", "name": "fgh_kernel<64, 3>", "ts": 0.0, "dur": 400.0},
              {"cat": "kernel", "name": "cg_kernel<8, true, false>", "ts": 410.0, "dur": 300.0}]
    ctx = {"kind": "fit", "calls": calls, "trace": bench_trace.Trace(events, 1e-3)}
    rec = types.SimpleNamespace(counters={"plan.cg.h_l2": 256, "newton.doc_steps": 3})
    mod._record = lambda c: (rec, 0.0)
    assert mod.read(ctx) == pytest.approx(fit.read(ctx)) and 0 < mod.read(ctx) <= 100
    assert "plan.cg.h_l2: 100.0%" in capsys.readouterr().err
    mod._record = lambda c: None
    assert mod.read(ctx) == pytest.approx(fit.read(ctx))


# ---------------------------------------------------------------------------
# the card: F at P=399 and Z at K=400 against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels' large-K branches run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_factor_at_p399_matches_plain(card):
    """F on a K=400 chunk's Hessians (Z's H of a random chunk, B=256) against
    the plain ladder and cholesky_inverse, by phase 2e's checks: rungs
    equal, L and nu within their allowances, nu's error against float64 at
    most twice plain's, two calls and the factor-only mode bit-equal."""
    args = cs.finalize_inputs(torch, 256, 400, 384, seed=400, device=card)
    eta, bd, c, mu, w, siginv, _se, Nd = args
    H = stages.finalize_terms(eta, bd, c, mu, w, siginv, Nd)[1]
    assert not stages.factor_plan(399)["in_smem"]
    checks, out = cs.factor_verdict(torch, stages, H)
    assert all(checks.values()), (checks, out)


@pytest.mark.cuda
def test_cuda_finalize_at_k400_matches_plain(card):
    """Z, F and the epilogue at K=400, L=384 (the fit's widths) against the
    plain finalize by phase 2f's allowances."""
    args = cs.finalize_inputs(torch, 256, 400, 384, seed=401, device=card)
    assert stages.finalize_plan(400)["stage"]
    checks, out = cs.finalize_verdict(torch, stages, estep, args)
    assert all(checks.values()), (checks, out)


@pytest.mark.cuda
@pytest.mark.parametrize("K,small", [(400, False), (100, True)])
def test_cuda_plan_counts_equal_the_rows(card, K, small):
    """A recorded finalize and Newton step on the card count every row of
    the chunk under the plan taken: at K=400 F's global scratch and B2's H
    in L2 (Z stages its phi up to K ~428), at K=100 both in shared memory."""
    B, L = 64, 96
    args = cs.finalize_inputs(torch, B, K, L, seed=K, device=card)
    eta, bd, c, mu, w, siginv, se, Nd = args
    ts = cs.step_sizes(torch, "cuda")
    done = torch.zeros(B, dtype=torch.bool, device=card)
    with trace.recording(), trace.span("test") as rec:
        estep._finalize_chunk(*args)
        stages.stage_step(eta, bd, c, mu, siginv, ts, done, None, 1e-5, 6)
    rec.resolve()
    plans = {k: v for k, v in rec.counters.items() if k.startswith("plan.")}
    assert plans == {"plan.finalize.staged": B,
                     "plan.factor.smem" if small else "plan.factor.global": B,
                     "plan.cg.h_smem" if small else "plan.cg.h_l2": B}
    assert stages.cg_plan(K - 1)["h_smem"] == small
