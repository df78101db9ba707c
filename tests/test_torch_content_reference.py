"""The port's content model against the float64 plain reference of the
benchmark (``perfbench/reference/content_ref.py``) at toy size on the
CPU: K=4 topics, A=2 aspects with topic-aspect interactions, V=60 words,
N=48 documents, seeded.  The reference imports nothing of either
package; the DGP (``perfbench/corpus_content.py``) is a function of its
seed.  Also the kappa regression's spans and counters
(``strutopy_tpu_torch/utils/trace.py``), recorded only when asked."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import corpus_content
from perfbench.reference import content_ref, stm_ref
from strutopy_tpu_torch import STM, STMConfig
from strutopy_tpu_torch.models.em import local_estep_stats, make_em_step
from strutopy_tpu_torch.ops import mstep
from strutopy_tpu_torch.utils import trace
from torch_world import one_thread

K, A, V, N = 4, 2, 60, 48
ALPHA = 1.0
F64 = stm_ref.Prec("float64")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file
    (tests/torch_world.py::one_thread)."""
    with one_thread():
        yield


def _config():
    cfg = json.loads((ROOT / "perfbench/configs/stm_poliblog_k20_content.json").read_text())
    cfg.update(K=K, V=V, N=N, A=A)
    cfg["corpus"] = dict(cfg["corpus"], mean_tokens=60)
    return cfg


def _fit(iters=3):
    """A toy content fit from the DGP, ``iters`` EM iterations in."""
    made = corpus_content.content_corpus(_config(), seed=7)
    cfg = STMConfig(K=K, content=True, A=A, kappa_interactions=True, lda_beta=False,
                    kappa_l2=ALPHA, init_type="random", max_em_iter=iters, batch_size=16,
                    convergence_threshold=0.0)
    beta0 = np.random.RandomState(3).gamma(0.1, 1.0, (K, V)) + 1e-3
    m = STM(made["docs"], K=K, X=made["X"], config=cfg, beta_index=made["aspects"],
            init_beta=beta0, device="cpu")
    m.expectation_maximization()
    return m, made


@pytest.fixture(scope="module")
def fitted():
    return _fit()


def _params(m) -> dict:
    return {"beta": m.beta.astype(np.float64), "mu": m.mu.astype(np.float64),
            "eta": m.eta.astype(np.float64), "sigma": m.sigma.astype(np.float64),
            "kappa": m.kappa.astype(np.float64)}


def _rel_rows(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float((torch.linalg.norm(a - b, dim=-1) / torch.linalg.norm(b, dim=-1)).max())


def test_estep_matches_the_reference(fitted):
    """From one warm state: each document's objective at the port's eta is
    within 1e-4 nats of the reference's optimum, 1e-7 on average (the
    float32 Newton stops at max|g| 1e-5, ~1e-10 nats; a document stalled
    where f's float32 rounding, ~1e-7 of |f| ~ 8e2, hides every Armijo
    step can stop 1e-6 nats off, read here); each aspect's beta_ss within
    2e-4 relative a row and the summed bound within 1e-4 relative (read:
    3.9e-5 and 1.2e-5; the stalled document's eta lies off along a flat
    direction, which moves its phi and its bound's log-det term at first
    order, and it is one of 48 documents)."""
    m, made = fitted
    p = _params(m)
    stats, eta, _theta, _it = local_estep_stats(m._state, m._data, m.config,
                                                m._plan.batch_sizes)
    eta_user = eta.numpy()[m._storage_index].astype(np.float64)
    ref = content_ref.e_step(made["docs"], made["aspects"], p["beta"], p["mu"], p["eta"],
                             p["sigma"], F64, at=[eta_user])
    gap = (ref["f_at"][0] - ref["f"]).numpy()
    assert gap.max() < 1e-4 and gap.mean() < 1e-7 and gap.min() > -1e-9
    ss = stats.beta_ss.numpy().astype(np.float64)
    assert ss.shape == (A, K, V)
    for a in range(A):
        assert _rel_rows(ss[a], ref["beta_ss"][a]) < 2e-4
    b = float(ref["bound"].sum())
    assert abs(float(stats.bound) - b) < 1e-4 * abs(b)


def _kappa_case(fitted):
    m, made = fitted
    stats = local_estep_stats(m._state, m._data, m.config, m._plan.batch_sizes)[0]
    Xd = content_ref.kappa_design(K, A, True)
    assert np.array_equal(Xd, mstep.build_kappa_design(K, A, True))
    prob = content_ref.kappa_problem(stats.beta_ss.double(), m.wcounts, Xd, F64)
    star = content_ref.solve_kappa(prob, ALPHA, F64)
    return m, stats, Xd, prob, star


def test_update_beta_content_matches_the_reference(fitted):
    """On one beta_ss, cold and warm: every word's kappa objective at the
    port's kappa within 1e-9 of the float64 optimum (float32's floor of
    an objective of size ~1e2 whose gradient carries ~1e-5 of rounding:
    ~g²/2h ~ 1e-11), and each of the A·K beta rows within 1e-5 relative
    (the softmax of a float32 linear predictor)."""
    m, stats, Xd, prob, star = _kappa_case(fitted)
    assert star["gmax"].max() <= 1e-9
    Xt = torch.tensor(Xd, dtype=torch.float32)
    wc = torch.tensor(m.wcounts, dtype=torch.float32)
    bref = content_ref.beta_of(prob, star["kappa"], stats.beta_ss.shape)
    for k0 in (None, m._state.kappa):
        beta, kappa = mstep.update_beta_content(stats.beta_ss, wc, Xt, alpha=ALPHA, iters=40,
                                                kappa0=k0)
        gap = content_ref.kappa_gap(prob, kappa, star["kappa"], ALPHA)
        assert gap.max() < 1e-9 and gap.min() > -1e-12
        assert _rel_rows(beta, bref) < 1e-5


def test_kappa_solve_passes_the_objective_floor():
    """A frequent word (counts ~1e4 a row, |F| ~ 1e5) is solved past the
    point where its objective's float32 rounding hides the decrease of a
    step: its gap to the float64 optimum is below 1e-6 (in float32 the
    gradient itself carries ~1e-2 of rounding at these counts, so the
    gap of the last accepted step is ~g²/2h ~ 1e-7); a solve that stops
    where no candidate's objective is below F's rounding leaves it at
    6.5e-6."""
    rng = np.random.default_rng(4)
    Xd = content_ref.kappa_design(K, A, True)
    R = Xd.shape[0]
    w_true = rng.normal(0.0, 0.3, (Xd.shape[1], 3))
    Y = rng.poisson(np.exp(np.log(2e4) + Xd @ w_true)).astype(np.float64)
    Y[:, 1] = rng.poisson(5.0, R)  # a rare word beside it
    wc = Y.sum(0) * 10.0
    beta_ss = Y.reshape(A, K, 3)
    prob = content_ref.kappa_problem(beta_ss, wc, Xd, F64)
    star = content_ref.solve_kappa(prob, ALPHA, F64)
    _beta, kappa = mstep.update_beta_content(
        torch.tensor(beta_ss, dtype=torch.float32), torch.tensor(wc, dtype=torch.float32),
        torch.tensor(Xd, dtype=torch.float32), alpha=ALPHA, iters=40)
    gap = content_ref.kappa_gap(prob, kappa, star["kappa"], ALPHA)
    assert gap.max() < 1e-6


def test_em_iteration_matches_the_reference(fitted):
    """One whole EM iteration from one warm state: the reference's E-step
    and M-step (the prevalence OLS, sigma, kappa) in float64 against the
    port's, each number read beside its limit: eta within 1e-4 nats a
    document and 1e-7 on average (read 1.0e-6 and 2.1e-8; the stalled
    document, as above); beta rows 1e-4 relative (read 9.4e-6) and
    kappa's objective gap 1e-8 on the reference's statistics (read
    9.6e-10: the port solves on its float32 beta_ss, whose rounding and
    the stalled document move the optimum); sigma and gamma 5e-4 relative
    (read 9.4e-6 and 5.1e-5: OLS of float32 eta, 12 design columns); the
    bound 1e-4 relative (read 1.2e-5, as above)."""
    m, made = fitted
    p = _params(m)
    step = make_em_step(m.config, m._design,
                        torch.tensor(mstep.build_kappa_design(K, A, True), dtype=torch.float32),
                        torch.tensor(m.wcounts, dtype=torch.float32), m._plan.batch_sizes)
    new = step(m._state, m._data)
    own = m._state
    m._state = new
    try:
        out = {"eta": m.eta, "beta": m.beta, "sigma": m.sigma, "gamma": m.gamma,
               "kappa": m.kappa, "bound": m.bound}
    finally:
        m._state = own
    D = np.c_[np.ones(N), made["X"]]
    ref_e = content_ref.e_step(made["docs"], made["aspects"], p["beta"], p["mu"], p["eta"],
                               p["sigma"], F64, at=[out["eta"].astype(np.float64)])
    ref_m = content_ref.m_step(ref_e, D, m.wcounts, content_ref.kappa_design(K, A, True),
                               ALPHA, F64, kappa0=p["kappa"])
    gap = ref_e["f_at"][0] - ref_e["f"]
    assert gap.max() < 1e-4 and gap.mean() < 1e-7
    assert _rel_rows(out["beta"], ref_m["beta"]) < 1e-4
    kgap = content_ref.kappa_gap(ref_m["problem"], out["kappa"], ref_m["kappa"], ALPHA)
    assert kgap.max() < 1e-8
    for k in ("sigma", "gamma"):
        got, want = torch.as_tensor(out[k], dtype=torch.float64), ref_m[k]
        assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) < 5e-4, k
    b = float(ref_e["bound"].sum())
    assert abs(out["bound"] - b) < 1e-4 * abs(b)


def _top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", ["perfbench/reference/content_ref.py",
                                  "perfbench/corpus_content.py"])
def test_reference_and_dgp_import_neither_package(path):
    names = _top_imports(ROOT / path)
    assert not names & {"jax", "jaxlib", "strutopy_tpu", "strutopy_tpu_torch"}, names


def test_dgp_is_a_function_of_its_seed():
    cfg = _config()
    a, b = (corpus_content.content_corpus(cfg, 2**31 + 5) for _ in range(2))
    assert a["docs"] == b["docs"]
    for k in ("X", "aspects", "day", "beta"):
        assert np.array_equal(a[k], b[k])
    c = corpus_content.content_corpus(cfg, 2**31 + 6)
    assert c["docs"] != a["docs"]
    assert len(a["docs"]) == N and a["X"].shape == (N, 1 + cfg["corpus"]["spline_df"])
    np.testing.assert_allclose(a["beta"].sum(-1), 1.0)
    # the program's spline is the DGP's
    from strutopy_tpu_torch.ops.design import bspline_basis
    np.testing.assert_allclose(bspline_basis(a["day"], df=10), a["X"][:, 1:], atol=1e-12)


KAPPA_COUNTERS = ("kappa.chunk_steps", "kappa.word_steps", "kappa.slot_steps",
                  "kappa.floor_exits")


def test_kappa_span_and_counters(fitted):
    """Recording, a content iteration holds one ``mstep.kappa`` span (its
    chunks and words) inside ``em.mstep`` and the four kappa counters:
    slot steps = chunk width x chunk steps, word steps at most that; an
    LDA fit's record holds none of them; off, the span is not made and
    the iteration's outputs are bit for bit the recorded one's."""
    m, _made = fitted
    start, it = m._state, m.config.max_em_iter
    with trace.recording():
        m.config = m.config.replace(max_em_iter=it + 1)
        m.expectation_maximization(start_iter=it)
    rec = m.trace[-1].resolve()
    spans = [s for s in rec.spans if s.name == "mstep.kappa"]
    assert len(spans) == 1 and spans[0].attrs == {"chunks": 1, "words": V}
    assert rec.spans[spans[0].parent].name == "em.mstep"
    c = rec.counters
    assert all(c.get(k) is not None for k in KAPPA_COUNTERS)
    assert c["kappa.slot_steps"] == V * c["kappa.chunk_steps"] > 0
    assert 0 < c["kappa.word_steps"] <= c["kappa.slot_steps"]
    assert 0 <= c["kappa.floor_exits"] <= V
    recorded = m._state
    m._state = start
    m.expectation_maximization(start_iter=it)
    assert torch.equal(m._state.kappa, recorded.kappa)
    assert torch.equal(m._state.eta, recorded.eta)
    m._state = start

    docs = [[(0, 2), (3, 1)], [(1, 1), (2, 2)], [(0, 1), (4, 3)]] * 4
    lda = STM(docs, K=2, init_type="random", max_em_iter=1, device="cpu")
    with trace.recording():
        lda.expectation_maximization()
    rec = lda.trace[-1].resolve()
    assert not [s for s in rec.spans if s.name == "mstep.kappa"]
    assert not set(rec.counters) & set(KAPPA_COUNTERS)
