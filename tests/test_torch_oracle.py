"""The port's copy of the float64 oracle (strutopy_tpu_torch/utils/
reference_numpy.py) against the JAX package's, and chip_smoke.py phase
14's functions (the card's E-step against that oracle) at toy size on the
CPU: they pass the port's own E-step and fail it perturbed.

The copy is the JAX package's code function for function, so the two
give the same float64 bits on the same inputs."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from strutopy_tpu.ops.mstep import build_kappa_design
from strutopy_tpu.utils import reference_numpy as jax_ref
from strutopy_tpu_torch import STM, STMConfig
from strutopy_tpu_torch.utils import reference_numpy as ref
from torch_world import one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(REPO, "strutopy_tpu_torch", "utils", "reference_numpy.py")


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


@pytest.fixture(scope="module")
def toy(toy_corpus, toy_metadata):
    docs = toy_corpus.train_docs
    V = 1 + max(w for d in docs for w, _ in d)
    return docs, V, np.asarray(toy_metadata[: len(docs)], np.float64)


def _assert_bits(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bits(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_the_copy_is_the_jax_oracle_function_for_function():
    names = [n.name for n in ast.parse(open(COPY).read()).body if isinstance(n, ast.FunctionDef)]
    assert names == ["doc_f", "doc_grad", "doc_hess", "make_pd", "safe_chol", "e_step",
                     "_ctm_mu_sigma", "m_step_ctm_lda", "fit_ctm_lda", "m_step_stm_ols",
                     "fit_stm_ols", "m_step_content", "fit_content"]
    assert "PARITY_NOTES.md #1, #2" in ref.__doc__


def test_the_copy_imports_numpy_and_scipy_only():
    """Loaded alone from its file in a fresh interpreter it brings in no
    torch, no jax and nothing of either package; its module-level imports
    are numpy and scipy."""
    tops = set()
    for node in ast.parse(open(COPY).read()).body:
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert tops == {"__future__", "numpy", "scipy"}
    code = ("import importlib.util, sys; "
            f"s = importlib.util.spec_from_file_location('oracle', {COPY!r}); "
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
            "bad = [n for n in sys.modules if n.split('.')[0] in "
            "('torch', 'jax', 'strutopy_tpu', 'strutopy_tpu_torch')]; "
            "assert not bad, bad; assert callable(m.e_step)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_e_step_and_ctm_m_step_bit_for_bit(toy):
    docs, V, _ = toy
    rng = np.random.default_rng(0)
    K, N = 3, len(docs)
    g = rng.gamma(0.1, 1.0, (K, V))
    beta = g / g.sum(1, keepdims=True)
    mu, eta = rng.normal(0, 0.3, (N, K - 1)), rng.normal(0, 0.3, (N, K - 1))
    sigma = np.eye(K - 1) + 0.2
    got = ref.e_step(docs, beta, mu, eta, sigma)
    want = jax_ref.e_step(docs, beta, mu, eta, sigma)
    _assert_bits(got, want)
    beta_ss, sigma_ss, _bound, eta_new, _theta = got
    _assert_bits(ref.m_step_ctm_lda(beta_ss, sigma_ss, eta_new, N, 0.3),
                 jax_ref.m_step_ctm_lda(beta_ss, sigma_ss, eta_new, N, 0.3))


def test_fit_ctm_lda_bit_for_bit(toy):
    docs, V, _ = toy
    _assert_bits(ref.fit_ctm_lda(docs, V, 3, n_iter=2), jax_ref.fit_ctm_lda(docs, V, 3, n_iter=2))


def test_fit_stm_ols_bit_for_bit(toy):
    docs, V, X = toy
    _assert_bits(ref.fit_stm_ols(docs, V, 3, X, n_iter=2),
                 jax_ref.fit_stm_ols(docs, V, 3, X, n_iter=2))


def test_fit_content_bit_for_bit(toy):
    docs, V, X = toy
    aspects = X.ravel().astype(np.int64)
    design = build_kappa_design(3, 2, True)
    _assert_bits(ref.fit_content(docs, V, 3, 2, aspects, design, n_iter=1),
                 jax_ref.fit_content(docs, V, 3, 2, aspects, design, n_iter=1))


# ---------------------------------------------------------------------------
# chip_smoke.py phase 14 at toy size
# ---------------------------------------------------------------------------


def _docs(seed=4, N=48, K=6, V=300):
    """Documents of two lengths, so the fit's plan stores them in another
    order than the user's."""
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.full(V, 0.2), size=K)
    docs = []
    for d in range(N):
        draw = rng.multinomial(500 if d % 3 == 0 else 100, rng.dirichlet(np.full(K, 0.5)) @ beta)
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    return docs, rng.integers(0, 2, N).astype(np.float64)


@pytest.fixture(scope="module")
def phase14():
    """A fitted model's warm state for its first 32 documents, the
    oracle's E-step on it, and the port's E-step on it on the CPU."""
    docs, X = _docs()
    model = STM(docs, K=6, X=X, device="cpu",
                config=STMConfig(K=6, init_type="random", batch_size=16, max_em_iter=2,
                                 convergence_threshold=0.0))
    model.expectation_maximization()
    st = cs.oracle_inputs(model, docs, n=32)
    port = cs.port_outputs(cs.port_estep(torch, st, "cpu")())
    oracle, _sec = cs.oracle_estep(ref, st)
    return model, docs, st, port, oracle


def test_phase14_takes_the_warm_state_in_document_order(phase14):
    model, docs, st, _port, _oracle = phase14
    assert model._plan.n_buckets == 2
    assert not np.array_equal(model._plan.storage_index[:32], np.arange(32))
    assert st["docs"] == docs[:32]
    np.testing.assert_array_equal(st["mu"], model.mu[:32])
    np.testing.assert_array_equal(st["eta"], model.eta[:32])
    np.testing.assert_array_equal(st["beta"], model.beta)
    np.testing.assert_array_equal(st["sigma"], model.sigma)
    assert all(a.dtype == np.float64 for k, a in st.items() if k != "docs")


def test_phase14_passes_the_port_s_estep(phase14):
    _model, _docs, st, port, oracle = phase14
    gaps = cs.oracle_gaps(ref, st, port, oracle)
    fails = cs.Failures()
    cs.judge_oracle(fails, gaps, "toy")
    assert not fails, gaps
    assert gaps["compared"] >= 30 and gaps["n"] == 32


def _shift_bound(port, oracle):
    port["bound"] = port["bound"] * (1 + 1e-5)


def _drop_a_word(port, oracle):
    w = np.argmax(oracle["beta_ss"].sum(0))
    port["beta_ss"][:, w] = 0.0


def _nu_of_one_document_lost(port, oracle):
    port["sigma_ss"] = port["sigma_ss"] * (1 - 1 / 32)


def _eta_off_on_one_document(port, oracle):
    port["eta"][3] += 2e-3


def _theta_of_another_document(port, oracle):
    port["theta"][[0, 1]] = port["theta"][[1, 0]]


def _stalled_solves(port, oracle):
    port["eta"][:4] = 0.0


@pytest.mark.parametrize("perturb,check", [
    (_shift_bound, "summed bound"), (_drop_a_word, "beta_ss"),
    (_nu_of_one_document_lost, "sigma_ss"), (_stalled_solves, "left above"),
    # an eta 2e-3 off has a gradient far above ORACLE_G, so it counts as
    # unconverged; with every document taken as converged, the per-document
    # comparison itself must catch it
    (_eta_off_on_one_document, "eta within"), (_theta_of_another_document, "eta within"),
])
def test_phase14_fails_a_perturbed_estep(phase14, perturb, check, monkeypatch):
    _model, _docs, st, port, oracle = phase14
    port = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in port.items()}
    perturb(port, oracle)
    if check == "eta within":
        monkeypatch.setattr(cs, "ORACLE_G", np.inf)
    fails = cs.Failures()
    cs.judge_oracle(fails, cs.oracle_gaps(ref, st, port, oracle), "toy")
    assert [f for f in fails if check in f], fails
