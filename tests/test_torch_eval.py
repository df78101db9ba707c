"""The port's post-fit analysis (strutopy_tpu_torch/eval/ and the twelve
``STM`` analysis methods) against the JAX package's on the same seeded
numpy inputs: exact equality for labels, orderings and assignments, rtol
1e-6 for float64 numpy results, ``simulate_theta``'s draws from one seed,
and the plot functions rendered with the Agg backend."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest

import strutopy_tpu.eval as jax_eval
import strutopy_tpu_torch.eval as port_eval
from strutopy_tpu.corpus.bow import pad_corpus as jax_pad_corpus
from strutopy_tpu.models.stm import STM as JaxSTM
from strutopy_tpu_torch import STM, CorpusCreation
from strutopy_tpu_torch.corpus.bow import pad_corpus
from strutopy_tpu_torch.utils.convert import state_from_numpy
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("diagnostics", "residuals", "align", "predict", "graph", "ldavis", "plots",
           "effects")


def _both(module, name):
    return (getattr(importlib.import_module(f"strutopy_tpu.eval.{module}"), name),
            getattr(importlib.import_module(f"strutopy_tpu_torch.eval.{module}"), name))


def _same(got, want, path="result"):
    """Recursive comparison: containers by structure, strings, bools and
    integers exactly, floats to rtol 1e-6."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) and want.dtype.kind in "fc":
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=path)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (float, np.floating)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.fixture(scope="module")
def inp():
    """Seeded numpy inputs shared by every function-level case."""
    rng = np.random.default_rng(7)
    K, V, N, L = 5, 40, 60, 12
    beta = rng.dirichlet(np.full(V, 0.2), size=K)
    beta3 = np.stack([beta, rng.dirichlet(np.full(V, 0.2), size=K)])
    theta = rng.dirichlet(np.full(K, 0.4), size=N)
    vocab = [f"w{i}" for i in range(V)]
    docs = []
    for d in range(N):
        draw = rng.multinomial(40, theta[d] @ beta)
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    A = rng.standard_normal((K - 1, K - 1))
    x = rng.standard_normal(N)
    return dict(
        K=K, V=V, N=N, beta=beta, beta3=beta3, theta=theta, vocab=vocab, docs=docs,
        sigma=A @ A.T + 0.5 * np.eye(K - 1), aspect=rng.integers(0, 2, N),
        wcounts=rng.integers(1, 50, V).astype(np.float64), x=x,
        y=theta[:, 0] * 3 - theta[:, 2] + 0.05 * rng.standard_normal(N),
        ybin=(theta[:, 1] + 0.1 * rng.standard_normal(N) > 0.2).astype(float),
        doc_lengths=np.array([sum(c for _, c in d) for d in docs], np.float64),
        kappa=rng.standard_normal((K + 2 + 2 * K, V)) * 0.1,
    )


def _corpus(fn, i):
    """Padded corpus of the package ``fn`` belongs to."""
    pad = jax_pad_corpus if fn.__module__.startswith("strutopy_tpu.") else pad_corpus
    return pad(i["docs"], V=i["V"])


def _kappa_design(fn, i):
    pkg = "strutopy_tpu" if fn.__module__.startswith("strutopy_tpu.") else "strutopy_tpu_torch"
    build = importlib.import_module(f"{pkg}.ops.mstep").build_kappa_design
    return build(i["K"], 2, True)


def _effect(fn, i):
    pkg = fn.__module__.rsplit(".", 1)[0]
    est = importlib.import_module(f"{pkg}.effects").estimate_effect
    return est(i["theta"], np.c_[i["x"], i["aspect"]])


# (module, function, call(fn, inputs))
CASES = [
    ("diagnostics", "ecdf", lambda f, i: f(i["y"])),
    ("diagnostics", "frex", lambda f, i: f(i["beta"], w=0.3)),
    ("diagnostics", "label_topics", lambda f, i: f(i["beta"], i["vocab"], n=6)),
    ("diagnostics", "label_topics", lambda f, i: f(i["beta3"], i["vocab"], topics=[3, 1], n=4,
                                                   frexweight=0.7)),
    ("diagnostics", "find_topic", lambda f, i: f(i["beta"], ["w3", "w17"], i["vocab"],
                                                 n=5)),
    ("diagnostics", "find_topic", lambda f, i: f(i["beta"], ["w5"], i["vocab"], n=5,
                                                 weighting="frex", wcounts=i["wcounts"])),
    ("diagnostics", "find_thoughts", lambda f, i: f(i["theta"], [0, 3], threshold=0.1, n=4)),
    ("diagnostics", "exclusivity", lambda f, i: f(i["beta"], M=8, w=0.6)),
    ("diagnostics", "semantic_coherence", lambda f, i: f(i["beta"], i["docs"], M=6)),
    ("diagnostics", "semantic_coherence", lambda f, i: f(i["beta"], _corpus(f, i), M=6)),
    ("diagnostics", "sage_labels", lambda f, i: f(i["beta3"], i["vocab"], kappa=i["kappa"],
                                                  kappa_design=_kappa_design(f, i), n=5)),
    ("diagnostics", "topic_quality", lambda f, i: f(i["beta"], i["docs"], M=6)),
    ("diagnostics", "check_beta", lambda f, i: f(
        np.where(np.arange(i["V"]) == 4, 0.97, i["beta3"] * 0.03), vocab=i["vocab"])),
    ("residuals", "check_residuals", lambda f, i: f(_corpus(f, i), i["theta"], i["beta"])),
    ("residuals", "check_residuals", lambda f, i: f(i["docs"], i["theta"], i["beta3"],
                                                    aspect=i["aspect"], chunk=16)),
    ("align", "topic_dissimilarity", lambda f, i: f(i["beta"], i["beta3"][1])),
    ("align", "topic_dissimilarity", lambda f, i: f(i["beta"], i["beta3"][1], metric="cosine")),
    ("align", "align_topics", lambda f, i: f([i["beta"], i["beta"][::-1], i["beta3"][1]])),
    ("align", "align_topics", lambda f, i: f([i["beta"], i["beta3"][1]], reference=1,
                                             metric="l1")),
    ("predict", "topic_lasso", lambda f, i: f(i["theta"], i["y"], nlambda=12, nfolds=4)),
    ("predict", "topic_lasso", lambda f, i: f(i["theta"], i["ybin"], covariates=i["x"],
                                              family="binomial", nlambda=8, nfolds=3)),
    ("graph", "topic_correlations", lambda f, i: f(i["sigma"])),
    ("graph", "topic_graph", lambda f, i: f(i["sigma"], cutoff=0.05)),
    ("graph", "nonparanormal", lambda f, i: f(i["theta"])),
    ("graph", "topic_graph_huge", lambda f, i: f(i["theta"], n_lambda=5, n_subsamples=6)),
    ("ldavis", "to_ldavis", lambda f, i: f(i["beta"], i["theta"], i["doc_lengths"],
                                           i["vocab"], R=8, lambda_step=0.1)),
    ("effects", "estimate_effect", lambda f, i: f(i["theta"], i["x"])),
    ("effects", "estimate_effect", lambda f, i: f(i["theta"], np.c_[i["x"], i["aspect"]],
                                                  topics=[4, 0], add_intercept=False)),
    ("effects", "effect_curve", lambda f, i: f(_effect(f, i), 1, np.linspace(-1, 1, 5),
                                               topics=[2, 0], at={2: 1.0})),
    ("effects", "effect_difference", lambda f, i: f(_effect(f, i), 2, 0, 1)),
    ("effects", "effect_point_estimates", lambda f, i: f(_effect(f, i), 2, [0, 1], topics=[1])),
    ("effects", "estimate_content_effect", lambda f, i: f(
        i["beta3"], i["theta"], i["doc_lengths"], i["aspect"], topics=[0, 2], n=4,
        vocab=i["vocab"])),
]


@pytest.mark.parametrize("module,name,call", CASES,
                         ids=[f"{m}.{n}-{k}" for k, (m, n, _) in enumerate(CASES)])
def test_function_matches_jax(module, name, call, inp):
    jax_fn, port_fn = _both(module, name)
    assert port_fn.__module__ == f"strutopy_tpu_torch.eval.{module}"
    _same(call(port_fn, inp), call(jax_fn, inp))


def test_align_metric_and_lasso_family_errors_match(inp):
    for module, name, call in [
        ("align", "topic_dissimilarity", lambda f: f(inp["beta"], inp["beta"], metric="l9")),
        ("predict", "topic_lasso", lambda f: f(inp["theta"], inp["y"], family="poisson")),
        ("effects", "estimate_effect", lambda f: f(inp["theta"], inp["x"][:-1])),
        ("graph", "plot_topic_graph", lambda f: f()),
    ]:
        msgs = []
        for fn in _both(module, name):
            with pytest.raises(ValueError) as err:
                call(fn)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], name


def test_eval_exports_every_public_name_of_the_jax_package():
    want = [n if n != "eval_heldout_jax" else "eval_heldout_torch" for n in jax_eval.__all__]
    assert port_eval.__all__ == want
    for n in want:
        assert getattr(port_eval, n).__module__.startswith("strutopy_tpu_torch.eval."), n


def test_every_public_function_exists_with_the_jax_signature():
    import inspect

    for module in MODULES:
        jm = importlib.import_module(f"strutopy_tpu.eval.{module}")
        pm = importlib.import_module(f"strutopy_tpu_torch.eval.{module}")
        for n, f in inspect.getmembers(jm, inspect.isfunction):
            if f.__module__ != jm.__name__ or n.startswith("_"):
                continue
            ours = list(inspect.signature(getattr(pm, n)).parameters.values())
            theirs = list(inspect.signature(f).parameters.values())
            if n == "permutation_test":  # the port adds the keyword-only device
                assert [p.name for p in ours if p.name not in [q.name for q in theirs]] == [
                    "device"]
                ours = [p for p in ours if p.name != "device"]
            assert [(p.name, p.default) for p in ours] == [(p.name, p.default) for p in theirs], n


def test_importing_eval_pulls_in_no_jax_matplotlib_or_sklearn():
    code = ("import sys, strutopy_tpu_torch.eval, strutopy_tpu_torch.eval.plots; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'strutopy_tpu', 'matplotlib', 'sklearn')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# a fitted model carried across: the STM methods and the device part
# ---------------------------------------------------------------------------


def _carry(jm, **kwargs):
    """A port STM holding the JAX model's fitted state."""
    m = STM(**kwargs, device="cpu")
    np.testing.assert_array_equal(m._storage_index, jm._storage_index)
    m._state = state_from_numpy(
        {f: np.asarray(getattr(jm._state, f)) for f in jm._state._fields}, "cpu")
    m.last_bounds = list(jm.last_bounds)
    return m


@pytest.fixture(scope="module")
def models(toy_corpus, toy_dictionary, toy_metadata):
    train = toy_corpus.train_docs
    kwargs = dict(documents=train, dictionary=toy_dictionary, K=3,
                  X=toy_metadata[: len(train)], max_em_iter=4, init_type="random",
                  model_type="STM", seed=123456)
    jm = JaxSTM(**kwargs)
    jm.expectation_maximization(saving=False)
    return jm, _carry(jm, **kwargs)


@pytest.fixture(scope="module")
def content_models(toy_corpus, toy_dictionary):
    train = toy_corpus.train_docs
    bi = np.random.default_rng(0).integers(0, 2, len(train))
    kwargs = dict(documents=train, dictionary=toy_dictionary, K=3, X=bi.astype(float),
                  content=True, A=2, beta_index=bi, kappa_interactions=True, max_em_iter=2,
                  init_type="random", model_type="STM", seed=123456)
    jm = JaxSTM(**kwargs)
    jm.expectation_maximization(saving=False)
    return jm, _carry(jm, **kwargs)


METHODS = [
    ("label_topics", lambda m: m.label_topics(n=5)),
    ("frex", lambda m: m.frex(w=0.4)),
    ("find_thoughts", lambda m: m.find_thoughts([0, 2], n=3)),
    ("find_topic", lambda m: m.find_topic([m.dictionary[3], m.dictionary[11]], n=3)),
    ("exclusivity", lambda m: m.exclusivity(M=5)),
    ("semantic_coherence", lambda m: m.semantic_coherence(M=5)),
    ("topic_quality", lambda m: m.topic_quality(M=5)),
    ("to_ldavis", lambda m: m.to_ldavis(R=6, lambda_step=0.25)),
    ("topic_corr", lambda m: m.topic_corr("simple", cutoff=0.0)),
    ("topic_corr_huge", lambda m: m.topic_corr("huge", n_lambda=4, n_subsamples=4)),
    ("check_residuals", lambda m: m.check_residuals()),
    ("summary", lambda m: m.summary(n=4, print_summary=False)),
]


@pytest.mark.parametrize("name,call", METHODS, ids=[n for n, _ in METHODS])
def test_stm_method_matches_jax(name, call, models):
    jm, m = models
    _same(call(m), call(jm))


@pytest.mark.parametrize("name,call", [
    ("sage_labels", lambda m: m.sage_labels(n=4)),
    ("label_topics", lambda m: m.label_topics(n=4)),
    ("frex", lambda m: m.frex()),
    ("exclusivity", lambda m: m.exclusivity(M=5)),
    ("check_residuals", lambda m: m.check_residuals()),
    ("to_ldavis", lambda m: m.to_ldavis(R=5, lambda_step=0.5)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_content_stm_method_matches_jax(name, call, content_models):
    jm, m = content_models
    _same(call(m), call(jm))


def test_stm_method_errors(models):
    _, m = models
    with pytest.raises(ValueError, match="content model"):
        m.sage_labels()
    with pytest.raises(ValueError, match="'simple' or 'huge'"):
        m.topic_corr(method="nope")
    fresh = STM(m._corpus, m.dictionary, K=3, init_type="random", device="cpu")
    assert fresh.summary(print_summary=False).endswith("(not fitted yet)")


@pytest.mark.parametrize("which", ["plain", "content"])
@pytest.mark.parametrize("return_eta", [False, True], ids=["theta", "eta"])
def test_simulate_theta_reproduces_jax_draws(which, return_eta, models, content_models):
    """Same z from ``default_rng(seed)`` in both packages, so the draws
    themselves agree, not only their moments.  Tolerance 1e-4 on eta:
    both compute H in float32 from the same state, factor it and solve
    one triangular system; the measured gap on this fit is 1.2e-7 on eta (values up to
    1.5) and 6e-8 on theta: one float32 rounding.  chunk=16 gives
    three chunks with a zero-padded last one."""
    jax_sim, port_sim = _both("effects", "simulate_theta")
    jm, m = models if which == "plain" else content_models
    want = jax_sim(jm, n_draws=5, seed=3, chunk=16, return_eta=return_eta)
    got = port_sim(m, n_draws=5, seed=3, chunk=16, return_eta=return_eta)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert got.shape == (5, m._corpus.N, 2 if return_eta else 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    if not return_eta:
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_estimate_effect_composition_matches_jax(models):
    jax_fn, port_fn = _both("effects", "estimate_effect_composition")
    jm, m = models
    want, got = jax_fn(jm, n_draws=6, seed=1, chunk=16), port_fn(m, n_draws=6, seed=1, chunk=16)
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            # float32 draws (1e-4 apart at most) through a float64 OLS
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-5, err_msg=k)
        else:
            assert got[k] == want[k], k
    with pytest.raises(ValueError, match="without covariates"):
        port_fn(STM(m._corpus, m.dictionary, K=3, init_type="random", device="cpu"))


def test_simulate_theta_on_a_streamed_fit(toy_corpus, toy_dictionary, toy_metadata):
    """A streamed model keeps no corpus on the device (``_data`` is
    None); the analysis reads its reassembled state all the same."""
    train = toy_corpus.train_docs
    m = STM(train, toy_dictionary, K=3, X=toy_metadata[: len(train)], max_em_iter=2,
            init_type="random", stream_parts=2, device="cpu")
    m.expectation_maximization()
    draws = port_eval.simulate_theta(m, n_draws=3, chunk=32)
    assert draws.shape == (3, len(train), 3) and np.isfinite(draws).all()
    assert np.isfinite(m.check_residuals()["dispersion"])
    assert len(m.label_topics(n=3)[0]) == 3


def test_permutation_test_refits_through_the_port(toy_corpus):
    port_fn = _both("effects", "permutation_test")[1]
    docs = toy_corpus.train_docs
    treat = np.random.default_rng(2).integers(0, 2, len(docs)).astype(float)
    res = port_fn(docs, treat, K=3, nruns=2, seed=0, init_type="random", max_em_iter=2,
                  device="cpu")
    assert set(res) == {"ref", "permuted", "pvalue"} and len(res["permuted"]) == 2
    assert 0 < res["pvalue"] <= 1 and np.isfinite(res["ref"]["coef"])
    with pytest.raises(ValueError, match="treatment has"):
        port_fn(docs, treat[:-1], K=3, device="cpu")


# ---------------------------------------------------------------------------
# plots: rendered with the Agg backend into tmp_path
# ---------------------------------------------------------------------------

_SELECT = {"runs": [{"semcoh_topics": [-3.0, -2.0], "exclusivity_topics": [8.0, 9.0],
                     "coherence": -2.5, "exclusivity": 8.5}] * 2, "kept": [0, 1],
           "selected": 1}
_SEARCH = {3: dict(heldout=-7.0, dispersion=1.2, coherence=-30.0, bound=-1e4),
           "5": dict(heldout=-6.8, dispersion=1.0, coherence=-33.0, bound=-9e3)}
_REMOVED = dict(threshold=[1, 2, 3], words_removed=[0, 5, 9], tokens_removed=[0, 7, 30],
                docs_removed=[0, 0, 1])

PLOTS = [
    ("diagnostics", "plot_topic_quality", lambda f, i, p: f(i["beta"], i["docs"], M=5, path=p,
                                                            theta=i["theta"])),
    ("align", "plot_alignment", lambda f, i, p: f(
        port_eval.align_topics([i["beta"], i["beta3"][1]]), run_labels=["a", "b"], path=p)),
    ("predict", "plot_topic_lasso", lambda f, i, p: f(
        port_eval.topic_lasso(i["theta"], i["y"], nlambda=8, nfolds=3), path=p)),
    ("graph", "plot_topic_graph", lambda f, i, p: f(i["sigma"], cutoff=0.0, path=p)),
    ("graph", "plot_topic_graph", lambda f, i, p: f(
        graph=port_eval.topic_graph_huge(i["theta"], n_lambda=4, n_subsamples=4), path=p)),
    ("plots", "display_props", lambda f, i, p: f(i["theta"], path=p)),
    ("plots", "plot_convergence", lambda f, i, p: f([-100, -50, -48], path=p)),
    ("plots", "plot_topic_words", lambda f, i, p: f(i["beta"], i["vocab"], topics=[0, 2], n=5,
                                                    path=p)),
    ("plots", "plot_word_frequencies", lambda f, i, p: f(i["docs"], i["vocab"], n=10, path=p)),
    ("plots", "plot_tsne_tfidf", lambda f, i, p: f(i["docs"], labels=i["aspect"],
                                                   perplexity=5.0, path=p)),
    ("plots", "plot_heldout_by_k", lambda f, i, p: f({"STM": {10: -7.1, 20: -6.9}}, path=p)),
    ("plots", "plot_removed", lambda f, i, p: f(_REMOVED, path=p)),
    ("plots", "plot_perspectives", lambda f, i, p: f(i["beta"], i["vocab"], (0, 1), n=10,
                                                     path=p)),
    ("plots", "plot_perspectives", lambda f, i, p: f(i["beta3"], i["vocab"], 2, aspects=(0, 1),
                                                     n=10, path=p)),
    ("plots", "plot_search_k", lambda f, i, p: f(_SEARCH, path=p)),
    ("plots", "plot_select_model", lambda f, i, p: f(_SELECT, path=p)),
    ("plots", "plot_quote", lambda f, i, p: f(["first document text", "x" * 2000], maxlen=100,
                                              path=p)),
    ("plots", "plot_cloud", lambda f, i, p: f(i["beta"][0], i["vocab"], max_words=20, path=p)),
    ("plots", "plot_theta_hist", lambda f, i, p: f(i["theta"], topics=[0, 1], path=p)),
    ("plots", "plot_topic_summary", lambda f, i, p: f(i["theta"], i["beta"], i["vocab"],
                                                      path=p)),
    ("effects", "plot_effect", lambda f, i, p: f(
        port_eval.estimate_effect(i["theta"], i["x"]), path=p)),
    ("effects", "plot_effect_pointestimate", lambda f, i, p: f(
        port_eval.estimate_effect(i["theta"], i["aspect"]), 1, [0, 1], path=p)),
    ("effects", "plot_effect_continuous", lambda f, i, p: f(
        port_eval.estimate_effect(i["theta"], i["x"]), 1, np.linspace(-1, 1, 7), topics=[0, 1],
        path=p)),
    ("effects", "plot_effect_difference", lambda f, i, p: f(
        port_eval.estimate_effect(i["theta"], i["aspect"]), 1, 0, 1, path=p)),
    ("effects", "plot_content_effect", lambda f, i, p: f(
        port_eval.estimate_content_effect(i["beta3"], i["theta"], i["doc_lengths"], i["aspect"],
                                          vocab=i["vocab"]), topic_pos=1, n=4, path=p)),
    ("effects", "plot_permutation_test", lambda f, i, p: f(
        {"ref": {"coef": 0.2, "ci": [0.1, 0.3], "topic": 0},
         "permuted": [{"coef": 0.01, "ci": [-0.1, 0.1], "topic": 1}] * 3, "pvalue": 0.25},
        path=p)),
]


@pytest.mark.parametrize("module,name,call", PLOTS,
                         ids=[f"{n}-{k}" for k, (_, n, _) in enumerate(PLOTS)])
def test_plot_renders(module, name, call, inp, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fn = _both(module, name)[1]
    path = str(tmp_path / f"{name}.png")
    fig = call(fn, inp, path)
    assert fig is not None and os.path.getsize(path) > 0
    plt.close("all")


def test_display_props_of_the_generator_renders(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    gen = CorpusCreation(n_topics=3, n_docs=12, n_words=20, V=60, seed=1)
    gen.generate_documents()
    path = str(tmp_path / "props.png")
    assert gen.display_props(path=path) is not None and os.path.getsize(path) > 0
