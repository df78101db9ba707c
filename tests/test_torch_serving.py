"""The port's model artifacts and serving (strutopy_tpu_torch/models/
serving.py, STM.transform, STM.save_model, corpus/io.py) against the
JAX package: artifacts written by either package are read by the other,
and both serve the same theta for the same new documents.

Tolerances between the two packages' E-steps: eta within 5e-3, the
bound tests/test_pallas.py:43 and :76 set between two Newton paths, on
every document both bring below 10 grad_tol (above g's float32 floor;
a document one path leaves stalled at the floor ends where its path
took it, ROADMAP Queue C); theta within 1e-3 (tests/test_torch_estep.py).
"""

import json
import os

import numpy as np
import pytest
import torch

from strutopy_tpu.corpus.io import load_model_artifacts as jax_load_model_artifacts
from strutopy_tpu.models.config import STMConfig as JaxConfig
from strutopy_tpu.models.serving import ThetaServer as JaxThetaServer
from strutopy_tpu.models.serving import infer_from_artifacts as jax_infer_from_artifacts
from strutopy_tpu.models.stm import STM as JaxSTM
from strutopy_tpu_torch import STM, STMConfig, ThetaServer, infer_from_artifacts
from strutopy_tpu_torch.corpus.bow import pad_corpus
from strutopy_tpu_torch.corpus.io import load_model_artifacts
from strutopy_tpu_torch.ops import stages
from strutopy_tpu_torch.ops.estep import _gather_beta
from strutopy_tpu_torch.ops.linalg import precompute_sigma
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


# the JAX Newton body on its Pallas stage kernels (interpret mode on the
# CPU): the semantics the port's kernels carry (ROADMAP Queue C)
STAGE_KERNELS = dict(pallas_fgh=True, pallas_cg=True, pallas_ls=True)
K, V = 5, 200
WIKI = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "artifacts", "wiki_reference_model", "50")


def _docs(seed, N, beta, n_words=80):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(N):
        draw = rng.multinomial(n_words, rng.dirichlet(np.full(beta.shape[0], 0.5)) @ beta)
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    return docs, rng.integers(0, 2, N).astype(np.float64)


def _true_beta(seed=0):
    return np.random.default_rng(seed).dirichlet(np.full(V, 0.1), size=K)


def _beta0(seed=11):
    g = np.random.RandomState(seed).gamma(0.1, 1.0, (K, V))
    return g / g.sum(axis=1, keepdims=True)


def _jax_config(model_type="STM"):
    return JaxConfig(K=K, init_type="random", max_em_iter=3, batch_size=16,
                     convergence_threshold=0.0, model_type=model_type, **STAGE_KERNELS)


def _fit_both(model_type="STM"):
    """The same 3-iteration fit (N=64, binary X) in both packages from one
    beta; the port configured from the JAX configuration's JSON."""
    docs, X = _docs(1, 64, _true_beta())
    vocab = [f"w{i}" for i in range(V)]
    jcfg = _jax_config(model_type)
    jm = JaxSTM(docs, dictionary=vocab, K=K, X=X, config=jcfg, init_beta=_beta0())
    jm.expectation_maximization(saving=False)
    m = STM(docs, dictionary=vocab, K=K, X=X, config=STMConfig.from_json(jcfg.to_json()),
            init_beta=_beta0(), device="cpu")
    m.expectation_maximization()
    return jm, m


def _prior(model, X):
    return np.c_[np.ones(len(X)), X] @ np.asarray(model.gamma, np.float64).T


def _grad_norm(beta, sigma, mu, docs, eta):
    """max|g| per document at ``eta`` under (beta, sigma, mu), float32."""
    corpus = pad_corpus(docs, V=beta.shape[1])
    T = torch.tensor
    bd = _gather_beta(T(np.asarray(beta, np.float32)), T(corpus.words))
    siginv, _ = precompute_sigma(T(np.asarray(sigma, np.float32)))
    g = stages.fgh_plain(T(np.asarray(eta, np.float32)), bd, T(corpus.counts),
                         T(np.asarray(mu, np.float32)), siginv, bf16=False)[1]
    return g.abs().amax(1).numpy()


def _assert_same_inference(got, want, model, docs, model_j=None):
    """``model``/``model_j``: (beta, sigma, mu) each side served with (the
    same for both unless the two fits differ)."""
    (theta, eta), (theta_j, eta_j) = got, (np.asarray(want[0]), np.asarray(want[1]))
    assert theta.shape == theta_j.shape and eta.shape == eta_j.shape
    assert np.isfinite(theta).all() and np.allclose(theta.sum(1), 1, atol=1e-5)
    g_p = _grad_norm(*model, docs, eta)
    g_j = _grad_norm(*(model_j or model), docs, eta_j)
    both = (g_p <= 1e-4) & (g_j <= 1e-4)
    # the port leaves no more documents unconverged than JAX, plus one
    # (5% of them on larger requests), and most converge in both
    slack = max(1, int(0.05 * len(docs)))
    assert (g_p > 1e-4).sum() <= (g_j > 1e-4).sum() + slack, (g_p, g_j)
    assert both.sum() >= len(docs) // 2, (g_p, g_j)
    np.testing.assert_allclose(eta[both], eta_j[both], atol=5e-3)
    np.testing.assert_allclose(theta[both], theta_j[both], atol=1e-3)


def test_port_serves_a_jax_saved_model(tmp_path):
    jm, _m = _fit_both()
    jm.save_model(str(tmp_path))
    docs, X = _docs(2, 24, _true_beta())
    want = JaxThetaServer(str(tmp_path)).infer(docs, X=X)
    srv = ThetaServer(str(tmp_path), device="cpu")
    assert srv.cfg == STMConfig.from_json(jm.config.to_json())
    srv.warmup()  # on the CPU: serves one request, builds nothing
    got = srv.infer(docs, X=X)
    _assert_same_inference(got, want, (jm.beta, jm.sigma, _prior(jm, X)), docs)


def test_jax_reads_a_port_saved_model(tmp_path):
    jm, m = _fit_both()
    m.save_model(str(tmp_path))
    art = jax_load_model_artifacts(str(tmp_path))
    for name, value in (("beta", m.beta), ("theta", m.theta), ("sigma", m.sigma),
                        ("eta", m.eta), ("mu", m.mu), ("gamma", m.gamma), ("X", m.X)):
        assert art[name].dtype == value.dtype and np.array_equal(art[name], value), name
    assert art["lower_bound"] == m.last_bounds
    assert art.keys() == load_model_artifacts(str(tmp_path)).keys()
    with open(tmp_path / "stm_config.json") as f:
        raw = f.read()
    assert JaxConfig.from_json(raw) == jm.config.replace(**dict.fromkeys(STAGE_KERNELS, False))
    with open(tmp_path / "vocab.json") as f:
        assert json.load(f) == [f"w{i}" for i in range(V)]
    with open(tmp_path / "fit_health.json") as f:
        assert json.load(f) == {"bound_finite": True, "nonfinite_bound_iters": []}

    docs, X = _docs(3, 24, _true_beta())
    want = jax_infer_from_artifacts(str(tmp_path), docs, X=X)
    got = infer_from_artifacts(str(tmp_path), docs, X=X, device="cpu")
    _assert_same_inference(got, want, (m.beta, m.sigma, _prior(m, X)), docs)


def test_both_packages_write_the_same_files(tmp_path):
    """save_model writes the same file set, and the arrays with the same
    npy headers, in both packages (the values differ by the fits'
    rounding only)."""
    jm, m = _fit_both()
    jm.save_model(str(tmp_path / "jax"))
    m.save_model(str(tmp_path / "port"))
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    for name in files:
        a, b = (tmp_path / d / name for d in ("jax", "port"))
        if name.endswith(".npy"):
            assert a.read_bytes()[:128] == b.read_bytes()[:128], name
        elif name in ("vocab.json", "fit_health.json"):
            assert a.read_bytes() == b.read_bytes(), name
    # the port writes the stage-kernel flags False (it has no fields for
    # them): the JAX package's own JSON for that configuration
    jcfg = jm.config.replace(**dict.fromkeys(STAGE_KERNELS, False))
    assert (tmp_path / "port" / "stm_config.json").read_text() == jcfg.to_json()
    np.testing.assert_allclose(np.load(tmp_path / "port" / "beta_hat.npy"),
                               np.load(tmp_path / "jax" / "beta_hat.npy"), atol=1e-4)


@pytest.mark.parametrize("model_type", ["STM", "CTM"])
def test_transform_matches_jax(model_type):
    jm, m = _fit_both(model_type)
    docs, X = _docs(4, 24, _true_beta())
    want = jm.transform(docs, X=X)
    got = m.transform(docs, X=X)
    if model_type == "STM":
        mu, mu_j = _prior(m, X), _prior(jm, X)
    else:
        mu, mu_j = (np.tile(x.eta.mean(0), (len(docs), 1)) for x in (m, jm))
    _assert_same_inference(got, want, (m.beta, m.sigma, mu), docs,
                           model_j=(jm.beta, jm.sigma, mu_j))


@pytest.fixture(scope="module")
def wiki_request():
    """16 documents drawn from the wiki model's own beta, binary X."""
    beta = np.load(os.path.join(WIKI, "beta_hat.npy")).astype(np.float64)
    docs, X = _docs(5, 16, beta / beta.sum(1, keepdims=True), n_words=150)
    return docs, X


def test_both_servers_on_the_wiki_model(wiki_request):
    """The repo's wiki artifacts (K=50, V=13,852) carry a configuration
    neither package reads (a "dtype" key): both fall back to
    STMConfig(K=50) and serve the same theta."""
    docs, X = wiki_request
    srv = ThetaServer(WIKI, device="cpu")
    assert srv.cfg == STMConfig(K=50) and srv.vocab is None
    got = srv.infer(docs, X=X)
    jsrv = JaxThetaServer(WIKI)
    assert jsrv.cfg == JaxConfig(K=50)
    want = jsrv.infer(docs, X=X)
    gamma = np.load(os.path.join(WIKI, "gamma_hat.npy")).astype(np.float64)
    mu = np.c_[np.ones(len(docs)), X] @ gamma.T
    model = tuple(np.load(os.path.join(WIKI, f"{n}_hat.npy")) for n in ("beta", "sigma"))
    _assert_same_inference(got, want, (*model, mu), docs)


def test_serving_refuses_what_is_not_ported(tmp_path, wiki_request):
    srv = ThetaServer(WIKI, device="cpu")
    # the wiki model has no vocab.json: raw text has nothing to be encoded against
    with pytest.raises(ValueError, match="no vocab.json"):
        srv.infer_text(["some raw text"])
    with pytest.raises(ValueError, match="pass X"):
        srv.infer(wiki_request[0])
    bad = [[(13_852, 1)]]
    with pytest.raises(ValueError, match="word id"):
        srv.infer(bad, X=np.zeros(1))
    np.save(tmp_path / "beta_hat.npy", np.full((2, K, V), 1.0 / V, np.float32))
    np.save(tmp_path / "sigma_hat.npy", np.eye(K - 1, dtype=np.float32))
    # a content model (per-aspect beta) serves only with beta_index
    content = ThetaServer(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="pass beta_index"):
        content.infer([[(3, 1)]])


def test_artifact_loader_refuses_pickled_objects(tmp_path):
    np.save(tmp_path / "beta_hat.npy", np.array([{"a": 1}], dtype=object), allow_pickle=True)
    with pytest.raises(ValueError, match="refusing to unpickle"):
        load_model_artifacts(str(tmp_path))
    (tmp_path / "beta_hat.npy").unlink()
    import pickle

    with open(tmp_path / "lower_bound.pickle", "wb") as f:
        pickle.dump([os.getcwd], f)  # a function: code, not data
    with pytest.raises(pickle.UnpicklingError):
        load_model_artifacts(str(tmp_path))


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu():
    """Every entry point's device defaults to the card; the CPU is a
    choice the caller makes (as every CPU test here does)."""
    import inspect

    from strutopy_tpu_torch.eval.heldout import eval_heldout_torch
    from strutopy_tpu_torch.models.serving import infer_theta
    from strutopy_tpu_torch.ops.spectral import spectral_init
    from strutopy_tpu_torch.pipeline import train_and_eval_heldout
    from strutopy_tpu_torch.utils.checkpoint import load_checkpoint

    for fn in (STM, ThetaServer, infer_theta, infer_from_artifacts, spectral_init,
               train_and_eval_heldout, eval_heldout_torch, load_checkpoint):
        param = inspect.signature(fn).parameters["device"]
        assert param.kind is inspect.Parameter.KEYWORD_ONLY, fn
        assert param.default == "cuda", fn
