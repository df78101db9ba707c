"""The port's content model (kappa regression, per-aspect beta, aspect
E-step, content serving) against the JAX package on the same numpy
inputs, on the CPU.

Tolerances: the kappa solves are float32 Newton iterations whose
Hessians sum over the design rows in another order (atol 1e-4 on kappa
under the model's penalty of 250); beta_ss is a scatter-add (rtol 1e-5);
fits follow tests/test_torch_em.py (bounds 1e-4 relative, beta rtol
1e-3 above an absolute floor).
"""

import os

import numpy as np
import pytest
import sklearn.linear_model
import jax.numpy as jnp
import torch

from strutopy_tpu.models.config import STMConfig as JaxConfig
from strutopy_tpu.models.serving import ThetaServer as JaxThetaServer
from strutopy_tpu.models.stm import STM as JaxSTM
from strutopy_tpu.ops import estep as jax_estep
from strutopy_tpu.ops import mstep as jax_mstep
from strutopy_tpu_torch import STM, STMConfig, ThetaServer, infer_from_artifacts
from strutopy_tpu_torch.ops import estep, mstep
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


STAGE_KERNELS = dict(pallas_fgh=True, pallas_cg=True, pallas_ls=True)
K, V, A = 4, 150, 2


@pytest.mark.parametrize("k,a,inter", [(4, 1, False), (3, 2, False), (3, 2, True),
                                       (5, 3, True)])
def test_build_kappa_design_matches_jax(k, a, inter):
    np.testing.assert_array_equal(mstep.build_kappa_design(k, a, inter),
                                  jax_mstep.build_kappa_design(k, a, inter))


def _glm_inputs(seed=5, Vc=24, inter=True):
    rng = np.random.default_rng(seed)
    Xd = mstep.build_kappa_design(K, A, inter).astype(np.float32)
    R, P = Xd.shape
    Y = rng.gamma(1.0, 2.0, (R, Vc)).astype(np.float32)
    Y[:, ::5] = 0.0  # silent words
    m = np.log(rng.dirichlet(np.ones(Vc))).astype(np.float32)
    offset = np.log(Y.sum(1) + 1.0).astype(np.float32)
    return Y, m, Xd, offset, R, P


def _both_batches(Y, m, Xd, offset, R, W0, alpha=250.0, iters=40, **kw):
    Wj, nj = jax_mstep._poisson_newton_batch(
        jnp.asarray(Y), jnp.asarray(m), jnp.asarray(Xd), jnp.asarray(offset),
        jnp.asarray(alpha, jnp.float32), jnp.asarray(float(R), jnp.float32), iters,
        jnp.asarray(W0), **kw)
    T = torch.tensor
    W, n = mstep._poisson_newton_batch(T(Y), T(m), T(Xd), T(offset), alpha, float(R), iters,
                                       T(W0), **kw)
    return W.numpy(), n, np.asarray(Wj), int(nj)


def test_poisson_newton_batch_matches_jax():
    Y, m, Xd, offset, R, P = _glm_inputs()
    W, n, Wj, nj = _both_batches(Y, m, Xd, offset, R, np.zeros((P, Y.shape[1]), np.float32))
    np.testing.assert_allclose(W, Wj, atol=1e-4)
    # the last step may or may not pass the float32 floor of the objective
    assert abs(n - nj) <= 1 and 0 < n < 40
    # the optimum: the gradient of the objective vanishes
    z = m[None] + offset[:, None] + Xd @ W.astype(np.float64)
    g = Xd.T @ (np.exp(z) - Y) / R + 250.0 * W
    assert np.abs(g).max() < 1e-3  # the float32 floor of an objective of size ~10


def _f64_optimum(Y, m, Xd, offset, R, alpha=250.0):
    """Every word's optimum of the penalized Poisson objective in float64
    (exact Newton from zero to max|g| < 1e-12; the objective is strictly
    convex, and near its optimum a full step always decreases it)."""
    Y, Xd = Y.astype(np.float64), Xd.astype(np.float64)
    base = m.astype(np.float64)[None, :] + offset.astype(np.float64)[:, None]
    W = np.zeros((Xd.shape[1], Y.shape[1]))
    for _ in range(100):
        lam = np.exp(base + Xd @ W)
        G = Xd.T @ (lam - Y) / R + alpha * W
        if np.abs(G).max() < 1e-12:
            break
        for v in range(W.shape[1]):
            H = (Xd * lam[:, v:v + 1]).T @ Xd / R + alpha * np.eye(Xd.shape[1])
            W[:, v] -= np.linalg.solve(H, G[:, v])
    return W


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_poisson_newton_warm_start_and_ftol_rel(pkg):
    """Each package: a warm start that meets tol runs no iteration and
    moves nothing; a near start is solved again, within a step of the
    cold solve's count, to the float64 optimum (atol 1e-4 on kappa, the
    packages' old distance from each other; the port now also takes the
    steps whose decrease its objective's float32 rounding hides, so
    their counts part); ``ftol_rel > 0`` freezes a word after the first
    step that it takes, in both packages alike."""
    which = 0 if pkg == "port" else 2
    Y, m, Xd, offset, R, P = _glm_inputs(seed=9)

    def solve(W0, **kw):
        out = _both_batches(Y, m, Xd, offset, R, W0, **kw)
        return out[which], out[which + 1], out[2 - which]

    cold = np.zeros((P, Y.shape[1]), np.float32)
    W, n_cold, _ = solve(cold, tol=1e-5)
    W2, n_warm, _ = solve(W, tol=1e-3)
    assert n_warm == 0
    np.testing.assert_array_equal(W2, W)
    near = (W + 0.05).astype(np.float32)
    W3, n_near, _ = solve(near, tol=1e-5)
    assert 0 < n_near <= n_cold + 1
    np.testing.assert_allclose(W3, _f64_optimum(Y, m, Xd, offset, R), atol=1e-4)
    W4, n4, W4_other = solve(cold, tol=1e-5, ftol_rel=1e-3)
    assert n4 == 1
    np.testing.assert_allclose(W4, W4_other, atol=1e-4)


def test_poisson_regression_matches_sklearn():
    """tests/test_mstep.py::test_poisson_regression_matches_sklearn for
    the port: the optimality condition with an offset, and sklearn's
    PoissonRegressor without one."""
    rng = np.random.default_rng(5)
    Xd = mstep.build_kappa_design(3, 2, True)
    n = Xd.shape[0]
    w_true = rng.normal(0, 0.5, Xd.shape[1])
    offset = rng.normal(0, 0.2, n)
    m_v = -2.0
    y = rng.poisson(np.exp(m_v + offset + Xd @ w_true) * 50) / 50.0
    T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    w = mstep._poisson_newton_word(T(y), T(m_v), T(Xd), T(offset), 1.0, float(n), 60).numpy()
    z = m_v + offset + Xd @ w.astype(np.float64)
    g = Xd.T @ (np.exp(z) - y) / n + w
    assert np.abs(g).max() < 1e-4
    clf = sklearn.linear_model.PoissonRegressor(fit_intercept=False, alpha=1.0, tol=1e-8,
                                                max_iter=10000)
    clf.fit(Xd, y)
    w2 = mstep._poisson_newton_word(T(y), T(0.0), T(Xd), torch.zeros(n), 1.0, float(n), 60)
    np.testing.assert_allclose(w2.numpy(), clf.coef_, atol=5e-3)


def _beta_ss(seed=6, v=V):
    rng = np.random.default_rng(seed)
    ss = rng.gamma(1.0, 1.0, (A, K, v)).astype(np.float32)
    wc = rng.integers(1, 100, v).astype(np.float32)
    wc[3] = wc[7]  # a tie in the frequency sort
    return ss, wc


@pytest.mark.parametrize("inter,warm", [(False, False), (True, False), (True, True)])
def test_update_beta_content_matches_jax(inter, warm):
    ss, wc = _beta_ss()
    Xd = mstep.build_kappa_design(K, A, inter).astype(np.float32)
    k0 = None
    if warm:
        k0 = np.random.default_rng(1).normal(0, 0.01, (Xd.shape[1], V)).astype(np.float32)
    bj, kj = jax_mstep.update_beta_content(
        jnp.asarray(ss), jnp.asarray(wc), jnp.asarray(Xd), alpha=250.0, iters=30,
        kappa0=None if k0 is None else jnp.asarray(k0))
    b, k = mstep.update_beta_content(
        torch.tensor(ss), torch.tensor(wc), torch.tensor(Xd), alpha=250.0, iters=30,
        kappa0=None if k0 is None else torch.tensor(k0))
    assert b.shape == (A, K, V) and k.shape == (Xd.shape[1], V)
    np.testing.assert_allclose(k.numpy(), np.asarray(kj), atol=1e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(b.numpy().sum(-1), 1.0, atol=1e-4)


def test_update_beta_content_two_chunk_sizes_one_kappa(monkeypatch):
    """Each word freezes on its own, so the chunking changes no word's
    solve (up to the rounding of a matmul of another shape)."""
    ss, wc = _beta_ss(v=300)
    Xd = torch.tensor(mstep.build_kappa_design(K, A, True), dtype=torch.float32)
    assert mstep._kappa_vchunk(300, Xd.shape[1]) == 300
    assert mstep._kappa_vchunk(10_000, 102) == 1024  # 16M floats / 102²
    assert mstep._kappa_vchunk(10_000, 302) == 128
    b1, k1 = mstep.update_beta_content(torch.tensor(ss), torch.tensor(wc), Xd, iters=30)
    seen = []
    real = mstep._poisson_newton_batch

    def spy(Y, *a, **kw):
        seen.append(Y.shape[1])
        return real(Y, *a, **kw)

    monkeypatch.setattr(mstep, "_kappa_vchunk", lambda V, P: 128)
    monkeypatch.setattr(mstep, "_poisson_newton_batch", spy)
    b2, k2 = mstep.update_beta_content(torch.tensor(ss), torch.tensor(wc), Xd, iters=30)
    assert seen == [128, 128, 44]
    np.testing.assert_allclose(k2.numpy(), k1.numpy(), atol=1e-6)
    np.testing.assert_allclose(b2.numpy(), b1.numpy(), rtol=1e-5)


def test_aspect_gather_and_scatter_match_jax():
    rng = np.random.default_rng(2)
    B, L = 6, 9
    beta = rng.random((A, K, V)).astype(np.float32)
    words = rng.integers(0, V, (B, L)).astype(np.int32)
    words[:, -2:] = 0  # padding slots repeat word 0
    aspects = rng.integers(0, A, B).astype(np.int32)
    phi = rng.random((B, K, L)).astype(np.float32)
    bd = estep._gather_beta(torch.tensor(beta), torch.tensor(words), torch.tensor(aspects))
    want = jax_estep._gather_beta(jnp.asarray(beta), jnp.asarray(words), jnp.asarray(aspects))
    assert bd.is_contiguous()
    np.testing.assert_array_equal(bd.numpy(), np.asarray(want))
    ss0 = rng.random((A, K, V)).astype(np.float32)
    got = estep._scatter_phi(torch.tensor(ss0), torch.tensor(phi), torch.tensor(words),
                             torch.tensor(aspects))
    want = jax_estep._scatter_phi(jnp.asarray(ss0), jnp.asarray(phi), jnp.asarray(words),
                                  jnp.asarray(aspects))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def _content_docs(seed=0, N=48, n_words=90):
    rng = np.random.default_rng(seed)
    base = rng.dirichlet(np.full(V, 0.1), size=K)
    tilt = np.exp(rng.normal(0, 0.7, (A, 1, V)))
    beta = base[None] * tilt
    beta /= beta.sum(-1, keepdims=True)
    aspects = rng.integers(0, A, N)
    docs = []
    for d in range(N):
        p = rng.dirichlet(np.full(K, 0.5)) @ beta[aspects[d]]
        draw = rng.multinomial(n_words, p)
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    return docs, aspects.astype(np.float64), aspects.astype(np.int32)


def _beta0(seed=11):
    g = np.random.RandomState(seed).gamma(0.1, 1.0, (K, V))
    return g / g.sum(axis=1, keepdims=True)


def _fit_both(interactions=False, iters=3):
    docs, X, bi = _content_docs()
    vocab = [f"w{i}" for i in range(V)]
    jcfg = JaxConfig(K=K, content=True, A=A, kappa_interactions=interactions, lda_beta=False,
                     init_type="random", max_em_iter=iters, batch_size=16,
                     convergence_threshold=0.0, **STAGE_KERNELS)
    jm = JaxSTM(docs, dictionary=vocab, K=K, X=X, config=jcfg, beta_index=bi,
                init_beta=_beta0())
    jm.expectation_maximization(saving=False)
    m = STM(docs, dictionary=vocab, K=K, X=X, config=STMConfig.from_json(jcfg.to_json()),
            beta_index=bi, init_beta=_beta0(), device="cpu")
    m.expectation_maximization()
    return jm, m


@pytest.fixture(scope="module")
def fits():
    return _fit_both()


@pytest.mark.parametrize("interactions", [False, True])
def test_content_fit_matches_jax(interactions, fits):
    jm, m = fits if not interactions else _fit_both(True)
    assert m.beta.shape == (A, K, V) == jm.beta.shape
    assert m.kappa.shape == jm.kappa.shape == (K + A + (A * K if interactions else 0), V)
    np.testing.assert_allclose(m.last_bounds, jm.last_bounds, rtol=1e-4)
    np.testing.assert_allclose(m.beta, jm.beta, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(m.kappa, jm.kappa, atol=1e-3)
    np.testing.assert_allclose(m.beta.sum(-1), 1.0, atol=1e-4)
    np.testing.assert_array_equal(m.wcounts, jm.wcounts)


def test_constructor_keywords_build_the_content_model():
    """content=True through the keyword surface: A defaults to 2 and the
    LDA update goes off, as in JAX; lda_beta=False alone is the one-aspect
    SAGE model with an identity kappa design."""
    docs, X, bi = _content_docs(N=16)
    m = STM(docs, K=K, X=X, content=True, beta_index=bi, init_type="random", max_em_iter=1,
            device="cpu")
    jm = JaxSTM(docs, K=K, X=X, content=True, beta_index=bi, init_type="random",
                max_em_iter=1)
    assert (m.config.A, m.config.lda_beta) == (jm.config.A, jm.config.lda_beta) == (2, False)
    m.expectation_maximization()
    jm.expectation_maximization(saving=False)
    np.testing.assert_allclose(m.last_bounds, jm.last_bounds, rtol=1e-4)
    s = STM(docs, K=K, lda_beta=False, init_type="random", max_em_iter=2, device="cpu")
    js = JaxSTM(docs, K=K, lda_beta=False, init_type="random", max_em_iter=2)
    s.expectation_maximization()
    js.expectation_maximization(saving=False)
    assert s.beta.shape == js.beta.shape == (K, max(s.V, 1))
    assert s.kappa.shape == js.kappa.shape == (K, s.V)
    np.testing.assert_allclose(s.last_bounds, js.last_bounds, rtol=1e-4)


@pytest.mark.parametrize("bi,msg", [
    (None, "requires beta_index"),
    (np.zeros(5, np.int32), "has 5 entries"),
    (np.full(16, 2, np.int32), r"\[0, A=2\)"),
    (np.full(16, -1, np.int32), r"\[0, A=2\)"),
])
def test_beta_index_guards(bi, msg):
    docs, X, _ = _content_docs(N=16)
    with pytest.raises(ValueError, match=msg):
        STM(docs, K=K, X=X, content=True, beta_index=bi, init_type="random", device="cpu")


def test_each_package_serves_the_other_content_model(tmp_path, fits):
    jm, m = fits
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jm.save_model(jdir)
    m.save_model(tdir)
    kap = np.load(os.path.join(tdir, "kappa_hat.npy"))
    assert kap.shape == (K + A, V) and kap.dtype == np.float32
    np.testing.assert_allclose(kap, np.load(os.path.join(jdir, "kappa_hat.npy")), atol=1e-3)

    docs, X, bi = _content_docs(seed=3, N=24)
    own, _ = ThetaServer(tdir, device="cpu").infer(docs, X=X, beta_index=bi)
    from_jax, _ = ThetaServer(jdir, device="cpu").infer(docs, X=X, beta_index=bi)
    jax_own, _ = JaxThetaServer(jdir).infer(docs, X=X, beta_index=bi)
    jax_from_port, _ = JaxThetaServer(tdir).infer(docs, X=X, beta_index=bi)
    for th in (own, from_jax, jax_own, jax_from_port):
        np.testing.assert_allclose(th.sum(1), 1.0, atol=1e-5)
    # the same artifacts through either package's server: theta within
    # 5e-3, the distance tests/test_torch_serving.py allows eta between
    # two Newton paths (a document stalled at g's float32 floor ends
    # where its path took it)
    np.testing.assert_allclose(from_jax, jax_own, atol=5e-3)
    np.testing.assert_allclose(own, jax_from_port, atol=5e-3)
    # the aspect matters, and transform/infer_from_artifacts agree with the server
    flipped, _ = ThetaServer(tdir, device="cpu").infer(docs, X=X, beta_index=1 - bi)
    assert np.abs(flipped - own).max() > 1e-3
    tr, _ = m.transform(docs, X=X, beta_index=bi)
    np.testing.assert_allclose(tr, own, atol=1e-5)
    fa, _ = infer_from_artifacts(tdir, docs, X=X, beta_index=bi, device="cpu")
    np.testing.assert_allclose(fa, own, atol=1e-6)


def test_content_serving_requires_beta_index(tmp_path, fits):
    _jm, m = fits
    d = str(tmp_path / "m")
    m.save_model(d)
    docs, X, bi = _content_docs(seed=4, N=4)
    srv = ThetaServer(d, device="cpu")
    assert srv.content
    srv.warmup()
    for call in (lambda: srv.infer(docs, X=X),
                 lambda: infer_from_artifacts(d, docs, X=X, device="cpu")):
        with pytest.raises(ValueError, match="pass beta_index"):
            call()
    with pytest.raises(ValueError, match="requires beta_index"):
        m.transform(docs, X=X)
