"""The port's M-step (strutopy_tpu_torch/ops/mstep.py) against the JAX
package's ops/mstep.py on the same numpy inputs."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from strutopy_tpu.ops import mstep as jax_mstep
from strutopy_tpu_torch.ops import mstep

N, KM1 = 40, 6


def _X(kind, rng):
    if kind == "none":
        return None
    if kind == "binary":
        return rng.integers(0, 2, N).astype(np.float64)
    if kind == "categorical":  # one-hot encoded: 3 levels
        return rng.integers(0, 3, N).astype(np.float64) * 2.5
    return rng.normal(0, 1, (N, 2))  # numeric, two columns


def _doc_ok():
    ok = np.ones(N, bool)
    ok[-4:] = False  # padding documents
    return ok


def _designs(kind, seed=0, ridge_alpha=0.1, fit_intercept=True):
    rng = np.random.default_rng(seed)
    X = _X(kind, rng)
    D0, d0 = jax_mstep.make_prevalence_design(X, _doc_ok(), fit_intercept=fit_intercept,
                                              ridge_alpha=ridge_alpha)
    D1, d1 = mstep.make_prevalence_design(X, _doc_ok(), fit_intercept=fit_intercept,
                                          ridge_alpha=ridge_alpha, device="cpu")
    return (D0, d0), (D1, d1)


@pytest.mark.parametrize("kind", ["none", "binary", "categorical", "numeric"])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_make_prevalence_design_matches_jax(kind, fit_intercept):
    (D0, d0), (D1, d1) = _designs(kind, fit_intercept=fit_intercept)
    # numpy float64 on the host in both packages: identical
    np.testing.assert_array_equal(D1, D0)
    for name in ("DtD", "pen_mask", "n_docs", "pinv_ols", "inv_ridge"):
        np.testing.assert_array_equal(getattr(d1, name).numpy(),
                                      np.asarray(getattr(d0, name)), err_msg=name)
    assert d1.built_ridge_alpha == d0.built_ridge_alpha


def _moments(seed=1, kind="binary"):
    rng = np.random.default_rng(seed)
    (D0, d0), (D1, d1) = _designs(kind, seed=seed)
    eta = rng.normal(0, 1, (N, KM1)).astype(np.float32)
    eta[-4:] = 0
    m0 = jax_mstep.eta_moments(jnp.asarray(D0), jnp.asarray(eta))
    m1 = mstep.eta_moments(torch.tensor(D1), torch.tensor(eta))
    return eta, (D0, d0, m0), (D1, d1, m1)


def test_eta_moments_match_jax():
    _eta, (_, _, m0), (_, _, m1) = _moments()
    np.testing.assert_allclose(m1.Dt_eta.numpy(), np.asarray(m0.Dt_eta), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(m1.eta_sum.numpy(), np.asarray(m0.eta_sum), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("model_type,mode,ridge_alpha", [
    ("CTM", "ols", 0.1),
    ("STM", "ols", 0.1),
    ("STM", "ridge", 0.1),  # the host inverse built for this alpha
    ("STM", "ridge", 0.7),  # another alpha: solved on the device
    ("STM", "lasso", 0.1),
])
def test_update_prevalence_and_mu_match_jax(model_type, mode, ridge_alpha):
    _eta, (D0, d0, m0), (D1, d1, m1) = _moments(kind="categorical")
    g0, mm0 = jax_mstep.update_prevalence(m0, d0, model_type, mode, ridge_alpha=ridge_alpha,
                                          lasso_alpha=0.05)
    g1, mm1 = mstep.update_prevalence(m1, d1, model_type, mode, ridge_alpha=ridge_alpha,
                                      lasso_alpha=0.05)
    # float32 solves of the same normal equations; FISTA's 600 steps
    # accumulate float32 rounding in another order
    tol = 1e-4 if mode == "lasso" else 1e-5
    np.testing.assert_allclose(g1.numpy(), np.asarray(g0), rtol=tol, atol=tol)
    ok = _doc_ok()
    mu0 = jax_mstep.compute_mu(jnp.asarray(D0), g0, mm0, jnp.asarray(ok), model_type)
    mu1 = mstep.compute_mu(torch.tensor(D1), g1, mm1, torch.tensor(ok), model_type)
    np.testing.assert_allclose(mu1.numpy(), np.asarray(mu0), rtol=tol, atol=tol)
    assert (mu1[-4:] == 0).all()


def test_fista_lasso_matches_jax():
    rng = np.random.default_rng(4)
    D = rng.normal(0, 1, (30, 4))
    y = D @ np.array([[1.0, 0.0], [0.0, -2.0], [0.5, 0.0], [0.0, 0.0]]) + 0.1 * rng.normal(
        0, 1, (30, 2))
    args = (D.T @ D, D.T @ y, np.array([0.0, 1, 1, 1]))
    w0 = jax_mstep._fista_lasso(*(jnp.asarray(a, jnp.float32) for a in args), 30.0, 0.1)
    w1 = mstep._fista_lasso(*(torch.tensor(a, dtype=torch.float32) for a in args), 30.0, 0.1)
    np.testing.assert_allclose(w1.numpy(), np.asarray(w0), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sigma_prior", [0.0, 0.3])
def test_residual_moment_and_sigma_match_jax(sigma_prior):
    rng = np.random.default_rng(5)
    eta = rng.normal(0, 1, (N, KM1)).astype(np.float32)
    mu = rng.normal(0, 0.5, (N, KM1)).astype(np.float32)
    A = rng.normal(0, 0.2, (KM1, KM1))
    sigma_ss = (A @ A.T).astype(np.float32)
    r0 = jax_mstep.residual_moment(jnp.asarray(eta), jnp.asarray(mu))
    r1 = mstep.residual_moment(torch.tensor(eta), torch.tensor(mu))
    np.testing.assert_allclose(r1.numpy(), np.asarray(r0), rtol=1e-5, atol=1e-5)
    s0 = jax_mstep.update_sigma(r0, jnp.asarray(sigma_ss), jnp.asarray(36.0), sigma_prior)
    s1 = mstep.update_sigma(torch.tensor(np.asarray(r0)), torch.tensor(sigma_ss),
                            torch.tensor(36.0), sigma_prior)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s0), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(s1.numpy(), s1.numpy().T)


@pytest.mark.parametrize("smoothing", [0.0, 0.05])
def test_update_beta_lda_matches_jax(smoothing):
    rng = np.random.default_rng(6)
    beta_ss = rng.gamma(0.3, 1.0, (5, 80)).astype(np.float32)
    beta_ss[:, :7] = 0  # words no document used
    beta_ss[3] = 0  # an empty topic row stays zero without smoothing
    b0 = jax_mstep.update_beta_lda(jnp.asarray(beta_ss), smoothing)
    b1 = mstep.update_beta_lda(torch.tensor(beta_ss), smoothing)
    np.testing.assert_allclose(b1.numpy(), np.asarray(b0), rtol=1e-6, atol=1e-9)
