"""The port's linear algebra and finalize (strutopy_tpu_torch/ops/linalg.py,
ops/stages.py::chol_pd_inverse, ops/estep.py::_finalize_chunk) against the JAX
package on the same numpy inputs."""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from strutopy_tpu.ops import estep as jax_estep
from strutopy_tpu.ops import linalg as jax_linalg
from strutopy_tpu_torch.ops import estep, linalg, stages
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "nan_bisect_H.npz")


def _spd(rng, P, scale=1.0):
    A = rng.normal(0, 0.3, (P, P))
    return (scale * (np.eye(P) + A @ A.T)).astype(np.float32)


@pytest.mark.parametrize("case", ["spd", "indefinite"])
def test_precompute_sigma_matches_jax(case):
    rng = np.random.default_rng(0)
    sigma = _spd(rng, 12)
    if case == "indefinite":
        # fails the plain factorization: exercises the make_pd rung
        sigma = sigma - 2.5 * np.eye(12, dtype=np.float32)
    si0, se0 = jax_linalg.precompute_sigma(jnp.asarray(sigma))
    si1, se1 = linalg.precompute_sigma(torch.tensor(sigma))
    # float32 factorizations by two LAPACK paths (solve_triangular vs
    # cholesky_inverse): rounding of a condition-number-sized product
    np.testing.assert_allclose(si1.numpy(), np.asarray(si0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(se1), float(se0), rtol=1e-6)
    np.testing.assert_array_equal(si1.numpy(), si1.numpy().T)


def test_make_pd_matches_jax():
    rng = np.random.default_rng(1)
    M = rng.normal(0, 1, (3, 7, 7)).astype(np.float32)
    M = M + np.transpose(M, (0, 2, 1))
    # the row sums of |M| run in another order: float32 rounding only
    np.testing.assert_allclose(
        linalg.make_pd(torch.tensor(M)).numpy(),
        np.asarray(jax_estep._make_pd_batched(jnp.asarray(M))), rtol=1e-6)


def _jax_rungs(H):
    """Which rung the JAX ladder takes for each matrix: the first whose
    ``jnp.linalg.cholesky`` factor is finite (estep.py:533-549)."""
    H = jnp.asarray(H)
    eye = jnp.eye(H.shape[-1], dtype=H.dtype)[None]
    H2 = jax_estep._make_pd_batched(H)
    j4 = 1e-3 * jnp.max(jnp.abs(H2), axis=(1, 2))
    cands = [H, H2, H2 + 1e-5 * eye, H2 + j4[:, None, None] * eye]
    ok = [np.isfinite(np.asarray(jnp.linalg.cholesky(c))).all(axis=(1, 2)) for c in cands]
    return np.where(ok[0], 1, np.where(ok[1], 2, np.where(ok[2], 3, 4)))


def _ladder_batch():
    """One matrix for each rung: PD; indefinite but diagonally
    repairable; singular after the repair (rung 3's 1e-5 jitter
    suffices); the same at scale 1e6, where 1e-5 is below float32
    resolution and only the scale-aware rung 4 factors it."""
    pd = np.array([[2.1, 0.1, 0.1], [0.1, 2.1, 0.1], [0.1, 0.1, 2.1]])
    repairable = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.5], [0.0, 0.5, 3.0]])
    singular = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    return np.stack([pd, repairable, singular, 1e6 * singular]).astype(np.float32)


def test_ladder_takes_the_jax_rung_for_each_matrix():
    H = _ladder_batch()
    L, _nu, rung = stages.chol_pd_inverse(torch.tensor(H), inverse=False)
    np.testing.assert_array_equal(_jax_rungs(H), [1, 2, 3, 4])
    np.testing.assert_array_equal(rung.numpy(), _jax_rungs(H))
    want = np.asarray(jax_estep._chol_pd_batched(jnp.asarray(H)))
    # the same factor to float32 rounding (scaled by the 1e6 entries)
    np.testing.assert_allclose(L.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("repair", [False, True])
def test_ladder_on_the_barely_pd_fixture(repair):
    """The five dumped Hessians of tests/fixtures/nan_bisect_H.npz (raw,
    and after the make_pd rung): the same rung as JAX for each, and a
    finite factor."""
    H = np.load(FIXTURE)["Hs"].astype(np.float32)
    if repair:
        H = np.asarray(jax_estep._make_pd_batched(jnp.asarray(H)))
    L, _nu, rung = stages.chol_pd_inverse(torch.tensor(H), inverse=False)
    np.testing.assert_array_equal(rung.numpy(), _jax_rungs(H))
    assert torch.isfinite(L).all()
    want = np.asarray(jax_estep._chol_pd_batched(jnp.asarray(H)))
    np.testing.assert_allclose(L.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("nu_method", ["chol", "blocked"])
def test_finalize_chunk_matches_jax(nu_method):
    rng = np.random.default_rng(2)
    B, K, L = 16, 9, 64
    beta = rng.dirichlet(np.ones(300), size=K)
    words = np.stack([rng.choice(300, L, replace=False) for _ in range(B)])
    beta_doc = np.stack([beta[:, w] for w in words]).astype(np.float32)
    counts = rng.integers(0, 4, (B, L)).astype(np.float32)
    eta = rng.normal(0, 0.5, (B, K - 1)).astype(np.float32)
    mu = rng.normal(0, 0.3, (B, K - 1)).astype(np.float32)
    doc_w = np.ones(B, np.float32)
    doc_w[-2:] = 0.0  # padding documents contribute nothing
    sigma = _spd(rng, K - 1)
    si, se = jax_linalg.precompute_sigma(jnp.asarray(sigma))
    Nd = counts.sum(1)
    want = jax_estep._finalize_chunk(
        jnp.asarray(eta), jnp.asarray(beta_doc), jnp.asarray(counts), jnp.asarray(mu),
        jnp.asarray(doc_w), si, se, jnp.asarray(Nd), nu_method=nu_method)
    T = torch.tensor
    got = estep._finalize_chunk(T(eta), T(beta_doc), T(counts), T(mu), T(doc_w),
                                T(np.asarray(si)), T(np.asarray(se)), T(Nd))
    # float32 model quantities by another factorization route
    for name, a, b, tol in zip(("theta", "nu", "bound", "phi"), got, want,
                               (1e-6, 1e-5, 1e-5, 1e-5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol,
                                   err_msg=name)
    assert (got[2][-2:] == 0).all() and (got[1][-2:] == 0).all()


def test_finalize_hessian_is_float32_not_bf16():
    """The finalize's Hessian is the float32 one: the in-loop bf16
    operand must not leak into nu or the bound."""
    rng = np.random.default_rng(3)
    B, K, L = 4, 6, 32
    bd = torch.tensor(rng.dirichlet(np.ones(L), size=(B, K)).astype(np.float32))
    c = torch.tensor(rng.integers(1, 5, (B, L)).astype(np.float32))
    eta = torch.tensor(rng.normal(0, 0.5, (B, K - 1)).astype(np.float32))
    mu = torch.zeros(B, K - 1)
    si = torch.eye(K - 1)
    H32 = stages.f_g_H_batched(eta, bd, c, mu, si, c.sum(1), bf16=False)[2]
    Hbf = stages.f_g_H_batched(eta, bd, c, mu, si, c.sum(1), bf16=True)[2]
    assert not torch.equal(H32, Hbf)
    _, nu, _, _ = estep._finalize_chunk(eta, bd, c, mu, torch.ones(B), si,
                                        torch.zeros(()), c.sum(1))
    np.testing.assert_allclose(nu.numpy(), torch.linalg.inv(H32).numpy(),
                               rtol=1e-4, atol=1e-6)
