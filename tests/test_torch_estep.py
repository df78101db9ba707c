"""The port's E-step (strutopy_tpu_torch/ops/estep.py) against the JAX
package's, with the JAX Newton body on its three Pallas stage kernels
(pallas_fgh/cg/ls, interpret mode on the CPU) — the path the port's
kernels replace."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from strutopy_tpu.ops import estep as jax_estep
from strutopy_tpu.ops.linalg import precompute_sigma as jax_precompute_sigma
from strutopy_tpu_torch.ops import estep, stages
from strutopy_tpu_torch.ops.linalg import precompute_sigma
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


STAGE_KERNELS = dict(pallas_fgh=True, pallas_cg=True, pallas_ls=True)


def _corpus(seed=5, N=64, K=9, L=64, V=300):
    """N documents of up to 48 unique words; the last 3 are padding."""
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.full(V, 0.3), size=K).astype(np.float32)
    words = np.stack([rng.choice(V, L, replace=False) for _ in range(N)]).astype(np.int32)
    counts = rng.integers(1, 4, (N, L)).astype(np.float32)
    counts[:, 48:] = 0
    counts[-3:] = 0
    mu = rng.normal(0, 0.3, (N, K - 1)).astype(np.float32)
    mu[-3:] = 0  # padding rows of the design are zero, so is their mu
    sigma = (np.eye(K - 1) + 0.1).astype(np.float32)
    return dict(beta=beta, words=words, counts=counts, doc_ok=counts.sum(1) > 0,
                mu=mu, eta0=np.zeros((N, K - 1), np.float32), sigma=sigma)


def _run_both(x, bf16, batch_size=16, pass1_iters=0, straggler_frac=0.3):
    si, se = jax_precompute_sigma(jnp.asarray(x["sigma"]))
    N = x["words"].shape[0]
    want = jax_estep.run_estep(
        jnp.asarray(x["beta"]), jnp.asarray(x["mu"]), jnp.asarray(x["eta0"]), si, se,
        jnp.asarray(x["words"]), jnp.asarray(x["counts"]), jnp.zeros(N, jnp.int32),
        jnp.asarray(x["doc_ok"]),
        cfg=jax_estep.NewtonConfig(bf16_hessian=bf16, **STAGE_KERNELS),
        batch_size=batch_size, pass1_iters=pass1_iters, straggler_frac=straggler_frac)
    T = torch.tensor
    si2, se2 = precompute_sigma(T(x["sigma"]))
    got = estep.run_estep(
        T(x["beta"]), T(x["mu"]), T(x["eta0"]), si2, se2, T(x["words"]), T(x["counts"]),
        torch.zeros(N, dtype=torch.int32), T(x["doc_ok"]),
        cfg=estep.NewtonConfig(bf16_hessian=bf16),
        batch_size=batch_size, pass1_iters=pass1_iters, straggler_frac=straggler_frac)
    return got, want


def _grad_norm(x, eta, siginv):
    """max|g| per document at ``eta`` (port's float32 gradient)."""
    T = torch.tensor
    bd = T(np.ascontiguousarray(x["beta"][:, x["words"]].transpose(1, 0, 2)))
    counts = T(x["counts"])
    g = stages.f_g_H_batched(T(np.asarray(eta)), bd, counts, T(x["mu"]), siginv,
                             counts.sum(1), bf16=False)[1]
    return g.abs().amax(1).numpy()


def _check_iters(x, siginv, got_iters, want_iters, got_eta, want_eta, grad_tol=1e-5):
    """Newton counts per document.  They cannot agree document by
    document: the convergence test max|g| <= 1e-5 sits at the float32
    noise floor of g (~4e-6 absolute at Nd ~ 100, test_torch_stages.py),
    where the Armijo test decides at rounding level between stopping and
    rounding-size steps.  Each path leaves a few documents stalled short
    of grad_tol, each on different documents: on this corpus the port 3,
    the JAX Pallas path 5 and its XLA path 4 of 64 — the JAX package's
    own paths differ the same way (tests/test_pallas_stages.py:112-119).
    What must hold: the port stalls on no more documents than JAX plus
    5% of them, its stalls stay at the floor's scale (|g| <= 1e-2, as
    JAX's) except where JAX's document is as far off too (the two-pass
    budget overflow, left at its pass-1 eta by design), and the typical
    count is the same."""
    want_iters = np.asarray(want_iters)
    g_port = _grad_norm(x, got_eta, siginv)
    g_jax = _grad_norm(x, want_eta, siginv)
    slack = max(1, int(0.05 * len(g_port)))
    assert (g_port > grad_tol).sum() <= (g_jax > grad_tol).sum() + slack, (g_port, g_jax)
    assert (g_port <= np.maximum(2 * g_jax, 1e-2)).all(), (g_port, g_jax)
    assert abs(np.median(got_iters) - np.median(want_iters)) <= 1


@pytest.mark.parametrize("bf16", [False, True])
def test_batched_newton_matches_jax(bf16):
    x = _corpus(seed=1, N=16)
    si, _ = jax_precompute_sigma(jnp.asarray(x["sigma"]))
    bd = x["beta"][:, x["words"]].transpose(1, 0, 2)
    args = (bd, x["counts"], x["mu"], x["eta0"])
    eta0, it0, done0 = jax_estep._batched_newton(
        *map(jnp.asarray, args), si,
        jax_estep.NewtonConfig(bf16_hessian=bf16, **STAGE_KERNELS))
    eta1, it1, done1 = estep._batched_newton(
        *(torch.tensor(np.ascontiguousarray(a)) for a in args),
        torch.tensor(np.asarray(si)), estep.NewtonConfig(bf16_hessian=bf16))
    # the converged etas agree to the wiggle of grad_tol-level steps
    # (tests/test_pallas_stages.py:185-189)
    np.testing.assert_allclose(eta1.numpy(), np.asarray(eta0), atol=5e-3)
    _check_iters(x, torch.tensor(np.asarray(si)), it1.numpy(), it0, eta1, eta0)
    # a document is left not done only at the max_iters cap
    for it, done in ((it1.numpy(), done1.numpy()), (np.asarray(it0), np.asarray(done0))):
        assert (done | (it == 24)).all()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("pass1_iters", [0, 2], ids=["single_pass", "two_pass"])
def test_run_estep_matches_jax(pass1_iters, bf16):
    x = _corpus()
    # straggler_frac 0.25 of 64 documents = one chunk of 16: with a
    # pass-1 cap of 2 most documents overflow, so the count is exercised
    got, want = _run_both(x, bf16, pass1_iters=pass1_iters, straggler_frac=0.25)
    # bound: tests/test_pallas_stages.py:185-189; the statistics are sums
    # of per-document quantities of the same converged etas
    np.testing.assert_allclose(float(got.bound), float(want.bound), rtol=1e-5)
    np.testing.assert_allclose(got.eta.numpy(), np.asarray(want.eta), atol=5e-3)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), atol=1e-3)
    scale = np.abs(np.asarray(want.beta_ss)).max()
    np.testing.assert_allclose(got.beta_ss.numpy(), np.asarray(want.beta_ss),
                               atol=1e-3 * scale)
    np.testing.assert_allclose(got.sigma_ss.numpy(), np.asarray(want.sigma_ss),
                               rtol=1e-3, atol=1e-3)
    si = precompute_sigma(torch.tensor(x["sigma"]))[0]
    _check_iters(x, si, got.newton_iters.numpy(), want.newton_iters, got.eta, want.eta)
    assert int(got.straggler_overflow) == int(want.straggler_overflow)
    if pass1_iters:
        assert int(got.straggler_overflow) > 0
    # padding documents keep eta at their start and add nothing
    assert (got.eta[-3:] == 0).all()


def test_two_pass_reproduces_single_pass():
    """With a budget that admits every straggler, the two-pass schedule
    runs each document through the same Newton steps as the single
    pass: the same etas and counts, bit for bit (each step is a pure
    per-document function of eta)."""
    x = _corpus(seed=7)
    T = torch.tensor
    si, se = precompute_sigma(T(x["sigma"]))
    args = (T(x["beta"]), T(x["mu"]), T(x["eta0"]), si, se, T(x["words"]),
            T(x["counts"]), torch.zeros(len(x["words"]), dtype=torch.int32),
            T(x["doc_ok"]))
    cfg = estep.NewtonConfig()
    one = estep.run_estep(*args, cfg=cfg, batch_size=16)
    two = estep.run_estep(*args, cfg=cfg, batch_size=16, pass1_iters=2,
                          straggler_frac=1.0)
    assert torch.equal(two.eta, one.eta)
    assert torch.equal(two.newton_iters, one.newton_iters)
    assert int(two.straggler_overflow) == 0
    np.testing.assert_allclose(float(two.bound), float(one.bound), rtol=1e-6)


def test_gather_and_scatter_match_jax():
    rng = np.random.default_rng(3)
    K, V, B, L = 5, 50, 4, 12
    beta = rng.random((K, V)).astype(np.float32)
    words = rng.integers(0, V, (B, L)).astype(np.int32)
    phi = rng.random((B, K, L)).astype(np.float32)
    bd = estep._gather_beta(torch.tensor(beta), torch.tensor(words))
    np.testing.assert_array_equal(
        bd.numpy(), np.asarray(jax_estep._gather_beta(jnp.asarray(beta), jnp.asarray(words),
                                                      None)))
    got = estep._scatter_phi(torch.zeros(K, V), torch.tensor(phi), torch.tensor(words))
    want = jax_estep._scatter_phi(jnp.zeros((K, V)), jnp.asarray(phi), jnp.asarray(words),
                                  None)
    # repeated word ids add in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_likelihood_temper_scales_the_search_only():
    x = _corpus(seed=9, N=16)
    T = torch.tensor
    bd = T(np.ascontiguousarray(x["beta"][:, x["words"]].transpose(1, 0, 2)))
    si, _ = precompute_sigma(T(x["sigma"]))
    eta_t, _, _ = estep._batched_newton(bd, T(x["counts"]), T(x["mu"]), T(x["eta0"]), si,
                                        estep.NewtonConfig(likelihood_temper=0.5))
    eta_h, _, _ = estep._batched_newton(bd, 0.5 * T(x["counts"]), T(x["mu"]), T(x["eta0"]),
                                        si, estep.NewtonConfig())
    assert torch.equal(eta_t, eta_h)


def _two_loop_estep(beta, mu, eta0, siginv, sigmaentropy, words, counts, aspects, doc_ok,
                    cfg, B, use_pallas):
    """The single-pass E-step as it was before it became one loop: Newton
    over every chunk, then a finalize over every chunk from a second
    gather.  Kept here as the reference of the bit-equality test."""
    N, K = words.shape[0], beta.shape[-2]
    etas, iters = [], []
    for lo in range(0, N, B):
        sl = slice(lo, lo + B)
        bd = estep._gather_beta(beta, words[sl], aspects[sl])
        if use_pallas:
            eta, it = estep._newton_loop(bd, counts[sl], mu[sl], eta0[sl], siginv, cfg)
        else:
            eta, it, _ = estep._batched_newton(bd, counts[sl], mu[sl], eta0[sl], siginv, cfg)
        etas.append(eta)
        iters.append(it)
    eta, iters = torch.cat(etas), torch.cat(iters)
    beta_ss = torch.zeros_like(beta)
    sigma_ss = torch.zeros(K - 1, K - 1)
    bound = torch.zeros(())
    thetas = []
    for lo in range(0, N, B):
        sl = slice(lo, lo + B)
        w, c = words[sl], counts[sl]
        bd = estep._gather_beta(beta, w, aspects[sl])
        theta, nu, bound_d, phi = estep._finalize_chunk(
            eta[sl], bd, c, mu[sl], doc_ok[sl].to(beta.dtype), siginv, sigmaentropy,
            torch.sum(c, dim=1))
        estep._scatter_phi(beta_ss, phi, w, aspects[sl])
        sigma_ss = sigma_ss + torch.sum(nu, dim=0)
        bound = bound + torch.sum(bound_d)
        thetas.append(theta)
    return estep.EStepResult(beta_ss, sigma_ss, bound, eta, torch.cat(thetas), iters,
                             torch.zeros((), dtype=torch.int32))


def _count_gathers(monkeypatch):
    calls = []
    real = estep._gather_beta

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(estep, "_gather_beta", counted)
    return calls, real


@pytest.mark.parametrize("path", ["stages", "pallas_iter", "use_pallas"])
def test_single_pass_gathers_once_a_chunk(path, monkeypatch):
    """The single-pass E-step gathers beta_doc once a chunk (the JAX
    ``chunk_fn``) and its result equals the two-loop form bit for bit:
    the sums run in storage order either way."""
    x = _corpus(seed=13)
    T = torch.tensor
    N, B = len(x["words"]), 16
    si, se = precompute_sigma(T(x["sigma"]))
    args = (T(x["beta"]), T(x["mu"]), T(x["eta0"]), si, se, T(x["words"]),
            T(x["counts"]), torch.zeros(N, dtype=torch.int32), T(x["doc_ok"]))
    cfg = estep.NewtonConfig(pallas_iter=path == "pallas_iter")
    use_pallas = path == "use_pallas"
    want = _two_loop_estep(*args, cfg, B, use_pallas)
    calls, _ = _count_gathers(monkeypatch)
    got = estep.run_estep(*args, cfg=cfg, batch_size=B, use_pallas=use_pallas)
    assert len(calls) == N // B
    for name in estep.EStepResult._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_two_pass_keeps_its_gathers(monkeypatch):
    """Pass 1 gathers every chunk, pass 2 the straggler chunks, pass 3
    every chunk again, as the JAX two-pass schedule does."""
    x = _corpus(seed=13)
    T = torch.tensor
    N, B = len(x["words"]), 16
    si, se = precompute_sigma(T(x["sigma"]))
    calls, _ = _count_gathers(monkeypatch)
    estep.run_estep(T(x["beta"]), T(x["mu"]), T(x["eta0"]), si, se, T(x["words"]),
                    T(x["counts"]), torch.zeros(N, dtype=torch.int32), T(x["doc_ok"]),
                    cfg=estep.NewtonConfig(), batch_size=B, pass1_iters=2,
                    straggler_frac=0.5)
    assert len(calls) == N // B + (N // 2) // B + N // B
