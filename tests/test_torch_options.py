"""The E-step's two options in the port, against the JAX package:
``two_pass_fused`` (the two-pass schedule with the finalize riding passes
1 and 2, ``ops/estep.py::_two_pass_fused_estep``) and ``newton_bf16_beta``
(the Newton search reads beta_doc rounded to bf16; the finalize reads
float32), with the bf16-input modes of B1 (f/g/H), B3 (the sweep) and B4
(one fused iteration).  The JAX Newton body runs on its Pallas stage
kernels in interpret mode, the path the port's kernels replace.  On CPU
tensors the port's wrappers run their plain versions, which upcast a
bf16 beta_doc once: the JAX kernels, given a bf16 beta_doc, compute the
float32 function of the rounded values too."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from strutopy_tpu.models.config import STMConfig as JaxConfig
from strutopy_tpu.models.stm import STM as JaxSTM
from strutopy_tpu.ops import estep as jax_estep
from strutopy_tpu.ops.linalg import precompute_sigma as jax_precompute_sigma
from strutopy_tpu.ops.pallas_stages import (
    pallas_fgh_impl,
    pallas_iter_impl,
    pallas_linesearch_impl,
)
from strutopy_tpu_torch import STM, STMConfig, ThetaServer
from strutopy_tpu_torch.ops import estep, stages
from strutopy_tpu_torch.ops.linalg import precompute_sigma
from test_torch_estep import STAGE_KERNELS, _check_iters, _corpus
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


BF16 = torch.bfloat16
OPTIONS = dict(two_pass_fused=True, newton_bf16_beta=True)


def _stage_chunk(seed=5, B=16):
    """One chunk of test_torch_estep.py's corpus (K=9, L=64) as the Newton
    stages take it: beta_doc, counts, mu, siginv, a start eta, the step
    sizes and a done mask, numpy float32."""
    x = _corpus(seed=seed)
    rng = np.random.default_rng(seed)
    K = x["beta"].shape[0]
    si, _ = jax_precompute_sigma(jnp.asarray(x["sigma"]))
    return dict(
        eta=rng.normal(0, 0.4, (B, K - 1)).astype(np.float32),
        beta_doc=np.ascontiguousarray(x["beta"][:, x["words"][:B]].transpose(1, 0, 2)),
        counts=x["counts"][:B], mu=x["mu"][:B], siginv=np.asarray(si),
        ts=np.exp2(-np.arange(12, dtype=np.float32)), done=np.arange(B) % 5 == 0)


def _bf16_pair(beta_doc):
    """The same bf16 beta_doc for both packages (numpy has no bf16)."""
    bd = torch.tensor(beta_doc).to(BF16)
    return bd, jnp.asarray(bd.float().numpy()).astype(jnp.bfloat16)


def _port(x, *names):
    return [torch.tensor(np.asarray(x[k])) for k in names]


def _jax(x, *names):
    return [jnp.asarray(x[k]) for k in names]


# ---------------------------------------------------------------------------
# B1, B3, B4 on a bf16 beta_doc
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bf16", [False, True])
def test_fgh_on_a_bf16_beta_doc_matches_jax(bf16):
    x = _stage_chunk()
    bd_t, bd_j = _bf16_pair(x["beta_doc"])
    eta, c, mu, si = _port(x, "eta", "counts", "mu", "siginv")
    before = dict(stages.LAUNCHES)
    got = stages.fgh(eta, bd_t, c, mu, si, bf16=bf16)
    assert stages.LAUNCHES == before
    # the plain version of the rounded float32 beta_doc, bit for bit
    for a, b in zip(got, stages.fgh_plain(eta, bd_t.float(), c, mu, si, bf16=bf16)):
        assert torch.equal(a, b)
    # ... and not that of the unrounded one
    assert not torch.equal(got[0], stages.fgh_plain(eta, torch.tensor(x["beta_doc"]), c, mu,
                                                    si, bf16=bf16)[0])
    je, jc, jm, js = _jax(x, "eta", "counts", "mu", "siginv")
    want = pallas_fgh_impl(je, bd_j, jc, jm, js, bf16=bf16, interpret=True)
    # test_torch_stages.py::test_fgh_matches_jax's tolerances
    tol_H = 2e-2 if bf16 else 1e-5
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=tol_H, atol=tol_H)


def test_linesearch_on_a_bf16_beta_doc_matches_jax():
    x = _stage_chunk(seed=6)
    bd_t, bd_j = _bf16_pair(x["beta_doc"])
    eta, c, mu, si, ts = _port(x, "eta", "counts", "mu", "siginv", "ts")
    g = stages.fgh_plain(eta, bd_t, c, mu, si, bf16=False)[1]
    before = dict(stages.LAUNCHES)
    got = stages.linesearch(eta, -g, ts, bd_t, c, mu, si)
    assert stages.LAUNCHES == before
    assert torch.equal(got, stages.linesearch_plain(eta, -g, ts, bd_t.float(), c, mu, si))
    je, jc, jm, js, jt = _jax(x, "eta", "counts", "mu", "siginv", "ts")
    want = pallas_linesearch_impl(je, jnp.asarray(-g.numpy()), jt, bd_j, jc, jm, js,
                                  interpret=True)
    # the sweep tolerance of test_torch_stages.py
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_newton_iter_on_a_bf16_beta_doc_matches_jax(bf16):
    x = _stage_chunk(seed=7)
    bd_t, bd_j = _bf16_pair(x["beta_doc"])
    eta, c, mu, si, ts, done = _port(x, "eta", "counts", "mu", "siginv", "ts", "done")
    # a step from 3 iterations along the trajectory (test_torch_newton.py)
    for _ in range(3):
        eta, done, _adv = stages.newton_iter_plain(eta, bd_t, c, mu, si, ts, done, 1e-5, 6, bf16)
    done = done.clone()
    done[::5] = True
    before = dict(stages.LAUNCHES)
    got = stages.newton_iter(eta, bd_t, c, mu, si, ts, done, 1e-5, 6, bf16)
    assert stages.LAUNCHES == before
    for a, b in zip(got, stages.newton_iter_plain(eta, bd_t.float(), c, mu, si, ts, done,
                                                  1e-5, 6, bf16)):
        assert torch.equal(a, b)
    want = pallas_iter_impl(jnp.asarray(eta.numpy()), bd_j, *_jax(x, "counts", "mu", "siginv",
                                                                  "ts"),
                            jnp.asarray(done.numpy()), grad_tol=1e-5, cg_iters=6, bf16=bf16,
                            interpret=True)
    # test_torch_newton.py::test_newton_iter_matches_pallas_iter's tolerances
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_the_whole_loop_takes_no_bf16_beta_doc():
    x = _stage_chunk()
    bd_t, _ = _bf16_pair(x["beta_doc"])
    c, mu, si, ts = _port(x, "counts", "mu", "siginv", "ts")
    with pytest.raises(ValueError, match="float32"):
        stages.newton_loop(bd_t, c, mu, mu, si, ts, 24, 1e-5, 6, True)


# ---------------------------------------------------------------------------
# run_estep with the options
# ---------------------------------------------------------------------------


def _run_both(x, pass1_iters=0, straggler_frac=0.3, fused=False, bf16_beta=False):
    N = x["words"].shape[0]
    si, se = jax_precompute_sigma(jnp.asarray(x["sigma"]))
    want = jax_estep.run_estep(
        jnp.asarray(x["beta"]), jnp.asarray(x["mu"]), jnp.asarray(x["eta0"]), si, se,
        jnp.asarray(x["words"]), jnp.asarray(x["counts"]), jnp.zeros(N, jnp.int32),
        jnp.asarray(x["doc_ok"]),
        cfg=jax_estep.NewtonConfig(bf16_beta=bf16_beta, **STAGE_KERNELS), batch_size=16,
        pass1_iters=pass1_iters, straggler_frac=straggler_frac, fused_finalize=fused)
    return _run_port(x, pass1_iters, straggler_frac, fused, bf16_beta), want


def _port_args(x):
    T = torch.tensor
    si, se = precompute_sigma(T(x["sigma"]))
    return (T(x["beta"]), T(x["mu"]), T(x["eta0"]), si, se, T(x["words"]), T(x["counts"]),
            torch.zeros(len(x["words"]), dtype=torch.int32), T(x["doc_ok"]))


def _run_port(x, pass1_iters=0, straggler_frac=0.3, fused=False, bf16_beta=False, **cfg):
    return estep.run_estep(*_port_args(x), cfg=estep.NewtonConfig(bf16_beta=bf16_beta, **cfg),
                           batch_size=16, pass1_iters=pass1_iters,
                           straggler_frac=straggler_frac, fused_finalize=fused)


def _assert_matches_jax(x, got, want):
    """test_torch_estep.py::test_run_estep_matches_jax's tolerances."""
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
    assert (got.eta[-3:] == 0).all()


@pytest.mark.parametrize("pass1_iters", [0, 2], ids=["single_pass", "two_pass"])
def test_run_estep_with_a_bf16_beta_doc_matches_jax(pass1_iters):
    x = _corpus()
    got, want = _run_both(x, pass1_iters=pass1_iters, straggler_frac=0.25, bf16_beta=True)
    _assert_matches_jax(x, got, want)
    # the search moved: not the float32 search's etas
    assert not torch.equal(got.eta, _run_port(x, pass1_iters, 0.25).eta)


@pytest.mark.parametrize("pass1_iters, frac, bf16_beta", [
    (2, 0.25, False),  # most documents overflow the budget: the fallback sweep runs
    (4, 1.0, False),
    (2, 0.25, True),
], ids=["overflow", "no_overflow", "overflow_bf16_beta"])
def test_fused_run_estep_matches_jax(pass1_iters, frac, bf16_beta):
    x = _corpus(seed=9)
    got, want = _run_both(x, pass1_iters, frac, fused=True, bf16_beta=bf16_beta)
    _assert_matches_jax(x, got, want)
    assert (int(got.straggler_overflow) == 0) == (frac == 1.0)


@pytest.mark.parametrize("pass1_iters, frac, bf16_beta", [
    (4, 1.0, False), (4, 1.0, True), (1, 0.01, False), (1, 0.01, True), (2, 0.5, False),
], ids=["budget", "budget_bf16_beta", "overflow", "overflow_bf16_beta", "half"])
def test_fused_schedule_matches_the_unfused_one(pass1_iters, frac, bf16_beta):
    """tests/test_two_pass.py:217-262 for the port: the same Newton
    trajectories bit for bit; the statistics differ only in float32
    summation order, including the overflow fallback at pass-1 eta."""
    x = _corpus(seed=11)
    two = _run_port(x, pass1_iters, frac, bf16_beta=bf16_beta)
    fused = _run_port(x, pass1_iters, frac, fused=True, bf16_beta=bf16_beta)
    assert torch.equal(fused.eta, two.eta)
    assert torch.equal(fused.newton_iters, two.newton_iters)
    assert int(fused.straggler_overflow) == int(two.straggler_overflow)
    assert (int(two.straggler_overflow) == 0) == (frac == 1.0)
    np.testing.assert_allclose(float(fused.bound), float(two.bound), rtol=1e-6)
    np.testing.assert_allclose(fused.beta_ss.numpy(), two.beta_ss.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fused.sigma_ss.numpy(), two.sigma_ss.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(fused.theta.numpy(), two.theta.numpy(), rtol=1e-5, atol=1e-7)


def test_fused_is_a_no_op_without_a_pass_2_budget():
    """pass1_iters == max_iters leaves no pass-2 budget: the unfused path
    runs, bit for bit (tests/test_two_pass.py::test_fused_noop_...)."""
    x = _corpus(seed=3)
    a = _run_port(x, 24)
    b = _run_port(x, 24, fused=True)
    for name in estep.EStepResult._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("frac, overflow", [(1.0, False), (0.01, True)])
def test_fused_schedule_gathers(frac, overflow, monkeypatch):
    """Pass 1 gathers every chunk and pass 2 the budget's chunks, with no
    third pass; the overflow sweep gathers every chunk once more."""
    x = _corpus(seed=13)
    N, B = len(x["words"]), 16
    calls = []
    real = estep._gather_beta
    monkeypatch.setattr(estep, "_gather_beta", lambda *a, **k: calls.append(1) or real(*a, **k))
    res = _run_port(x, 2, frac, fused=True)
    assert (int(res.straggler_overflow) > 0) == overflow
    M = max(-(-int(frac * N) // B) * B, B)
    assert len(calls) == N // B + M // B + (N // B if overflow else 0)


@pytest.mark.parametrize("fused", [False, True])
def test_the_whole_loop_ignores_bf16_beta(fused):
    """use_pallas reads the float32 beta_doc whatever bf16_beta says (JAX's
    run_estep casts only off the whole-loop path); fused_finalize is a
    no-op on the single pass."""
    x = _corpus(seed=17, N=32)
    args = _port_args(x)
    a = estep.run_estep(*args, cfg=estep.NewtonConfig(), batch_size=16, use_pallas=True)
    b = estep.run_estep(*args, cfg=estep.NewtonConfig(bf16_beta=True), batch_size=16,
                        use_pallas=True, fused_finalize=fused)
    for name in estep.EStepResult._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_fused_iteration_path_reads_the_bf16_beta_doc():
    """pallas_iter with bf16_beta runs the step on the bf16 beta_doc: on
    CPU tensors the same plain step as the stage path, bit for bit."""
    x = _corpus(seed=19, N=32)
    a = _run_port(x, 2, 0.5, fused=True, bf16_beta=True)
    b = _run_port(x, 2, 0.5, fused=True, bf16_beta=True, pallas_iter=True)
    for name in estep.EStepResult._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# ---------------------------------------------------------------------------
# the configuration and the fit
# ---------------------------------------------------------------------------


def test_config_takes_the_options_in_both_directions():
    jcfg = JaxConfig(K=7, newton_pass1_iters=3, **OPTIONS)
    cfg = STMConfig.from_json(jcfg.to_json())
    assert cfg.two_pass_fused and cfg.newton_bf16_beta
    assert cfg.to_json() == jcfg.to_json()
    back = JaxConfig.from_json(STMConfig(K=7, newton_pass1_iters=3, **OPTIONS).to_json())
    assert back == jcfg


def _docs(seed=2, N=40, K=6, V=400):
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.full(V, 0.2), size=K)
    docs = []
    for d in range(N):
        draw = rng.multinomial(600 if d % 4 == 0 else 120,
                               rng.dirichlet(np.full(K, 0.5)) @ beta)
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    return docs, rng.integers(0, 2, N).astype(np.float64)


def _beta0(K=6, V=400, seed=3):
    g = np.random.RandomState(seed).gamma(0.1, 1.0, (K, V))
    return g / g.sum(axis=1, keepdims=True)


@pytest.fixture(scope="module")
def fits():
    """A 3-iteration STM fit with both options, every iteration on the
    fused two-pass schedule, in both packages from one beta; the port
    configured from the JAX configuration's JSON.  The budget admits every
    straggler: the overflow count sits on the float32 floor of the
    convergence test (test_torch_em.py), and run_estep's tests above hold
    the overflow sweep."""
    docs, X = _docs()
    jcfg = JaxConfig(K=6, init_type="random", max_em_iter=3, batch_size=8,
                     newton_pass1_iters=3, newton_straggler_frac=1.0, newton_warmup_iters=0,
                     convergence_threshold=0.0, **OPTIONS, **STAGE_KERNELS)
    jm = JaxSTM(docs, K=6, X=X, config=jcfg, init_beta=_beta0())
    jm.expectation_maximization(saving=False)
    m = STM(docs, K=6, X=X, config=STMConfig.from_json(jcfg.to_json()), init_beta=_beta0(),
            device="cpu")
    m.expectation_maximization()
    return docs, X, jm, m


def test_stm_fit_with_both_options_matches_jax(fits):
    """test_torch_em.py::test_stm_bound_trajectory_matches_jax's tolerances."""
    docs, X, jm, m = fits
    assert m.config.two_pass_fused and m.config.newton_bf16_beta
    assert len(m.last_bounds) == 3
    np.testing.assert_allclose(m.last_bounds, jm.last_bounds, rtol=1e-5)
    np.testing.assert_allclose(m.theta, jm.theta, atol=1e-3)
    np.testing.assert_allclose(m.beta, jm.beta, atol=1e-4)
    assert m.straggler_overflow == jm.straggler_overflow == 0
    # the port's own fit without the fused finalize (test_two_pass.py:265-285)
    plain = STM(docs, K=6, X=X, config=m.config.replace(two_pass_fused=False),
                init_beta=_beta0(), device="cpu")
    plain.expectation_maximization()
    np.testing.assert_allclose(m.last_bounds, plain.last_bounds, rtol=1e-5)
    np.testing.assert_allclose(m.beta, plain.beta, atol=1e-5)
    np.testing.assert_allclose(m.theta, plain.theta, atol=1e-5)


def test_port_serves_a_jax_model_saved_with_both_options(fits, tmp_path):
    """The JAX package's saved configuration with both options loads in the
    port's server, which serves with them: theta against the same server
    with the options off, to test_torch_serving.py's tolerances."""
    _docs_fit, _X, jm, _m = fits
    jm.save_model(str(tmp_path))
    new, Xn = _docs(seed=4, N=16)
    srv = ThetaServer(str(tmp_path), device="cpu")
    assert srv.cfg == STMConfig.from_json(jm.config.to_json())
    assert srv.cfg.two_pass_fused and srv.cfg.newton_bf16_beta
    theta, eta = srv.infer(new, X=Xn)
    assert theta.shape == (16, 6) and np.isfinite(theta).all()
    assert np.allclose(theta.sum(1), 1, atol=1e-5)
    srv.cfg = srv.cfg.replace(two_pass_fused=False, newton_bf16_beta=False)
    theta_f, eta_f = srv.infer(new, X=Xn)
    assert not np.array_equal(eta, eta_f)  # the bf16 search moved the etas ...
    np.testing.assert_allclose(eta, eta_f, atol=5e-3)  # ... within two Newton paths' bound
    np.testing.assert_allclose(theta, theta_f, atol=1e-3)
