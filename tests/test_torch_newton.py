"""The port's fused Newton functions and row gather (strutopy_tpu_torch/
ops/stages.py: newton_iter, newton_loop, gather_rows) against the JAX
Pallas kernels they replace, run in interpret mode as
tests/test_pallas_stages.py and tests/test_pallas.py run them; the
E-step on the fused paths against JAX's; the configuration surface.  On
CPU tensors the port's wrappers run their plain PyTorch versions; the
CUDA kernels are compared with those on the card (the ``cuda`` tests
below, and chip_smoke.py)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke as cs
from strutopy_tpu.models.config import STMConfig as JaxConfig
from strutopy_tpu.ops import estep as jax_estep
from strutopy_tpu.ops.linalg import precompute_sigma as jax_precompute_sigma
from strutopy_tpu.ops.pallas_estep import pallas_newton
from strutopy_tpu.ops.pallas_stages import pallas_gather_beta, pallas_iter_impl
from strutopy_tpu_torch.models.config import STMConfig
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


NEW = ("iter", "newton", "gather", "direction", "accept")


def _chunk(seed=0, B=16, K=9, L=128, V=400):
    """One chunk as numpy float32 (tests/test_pallas_stages.py::_chunk's
    recipe), a start eta and a done mask."""
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.ones(V), size=K)
    words = np.stack([rng.choice(V, L, replace=False) for _ in range(B)])
    counts = np.zeros((B, L), np.float32)
    n = min(40, L)
    counts[:, :n] = rng.integers(1, 5, (B, n))
    sig = np.diag(np.full(K - 1, 2.0)) + 0.3
    return dict(
        eta=rng.normal(0, 0.4, (B, K - 1)).astype(np.float32),
        beta_doc=np.stack([beta[:, w] for w in words]).astype(np.float32),
        counts=counts,
        mu=rng.normal(0, 0.3, (B, K - 1)).astype(np.float32),
        siginv=np.linalg.inv(sig).astype(np.float32),
        ts=np.exp2(-np.arange(12, dtype=np.float32)),
        done=np.arange(B) % 5 == 0,
    )


def _args(x, lib):
    names = ("eta", "beta_doc", "counts", "mu", "siginv", "ts", "done")
    conv = jnp.asarray if lib == "jax" else (lambda a: torch.tensor(np.asarray(a)))
    return [conv(x[k]) for k in names]


@pytest.mark.parametrize("bf16", [False, True])
def test_newton_iter_matches_pallas_iter(bf16):
    x = _chunk(seed=1)
    # as tests/test_pallas_stages.py:131-149, compare a step taken from a
    # point 3 iterations along the trajectory, not from the random start
    a = _args(x, "torch")
    for _ in range(3):
        a[0], a[6], _adv = stages.newton_iter_plain(*a, 1e-5, 6, bf16)
    x["eta"], x["done"] = a[0].numpy(), a[6].numpy().copy()
    x["done"][::5] = True
    want = pallas_iter_impl(*_args(x, "jax"), grad_tol=1e-5, cg_iters=6, bf16=bf16,
                            interpret=True)
    got = stages.newton_iter(*_args(x, "torch"), 1e-5, 6, bf16)
    # the tolerances of tests/test_pallas_stages.py:154-158: one fused
    # iteration equals one Newton-body iteration to float32 rounding
    # (both round the Hessian to bf16 and keep p float32 in CG, so the
    # bf16 mode shares the semantics and the tolerance)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # done documents keep their eta and do not advance
    done = x["done"]
    assert torch.equal(got[0][done], torch.tensor(x["eta"][done]))
    assert not got[2][done].any()


def _inline_glue(g, x, f, fs, ts, eta, done, grad_tol):
    """The step glue inline around the stage functions, op for op, as the
    reference of the glue wrappers: (p, gTp, conv, eta, done, advance,
    any_ok)."""
    conv = torch.amax(torch.abs(g), dim=1) <= grad_tol
    p = x
    gTp = torch.sum(g * p, dim=1)
    bad = gTp >= 0
    p = torch.where(bad[:, None], -g, p)
    gTp = torch.where(bad, -torch.sum(g * g, dim=1), gTp)
    ok = fs <= f[:, None] + 1e-4 * ts[None, :] * gTp[:, None]
    any_ok = torch.any(ok, dim=1)
    t = torch.amax(torch.where(ok, ts[None, :], 0.0), dim=1)
    advance = ~done & ~conv
    step = advance & any_ok
    eta = torch.where(step[:, None], eta + t[:, None] * p, eta)
    done = done | conv | ~any_ok
    return p, gTp, conv, eta, done, advance, any_ok


@pytest.mark.parametrize("K, T, all_done", [(9, 12, False), (5, 1, False), (9, 12, True)])
def test_glue_wrappers_on_cpu_tensors_are_the_inline_glue(K, T, all_done):
    """newton_direction and newton_accept on CPU tensors equal the inline
    glue bit for bit, on chip_smoke.py's planted inputs: done documents, a
    NaN in g, directions that do not descend, a converged document, one
    with no passing step size; and on an all-done chunk.  n_iters takes
    advance in place; all_done is every document's new done flag."""
    g, x, eta, f, ts, done = cs.glue_cases(torch, 24, K, T, seed=K, device="cpu")
    if all_done:
        done = torch.ones_like(done)
    # the sweep's values about the Armijo line of the direction's gTp
    gTp0 = _inline_glue(g, x, f, torch.zeros(24, T), ts, eta, done, 1e-5)[1]
    fs = cs.glue_sweep(torch, f, gTp0, ts, seed=1)
    want = _inline_glue(g, x, f, fs, ts, eta, done, 1e-5)
    n0 = {k: stages.LAUNCHES[k] for k in ("direction", "accept")}
    p, gTp, conv = stages.newton_direction(g, x, 1e-5)
    n_iters = torch.arange(24, dtype=torch.int32) % 3
    start = n_iters.clone()
    got = stages.newton_accept(eta, p, fs, f, gTp, ts, done, conv, n_iters)
    for u, v in zip((p, gTp, conv) + got[:4], want):
        assert cs.same_bits(torch, u, v)
    assert torch.equal(n_iters, start + want[5].to(torch.int32))
    assert got[4].shape == () and bool(got[4]) == bool(want[4].all())
    assert {k: stages.LAUNCHES[k] for k in n0} == n0
    # each planted case took its branch
    assert bool(conv[3]) and not bool(conv[1]) and torch.isnan(gTp[1])
    assert torch.equal(p[2::5], -g[2::5]) and bool(got[1][4]) and not bool(got[3][4])
    if all_done:
        assert bool(got[4]) and torch.equal(got[0], eta) and not bool(got[2].any())
    else:
        assert bool(got[2].any()) and not bool(got[4])


def test_stage_step_is_stage_iter_with_the_counts_on_cpu_tensors():
    """stage_step with n_iters: the (eta, done, advance) it returns without
    them, advance added to n_iters in place, and torch.all(done)."""
    a = _args(_chunk(seed=2), "torch")
    n_iters = torch.ones(a[0].shape[0], dtype=torch.int32)
    eta, done, adv, all_done = stages.stage_step(*a, n_iters, 1e-5, 6, True)
    for u, v in zip((eta, done, adv), stages.stage_step(*a, None, 1e-5, 6, True)[:3]):
        assert torch.equal(u, v)
    assert torch.equal(n_iters, 1 + adv.to(torch.int32))
    assert all_done.shape == () and bool(all_done) == bool(done.all())


def test_stage_iter_is_the_plain_step_on_cpu_tensors():
    """The default path's step (stage kernels + glue) and the fused
    iteration's plain version are one function: equal bit for bit."""
    a = _args(_chunk(seed=2), "torch")
    for u, v in zip(stages.stage_step(*a, None, 1e-5, 6, True)[:3],
                    stages.newton_iter_plain(*a, 1e-5, 6, True)):
        assert torch.equal(u, v)


def _problem(B=32, K=8, L=128, V=300, seed=0):
    """tests/test_pallas.py::_problem's inputs as numpy float32."""
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.ones(V), size=K)
    words = rng.integers(0, V, (B, L))
    siginv, _ = jax_precompute_sigma(2.0 * jnp.eye(K - 1) + 0.2)
    return dict(
        beta_doc=np.take(beta, words, axis=1).transpose(1, 0, 2).astype(np.float32),
        counts=np.where(np.arange(L) < 20, rng.integers(1, 4, (B, L)), 0).astype(np.float32),
        mu=rng.normal(0, 0.3, (B, K - 1)).astype(np.float32),
        siginv=np.asarray(siginv),
    )


@pytest.mark.parametrize("bf16", [False, True])
def test_newton_loop_matches_pallas_newton(bf16):
    x = _problem()
    j = {k: jnp.asarray(v) for k, v in x.items()}
    want_eta, want_n = pallas_newton(j["beta_doc"], j["counts"], j["mu"], j["mu"], j["siginv"],
                                     cfg=jax_estep.NewtonConfig(bf16_hessian=bf16),
                                     block_docs=16, interpret=True)
    t = {k: torch.tensor(v) for k, v in x.items()}
    ts = torch.exp2(-torch.arange(12, dtype=torch.float32))
    eta, n = stages.newton_loop(t["beta_doc"], t["counts"], t["mu"], t["mu"], t["siginv"], ts,
                                24, 1e-5, 6, bf16)
    # tests/test_pallas.py:43: the two Newton paths round differently and
    # may part within float tolerance; the optima agree to 5e-3
    np.testing.assert_allclose(eta.numpy(), np.asarray(want_eta), atol=5e-3)
    assert n.dtype == torch.int32 and (n >= 1).all() and (n <= 24).all()
    # the typical Newton count is the same (counts at the float32 floor
    # of g differ document by document: ROADMAP Queue C)
    assert abs(float(np.median(n.numpy())) - float(np.median(np.asarray(want_n)))) <= 1


def test_newton_loop_equals_the_loop_of_newton_iter():
    """The whole-loop plain version is the fused iteration's plain version
    in a loop: a document that is done stays frozen, so stopping a
    document at its own done flag equals running every iteration."""
    x = {k: torch.tensor(v) for k, v in _problem(B=8, seed=2).items()}
    ts = torch.exp2(-torch.arange(12, dtype=torch.float32))
    eta, n = stages.newton_loop(x["beta_doc"], x["counts"], x["mu"], x["mu"], x["siginv"], ts,
                                24, 1e-5, 6, True)
    e, done = x["mu"], torch.zeros(8, dtype=torch.bool)
    m = torch.zeros(8, dtype=torch.int32)
    for _ in range(24):  # all 24 steps, no early stop
        e, done, adv = stages.newton_iter(e, x["beta_doc"], x["counts"], x["mu"], x["siginv"],
                                          ts, done, 1e-5, 6, True)
        m += adv.to(torch.int32)
    assert torch.equal(eta, e) and torch.equal(n, m)


def test_gather_rows_matches_pallas_gather():
    rng = np.random.default_rng(7)
    beta_T = rng.normal(0, 1, (500, 12)).astype(np.float32)
    words = rng.integers(0, 500, (16, 40)).astype(np.int32)
    want = pallas_gather_beta(jnp.asarray(beta_T), jnp.asarray(words), rows_per_program=64,
                              interpret=True)
    got = stages.gather_rows(torch.tensor(beta_T), torch.tensor(words))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # a copy: exact
    # the E-step's gather is the same rows, laid out (B, K, L)
    bd = estep._gather_beta(torch.tensor(beta_T.T.copy()), torch.tensor(words))
    assert torch.equal(bd, got.permute(0, 2, 1))


def _corpus(seed=5, N=64, K=9, L=64, V=300):
    """N documents of up to 48 unique words; the last 3 are padding
    (tests/test_torch_estep.py::_corpus)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 4, (N, L)).astype(np.float32)
    counts[:, 48:] = 0
    counts[-3:] = 0
    mu = rng.normal(0, 0.3, (N, K - 1)).astype(np.float32)
    mu[-3:] = 0
    return dict(beta=rng.dirichlet(np.full(V, 0.3), size=K).astype(np.float32),
                words=np.stack([rng.choice(V, L, replace=False) for _ in range(N)]).astype(
                    np.int32),
                counts=counts, doc_ok=counts.sum(1) > 0, mu=mu,
                eta0=np.zeros((N, K - 1), np.float32),
                sigma=(np.eye(K - 1) + 0.1).astype(np.float32))


def _grad_norm(x, eta):
    """max|g| per document at ``eta`` (the port's float32 gradient)."""
    T = torch.tensor
    bd = T(np.ascontiguousarray(x["beta"][:, x["words"]].transpose(1, 0, 2)))
    siginv, _ = precompute_sigma(T(x["sigma"]))
    g = stages.fgh_plain(T(np.asarray(eta)), bd, T(x["counts"]), T(x["mu"]), siginv,
                         bf16=False)[1]
    return g.abs().amax(1).numpy()


def _run_both(x, jcfg, tcfg, batch_size=16, **kw):
    si, se = jax_precompute_sigma(jnp.asarray(x["sigma"]))
    N = x["words"].shape[0]
    want = jax_estep.run_estep(
        jnp.asarray(x["beta"]), jnp.asarray(x["mu"]), jnp.asarray(x["eta0"]), si, se,
        jnp.asarray(x["words"]), jnp.asarray(x["counts"]), jnp.zeros(N, jnp.int32),
        jnp.asarray(x["doc_ok"]), cfg=jcfg, batch_size=batch_size, **kw)
    T = torch.tensor
    si2, se2 = precompute_sigma(T(x["sigma"]))
    kw.pop("pallas_block", None)
    got = estep.run_estep(T(x["beta"]), T(x["mu"]), T(x["eta0"]), si2, se2, T(x["words"]),
                          T(x["counts"]), torch.zeros(N, dtype=torch.int32),
                          T(x["doc_ok"]), cfg=tcfg, batch_size=batch_size,
                          **kw)
    return got, want


def test_run_estep_whole_loop_matches_jax(monkeypatch):
    """run_estep(use_pallas=True) in both packages on the inputs of
    tests/test_pallas.py:60-75, the JAX kernel in interpret mode as
    tests/test_pallas.py:52-58 forces it."""
    import strutopy_tpu.ops.pallas_estep as pe

    orig = pe.pallas_newton_impl

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pe, "pallas_newton_impl", interp)
    rng = np.random.default_rng(1)
    K, V, L, N = 5, 200, 128, 64
    x = dict(beta=rng.dirichlet(np.ones(V), size=K).astype(np.float32),
             words=rng.integers(0, V, (N, L)).astype(np.int32),
             counts=np.where(np.arange(L) < 15, rng.integers(1, 3, (N, L)), 0).astype(
                 np.float32),
             mu=np.zeros((N, K - 1), np.float32), eta0=np.zeros((N, K - 1), np.float32),
             doc_ok=np.ones(N, bool), sigma=20.0 * np.eye(K - 1, dtype=np.float32))
    got, want = _run_both(x, jax_estep.NewtonConfig(), estep.NewtonConfig(), batch_size=32,
                          use_pallas=True, pallas_block=16)
    # tests/test_pallas.py:76-80's tolerances between two Newton paths.
    # eta is held to 5e-3 where both paths converge (max|g| <= 10
    # grad_tol, above g's float32 floor): with this weak prior (sigma =
    # 20 I) a path can stall at the floor of f before converging, each on
    # its own documents (ROADMAP Queue C; here the port on one document
    # at max|g| = 2e-3, 1e-2 from JAX's eta with f equal to 1e-7), and
    # such an end point depends on the path.  No more such documents
    # than JAX's plus one.
    g_port, g_jax = (_grad_norm(x, e) for e in (got.eta, want.eta))
    both = (g_port <= 1e-4) & (g_jax <= 1e-4)
    np.testing.assert_allclose(got.eta.numpy()[both], np.asarray(want.eta)[both], atol=5e-3)
    assert (g_port > 1e-4).sum() <= (g_jax > 1e-4).sum() + 1
    np.testing.assert_allclose(float(got.bound), float(want.bound), rtol=1e-4)
    np.testing.assert_allclose(got.beta_ss.numpy(), np.asarray(want.beta_ss), atol=2e-3)


@pytest.mark.parametrize("bf16", [False, True])
def test_run_estep_fused_iteration_two_pass_matches_jax(bf16):
    """run_estep with pallas_iter and the two-pass schedule in both
    packages (JAX's fused kernel in interpret mode off the TPU)."""
    x = _corpus(seed=13)
    got, want = _run_both(x, jax_estep.NewtonConfig(bf16_hessian=bf16, pallas_iter=True),
                          estep.NewtonConfig(bf16_hessian=bf16, pallas_iter=True),
                          pass1_iters=2, straggler_frac=1.0)
    # tests/test_pallas_stages.py:185-189: bound to 1e-5, etas to the
    # wiggle of grad_tol-level steps
    np.testing.assert_allclose(float(got.bound), float(want.bound), rtol=1e-5)
    np.testing.assert_allclose(got.eta.numpy(), np.asarray(want.eta), atol=5e-3)
    assert int(got.straggler_overflow) == int(want.straggler_overflow) == 0


def test_fused_iteration_path_equals_the_stage_path_on_cpu():
    """On CPU tensors the fused iteration and the stage kernels run the
    same plain step: the E-steps agree bit for bit."""
    x = {k: torch.tensor(v) for k, v in _corpus(seed=17, N=32).items()}
    si, se = precompute_sigma(x["sigma"])
    args = (x["beta"], x["mu"], x["eta0"], si, se, x["words"], x["counts"],
            torch.zeros(32, dtype=torch.int32), x["doc_ok"])
    a = estep.run_estep(*args, cfg=estep.NewtonConfig(), batch_size=16, pass1_iters=2)
    b = estep.run_estep(*args, cfg=estep.NewtonConfig(pallas_iter=True), batch_size=16,
                        pass1_iters=2)
    c = estep.run_estep(*args, cfg=estep.NewtonConfig(), batch_size=16, use_pallas=True)
    d = estep.run_estep(*args, cfg=estep.NewtonConfig(), batch_size=16)
    assert torch.equal(a.eta, b.eta) and torch.equal(a.newton_iters, b.newton_iters)
    assert torch.equal(c.eta, d.eta) and torch.equal(c.newton_iters, d.newton_iters)


def test_whole_loop_refuses_the_two_pass_schedule():
    with pytest.raises(ValueError, match="two-pass"):
        STMConfig(K=5, use_pallas=True, newton_pass1_iters=3)
    x = {k: torch.tensor(v) for k, v in _corpus(N=16).items()}
    si, se = precompute_sigma(x["sigma"])
    with pytest.raises(ValueError, match="incompatible with use_pallas"):
        estep.run_estep(x["beta"], x["mu"], x["eta0"], si, se, x["words"], x["counts"],
                        torch.zeros(16, dtype=torch.int32), x["doc_ok"],
                        pass1_iters=2, use_pallas=True)


@pytest.mark.parametrize("flag", ["use_pallas", "pallas_iter"])
def test_config_reads_jax_json_with_the_fused_flags(flag):
    jcfg = JaxConfig(K=7, **{flag: True})
    cfg = STMConfig.from_json(jcfg.to_json())
    assert getattr(cfg, flag) is True
    # and writes the JAX package's JSON back, byte for byte
    assert cfg.to_json() == jcfg.to_json()


def test_cpu_wrappers_leave_the_new_counters_at_zero():
    x = _args(_chunk(seed=3, B=4, K=5, L=16), "torch")
    before = {k: stages.LAUNCHES[k] for k in NEW}
    stages.newton_iter(*x, 1e-5, 4, True)
    eta, bd, c, mu, siginv, ts, _done = x
    stages.newton_loop(bd, c, mu, eta, siginv, ts, 3, 1e-5, 4, True)
    stages.gather_rows(torch.rand(20, 5), torch.zeros(2, 3, dtype=torch.int32))
    g, x, eta, f, ts, done = cs.glue_cases(torch, 8, 5, 4, seed=0, device="cpu")
    p, gTp, conv = stages.newton_direction(g, x, 1e-5)
    stages.newton_accept(eta, p, cs.glue_sweep(torch, f, gTp, ts, seed=0), f, gTp, ts, done, conv,
                         torch.zeros(8, dtype=torch.int32))
    assert {k: stages.LAUNCHES[k] for k in NEW} == before


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs this check on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_iter_kernel_matches_plain(bf16):
    _cuda()
    a = [t.cuda() for t in _args(_chunk(seed=5, B=32), "torch")]
    n0 = stages.LAUNCHES["iter"]
    got = stages.newton_iter(*a, 1e-5, 6, bf16)
    want = stages.newton_iter_plain(*a, 1e-5, 6, bf16)
    # rtol/atol of the CPU parity test above (float32 rounding of one step)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(), rtol=1e-4, atol=1e-4)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert stages.LAUNCHES["iter"] == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_newton_kernel_matches_plain(bf16):
    _cuda()
    x = {k: torch.tensor(v).cuda() for k, v in _problem().items()}
    ts = torch.exp2(-torch.arange(12, dtype=torch.float32, device="cuda"))
    n0 = stages.LAUNCHES["newton"]
    args = (x["beta_doc"], x["counts"], x["mu"], x["mu"], x["siginv"], ts, 24, 1e-5, 6, bf16)
    eta, _n = stages.newton_loop(*args)
    want, _m = stages.newton_loop_plain(*args)
    # tests/test_pallas.py:43's bound between two Newton paths
    np.testing.assert_allclose(eta.cpu().numpy(), want.cpu().numpy(), atol=5e-3)
    assert stages.LAUNCHES["newton"] == n0 + 1


@pytest.mark.cuda
def test_cuda_gather_kernel_matches_plain():
    _cuda()
    rng = np.random.default_rng(9)
    beta_T = torch.tensor(rng.random((1000, 100)).astype(np.float32), device="cuda")
    words = torch.tensor(rng.integers(0, 1000, (32, 128)).astype(np.int32), device="cuda")
    n0 = stages.LAUNCHES["gather"]
    assert torch.equal(stages.gather_rows(beta_T, words), stages.gather_rows_plain(beta_T, words))
    assert stages.LAUNCHES["gather"] == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("K, T", [(100, 12), (6, 1), (400, 16)])
def test_cuda_glue_kernels_match_plain(K, T):
    """The stage path's glue kernels against their plain versions on
    chip_smoke.py's planted inputs at the bench chunk (B=256) and at K=6
    and K=400: conv, p, every flag, eta, n_iters and all_done bit for bit,
    gTp within 4 ulps of Σ|g_i p_i|; one launch a call."""
    _cuda()
    checks, worst, launched, _errs = cs.glue_verdict(
        torch, stages, *cs.glue_cases(torch, 256, K, T, seed=K), seed=7, planted=True)
    assert all(checks.values()), checks
    assert worst <= 1.0 and launched == {"direction": 1, "accept": 2}
