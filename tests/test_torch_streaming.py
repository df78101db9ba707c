"""The port's streamed (out-of-core) EM against its in-memory EM step and
against the JAX package's streamed fit on the same numpy parts: mirrors
of tests/test_streaming.py at its sizes and tolerances, all on the CPU
(where the kernel wrappers run their plain versions)."""

import dataclasses

import numpy as np
import pytest
import jax
import torch

from strutopy_tpu.models.config import STMConfig as JaxConfig
from strutopy_tpu.models.state import init_state as jax_init_state
from strutopy_tpu.models.stm import STM as JaxSTM
from strutopy_tpu.models.streaming import StreamedEM as JaxStreamedEM
from strutopy_tpu.ops import mstep as jax_mstep
from strutopy_tpu_torch import STM, STMConfig, StreamedEM
from strutopy_tpu_torch.models.em import CorpusData, make_em_step
from strutopy_tpu_torch.ops import mstep
from strutopy_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


STAGE_KERNELS = dict(pallas_fgh=True, pallas_cg=True, pallas_ls=True)


def _corpus(N=96, K=4, L=18, V=120, seed=0):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, V, (N, L)).astype(np.int32)
    counts = rng.integers(1, 3, (N, L)).astype(np.float32)
    aspects = np.zeros(N, np.int32)
    doc_ok = np.ones(N, bool)
    X = rng.integers(0, 2, N).astype(np.float64)
    return words, counts, aspects, doc_ok, X


def _parts(arrays, D_np, n_parts):
    words, counts, aspects, doc_ok = arrays
    n = len(words) // n_parts
    return [
        (words[i * n:(i + 1) * n], counts[i * n:(i + 1) * n],
         aspects[i * n:(i + 1) * n], doc_ok[i * n:(i + 1) * n],
         D_np[i * n:(i + 1) * n].astype(np.float32))
        for i in range(n_parts)
    ]


def _jax_state_np(K, V, N, P, key=0):
    s = jax_init_state(jax.random.PRNGKey(key), K=K, V=V, N=N, P=P)
    return s, {f: np.asarray(getattr(s, f)) for f in s._fields}


def _slice_parts(full, n, n_parts, replace):
    return [
        replace(full,
                eta=full.eta[i * n:(i + 1) * n], mu=full.mu[i * n:(i + 1) * n],
                theta=full.theta[i * n:(i + 1) * n],
                opt_iters=full.opt_iters[i * n:(i + 1) * n])
        for i in range(n_parts)
    ]


@pytest.mark.parametrize("n_parts", [2, 3])
def test_streamed_matches_in_memory(n_parts):
    """Three iterations: the streamed driver against make_em_step on the
    concatenated corpus (the tolerances of
    tests/test_streaming.py::test_streamed_matches_in_memory), and
    against the JAX package's streamed driver on the same parts."""
    N, K, V = 96, 4, 120
    words, counts, aspects, doc_ok, X = _corpus(N=N, K=K, V=V)
    kw = dict(K=K, model_type="STM", init_type="random", batch_size=16,
              sort_by_difficulty=False)
    cfg = STMConfig(**kw)
    D_np, design = mstep.make_prevalence_design(X, doc_ok, device="cpu")
    jstate0, init_np = _jax_state_np(K, V, N, D_np.shape[1])

    T = torch.tensor
    data = CorpusData((T(words),), (T(counts),), (T(aspects),), (T(doc_ok),), (T(D_np),))
    state = state_from_numpy(init_np, "cpu")
    em = make_em_step(cfg, design, None, None)
    bounds_mem = []
    for _ in range(3):
        state = em(state, data)
        bounds_mem.append(float(state.bound))

    n = N // n_parts
    parts = _parts((words, counts, aspects, doc_ok), D_np, n_parts)
    sem = StreamedEM(cfg, design, parts, device="cpu")
    shared = state_from_numpy(init_np, "cpu")
    part_states = _slice_parts(shared, n, n_parts, dataclasses.replace)
    bounds_str = []
    for _ in range(3):
        shared, part_states = sem.em_iteration(shared, part_states)
        bounds_str.append(float(shared.bound))

    np.testing.assert_allclose(bounds_str, bounds_mem, rtol=2e-5)
    got, want = state_to_numpy(shared), state_to_numpy(state)
    np.testing.assert_allclose(got["beta"], want["beta"], atol=2e-5)
    np.testing.assert_allclose(got["sigma"], want["sigma"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["gamma"], want["gamma"], rtol=2e-3, atol=2e-4)
    eta_streamed = np.concatenate([s.eta.numpy() for s in part_states])
    np.testing.assert_allclose(eta_streamed, want["eta"], atol=2e-3)

    # ---- the JAX package's streamed fit on the same numpy parts ----
    _, jdesign = jax_mstep.make_prevalence_design(X, doc_ok)
    jsem = JaxStreamedEM(JaxConfig(**kw, **STAGE_KERNELS), jdesign, parts)
    jshared = jstate0
    jparts = _slice_parts(jstate0, n, n_parts, lambda s, **k: s._replace(**k))
    jbounds = []
    for _ in range(3):
        jshared, jparts = jsem.em_iteration(jshared, jparts)
        jbounds.append(float(np.asarray(jshared.bound)))
    np.testing.assert_allclose(bounds_str, jbounds, rtol=2e-4)
    np.testing.assert_allclose(got["beta"], np.asarray(jshared.beta), atol=2e-4)
    np.testing.assert_allclose(got["sigma"], np.asarray(jshared.sigma), rtol=2e-3, atol=2e-4)
    assert sem.nonfinite_bound_count == 0


def test_streamed_provider_callable():
    """Callable provider: parts regenerated per call; init_parts peeks
    part 0 for its shapes, and that fetch is cached and reused by the
    first iteration's part-0 E-step instead of a second call."""
    N, K, V, n_parts = 64, 3, 80, 2
    words, counts, aspects, doc_ok, X = _corpus(N=N, K=K, V=V, seed=1)
    cfg = STMConfig(K=K, model_type="STM", init_type="random", batch_size=16,
                    sort_by_difficulty=False)
    D_np, design = mstep.make_prevalence_design(X, doc_ok, device="cpu")
    n = N // n_parts
    calls = []

    def provider(p):
        calls.append(p)
        s = slice(p * n, (p + 1) * n)
        return (words[s], counts[s], aspects[s], doc_ok[s], D_np[s].astype(np.float32))

    sem = StreamedEM(cfg, design, provider, n_parts=n_parts, device="cpu")
    part_states = sem.init_parts(None, K=K, V=V)
    assert len(part_states) == n_parts and part_states[0].eta.shape == (n, K - 1)
    _, init_np = _jax_state_np(K, V, n, D_np.shape[1])
    shared = state_from_numpy(init_np, "cpu")
    for _ in range(2):
        shared, part_states = sem.em_iteration(shared, part_states)
    assert np.isfinite(float(shared.bound))
    assert calls == [0, 1, 0, 1]
    with pytest.raises(ValueError, match="n_parts is required"):
        StreamedEM(cfg, design, provider, device="cpu")


def _toy_kwargs(toy_corpus, toy_dictionary, toy_metadata, **extra):
    train_docs = toy_corpus.train_docs
    return dict(documents=train_docs, dictionary=toy_dictionary, K=3,
                X=toy_metadata[: len(train_docs)], max_em_iter=3, init_type="random",
                model_type="STM", seed=123456, **extra)


def test_stm_stream_parts_matches_plain(tmp_path, toy_corpus, toy_dictionary, toy_metadata):
    """STM(stream_parts=N) reproduces the in-memory fit and the JAX
    package's streamed fit; the streamed model transforms and saves as
    an in-memory one does (its ``_data`` is None)."""
    kwargs = _toy_kwargs(toy_corpus, toy_dictionary, toy_metadata)
    m1 = STM(**kwargs, device="cpu")
    m1.expectation_maximization(saving=False)
    ms = STM(**kwargs, stream_parts=3, device="cpu")
    assert ms._data is None  # corpus not device-resident
    ms.expectation_maximization(saving=False)
    np.testing.assert_allclose(ms.last_bounds, m1.last_bounds, rtol=2e-4)
    np.testing.assert_allclose(ms.beta, m1.beta, atol=2e-4)
    np.testing.assert_allclose(ms.theta, m1.theta, atol=2e-3)

    jm = JaxSTM(**kwargs, stream_parts=3)
    jm.expectation_maximization(saving=False)
    np.testing.assert_allclose(ms.last_bounds, jm.last_bounds, rtol=2e-4)
    np.testing.assert_allclose(ms.beta, jm.beta, atol=2e-4)
    np.testing.assert_allclose(ms.theta, jm.theta, atol=2e-3)

    docs, X = kwargs["documents"][:7], kwargs["X"][:7]
    th_s, _ = ms.transform(docs, X=X)
    th_1, _ = m1.transform(docs, X=X)
    np.testing.assert_allclose(th_s, th_1, atol=2e-3)
    ms.save_model(str(tmp_path / "streamed"))
    np.testing.assert_array_equal(np.load(tmp_path / "streamed" / "theta_hat.npy"), ms.theta)


def test_stm_stream_parts_checkpoint_resume(tmp_path, toy_corpus, toy_dictionary,
                                            toy_metadata):
    """Interrupt + resume works through the streamed step closure (state
    slices per part from the restored full state)."""
    kw = _toy_kwargs(toy_corpus, toy_dictionary, toy_metadata, stream_parts=2)
    del kw["max_em_iter"]
    ckpt = str(tmp_path / "state.npz")
    m1 = STM(max_em_iter=4, **kw, device="cpu")
    m1.expectation_maximization(saving=False)

    m2a = STM(max_em_iter=2, **kw, device="cpu")
    m2a.expectation_maximization(saving=False, checkpoint_path=ckpt)
    m2b = STM(max_em_iter=4, **kw, device="cpu")
    m2b.expectation_maximization(saving=False, checkpoint_path=ckpt, resume=True)
    assert len(m2b.last_bounds) == len(m1.last_bounds)
    np.testing.assert_allclose(m2b.last_bounds, m1.last_bounds, rtol=1e-5)
    np.testing.assert_allclose(m2b.beta, m1.beta, atol=1e-5)


def test_stm_stream_parts_two_pass_steps(toy_corpus, toy_dictionary, toy_metadata):
    """A fit of 10 iterations or more streams through the cold
    single-pass step first and the two-pass step after, as the in-memory
    fit does."""
    kw = _toy_kwargs(toy_corpus, toy_dictionary, toy_metadata)
    kw.update(max_em_iter=10, convergence_threshold=0.0)
    ms = STM(**kw, stream_parts=2, device="cpu")
    assert ms.config.newton_pass1_iters == 6 and ms._em_step_cold is not None
    ms.expectation_maximization()
    m1 = STM(**kw, device="cpu")
    m1.expectation_maximization()
    assert len(ms.last_bounds) == 10
    np.testing.assert_allclose(ms.last_bounds, m1.last_bounds, rtol=2e-4)


def test_streamed_content_requires_kappa_inputs():
    cfg = STMConfig(K=3, content=True, A=2, lda_beta=False)
    with pytest.raises(ValueError, match="kappa_design"):
        StreamedEM(cfg, None, [], n_parts=1, device="cpu")


def test_stm_stream_parts_content_matches_plain(toy_corpus, toy_dictionary):
    """Streamed content model: the kappa regression runs once per
    iteration on the part-summed beta_ss, warm-started from the shared
    state, and reproduces the in-memory content fit and JAX's streamed
    one."""
    train_docs = toy_corpus.train_docs
    beta_index = np.random.default_rng(0).integers(0, 2, len(train_docs))
    kwargs = dict(documents=train_docs, dictionary=toy_dictionary, K=3,
                  X=beta_index.astype(float), content=True, A=2, beta_index=beta_index,
                  lda_beta=False, kappa_interactions=True, max_em_iter=2,
                  init_type="random", model_type="CTM", seed=123456)
    m1 = STM(**kwargs, device="cpu")
    m1.expectation_maximization(saving=False)
    ms = STM(**kwargs, stream_parts=2, device="cpu")
    assert ms._data is None
    ms.expectation_maximization(saving=False)
    np.testing.assert_allclose(ms.last_bounds, m1.last_bounds, rtol=2e-4)
    np.testing.assert_allclose(ms.beta, m1.beta, atol=2e-4)
    np.testing.assert_allclose(ms.kappa, m1.kappa, atol=2e-3)

    jm = JaxSTM(**kwargs, stream_parts=2)
    jm.expectation_maximization(saving=False)
    np.testing.assert_allclose(ms.last_bounds, jm.last_bounds, rtol=2e-4)
    np.testing.assert_allclose(ms.beta, jm.beta, atol=2e-4)


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy_parts", "tensor_parts"])
def test_prefetch_matches_no_prefetch(tensors):
    """The one-part-ahead prefetch thread does not change results: same
    bound and shared state as the synchronous path, bit for bit.  Parts
    given as tensors on the device pass through untouched."""
    N, K, V = 96, 4, 120
    words, counts, aspects, doc_ok, X = _corpus(N=N, K=K, V=V, seed=3)
    cfg = STMConfig(K=K, model_type="STM", init_type="random", batch_size=16,
                    sort_by_difficulty=False)
    D_np, design = mstep.make_prevalence_design(X, doc_ok, device="cpu")
    n = N // 3
    parts = _parts((words, counts, aspects, doc_ok), D_np, 3)
    if tensors:
        parts = [tuple(torch.tensor(a) for a in part) for part in parts]
    _, init_np = _jax_state_np(K, V, n, D_np.shape[1], key=1)
    outs = []
    for pf in (False, True):
        sem = StreamedEM(cfg, design, parts, prefetch=pf, device="cpu")
        if tensors:
            assert sem._fetch(1)[0].words[0] is parts[1][0]
        shared = state_from_numpy(init_np, "cpu")
        pstates = sem.init_parts(None, K=K, V=V)
        for _ in range(2):
            shared, pstates = sem.em_iteration(shared, pstates)
        outs.append((float(shared.bound), shared.beta.numpy(), shared.sigma.numpy(),
                     [ps.eta.numpy() for ps in pstates]))
    (b0, beta0, sig0, etas0), (b1, beta1, sig1, etas1) = outs
    assert b0 == b1
    np.testing.assert_array_equal(beta0, beta1)
    np.testing.assert_array_equal(sig0, sig1)
    for e0, e1 in zip(etas0, etas1):
        np.testing.assert_array_equal(e0, e1)


def test_streamed_n_parts_mismatch_raises():
    N, K, V = 32, 3, 60
    words, counts, aspects, doc_ok, X = _corpus(N=N, K=K, V=V)
    cfg = STMConfig(K=K, model_type="STM", init_type="random", batch_size=16)
    D_np, design = mstep.make_prevalence_design(X, doc_ok, device="cpu")
    parts = _parts((words, counts, aspects, doc_ok), D_np, 2)
    with pytest.raises(ValueError, match="does not match"):
        StreamedEM(cfg, design, parts, n_parts=1, device="cpu")
    assert StreamedEM(cfg, design, parts, n_parts=2, device="cpu").n_parts == 2


@pytest.mark.parametrize("prefetch", [False, True])
def test_streamed_ragged_part_raises(prefetch):
    """Every part must share one (n, L) shape: a short tail part is
    refused with the JAX package's message, from the prefetch thread
    too."""
    N, K, V = 64, 3, 60
    words, counts, aspects, doc_ok, X = _corpus(N=N, K=K, V=V)
    cfg = STMConfig(K=K, model_type="STM", init_type="random", batch_size=16)
    D_np, design = mstep.make_prevalence_design(X, doc_ok, device="cpu")
    parts = _parts((words, counts, aspects, doc_ok), D_np, 2)
    parts.append(tuple(a[:16] for a in parts[1]))
    sem = StreamedEM(cfg, design, parts, prefetch=prefetch, device="cpu")
    _, init_np = _jax_state_np(K, V, 32, D_np.shape[1])
    shared = state_from_numpy(init_np, "cpu")
    pstates = [shared, shared, shared]
    with pytest.raises(ValueError, match=r"every part must share one \(n, L\)"):
        sem.em_iteration(shared, pstates)


def test_streamed_refuses_mesh(toy_corpus, toy_dictionary, tmp_path):
    """A mesh is no longer refused: on a gloo world of one, StreamedEM and
    STM(stream_parts=2) with mesh=make_mesh(1) run exactly the unmeshed
    streamed fit."""
    from strutopy_tpu_torch.parallel.mesh import make_mesh
    from torch_world import one_thread, world_of_one

    N, K, V = 64, 3, 60
    words, counts, aspects, doc_ok, X = _corpus(N=N, K=K, V=V)
    cfg = STMConfig(K=K, model_type="STM", init_type="random", batch_size=16)
    D_np, design = mstep.make_prevalence_design(X, doc_ok, device="cpu")
    parts = _parts((words, counts, aspects, doc_ok), D_np, 2)
    _, init_np = _jax_state_np(K, V, 32, D_np.shape[1])
    kw = dict(K=3, init_type="random", max_em_iter=2, stream_parts=2, device="cpu")

    def run(mesh):
        sem = StreamedEM(cfg, design, parts, mesh=mesh, device="cpu")
        shared = state_from_numpy(init_np, "cpu")
        pstates = sem.init_parts(None, K, V)
        shared, pstates = sem.em_iteration(shared, pstates)
        m = STM(toy_corpus.train_docs, toy_dictionary, mesh=mesh, **kw)
        m.expectation_maximization()
        return shared, pstates, m

    with one_thread():
        shared, pstates, m = run(None)
        with world_of_one(tmp_path):
            shared1, pstates1, m1 = run(make_mesh(1))
    assert float(shared1.bound) == float(shared.bound)
    assert torch.equal(shared1.beta, shared.beta)
    assert all(torch.equal(a.eta, b.eta) for a, b in zip(pstates1, pstates))
    np.testing.assert_array_equal(m1.last_bounds, m.last_bounds)
    np.testing.assert_array_equal(m1.theta, m.theta)


def test_stream_parts_divisibility_is_pinned(toy_corpus, toy_dictionary):
    """The plan pads the single bucket to a multiple of stream_parts x
    batch; _make_streamed_step refuses a bucket that is not."""
    m = STM(toy_corpus.train_docs, toy_dictionary, K=3, init_type="random",
            stream_parts=3, device="cpu")
    assert m._plan.n_storage % (3 * m._plan.batch_sizes[0]) == 0
    from strutopy_tpu_torch.corpus.bow import PaddedCorpus

    n = m._plan.n_storage - 1
    bucket = PaddedCorpus(np.zeros((n, 4), np.int32), np.zeros((n, 4), np.float32),
                          np.ones(n, bool), m.V)
    with pytest.raises(ValueError, match="not divisible"):
        m._make_streamed_step(m.config, bucket, np.zeros(n, np.int32),
                              np.zeros((n, 1), np.float32), None, None)
