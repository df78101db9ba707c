"""The port's public surface against the JAX package's, on the CPU.

Each public function binds positional arguments in JAX's order: called
positionally as JAX is, it gives its keyword call's result, and that
result is JAX's on the same numpy inputs, to the tolerances of the
parity test that covers the function (named in each test).  The TPU-only
positions refuse any value but JAX's default.  Besides, the names that
complete the surface: the subpackages' exports, ``cho_inverse``,
``CorpusData.single``, ``BucketPlan.padded_area`` and ``init_state``'s
random beta.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import scipy.stats
import jax
import jax.numpy as jnp
import torch

from strutopy_tpu.corpus.bow import pad_corpus as jax_pad_corpus
from strutopy_tpu.corpus.bucketing import (
    make_bucket_plan as jax_make_bucket_plan,
    split_corpus_by_plan as jax_split,
)
from strutopy_tpu.models import em as jax_em
from strutopy_tpu.models.config import STMConfig as JaxConfig
from strutopy_tpu.models.state import init_state as jax_init_state
from strutopy_tpu.models.stm import STM as JaxSTM
from strutopy_tpu.ops import estep as jax_estep
from strutopy_tpu.ops import mstep as jax_mstep
from strutopy_tpu.ops import spectral as jax_spectral
from strutopy_tpu.ops.linalg import cho_inverse as jax_cho_inverse
from strutopy_tpu.ops.linalg import precompute_sigma as jax_precompute_sigma
from strutopy_tpu_torch import STM, STMConfig
from strutopy_tpu_torch.corpus.bow import pad_corpus
from strutopy_tpu_torch.corpus.bucketing import make_bucket_plan, split_corpus_by_plan
from strutopy_tpu_torch.dgp.corpus_creation import CorpusCreation
from strutopy_tpu_torch.models import em
from strutopy_tpu_torch.models.state import init_state
from strutopy_tpu_torch.ops import estep, mstep, spectral
from strutopy_tpu_torch.ops.linalg import cho_inverse, precompute_sigma
from strutopy_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
from torch_world import one_thread

STAGE_KERNELS = dict(pallas_fgh=True, pallas_cg=True, pallas_ls=True)
K, V = 6, 400


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


def _docs(seed=0, N=40):
    """tests/test_torch_em.py's documents: a quarter of them long, so the
    corpus splits into two length buckets."""
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.full(V, 0.2), size=K)
    docs = []
    for d in range(N):
        theta = rng.dirichlet(np.full(K, 0.5))
        draw = rng.multinomial(600 if d % 4 == 0 else 120, theta @ beta)
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    return docs, rng.integers(0, 2, N).astype(np.float64)


def _beta0(seed=11):
    g = np.random.RandomState(seed).gamma(0.1, 1.0, (K, V))
    return g / g.sum(axis=1, keepdims=True)


def _assert_same(a, b):
    """Two results of the port, field by field, bit for bit."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        for name in a.__dataclass_fields__:
            _assert_same(getattr(a, name), getattr(b, name))
    else:
        assert a == b


# ---------------------------------------------------------------------------
# exports and helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sub", ["models", "ops"])
def test_subpackage_exports_are_jax_s(sub):
    """The subpackage exports JAX's names in JAX's ``__all__``, and
    importing it first in a fresh interpreter works (no import cycle)."""
    import importlib

    ours = importlib.import_module(f"strutopy_tpu_torch.{sub}")
    theirs = importlib.import_module(f"strutopy_tpu.{sub}")
    assert ours.__all__ == theirs.__all__
    for name in ours.__all__:
        assert getattr(ours, name).__name__ == getattr(theirs, name).__name__
    code = (f"from strutopy_tpu_torch.{sub} import {', '.join(ours.__all__)}; import sys; "
            "assert not any(m == 'jax' or m.startswith(('jax.', 'strutopy_tpu.')) "
            "for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_cho_inverse_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(5, 9, 9)).astype(np.float32)
    spd = A @ A.transpose(0, 2, 1) + 9 * np.eye(9, dtype=np.float32)
    L = torch.linalg.cholesky(torch.tensor(spd))
    got = cho_inverse(L).numpy()
    for g, l in zip(got, L.numpy()):
        want = np.asarray(jax_cho_inverse(jnp.asarray(l)))
        assert np.linalg.norm(g - want) <= 1e-6 * np.linalg.norm(want)
    np.testing.assert_allclose(got @ spd, np.broadcast_to(np.eye(9), got.shape), atol=1e-5)


def test_corpus_data_single_is_jax_s():
    rng = np.random.default_rng(1)
    arrays = (rng.integers(0, V, (8, 5)).astype(np.int32), rng.random((8, 5), np.float32),
              np.zeros(8, np.int32), np.ones(8, bool), rng.random((8, 2), np.float32))
    got = em.CorpusData.single(*(torch.tensor(a) for a in arrays))
    want = jax_em.CorpusData.single(*(jnp.asarray(a) for a in arrays))
    assert got.n_buckets == want.n_buckets == 1
    for name in ("words", "counts", "aspects", "doc_ok", "D"):
        (g,), (w,) = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got.to("cpu").words[0] is not None


def test_padded_area_is_jax_s():
    docs, _ = _docs()
    plan = make_bucket_plan(pad_corpus(docs, V=V), 8)
    jplan = jax_make_bucket_plan(jax_pad_corpus(docs, V=V), 8)
    assert plan.n_buckets == 2
    assert plan.padded_area() == jplan.padded_area()
    assert plan.padded_area() == sum(s * L for s, L in zip(plan.sizes, plan.Ls))


# ---------------------------------------------------------------------------
# init_state
# ---------------------------------------------------------------------------


def test_init_state_draws_a_gamma_beta_from_its_generator():
    """beta_init=None: rows of Gamma(0.1, 1) draws normalized to the
    simplex, i.e. Dirichlet(0.1) rows, whose entries are Beta(0.1,
    0.1 (V-1)); the same seed gives the same beta."""
    Vb = 20_000

    def draw(seed):
        return init_state(torch.Generator().manual_seed(seed), 3, Vb, 4, 2, device="cpu").beta

    a, b, c = draw(5), draw(5), draw(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (3, Vb) and a.dtype == torch.float32 and bool((a >= 0).all())
    np.testing.assert_allclose(a.sum(1).numpy(), 1.0, atol=1e-5)
    ref = scipy.stats.beta(0.1, 0.1 * (Vb - 1))
    for row in a.double().numpy():
        assert scipy.stats.kstest(row, ref.cdf).pvalue > 1e-3
    with pytest.raises(ValueError, match="generator"):
        init_state(None, 3, 10, 4, 2, device="cpu")


@pytest.mark.parametrize("content", [False, True])
def test_init_state_positional_is_jax_s(content):
    A = 2 if content else 1
    beta0 = _beta0().astype(np.float32)
    args = (K, V, 12, 3, A, content, beta0, None)
    got = init_state(None, *args, torch.float32, device="cpu")
    kw = init_state(None, K=K, V=V, N=12, P=3, A=A, content=content, beta_init=beta0,
                    kappa_p=None, dtype=torch.float32, device="cpu")
    _assert_same(got, kw)
    want = jax_init_state(jax.random.PRNGKey(0), *args, jnp.float32)
    for name, value in state_to_numpy(got).items():
        np.testing.assert_array_equal(value, np.asarray(getattr(want, name)), err_msg=name)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64, torch.float32, torch.float64])
def test_make_prevalence_design_positional_is_jax_s(dtype):
    """dtype in JAX's place; D and the design's tensors in that dtype.
    tests/test_torch_mstep.py holds the float32 design bit for bit."""
    rng = np.random.default_rng(0)
    X, ok = rng.normal(0, 1, (40, 2)), np.ones(40, bool)
    ok[-4:] = False
    D, d = mstep.make_prevalence_design(X, ok, True, dtype, 0.5, device="cpu")
    D2, d2 = mstep.make_prevalence_design(X, ok, fit_intercept=True, dtype=dtype,
                                          ridge_alpha=0.5, device="cpu")
    _assert_same(D, D2)
    _assert_same(tuple(d), tuple(d2))
    wide = dtype in (np.float64, torch.float64)
    want_D, want = jax_mstep.make_prevalence_design(
        X, ok, True, np.float64 if wide else jnp.float32, 0.5)
    assert D.dtype == want_D.dtype == (np.float64 if wide else np.float32)
    np.testing.assert_array_equal(D, want_D)
    assert d.DtD.dtype == (torch.float64 if wide else torch.float32)
    for name in ("DtD", "pen_mask", "n_docs", "pinv_ols", "inv_ridge"):
        # JAX without x64 keeps the float64 host solves in float32
        got = getattr(d, name).numpy().astype(np.float32)
        np.testing.assert_array_equal(got, np.asarray(getattr(want, name)), err_msg=name)
    assert d.built_ridge_alpha == want.built_ridge_alpha == 0.5


def test_make_prevalence_design_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float32 or float64"):
        mstep.make_prevalence_design(None, np.ones(4, bool), True, np.int32, device="cpu")


def _estep_inputs(seed=5, N=64, Ke=9, L=64, Ve=300):
    """tests/test_torch_estep.py's corpus: N documents of up to 48 unique
    words, the last 3 padding."""
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.full(Ve, 0.3), size=Ke).astype(np.float32)
    words = np.stack([rng.choice(Ve, L, replace=False) for _ in range(N)]).astype(np.int32)
    counts = rng.integers(1, 4, (N, L)).astype(np.float32)
    counts[:, 48:] = 0
    counts[-3:] = 0
    mu = rng.normal(0, 0.3, (N, Ke - 1)).astype(np.float32)
    mu[-3:] = 0
    sigma = (np.eye(Ke - 1) + 0.1).astype(np.float32)
    return (beta, mu, np.zeros((N, Ke - 1), np.float32), sigma, words, counts,
            np.zeros(N, np.int32), counts.sum(1) > 0)


def test_run_estep_positional_is_jax_s():
    """Two-pass, a pass-1 cap of 2 and a straggler fraction of 0.25, so
    the positions after batch_size carry values; tolerances of
    tests/test_torch_estep.py::test_run_estep_matches_jax."""
    beta, mu, eta0, sigma, words, counts, aspects, ok = _estep_inputs()
    T = torch.tensor
    si, se = precompute_sigma(T(sigma))
    head = (T(beta), T(mu), T(eta0), si, se, T(words), T(counts), T(aspects), T(ok))
    cfg = estep.NewtonConfig(bf16_hessian=False)
    tail = (16, False, None, None, 2, 0.25, 1, False)
    got = estep.run_estep(*head, cfg, *tail)
    kw = estep.run_estep(*head, cfg=cfg, batch_size=16, use_pallas=False, pallas_block=None,
                         vocab=None, pass1_iters=2, straggler_frac=0.25, scan_unroll=1,
                         fused_finalize=False)
    _assert_same(tuple(got), tuple(kw))
    jsi, jse = jax_precompute_sigma(jnp.asarray(sigma))
    want = jax_estep.run_estep(
        jnp.asarray(beta), jnp.asarray(mu), jnp.asarray(eta0), jsi, jse, jnp.asarray(words),
        jnp.asarray(counts), jnp.asarray(aspects), jnp.asarray(ok),
        jax_estep.NewtonConfig(bf16_hessian=False, **STAGE_KERNELS), *tail)
    assert int(got.straggler_overflow) == int(want.straggler_overflow) > 0
    np.testing.assert_allclose(float(got.bound), float(want.bound), rtol=1e-5)
    np.testing.assert_allclose(got.eta.numpy(), np.asarray(want.eta), atol=5e-3)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta), atol=1e-3)
    scale = np.abs(np.asarray(want.beta_ss)).max()
    np.testing.assert_allclose(got.beta_ss.numpy(), np.asarray(want.beta_ss),
                               atol=1e-3 * scale)
    np.testing.assert_allclose(got.sigma_ss.numpy(), np.asarray(want.sigma_ss),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kw", [dict(pallas_block=16), dict(scan_unroll=2)])
def test_run_estep_refuses_tpu_only_values(kw):
    beta, mu, eta0, sigma, words, counts, aspects, ok = _estep_inputs(N=16)
    T = torch.tensor
    si, se = precompute_sigma(T(sigma))
    with pytest.raises(ValueError, match=f"{next(iter(kw))}.*TPU-only"):
        estep.run_estep(T(beta), T(mu), T(eta0), si, se, T(words), T(counts), T(aspects),
                        T(ok), **kw)


def test_update_beta_content_positional_is_jax_s():
    """ftol_rel last, as in JAX; tolerances of
    tests/test_torch_content.py::test_update_beta_content_matches_jax."""
    rng = np.random.default_rng(6)
    A, Kc, Vc = 2, 4, 150
    ss = rng.gamma(1.0, 1.0, (A, Kc, Vc)).astype(np.float32)
    wc = rng.integers(1, 100, Vc).astype(np.float32)
    Xd = mstep.build_kappa_design(Kc, A, True).astype(np.float32)
    T = torch.tensor
    tail = (250.0, 30, None, 1e-6, None, None, None, 1e-3)
    b, k = mstep.update_beta_content(T(ss), T(wc), T(Xd), *tail)
    b2, k2 = mstep.update_beta_content(T(ss), T(wc), T(Xd), alpha=250.0, iters=30,
                                       kappa0=None, tol=1e-6, ftol_rel=1e-3)
    _assert_same((b, k), (b2, k2))
    bj, kj = jax_mstep.update_beta_content(jnp.asarray(ss), jnp.asarray(wc), jnp.asarray(Xd),
                                           *tail)
    np.testing.assert_allclose(k.numpy(), np.asarray(kj), atol=1e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=1e-3, atol=1e-7)


def test_spectral_init_positional_is_jax_s():
    """mesh before gram_norm, as in JAX; tolerance of
    tests/test_torch_spectral.py::test_spectral_init_matches_jax."""
    cc = CorpusCreation(5, 400, 60, 300, seed=3).generate_documents()
    got = spectral.spectral_init(cc.documents, 5, cc.V, 5000, False, torch.float32, None, "l1",
                                 device="cpu")
    kw = spectral.spectral_init(cc.documents, 5, cc.V, maxV=5000, verbose=False,
                                dtype=torch.float32, mesh=None, gram_norm="l1", device="cpu")
    _assert_same(got, kw)
    want = jax_spectral.spectral_init(cc.documents, 5, cc.V, 5000, False, jnp.float32, None,
                                      "l1")
    np.testing.assert_allclose(got, want, atol=2e-4)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def em_inputs():
    """One state, the data and designs of both packages
    (tests/test_torch_em.py::test_em_iterations_match_jax's set-up, with
    JAX's Newton solve on its XLA path, which compiles faster here than
    its Pallas kernels in interpret mode)."""
    docs, X = _docs()
    jc = jax_pad_corpus(docs, V=V)
    jplan = jax_make_bucket_plan(jc, 8)
    jb = jax_split(jc, jplan)
    ok = np.concatenate([b.doc_ok for b in jb])
    Xs = np.concatenate([np.pad(X[i], (0, s - len(i))) for i, s in zip(jplan.doc_ids, jplan.sizes)])
    D0, d0 = jax_mstep.make_prevalence_design(Xs, ok)
    splits = np.cumsum([b.N for b in jb])[:-1]
    jdata = jax_em.CorpusData(
        words=tuple(jnp.asarray(b.words) for b in jb),
        counts=tuple(jnp.asarray(b.counts) for b in jb),
        aspects=tuple(jnp.zeros(b.N, jnp.int32) for b in jb),
        doc_ok=tuple(jnp.asarray(b.doc_ok) for b in jb),
        D=tuple(jnp.asarray(d) for d in np.split(D0, splits)))
    jstate = jax_init_state(jax.random.PRNGKey(0), K, V, jplan.n_storage, D0.shape[1],
                            beta_init=jnp.asarray(_beta0()))
    c = pad_corpus(docs, V=V)
    plan = make_bucket_plan(c, 8)
    bk = split_corpus_by_plan(c, plan)
    D1, d1 = mstep.make_prevalence_design(Xs, ok, device="cpu")
    data = em.CorpusData(
        words=tuple(torch.tensor(b.words) for b in bk),
        counts=tuple(torch.tensor(b.counts) for b in bk),
        aspects=tuple(torch.zeros(b.N, dtype=torch.int32) for b in bk),
        doc_ok=tuple(torch.tensor(b.doc_ok) for b in bk),
        D=tuple(torch.tensor(d) for d in np.split(D1, splits)))
    state = state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate._fields}, "cpu")
    kw = dict(K=K, init_type="random", batch_size=8, newton_bf16_hessian=False)
    return dict(jstate=jstate, jdata=jdata, jdesign=d0, wc=jc.word_counts(),
                jcfg=JaxConfig(**kw), batches=plan.batch_sizes,
                state=state, data=data, design=d1, cfg=STMConfig(**kw))


def test_local_estep_stats_positional_is_jax_s(em_inputs):
    """vocab in vocab_axis's place; tolerances of
    tests/test_torch_estep.py::test_run_estep_matches_jax."""
    x = em_inputs
    got = em.local_estep_stats(x["state"], x["data"], x["cfg"], x["batches"], None)
    kw = em.local_estep_stats(x["state"], x["data"], x["cfg"], bucket_batches=x["batches"],
                              vocab=None)
    _assert_same(tuple(got[0]) + got[1:], tuple(kw[0]) + kw[1:])
    want = jax_em.local_estep_stats(x["jstate"], x["jdata"], x["jcfg"], x["batches"], None)
    np.testing.assert_allclose(float(got[0].bound), float(want[0].bound), rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=5e-3)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-3)


def test_em_iteration_positional_is_jax_s(em_inputs):
    """psum before bucket_batches, as in JAX; tolerances of
    tests/test_torch_em.py::test_em_iterations_match_jax."""
    x = em_inputs
    args = (x["state"], x["data"], x["design"], None, None, x["cfg"])
    got = em.em_iteration(*args, None, x["batches"], None)
    kw = em.em_iteration(*args, psum=None, bucket_batches=x["batches"], vocab=None)
    _assert_same(got, kw)
    want = jax_em.em_iteration(x["jstate"], x["jdata"], x["jdesign"], None, x["wc"],
                               x["jcfg"], lambda s: s, x["batches"], None)
    np.testing.assert_allclose(float(got.bound), float(want.bound), rtol=1e-5)
    got = state_to_numpy(got)
    for name, tol in (("beta", 1e-4), ("sigma", 5e-3), ("mu", 5e-3), ("eta", 5e-3),
                      ("theta", 1e-3), ("gamma", 5e-3)):
        np.testing.assert_allclose(got[name], np.asarray(getattr(want, name)), atol=tol,
                                   err_msg=name)


def _stm_pair():
    docs, X = _docs(seed=2)
    jcfg = JaxConfig(K=K, init_type="random", max_em_iter=2, batch_size=8,
                     convergence_threshold=0.0, **STAGE_KERNELS)
    cfg = STMConfig.from_json(jcfg.to_json())
    beta0 = _beta0(seed=3)
    return (JaxSTM(docs, K=K, X=X, config=jcfg, init_beta=beta0),
            lambda: STM(docs, K=K, X=X, config=cfg, init_beta=beta0, device="cpu"))


def test_expectation_maximization_positional_is_jax_s(tmp_path):
    """profile_dir 6th and start_iter 7th, as in JAX: after a fit of two
    iterations, a call with start_iter 1 in that place runs one more; the
    bound tolerance of tests/test_torch_em.py::test_stm_bound_trajectory_matches_jax.
    A profile_dir in 6th place gets a torch.profiler chrome trace of the
    iterations, with the fit's spans in it."""
    jm, port = _stm_pair()
    a, b = port(), port()
    for m in (a, b, jm):
        m.expectation_maximization()
    a.expectation_maximization(False, None, None, 5, False, None, 1)
    b.expectation_maximization(saving=False, output_dir=None, checkpoint_path=None,
                               checkpoint_every=5, resume=False, profile_dir=None, start_iter=1)
    assert len(a.last_bounds) == 3
    assert a.last_bounds == b.last_bounds
    np.testing.assert_array_equal(a.theta, b.theta)
    jm.expectation_maximization(False, None, None, 5, False, None, 1)
    np.testing.assert_allclose(a.last_bounds, jm.last_bounds, rtol=1e-5)
    a.expectation_maximization(False, None, None, 5, False, str(tmp_path / "prof"), 1)
    assert len(a.last_bounds) == 4 and len(a.trace) == 1
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"fit.iteration", "fit.readback", "em.estep", "em.mstep", "estep.gather",
            "estep.newton", "estep.finalize", "finalize.factor", "finalize.scatter"} <= spans
