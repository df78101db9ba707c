"""The port's EM iteration and the STM estimator against the JAX package and the
float64 oracle (strutopy_tpu/utils/reference_numpy.py), its
configuration surface, and its import hygiene."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
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
from strutopy_tpu.ops import mstep as jax_mstep
from strutopy_tpu_torch import STM, STMConfig
from strutopy_tpu_torch.corpus.bow import pad_corpus
from strutopy_tpu_torch.corpus.bucketing import make_bucket_plan, split_corpus_by_plan
from strutopy_tpu_torch.models import em
from strutopy_tpu_torch.models.config import TPU_ONLY
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
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _docs(seed=0, N=40, K=6, V=400):
    """STM-DGP documents of mixed length: a quarter of them have more
    than 128 unique words, so the corpus splits into two length buckets."""
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.full(V, 0.2), size=K)
    docs = []
    for d in range(N):
        theta = rng.dirichlet(np.full(K, 0.5))
        n = 600 if d % 4 == 0 else 120
        draw = rng.multinomial(n, theta @ beta)
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    X = rng.integers(0, 2, N).astype(np.float64)
    return docs, X


def _beta0(K, V, seed=11):
    g = np.random.RandomState(seed).gamma(0.1, 1.0, (K, V))
    return g / g.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("model_type,pass1_iters", [("STM", 0), ("CTM", 2)])
def test_em_iterations_match_jax(model_type, pass1_iters):
    """Three EM iterations of make_em_step in both packages from one
    state, carried across by utils/convert.py."""
    K, V = 6, 400
    docs, X = _docs()
    kw = dict(K=K, model_type=model_type, init_type="random", batch_size=8,
              newton_pass1_iters=pass1_iters, newton_straggler_frac=0.5,
              newton_bf16_hessian=False)
    jcfg = JaxConfig(**kw, **STAGE_KERNELS)
    cfg = STMConfig(**kw)

    jc = jax_pad_corpus(docs, V=V)
    jplan = jax_make_bucket_plan(jc, 8)
    jb = jax_split(jc, jplan)
    assert jplan.n_buckets == 2
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
    jstate = jax_init_state(jax.random.PRNGKey(0), K=K, V=V, N=jplan.n_storage,
                            P=D0.shape[1], beta_init=jnp.asarray(_beta0(K, V)))
    jstep = jax_em.make_em_step(jcfg, d0, None, jc.word_counts(), jplan.batch_sizes)

    c = pad_corpus(docs, V=V)
    plan = make_bucket_plan(c, 8)
    bk = split_corpus_by_plan(c, plan)
    assert plan.batch_sizes == jplan.batch_sizes and plan.Ls == jplan.Ls
    D1, d1 = mstep.make_prevalence_design(Xs, ok, device="cpu")
    np.testing.assert_array_equal(D1, D0)
    data = em.CorpusData(
        words=tuple(torch.tensor(b.words) for b in bk),
        counts=tuple(torch.tensor(b.counts) for b in bk),
        aspects=tuple(torch.zeros(b.N, dtype=torch.int32) for b in bk),
        doc_ok=tuple(torch.tensor(b.doc_ok) for b in bk),
        D=tuple(torch.tensor(d) for d in np.split(D1, splits)))
    state = state_from_numpy({f: np.asarray(getattr(jstate, f)) for f in jstate._fields},
                             "cpu")
    step = em.make_em_step(cfg, d1, None, None, plan.batch_sizes)

    for _ in range(3):
        jstate = jstep(jstate, jdata)
        state = step(state, data)
        # the bound contract of tests/test_pallas_stages.py:185-189
        np.testing.assert_allclose(float(state.bound), float(jstate.bound), rtol=1e-5)
        assert int(state.straggler_overflow) == int(jstate.straggler_overflow)
    got = state_to_numpy(state)
    # parameters after three iterations: float32 noise of the converged
    # etas (atol 5e-3, the E-step contract) carried through the M-step
    for name, tol in (("beta", 1e-4), ("sigma", 5e-3), ("mu", 5e-3), ("eta", 5e-3),
                      ("theta", 1e-3), ("gamma", 5e-3)):
        np.testing.assert_allclose(got[name], np.asarray(getattr(jstate, name)),
                                   atol=tol, err_msg=name)


def test_stm_bound_trajectory_matches_jax():
    """STM(init_beta=...) in both packages: 2 cold single-pass iterations
    then 2 on the two-pass schedule, the port configured from the JAX
    configuration's JSON."""
    K = 6
    docs, X = _docs(seed=2)
    jcfg = JaxConfig(K=K, init_type="random", max_em_iter=4, batch_size=8,
                     newton_pass1_iters=3, newton_straggler_frac=0.5,
                     convergence_threshold=0.0, **STAGE_KERNELS)
    cfg = STMConfig.from_json(jcfg.to_json())
    beta0 = _beta0(K, 400, seed=3)
    jm = JaxSTM(docs, K=K, X=X, config=jcfg, init_beta=beta0)
    jm.expectation_maximization(saving=False)
    m = STM(docs, K=K, X=X, config=cfg, init_beta=beta0, device="cpu")
    m.expectation_maximization()
    assert len(m.last_bounds) == 4
    np.testing.assert_allclose(m.last_bounds, jm.last_bounds, rtol=1e-5)
    np.testing.assert_allclose(m.theta, jm.theta, atol=1e-3)
    np.testing.assert_allclose(m.beta, jm.beta, atol=1e-4)
    # the budget overflow counts documents unconverged after pass 1; with
    # the bf16 Hessian a document whose pass-1 convergence sits on the
    # float32 floor (test_torch_estep.py::_check_iters) can land on either
    # side (measured 12 vs 13 of 40); run_estep's exact agreement is
    # checked in test_torch_estep.py
    assert abs(m.straggler_overflow - jm.straggler_overflow) <= 2


@pytest.mark.parametrize("model_type", ["CTM", "STM"])
def test_bound_matches_float64_oracle(model_type, toy_corpus, toy_dictionary, toy_metadata):
    """The float32 port reproduces the float64 NumPy/SciPy oracle's ELBO
    trajectory (serial scipy-BFGS E-step) to ~1e-4 — the invariant the
    JAX package holds (tests/test_integration.py)."""
    from strutopy_tpu.utils.reference_numpy import fit_ctm_lda, fit_stm_ols

    train = toy_corpus.train_docs
    X = np.asarray(toy_metadata[: len(train)], np.float64)
    m = STM(train, toy_dictionary, K=3, X=X, max_em_iter=4, init_type="random",
            model_type=model_type, device="cpu")
    m.expectation_maximization()
    if model_type == "CTM":
        oracle, *_ = fit_ctm_lda(train, m.V, 3, n_iter=len(m.last_bounds))
        rtol = 1e-4
    else:
        oracle, *_ = fit_stm_ols(train, m.V, 3, X, n_iter=len(m.last_bounds))
        rtol = 2e-4  # as tests/test_integration.py: the OLS path adds f32 solves
    assert len(m.last_bounds) >= 2
    np.testing.assert_allclose(m.last_bounds, oracle, rtol=rtol)


@pytest.mark.parametrize("field", sorted(TPU_ONLY))
def test_config_rejects_tpu_only_knobs(field):
    default = TPU_ONLY[field]
    other = (not default) if isinstance(default, bool) else default + 1
    with pytest.raises(ValueError, match="TPU-only"):
        STMConfig(K=5, **{field: other})
    STMConfig(K=5, **{field: default})


@pytest.mark.parametrize("kw,exc", [
    (dict(nu_method="ns"), ValueError),
    (dict(content=True, A=1), ValueError),  # a content model has >= 2 aspects
    (dict(init_type="anchor"), ValueError),
    # debug_checks is ported (tests/test_torch_debug.py); the whole-loop
    # kernel still excludes the two-pass schedule, as in the JAX package
    (dict(use_pallas=True, newton_pass1_iters=3), ValueError),
])
def test_config_rejects_what_is_not_ported(kw, exc):
    with pytest.raises(exc):
        STMConfig(K=5, **kw)
    assert STMConfig(K=5, debug_checks=True).debug_checks


def test_stm_signature_is_the_jax_signature():
    """Positional callers of either package reach the same parameters:
    name by name and default by default up to ``init_beta``; the port
    adds only the keyword-only ``device``."""
    import inspect

    ours = list(inspect.signature(STM.__init__).parameters.values())
    theirs = list(inspect.signature(JaxSTM.__init__).parameters.values())
    assert theirs[-1].name == "init_beta"
    assert [p.name for p in ours[:len(theirs)]] == [p.name for p in theirs]
    for a, b in zip(ours, theirs):
        assert a.default is b.default or a.default == b.default, a.name
        assert a.kind == b.kind, a.name
    extra = ours[len(theirs):]
    assert [p.name for p in extra] == ["device"]
    assert extra[0].kind is inspect.Parameter.KEYWORD_ONLY


def test_stm_accepts_dtype_and_refuses_mesh(tmp_path):
    """dtype is accepted; a mesh is no longer refused: on a gloo world of
    one, STM(mesh=make_mesh(1)) and STM(mesh=make_mesh_2d(1, 1)) fit
    exactly the unmeshed fit (nothing is reduced in a world of one)."""
    from strutopy_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from torch_world import one_thread, world_of_one

    docs, X = _docs(N=8)
    m = STM(docs, None, False, 3, X, False, 2, 0.0, 1e-5, True, None, None, np.float32,
            "random", device="cpu")
    assert m.config.init_type == "random" and m.config.max_em_iter == 2
    with one_thread():
        m.expectation_maximization()
    with one_thread(), world_of_one(tmp_path):
        for mesh in (make_mesh(1), make_mesh_2d(1, 1)):
            mm = STM(docs, K=3, X=X, max_em_iter=2, init_type="random", mesh=mesh,
                     device="cpu")
            mm.expectation_maximization()
            np.testing.assert_array_equal(mm.last_bounds, m.last_bounds)
            np.testing.assert_array_equal(mm.beta, m.beta)
            np.testing.assert_array_equal(mm.theta, m.theta)


def test_config_reads_the_jax_json():
    jcfg = JaxConfig(K=7, mode="ridge", newton_pass1_iters=5, nu_method="chol",
                     **STAGE_KERNELS)
    cfg = STMConfig.from_json(jcfg.to_json())
    ours = dataclasses.asdict(cfg)
    theirs = dataclasses.asdict(jcfg)
    for k in STAGE_KERNELS:
        theirs.pop(k)
    assert ours == theirs
    assert STMConfig.from_json(cfg.to_json()) == cfg


def test_spectral_init_is_refused_not_replaced():
    """init_type="spectral" runs the spectral initialization: the initial
    beta is ``spectral_init``'s, not the random draw's."""
    from strutopy_tpu_torch.ops.spectral import spectral_init

    docs, _ = _docs(N=8)
    V = 1 + max(w for d in docs for w, _ in d)
    m = STM(docs, K=3, init_type="spectral", device="cpu")
    np.testing.assert_allclose(
        m.beta, spectral_init(docs, 3, V, device="cpu").astype(np.float32), rtol=1e-6)
    r = STM(docs, K=3, init_type="random", device="cpu")
    assert np.abs(m.beta - r.beta).max() > 1e-3


def test_import_loads_no_jax():
    code = ("import sys, strutopy_tpu_torch; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'strutopy_tpu')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
