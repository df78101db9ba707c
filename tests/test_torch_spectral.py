"""The port's spectral initialization (strutopy_tpu_torch/ops/spectral.py)
against the JAX package's on the same numpy inputs, on the CPU, and the
default ``STM(...)`` fit, which starts from it.

Tolerances.  Q and its row sums are sums of float32 products in another
order: rtol 1e-5.  The anchors are a chain of discrete choices and must
be identical, in order.  ``recover_l2`` runs 500 FISTA steps in float32
on ``P = M Mᵀ``, whose small eigenvalues leave flat directions along
which the iterates drift with the rounding of each product: two float32
implementations end as far from each other as each ends from the float64
NNLS solution (measured here: 8e-5 absolute on rows that sum to 1, about
0.2% of a mid-sized entry), so the recovered rows and the initial beta
are held to atol 2e-4 and to JAX's own distance from scipy's NNLS, not
to rtol 1e-3.
"""

import numpy as np
import pytest
import scipy.optimize
import jax.numpy as jnp
import torch

from strutopy_tpu.dgp.corpus_creation import CorpusCreation as JaxCorpusCreation
from strutopy_tpu.models.stm import STM as JaxSTM
from strutopy_tpu.ops import spectral as jax_spectral
from strutopy_tpu_torch import STM
from strutopy_tpu_torch.corpus.bow import pad_corpus
from strutopy_tpu_torch.dgp.corpus_creation import CorpusCreation
from strutopy_tpu_torch.ops import spectral
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


K = 5


@pytest.fixture(scope="module")
def corpus():
    cc = CorpusCreation(K, 400, 60, 300, seed=3).generate_documents()
    return cc


@pytest.fixture(scope="module")
def gram_inputs(corpus):
    c = pad_corpus(corpus.documents, V=corpus.V)
    return spectral.filter_corpus(c, corpus.V, 5000)


def test_corpus_creation_matches_jax(corpus):
    jc = JaxCorpusCreation(K, 400, 60, 300, seed=3).generate_documents()
    assert jc.documents == corpus.documents
    assert jc.V == corpus.V
    np.testing.assert_array_equal(jc.metadata, corpus.metadata)


@pytest.mark.parametrize("norm", ["none", "l1", "l2"])
def test_gram_matches_jax(gram_inputs, norm):
    wf, cf, keep, _wprob, nc = gram_inputs
    Qj, rj = jax_spectral._gram_scan(jnp.asarray(wf), jnp.asarray(cf), nc, len(keep),
                                     norm=norm)
    Q, r = spectral._gram_scan(torch.tensor(wf), torch.tensor(cf), nc, len(keep), norm=norm)
    scale = float(np.abs(np.asarray(Qj)).max())
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-6)


def test_gram_counts_repeated_padding_slots_once():
    """Padding slots all point at word 0 with count 0, and a document may
    name word 0 for real: the row scatter must ADD."""
    words = np.zeros((2, 6), np.int32)
    counts = np.zeros((2, 6), np.float32)
    words[0, :3], counts[0, :3] = [0, 2, 3], [2, 1, 1]
    words[1, :2], counts[1, :2] = [1, 0], [3, 2]
    Q, _ = spectral._gram_scan(torch.tensor(words), torch.tensor(counts), 1, 4)
    dtm = np.array([[2, 0, 1, 1], [2, 3, 0, 0]], np.float64)
    nd = dtm.sum(1)
    div = nd * (nd - 1)
    want = (dtm / np.sqrt(div)[:, None]).T @ (dtm / np.sqrt(div)[:, None]) \
        - np.diag((dtm / div[:, None]).sum(0))
    np.testing.assert_allclose(Q.numpy(), want, rtol=1e-6, atol=1e-7)


def test_fast_anchor_matches_jax(gram_inputs):
    wf, cf, keep, _wprob, nc = gram_inputs
    Q, _ = spectral._gram_scan(torch.tensor(wf), torch.tensor(cf), nc, len(keep))
    for k in (K, 13):
        want = np.asarray(jax_spectral.fast_anchor(jnp.asarray(Q.numpy()), k))
        got = spectral.fast_anchor(Q, k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert len(set(want.tolist())) == k


def test_fast_anchor_tie_goes_to_the_first_row():
    """Two rows with exactly the same score: both packages take the lower
    index (argmax returns the first maximum)."""
    Q = np.zeros((6, 6), np.float32)
    Q[1, 1] = Q[4, 4] = 2.0  # columns 1 and 4 tie exactly
    Q[2, 2] = 1.0
    Q[0, 3] = 0.5
    want = np.asarray(jax_spectral.fast_anchor(jnp.asarray(Q), 3))
    got = spectral.fast_anchor(torch.tensor(Q), 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 1 and got[1] == 4


def test_recover_l2_matches_jax_and_scipy_nnls():
    rng = np.random.default_rng(0)
    Vp, Kk = 30, 4
    Q = rng.dirichlet(np.ones(Vp), size=Vp).astype(np.float64)
    anchor = np.array([3, 11, 19, 27], np.int32)
    wprob = Q.sum(1) / Q.sum()
    got = spectral.recover_l2(torch.tensor(Q, dtype=torch.float32), torch.tensor(anchor),
                              torch.tensor(wprob, dtype=torch.float32), iters=2000).numpy()
    want = np.asarray(jax_spectral.recover_l2(
        jnp.asarray(Q, jnp.float32), jnp.asarray(anchor), jnp.asarray(wprob, jnp.float32),
        iters=2000))
    M = Q[anchor]
    weights = np.zeros((Vp, Kk))
    for i in range(Vp):
        if i in anchor:
            weights[i, list(anchor).index(i)] = 1.0
        else:
            weights[i], _ = scipy.optimize.nnls(M.T, Q[i])
    A = weights * wprob[:, None]
    exact = (A / A.sum(axis=0, keepdims=True)).T
    # tests/test_spectral.py:36 holds the JAX solver to scipy's at 2e-3
    np.testing.assert_allclose(got, exact, atol=2e-3)
    np.testing.assert_allclose(got, want, atol=2e-4)
    # the port is no farther from the float64 solution than JAX is
    assert np.abs(got - exact).max() <= 1.5 * np.abs(want - exact).max() + 1e-6


def test_spectral_init_matches_jax(corpus):
    want = jax_spectral.spectral_init(corpus.documents, K, corpus.V)
    got = spectral.spectral_init(corpus.documents, K, corpus.V, device="cpu")
    assert got.shape == (K, corpus.V) and got.dtype == np.float64
    assert np.all(got > 0)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-8)
    np.testing.assert_allclose(got, want, atol=2e-4)
    # most entries agree far closer than the drift along the flat directions
    assert np.mean(np.abs(got - want) <= 1e-6 + 1e-3 * np.abs(want)) > 0.9


def test_spectral_init_with_short_documents(corpus):
    """Documents with fewer than two surviving tokens are left out of the
    Gram matrix (their div = n(n-1) is 0)."""
    docs = list(corpus.documents[:120])
    docs[5] = [(docs[5][0][0], 1)]  # one token
    docs[17] = []  # none
    want = jax_spectral.spectral_init(docs, K, corpus.V, maxV=100)
    got = spectral.spectral_init(docs, K, corpus.V, maxV=100, device="cpu")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_stm_default_arguments_match_jax(corpus):
    """``STM(documents, dictionary, K=, X=)`` with nothing else: spectral
    init, and (3 iterations < 10) the single-pass schedule."""
    docs = corpus.documents[:96]
    X = corpus.metadata[:96, 0].astype(np.float64)
    jm = JaxSTM(docs, corpus.dictionary, K=K, X=X, max_em_iter=3)
    jm.expectation_maximization(saving=False)
    m = STM(docs, corpus.dictionary, K=K, X=X, max_em_iter=3, device="cpu")
    m.expectation_maximization()
    assert m.config.init_type == "spectral"
    assert len(m.last_bounds) == len(jm.last_bounds) == 3
    np.testing.assert_allclose(m.last_bounds, jm.last_bounds, rtol=1e-4)
    np.testing.assert_allclose(m.theta, jm.theta, atol=5e-3)


def test_stm_default_two_pass_schedule_matches_jax(corpus):
    """From 10 iterations up the default constructor turns the two-pass
    straggler schedule on; 10 iterations against the JAX fit."""
    docs = corpus.documents[:64]
    jm = JaxSTM(docs, corpus.dictionary, K=K, max_em_iter=10, convergence_threshold=0.0)
    jm.expectation_maximization(saving=False)
    m = STM(docs, corpus.dictionary, K=K, max_em_iter=10, convergence_threshold=0.0,
            device="cpu")
    m.expectation_maximization()
    assert m.config.newton_pass1_iters == 6
    np.testing.assert_allclose(m.last_bounds, jm.last_bounds, rtol=1e-4)
