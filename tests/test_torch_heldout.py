"""The port's evaluation layer (eval/heldout.py, eval/perplexity.py,
pipeline.train_and_eval_heldout) and its numpy copies (dgp/, ops/design.py,
corpus/bow.py) against the JAX package's on the same inputs, on the CPU.

The numpy functions are copies and must agree to 1e-6 or exactly; the
float32 device variant to 1e-5 of the float64 anchor; heldout
likelihoods of whole fits to 1e-3 absolute in nats.
"""

import numpy as np
import pytest
import scipy.sparse
import jax.numpy as jnp

from strutopy_tpu import pipeline as jax_pipeline
from strutopy_tpu.corpus import bow as jax_bow
from strutopy_tpu.dgp.corpus_creation import CorpusCreation as JaxCorpusCreation
from strutopy_tpu.eval import heldout as jax_heldout
from strutopy_tpu.eval.perplexity import perplexity as jax_perplexity
from strutopy_tpu.ops import design as jax_design
from strutopy_tpu_torch import pipeline
from strutopy_tpu_torch.corpus import bow
from strutopy_tpu_torch.dgp import CorpusCreation
from strutopy_tpu_torch.eval import (cut_in_half, eval_heldout, eval_heldout_torch,
                                     perplexity, split_corpus)
from strutopy_tpu_torch.ops import design
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


K = 4


@pytest.fixture(scope="module")
def cc():
    c = CorpusCreation(K, 120, 50, 200, seed=7).generate_documents()
    c.split_corpus(proportion=0.8)
    return c


@pytest.mark.parametrize("kw", [
    dict(),
    dict(dgp="LDA", alpha="asymmetric"),
    dict(dgp="LDA", treatment=True, alpha_treatment="auto-linear"),
    dict(level=2, alpha=0.3),
])
def test_corpus_creation_is_the_same_corpus(kw):
    a = JaxCorpusCreation(3, 30, 40, 120, seed=5, **kw).generate_documents()
    b = CorpusCreation(3, 30, 40, 120, seed=5, **kw).generate_documents()
    assert a.documents == b.documents and a.V == b.V
    np.testing.assert_array_equal(a.theta, b.theta)
    np.testing.assert_array_equal(a.beta, b.beta)
    np.testing.assert_array_equal(a.gamma, b.gamma)
    assert len(a.dictionary) == len(b.dictionary)
    a.split_corpus(validation_set=True)
    b.split_corpus(validation_set=True)
    for name in ("train_docs", "test_docs", "validate_docs", "test_1_docs", "test_2_docs"):
        assert getattr(a, name) == getattr(b, name)
    pa, pb = a.padded_corpus(), b.padded_corpus()
    np.testing.assert_array_equal(pa.words, pb.words)
    np.testing.assert_array_equal(pa.counts, pb.counts)


def test_design_helpers_match_jax():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=50), rng.integers(0, 2, 50)
    B = design.bspline_basis(x, df=6)
    np.testing.assert_array_equal(B, jax_design.bspline_basis(x, df=6))
    assert B.shape == (50, 6)
    np.testing.assert_array_equal(design.interact(B, y), jax_design.interact(B, y))
    np.testing.assert_array_equal(design.prevalence_matrix(B, y, design.interact(B, y)),
                                  jax_design.prevalence_matrix(B, y, jax_design.interact(B, y)))
    with pytest.raises(ValueError, match="must exceed"):
        design.bspline_basis(x, df=3)


def test_bow_helpers_match_jax(cc):
    c, jc = bow.pad_corpus(cc.documents, V=cc.V), jax_bow.pad_corpus(cc.documents, V=cc.V)
    np.testing.assert_array_equal(c.doc_lengths, jc.doc_lengths)
    idx = [5, 1, 17]
    np.testing.assert_array_equal(c.take(idx).words, jc.take(idx).words)
    np.testing.assert_array_equal(c.pad_terms_to(256).counts, jc.pad_terms_to(256).counts)
    with pytest.raises(ValueError, match="cannot shrink"):
        c.pad_terms_to(64)
    assert bow.to_bow(c) == jax_bow.to_bow(jc)
    assert [sorted(d) for d in bow.to_bow(c)] == [sorted(d) for d in cc.documents]
    dtm = bow.create_dtm(cc.documents, V=cc.V)
    np.testing.assert_array_equal(dtm, jax_bow.create_dtm(cc.documents, V=cc.V))
    assert bow.from_dtm(dtm) == jax_bow.from_dtm(dtm)
    assert bow.from_dtm(scipy.sparse.csr_matrix(dtm)) == bow.from_dtm(dtm)
    with pytest.raises(ValueError, match="negative"):
        bow.from_dtm(-dtm)
    assert list(bow.Vocabulary.from_tokens(["a", "b"])) == ["a", "b"]


def _theta_beta(cc, n, seed=1):
    rng = np.random.default_rng(seed)
    theta = rng.dirichlet(np.ones(K), size=n)
    beta = rng.dirichlet(np.full(cc.V, 0.5), size=K)
    return theta, beta


def test_eval_heldout_and_perplexity_match_jax(cc):
    theta, beta = _theta_beta(cc, len(cc.test_2_docs))
    got = eval_heldout(cc.test_2_docs, theta, beta)
    assert abs(got - jax_heldout.eval_heldout(cc.test_2_docs, theta, beta)) < 1e-6
    padded = bow.pad_corpus(cc.test_2_docs, V=cc.V)
    assert abs(eval_heldout(padded, theta, beta) - got) < 1e-12
    p = perplexity(cc.test_docs, theta, beta)
    assert abs(p - jax_perplexity(cc.test_docs, theta, beta)) < 1e-6 * p
    beta3 = np.stack([beta, beta[::-1]])
    assert abs(perplexity(cc.test_docs, theta, beta3)
               - jax_perplexity(cc.test_docs, theta, beta3)) < 1e-6 * p


def test_eval_heldout_torch_matches_the_anchor_and_jax(cc):
    theta, beta = _theta_beta(cc, len(cc.test_2_docs))
    c = bow.pad_corpus(cc.test_2_docs, V=cc.V)
    got = float(eval_heldout_torch(c.words, c.counts, c.doc_ok, theta, beta, device="cpu"))
    want = float(jax_heldout.eval_heldout_jax(
        jnp.asarray(c.words), jnp.asarray(c.counts), jnp.asarray(c.doc_ok),
        jnp.asarray(theta, jnp.float32), jnp.asarray(beta, jnp.float32)))
    assert abs(got - want) < 1e-6 * abs(want)
    assert abs(got - eval_heldout(cc.test_2_docs, theta, beta)) < 1e-5


def test_eval_heldout_torch_refuses_out_of_vocabulary_ids(cc):
    theta, beta = _theta_beta(cc, 2)
    words = np.array([[1, cc.V], [2, 0]], np.int32)
    counts = np.array([[1, 2], [1, 0]], np.float32)
    with pytest.raises(ValueError, match="different vocabulary"):
        eval_heldout_torch(words, counts, np.ones(2, bool), theta, beta, device="cpu")
    # a padding slot (count 0) may hold any id
    counts[0, 1] = 0
    assert np.isfinite(float(eval_heldout_torch(words.clip(max=cc.V - 1), counts,
                                                np.ones(2, bool), theta, beta, device="cpu")))


def test_splits_match_jax(cc):
    assert cut_in_half(cc.test_docs) == jax_heldout.cut_in_half(cc.test_docs)
    assert cut_in_half(cc.test_docs) == (cc.test_1_docs, cc.test_2_docs)
    padded = bow.pad_corpus(cc.documents, V=cc.V)
    for kw in (dict(), dict(validation_set=True, proportion=0.6),
               dict(document_completion=False)):
        got, want = split_corpus(cc.documents, **kw), jax_heldout.split_corpus(cc.documents, **kw)
        assert got == want
        assert split_corpus(padded, **kw).keys() == want.keys()
    assert split_corpus(cc.documents)["train"] == cc.train_docs


@pytest.mark.parametrize("fast", [False, True])
def test_train_and_eval_heldout_matches_jax(cc, fast):
    X = cc.metadata[:, 0].astype(np.float64)
    kw = dict(K=K, X=X, max_em_iter=3, fast=fast, batch_size=16)
    ll, mb, mt = pipeline.train_and_eval_heldout(cc.train_docs, cc.test_docs, device="cpu", **kw)
    jll, jmb, _ = jax_pipeline.train_and_eval_heldout(cc.train_docs, cc.test_docs, **kw)
    assert np.isfinite(ll) and abs(ll - jll) < 1e-3
    assert (mt is mb) == fast
    np.testing.assert_allclose(mb.last_bounds, jmb.last_bounds, rtol=1e-4)
    with pytest.raises(ValueError, match="pass covariates for"):
        pipeline.train_and_eval_heldout(cc.train_docs, cc.test_docs, K=K, X=X[:10],
                                        device="cpu")
