"""The port's text preparation (strutopy_tpu_torch/corpus/stem.py,
ngrams.py, preprocess.py, native.py's build_bow) and raw-text serving
(ThetaServer.infer_text) against the JAX package on the same inputs.

Text preparation is exact: the same tokens, vocabulary and documents, on
the native path and the Python path of both packages.  Served theta is
held as tests/test_torch_serving.py holds it: eta within 5e-3 and theta
within 1e-3 on the documents both E-steps bring below max|g| 1e-4.
"""

import json

import numpy as np
import pytest
import torch

from strutopy_tpu.corpus import ngrams as jax_ngrams
from strutopy_tpu.corpus import preprocess as jax_pre
from strutopy_tpu.corpus.stem import porter_stem as jax_porter_stem
from strutopy_tpu.models.config import STMConfig as JaxConfig
from strutopy_tpu.models.serving import ThetaServer as JaxThetaServer
from strutopy_tpu.models.stm import STM as JaxSTM
from strutopy_tpu_torch import STM, STMConfig, ThetaServer
from strutopy_tpu_torch.corpus import native, ngrams
from strutopy_tpu_torch.corpus import preprocess as pre
from strutopy_tpu_torch.corpus.bow import pad_corpus
from strutopy_tpu_torch.corpus.stem import porter_stem, stem_tokens
from strutopy_tpu_torch.models.serving import _prior_means
from strutopy_tpu_torch.ops import stages
from strutopy_tpu_torch.ops.estep import _gather_beta
from strutopy_tpu_torch.ops.linalg import precompute_sigma
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


# tests/test_text_prep_extras.py's classic Porter cases
PORTER_CASES = {
    "caresses": "caress", "ponies": "poni", "ties": "ti", "caress": "caress",
    "cats": "cat", "agreed": "agre", "plastered": "plaster", "motoring": "motor",
    "sing": "sing", "conflated": "conflat", "troubling": "troubl", "sized": "size",
    "hopping": "hop", "relational": "relat", "conditional": "condit",
    "vietnamization": "vietnam", "predication": "predic", "triplicate": "triplic",
    "formative": "form", "formalize": "formal", "revival": "reviv",
    "allowance": "allow", "inference": "infer", "probate": "probat", "rate": "rate",
    "cease": "ceas", "controll": "control", "roll": "roll",
}

# tests/test_native_bow.py's texts: unicode case and punctuation, unicode
# whitespace, min_len and apostrophes, empty documents
TEXTS = [
    "The quick brown fox; jumps over 42 lazy dogs!!",
    "Fox news: the lazy-dog's QUICK jump (again) -- truly quick.",
    "",
    "naïve café déjà-vu — ÉLAN élan straße",
    "word with nbsp and\ttabs\nnewlines",
    "a ab abc a1b2c3 don't can't it's",
    "repeat repeat repeat unique",
    "  only   spaces   ",
]

BOW_KWARGS = [
    {},
    {"stopwords": None},
    {"min_doc_freq": 2},
    {"max_doc_frac": 0.4},
    {"min_doc_freq": 2, "max_doc_frac": 0.6},
]


def _seeded_texts(seed=3, n=60, n_words=40):
    """English-like documents: every token of these goes through the stemmer."""
    rng = np.random.default_rng(seed)
    stems = ["run", "model", "comput", "relat", "generat", "hop", "agree", "nation",
             "cond", "predic", "format", "allow", "sens", "happi", "control", "topic"]
    suffixes = ["", "s", "es", "ed", "ing", "ational", "ization", "ness", "ful", "ly",
                "ment", "ities", "ive", "able", "ance", "ence", "er", "ism", "y", "e"]
    words = [s + x for s in stems for x in suffixes]
    return [" ".join(rng.choice(words, n_words)) for _ in range(n)]


def test_porter_stemmer_classic_cases_match_jax():
    for word, want in PORTER_CASES.items():
        assert porter_stem(word) == want == jax_porter_stem(word), word


def test_porter_stemmer_matches_jax_on_every_token_of_a_text_set():
    toks = sorted({t for text in _seeded_texts() for t in pre.tokenize(text, stopwords=None)})
    assert len(toks) > 200
    assert stem_tokens(toks) == [jax_porter_stem(t) for t in toks]


def test_ngrams_match_jax():
    docs = [["new", "york", "city"]] * 20 + [["old", "york"]] * 2
    merges = ngrams.learn_bigrams(docs, min_count=5, threshold=1.0)
    assert merges == jax_ngrams.learn_bigrams(docs, min_count=5, threshold=1.0)
    assert ("new", "york") in merges
    line = ["new", "york", "is", "big", "new", "york"]
    assert ngrams.apply_bigrams(line, merges) == jax_ngrams.apply_bigrams(line, merges)
    tok_docs = [pre.tokenize(t, stopwords=None) for t in _seeded_texts(n_words=60)]
    for passes in (1, 2):
        got = ngrams.ngram_docs(tok_docs, min_count=3, threshold=0.5, passes=passes)
        assert got == jax_ngrams.ngram_docs(tok_docs, min_count=3, threshold=0.5, passes=passes)


def test_tokenize_matches_jax():
    for text in TEXTS + _seeded_texts(n=5):
        for stop in (pre.DEFAULT_STOPWORDS, None):
            assert pre.tokenize(text, stop) == jax_pre.tokenize(text, stop)
    assert pre.DEFAULT_STOPWORDS == jax_pre.DEFAULT_STOPWORDS


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("kw", BOW_KWARGS + [{"stem": True}, {
    "stem": True, "ngrams": True, "ngram_min_count": 3, "ngram_threshold": 1.0}])
def test_build_corpus_matches_jax(kw, use_native):
    texts = TEXTS + _seeded_texts(n=30)
    bow, vocab = pre.build_corpus(texts, use_native=use_native, **kw)
    jbow, jvocab = jax_pre.build_corpus(texts, use_native=use_native, **kw)
    assert list(vocab) == list(jvocab)
    assert bow == jbow


@pytest.mark.parametrize("kw", BOW_KWARGS)
def test_native_build_corpus_matches_the_python_path(kw):
    assert native.available()
    (bow_n, vocab_n), (bow_p, vocab_p) = (pre.build_corpus(TEXTS, use_native=u, **kw)
                                          for u in (True, False))
    assert list(vocab_n) == list(vocab_p)
    assert bow_n == bow_p


def test_native_build_corpus_unicode_fuzz():
    """tests/test_native_bow.py's fuzz: random codepoints across ASCII,
    punctuation, digits, Latin-1, Greek, CJK, emoji and exotic whitespace
    give the same vocabulary and documents on both paths."""
    rng = np.random.default_rng(42)
    pools = [
        [chr(c) for c in range(ord("a"), ord("z") + 1)],
        [chr(c) for c in range(ord("A"), ord("Z") + 1)],
        list("0123456789"),
        list("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"),
        ["à", "é", "ß", "ñ", "ü", "Æ", "ç", "Ø"],
        ["α", "β", "Ω", "λ"],
        ["中", "文", "字"],
        ["😀", "🚀"],
        [" ", "\t", "\n", " ", " ", "　"],
    ]
    weights = np.array([8, 2, 2, 2, 2, 1, 1, 1, 4], np.float64)
    weights /= weights.sum()
    for trial in range(4):
        texts = []
        for _ in range(40):
            pick = rng.choice(len(pools), size=int(rng.integers(0, 200)), p=weights)
            texts.append("".join(pools[int(j)][int(rng.integers(len(pools[int(j)])))]
                                 for j in pick))
        for mdf in (1, 2):
            nat = pre.build_corpus(texts, use_native=True, min_doc_freq=mdf)
            py = pre.build_corpus(texts, use_native=False, min_doc_freq=mdf)
            assert list(nat[1]) == list(py[1]), trial
            assert nat[0] == py[0], (trial, mdf)


def test_removed_by_threshold_matches_jax():
    texts = ["aaa aaa bbb", "aaa ccc ccc ccc", "aaa aaa aaa bbb"]
    stats = pre.removed_by_threshold(texts, thresholds=[1, 2, 3, 4], stopwords=None)
    assert stats["tokens_removed"] == [0, 3, 5, 11]
    assert stats["docs_removed"] == [0, 0, 0, 3]
    texts = _seeded_texts(n=40) + TEXTS
    assert pre.removed_by_threshold(texts, [1, 2, 5, 20]) == jax_pre.removed_by_threshold(
        texts, [1, 2, 5, 20])


@pytest.mark.parametrize("use_native", [True, False])
def test_align_corpus_matches_jax(use_native):
    rng = np.random.default_rng(7)
    words = [f"tok{c}" for c in "abcdefghij"] + ["naïve", "café", "中文", "alpha", "beta"]
    _, vocab = pre.build_corpus([" ".join(rng.choice(words, 30)) for _ in range(40)])
    reqs = [" ".join(rng.choice(words + ["zzz", "qqq"], 25)) for _ in range(50)]
    reqs += ["the and of", "zzz qqq zzz", ""]
    got = pre.align_corpus(reqs, vocab, use_native=use_native)
    assert got == jax_pre.align_corpus(reqs, list(vocab), use_native=use_native)
    assert got == pre.align_corpus(reqs, vocab, use_native=not use_native)
    bow, report = got
    assert report["oov_types"] == 2 and report["docs_emptied"] >= 1
    # pre-tokenized documents take the Python path in both packages
    toks = [["alpha", "beta", "alpha", "zzz"]]
    ids = {t: i for i, t in enumerate(vocab)}
    assert pre.align_corpus(toks, vocab) == jax_pre.align_corpus(toks, list(vocab)) == (
        [sorted([(ids["alpha"], 2), (ids["beta"], 1)])],
        {"tokens_dropped": 1, "oov_types": 1, "docs_emptied": 0})


# ---------------------------------------------------------------------------
# raw-text serving
# ---------------------------------------------------------------------------

K, V = 4, 120


def _token(i: int) -> str:
    """Word id -> a letters-only token that tokenize keeps and no stopword."""
    return "qx" + "".join(chr(ord("a") + (i // 26 ** k) % 26) for k in (1, 0))


def _texts(seed, n, beta, n_words=60, oov=()):
    rng = np.random.default_rng(seed)
    out = []
    for d in range(n):
        draw = rng.multinomial(n_words, rng.dirichlet(np.full(K, 0.5)) @ beta)
        toks = [_token(w) for w in np.repeat(np.arange(V), draw)]
        toks += list(oov[: d % 3])
        rng.shuffle(toks)
        out.append(", ".join(toks[:5]) + ". " + " 7 ".join(toks[5:]).upper())
    return out, rng.integers(0, 2, n).astype(np.float64)


def _grad_norm(srv_beta, sigma, mu, bow, eta):
    corpus = pad_corpus(bow, V=srv_beta.shape[1])
    T = torch.tensor
    bd = _gather_beta(T(np.asarray(srv_beta, np.float32)), T(corpus.words))
    siginv, _ = precompute_sigma(T(np.asarray(sigma, np.float32)))
    g = stages.fgh_plain(T(np.asarray(eta, np.float32)), bd, T(corpus.counts),
                         T(np.asarray(mu, np.float32)), siginv, bf16=False)[1]
    return g.abs().amax(1).numpy()


@pytest.fixture(scope="module")
def saved_models(tmp_path_factory):
    """The same 3-iteration fit of a text-built corpus in both packages,
    each saved with its vocab.json."""
    beta = np.random.default_rng(0).dirichlet(np.full(V, 0.1), size=K)
    texts, X = _texts(1, 48, beta)
    bow, vocab = pre.build_corpus(texts)
    g = np.random.RandomState(11).gamma(0.1, 1.0, (K, len(vocab)))
    beta0 = g / g.sum(axis=1, keepdims=True)
    jcfg = JaxConfig(K=K, init_type="random", max_em_iter=3, batch_size=16,
                     convergence_threshold=0.0)
    jm = JaxSTM(bow, dictionary=list(vocab), K=K, X=X, config=jcfg, init_beta=beta0)
    jm.expectation_maximization(saving=False)
    m = STM(bow, dictionary=vocab, K=K, X=X, config=STMConfig.from_json(jcfg.to_json()),
            init_beta=beta0, device="cpu")
    m.expectation_maximization()
    dirs = {"jax": tmp_path_factory.mktemp("jax_model"),
            "port": tmp_path_factory.mktemp("port_model")}
    jm.save_model(str(dirs["jax"]))
    m.save_model(str(dirs["port"]))
    return dirs, beta, list(vocab)


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_infer_text_matches_jax(saved_models, saved_by):
    dirs, beta, vocab = saved_models
    model_dir = str(dirs[saved_by])
    with open(f"{model_dir}/vocab.json") as f:
        assert json.load(f) == vocab
    texts, X = _texts(2, 20, beta, oov=("zzyzx", "qwfp"))
    texts[-1] = "the and of zzyzx"  # no in-vocabulary token left
    srv = ThetaServer(model_dir, device="cpu")
    theta, eta, report = srv.infer_text(texts, X=X)
    theta_j, eta_j, report_j = JaxThetaServer(model_dir).infer_text(texts, X=X)
    assert report == report_j
    known = set(vocab)
    oov = [t for text in texts for t in pre.tokenize(text) if t not in known]
    assert {"zzyzx", "qwfp"} <= set(oov)
    assert report["tokens_dropped"] == len(oov) and report["oov_types"] == len(set(oov))
    assert report["docs_emptied"] == 1
    # infer_text is align_corpus then infer
    bow, _ = pre.align_corpus(texts, vocab)
    assert report["bow"] == bow
    theta2, eta2 = srv.infer(bow, X=X)
    assert np.array_equal(theta, theta2) and np.array_equal(eta, eta2)

    eta_j, theta_j = np.asarray(eta_j), np.asarray(theta_j)
    assert theta.shape == theta_j.shape == (20, K)
    assert np.isfinite(theta).all() and np.allclose(theta.sum(1), 1, atol=1e-5)
    mu = _prior_means(srv._gamma, srv._eta_mean, srv.cfg, K, len(X), X, train=srv._train)
    g_p = _grad_norm(srv._beta.numpy(), srv._sigma.numpy(), mu, bow, eta)
    g_j = _grad_norm(srv._beta.numpy(), srv._sigma.numpy(), mu, bow, eta_j)
    both = (g_p <= 1e-4) & (g_j <= 1e-4)
    assert both.sum() >= len(texts) // 2, (g_p, g_j)
    np.testing.assert_allclose(eta[both], eta_j[both], atol=5e-3)
    np.testing.assert_allclose(theta[both], theta_j[both], atol=1e-3)


def test_infer_text_needs_a_vocabulary(saved_models, tmp_path):
    dirs, _beta, _vocab = saved_models
    for name in ("beta_hat.npy", "sigma_hat.npy", "gamma_hat.npy", "eta_hat.npy", "X.npy"):
        (tmp_path / name).write_bytes((dirs["port"] / name).read_bytes())
    with pytest.raises(ValueError, match="no vocab.json"):
        ThetaServer(str(tmp_path), device="cpu").infer_text(["alpha"])
