"""Synthetic corpus generation under the LDA / STM data-generating processes.

A numpy copy of ``strutopy_tpu/dgp/corpus_creation.py``: the same seed
gives the same documents in both packages.  Alpha prior modes, treatment effects,
gamma ~ MVN, boolean metadata, eta ~ MVN(X gamma^T, 0.001 I),
theta = softmax([eta, 0]) (STM) or Dirichlet (LDA), words ~
Multinomial(n_words, theta beta), infrequent-term removal with vocab
re-indexing, and the 80/10/10 + document-completion split, in
vectorized numpy with a single Generator.

Documents are produced both as BoW lists and as a PaddedCorpus.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from strutopy_tpu_torch.corpus.bow import PaddedCorpus, Vocabulary, pad_corpus

logger = logging.getLogger(__name__)


def _stable_softmax_rows(x: np.ndarray) -> np.ndarray:
    xs = x - x.max(axis=1, keepdims=True)
    e = np.exp(xs)
    return e / e.sum(axis=1, keepdims=True)


class CorpusCreation:
    def __init__(
        self,
        n_topics: int,
        n_docs: int,
        n_words: int,
        V: int,
        level: int = 1,
        treatment: bool = False,
        alpha="symmetric",
        dgp: str = "STM",
        metadata: Optional[np.ndarray] = None,
        alpha_treatment=None,
        beta: Optional[np.ndarray] = None,
        theta: Optional[np.ndarray] = None,
        gamma: Optional[np.ndarray] = None,
        seed: int = 12345,
    ):
        self.K = n_topics
        self.n_docs = n_docs
        self.n_words = n_words
        self.V = V
        self.dgp = dgp
        self.level = level
        self.treatment = treatment
        self.rng = np.random.default_rng(seed)

        self._init_alpha(alpha, alpha_treatment, theta)
        self._word_topic_dist(beta)
        self._init_gamma(gamma)
        self._set_metadata(metadata)
        self._init_eta()
        self._init_theta(theta)

    # ----- priors ------------------------------------------------------

    def _init_alpha(self, alpha, alpha_treatment, theta):
        if isinstance(alpha, np.ndarray):
            self.alpha = alpha
        elif alpha == "symmetric":
            self.alpha = np.repeat(1.0 / self.K, self.K)
        elif alpha == "asymmetric":
            idx = np.arange(1, self.K + 1)
            self.alpha = 1.0 / (idx + np.sqrt(idx))
        else:
            self.alpha = np.repeat(float(alpha), self.K)

        if not np.any(self.alpha):
            assert theta is not None, (
                "Either alpha or theta needs to be specified for generating documents."
            )
        if self.treatment:
            assert alpha_treatment is not None, (
                "If treatment == True, the effect needs to be specified by alpha_treatment"
            )
            if isinstance(alpha_treatment, np.ndarray):
                self.alpha_treatment = alpha_treatment
            elif alpha_treatment == "auto-linear":
                self.alpha_treatment = np.flip(self.alpha)
            elif alpha_treatment == "auto-nonlinear":
                self.alpha_treatment = np.exp(self.alpha)

    def _word_topic_dist(self, beta):
        if beta is None:
            self.beta = self.rng.dirichlet(np.repeat(0.05, self.V), size=self.K)
        else:
            self.beta = np.asarray(beta)

    def _init_gamma(self, gamma, mean=None):
        """gamma (K-1, level) ~ MVN per topic."""
        if gamma is None:
            if mean is None:
                mean = self.rng.standard_normal(self.level)
            sigma_prior = np.diag(np.full(self.level, 0.001))
            mean = self.rng.multivariate_normal(mean, sigma_prior)
            self.gamma = self.rng.multivariate_normal(
                mean, np.diag(np.full(self.level, 0.001)), self.K - 1
            )
        else:
            self.gamma = np.asarray(gamma)

    def _set_metadata(self, metadata, metadata_levels=(0, 1)):
        if metadata is None:
            self.metadata = self.rng.choice(
                np.asarray(metadata_levels), size=(int(self.n_docs), self.level)
            )
        else:
            assert metadata.shape == (self.n_docs, self.level), (
                "Unexpected metadata shape provided."
            )
            self.metadata = metadata

    def _init_eta(self):
        mu = self.metadata @ self.gamma.T  # (N, K-1)
        noise = self.rng.multivariate_normal(
            np.zeros(self.K - 1), np.diag(np.full(self.K - 1, 0.001)), self.n_docs
        )
        self.eta = mu + noise

    def _init_theta(self, theta):
        if self.dgp == "LDA":
            if theta is None:
                if not self.treatment:
                    self.theta = self.rng.dirichlet(self.alpha, size=self.n_docs)
                else:
                    half = int(self.n_docs / 2)
                    self.theta = self.rng.dirichlet(self.alpha, size=half)
                    self.theta_treatment = self.rng.dirichlet(
                        self.alpha_treatment, size=self.n_docs - half
                    )
            else:
                self.theta = np.asarray(theta)
        elif self.dgp == "STM":
            eta_full = np.concatenate(
                [self.eta, np.zeros((self.n_docs, 1))], axis=1
            )
            self.theta = _stable_softmax_rows(eta_full)
        else:
            raise ValueError('dgp must be "STM" or "LDA"')

    # ----- sampling ----------------------------------------------------

    def generate_documents(
        self, remove_terms: bool = True, dictionary: bool = True, display_props: bool = False
    ):
        logger.info("Create corpus for K=%d topics.", self.K)
        self._sample_documents()
        if remove_terms:
            self.remove_infrequent_terms()
        if dictionary:
            self.dictionary = Vocabulary.from_corpus(self.documents, V=self.V)
        if display_props:
            self.display_props()
        return self

    def display_props(self, path=None):
        """Topic-proportion bar chart (``eval/plots.py::display_props``)."""
        from strutopy_tpu_torch.eval.plots import display_props as _dp

        return _dp(self.theta, path=path)

    def _sample_documents(self):
        if self.dgp == "LDA" and self.treatment:
            p = np.concatenate(
                [self.theta @ self.beta, self.theta_treatment @ self.beta], axis=0
            )
        else:
            p = self.theta @ self.beta
        self.p = p

        documents = []
        new_ids: dict = {}
        nxt = 0
        for d in range(self.n_docs):
            draw = self.rng.multinomial(self.n_words, p[d])
            idx = np.nonzero(draw)[0]
            # remap vocabulary ids in first-seen order
            for x in idx:
                if int(x) not in new_ids:
                    new_ids[int(x)] = nxt
                    nxt += 1
            documents.append(
                [(new_ids[int(x)], int(draw[x])) for x in idx]
            )
        self.new_ids = new_ids
        self.documents = documents
        self.V_used = nxt

    def remove_infrequent_terms(self):
        """Compact vocab ids to the set of observed terms."""
        seen = sorted({w for doc in self.documents for (w, _) in doc})
        logger.info("removes %d words due to no occurence", self.V - len(seen))
        remap = {w: i for i, w in enumerate(seen)}
        self.documents = [
            [(remap[w], c) for (w, c) in doc] for doc in self.documents
        ]
        self.V = len(seen)

    # ----- splits ------------------------------------------------------

    def split_corpus(
        self, validation_set: bool = False, document_completion: bool = True,
        proportion: float = 0.8,
    ):
        assert isinstance(self.documents, list)
        split = int(proportion * len(self.documents))
        self.train_docs = self.documents[:split]
        if validation_set:
            v = int((proportion + (1 - proportion) / 2) * len(self.documents))
            self.test_docs = self.documents[split:v]
            self.validate_docs = self.documents[v:]
        else:
            self.test_docs = self.documents[split:]
        if document_completion:
            self.test_1_docs, self.test_2_docs = self.cut_in_half(self.test_docs)

    @staticmethod
    def cut_in_half(doc_set):
        first = [list(doc[0::2]) for doc in doc_set]
        second = [list(doc[1::2]) for doc in doc_set]
        return first, second

    # ----- conversion --------------------------------------------------

    def padded_corpus(self) -> PaddedCorpus:
        return pad_corpus(self.documents, V=self.V)
