"""Serving: theta inference from saved model artifacts (twin of
``strutopy_tpu/models/serving.py``).

Load a fitted model's artifact directory (the ``*_hat.npy`` set written
by either package's ``STM.save_model``) and infer topic proportions for
new documents with one batched E-step — no refit, no STM instance, no
training corpus::

    srv = ThetaServer("artifacts/fit", device="cuda")
    srv.warmup()
    theta, eta = srv.infer(new_docs, X=X_new)

Raw-text requests go through ``ThetaServer.infer_text``, which encodes
them against the model's saved ``vocab.json`` (``corpus/preprocess.py::
align_corpus``) and infers.  The E-step runs on whichever Newton path the
configuration selects: the stage kernels (default), the fused iteration
(``pallas_iter``) or the whole-loop kernel (``use_pallas``).  With a mesh
(``parallel/``) a request is document-sharded over the ranks, each of
which calls with the whole request, and every rank gets the whole answer.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from strutopy_tpu_torch.corpus.bow import PaddedCorpus, pad_corpus
from strutopy_tpu_torch.corpus.bucketing import (
    gather_per_bucket,
    make_bucket_plan,
    split_corpus_by_plan,
)
from strutopy_tpu_torch.corpus.io import load_model_artifacts
from strutopy_tpu_torch.corpus.preprocess import DEFAULT_STOPWORDS, align_corpus
from strutopy_tpu_torch.models.config import STMConfig
from strutopy_tpu_torch.models.em import CorpusData, local_estep_stats
from strutopy_tpu_torch.models.state import STMState
from strutopy_tpu_torch.ops import build
from strutopy_tpu_torch.ops.mstep import encode_new_covariates
from strutopy_tpu_torch.parallel.mesh import doc_axis, vocab_axis
from strutopy_tpu_torch.parallel.sharding import gather_rows, shard_corpus, shard_cols, shard_rows
from strutopy_tpu_torch.utils import trace
from strutopy_tpu_torch.utils.precision import true_float32


def _require_beta_index(beta, beta_index) -> None:
    if beta.ndim == 3 and beta_index is None:
        raise ValueError(
            "this is a content-covariate model (per-aspect beta); pass "
            "beta_index for the new documents"
        )


def _n_docs(documents) -> int:
    return documents.N if isinstance(documents, PaddedCorpus) else len(documents)


@true_float32
def infer_theta(beta, sigma, mu_user: np.ndarray, documents, cfg: STMConfig,
                aspects_user=None, full_convergence: bool = True, mesh=None, *,
                device="cuda"):
    """One batched E-step under fixed (beta, sigma) with per-document
    prior means ``mu_user`` -> (theta, eta) in document order, as numpy.

    ``beta``/``sigma`` are numpy arrays or tensors (a tensor already on
    ``device`` is used as it is).  ``full_convergence=True`` guarantees
    every document its full Newton budget: with the two-pass schedule it
    admits every unconverged document to pass 2 (straggler fraction 1);
    ``False`` keeps the training configuration's capped budget.
    ``aspects_user`` (N,) gives each document its aspect level under a
    content model's (A, K, V) beta; zeros when absent.

    ``mesh`` (a 1-D document mesh, or a 2-D (docs, vocab) mesh) shards the
    request over the docs axis: every rank calls with the same whole
    request and its own ``device``, runs the E-step on its rows in the
    training layout (the device-major ``plan.storage_index``), under a 2-D
    mesh on its block of beta's vocabulary with one vocab all-reduce a
    chunk, and the rows come back whole on every rank by the exact sum.

    While recording (``utils/trace.py``) a request is a ``serve.request``
    record: ``serve.prepare`` (the host's padding, buckets, prior means and
    their copy to the device), then the E-step's spans.
    """
    with trace.session(), trace.span("serve.request", attrs={"docs": _n_docs(documents)}):
        with trace.span("serve.prepare"):
            dev = torch.device(device)
            V = beta.shape[-1]
            K = beta.shape[-2]
            if full_convergence and cfg.newton_pass1_iters:
                cfg = cfg.replace(newton_straggler_frac=1.0)
            corpus = (documents if isinstance(documents, PaddedCorpus)
                      else pad_corpus(documents, V=V))
            live = (corpus.counts > 0) & corpus.doc_ok[:, None]
            max_id = int(corpus.words[live].max()) if live.any() else -1
            if max_id >= V:
                raise ValueError(
                    f"documents contain word id {max_id} but the model vocabulary "
                    f"has only {V} terms — were they encoded with a different "
                    "vocabulary? (a gather would read past beta)"
                )
            if corpus.V != V:
                corpus = PaddedCorpus(corpus.words, corpus.counts, corpus.doc_ok, V)
            N_new = corpus.N

            docs = vocab = None
            if mesh is not None:
                docs, vocab = doc_axis(mesh), vocab_axis(mesh)
            plan = make_bucket_plan(corpus, cfg.batch_size,
                                    n_devices=docs.size if docs else 1,
                                    max_buckets=cfg.max_buckets if cfg.auto_bucket else 1)
            buckets = split_corpus_by_plan(corpus, plan)
            # device-major storage (the training layout): storage_index maps
            # user doc i to its row, and each rank's rows of every bucket line
            # up with its rows of the state; padding rows are zeros
            mu32 = np.asarray(mu_user, np.float32)
            mu_full = np.zeros((plan.n_storage, mu32.shape[1]), np.float32)
            mu_full[plan.storage_index] = mu32
            mu_storage = torch.as_tensor(mu_full)
            if docs is not None:
                mu_storage = shard_rows(mu_storage, docs)
            N_pad = mu_storage.shape[0]
            mu_storage = mu_storage.to(dev)

            if aspects_user is None:
                aspects_user = np.zeros(N_new, np.int32)
            aspect_buckets = gather_per_bucket(np.asarray(aspects_user, np.int32), plan)

            def zeros(*shape, dt=torch.float32):
                return torch.zeros(shape, dtype=dt, device=dev)

            data = CorpusData(
                words=tuple(torch.as_tensor(b.words) for b in buckets),
                counts=tuple(torch.as_tensor(b.counts) for b in buckets),
                aspects=tuple(torch.as_tensor(a) for a in aspect_buckets),
                doc_ok=tuple(torch.as_tensor(b.doc_ok) for b in buckets),
                D=tuple(torch.zeros(b.N, 1) for b in buckets),
            )
            if docs is not None:
                data = shard_corpus(mesh, data)
            data = data.to(dev)
            beta = torch.as_tensor(beta, dtype=torch.float32, device=dev)
            if vocab is not None:
                beta = shard_cols(beta, vocab)
            state = STMState(
                beta=beta,
                mu=mu_storage,
                sigma=torch.as_tensor(sigma, dtype=torch.float32, device=dev),
                eta=mu_storage.clone(),  # warm start at the prior mean
                theta=zeros(N_pad, K),
                gamma=zeros(K - 1, 1),
                kappa=zeros(0, V),
                bound=zeros(),
                opt_iters=zeros(N_pad, dt=torch.int32),
                straggler_overflow=zeros(dt=torch.int32),
            )
        _stats, eta, theta, _iters = local_estep_stats(state, data, cfg, plan.batch_sizes,
                                                       vocab)
        if docs is not None:
            theta, eta = gather_rows(theta, docs), gather_rows(eta, docs)
        theta, eta = trace.read("serve.readback", lambda: (theta.cpu(), eta.cpu()))
        return theta.numpy()[plan.storage_index], eta.numpy()[plan.storage_index]


def _load_params(model_dir: str):
    """Load the ``*_hat.npy`` artifacts and the configuration -> (beta,
    sigma, gamma, eta_mean, cfg, train); ``gamma``/``eta_mean`` may be
    None, ``train`` is ``(X_train, ok_train)`` or None (for re-encoding a
    categorical covariate with the training levels)."""
    art = load_model_artifacts(model_dir)
    if "beta" not in art or "sigma" not in art:
        raise FileNotFoundError(
            f"{model_dir} does not contain beta_hat.npy/sigma_hat.npy — "
            "is it a model artifact directory written by save_model?"
        )
    K = art["beta"].shape[-2]
    cfg_path = os.path.join(model_dir, "stm_config.json")
    cfg = STMConfig(K=K)
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = f.read()
        try:
            cfg = STMConfig.from_json(raw)
        except TypeError:
            # a foreign configuration (e.g. the reference's): keep the
            # shape-derived one, as the JAX package does
            pass

    beta = np.asarray(art["beta"], np.float32)
    sigma = np.asarray(art["sigma"], np.float32)
    eta = art.get("eta")
    real = None
    eta_mean = None
    if eta is not None:
        eta = np.asarray(eta)
        # empty (doc_ok=False) documents keep eta exactly 0: an all-zero
        # row identifies one, and the prior mean averages real ones only
        real = ~(eta == 0.0).all(axis=1)
        eta_mean = eta[real].mean(axis=0) if real.any() else eta.mean(axis=0)
    train = None
    X_train = art.get("X")
    if X_train is not None:
        ok = (real if real is not None and len(eta) == len(X_train)
              else np.ones(len(X_train), bool))
        train = (np.asarray(X_train, np.float64), ok)
    return beta, sigma, art.get("gamma"), eta_mean, cfg, train


def _prior_means(gamma, eta_mean, cfg: STMConfig, K: int, N_new: int, X,
                 train=None) -> np.ndarray:
    """Per-document prior means mu (N_new, K-1) from the fitted
    prevalence model (or its fallbacks), as ``STM.transform`` builds them."""
    if X is not None and gamma is None:
        raise ValueError(
            "X was passed but the model has no prevalence regression "
            "(no gamma_hat in the artifacts — a CTM or covariate-free "
            "fit); its theta priors come from the fitted eta mean, so X "
            "cannot be used"
        )
    if gamma is not None and X is not None:
        Xa = np.asarray(X, np.float64)
        if Xa.ndim == 1:
            Xa = Xa[:, None]
        if train is not None:
            enc = encode_new_covariates(Xa, train[0], train[1])
            if enc is not None:
                Xa = enc
        P = gamma.shape[1]
        # dispatch on the fitted configuration, not a column-count guess
        if cfg.fit_intercept and Xa.shape[1] == P - 1:
            D = np.c_[np.ones(N_new), Xa]
        elif Xa.shape[1] == P:
            if cfg.fit_intercept and not np.allclose(Xa[:, 0], 1.0):
                raise ValueError(
                    f"X has {Xa.shape[1]} column(s), matching the full "
                    f"{P}-column design of an intercept-included fit, but "
                    "its first column is not the constant 1 — pass X "
                    "WITHOUT the intercept column (it is prepended here)"
                )
            D = Xa
        else:
            raise ValueError(
                f"X has {Xa.shape[1]} column(s) but gamma_hat expects a "
                f"{P}-column design; if the model was fit with a "
                "categorical covariate, pass the SAME one-hot encoding "
                "used at training"
            )
        mu_user = D @ np.asarray(gamma, np.float64).T
    elif gamma is not None and gamma.shape[1] == 1 and cfg.fit_intercept:
        # intercept-only prevalence (an STM fit without covariates)
        mu_user = np.tile(np.asarray(gamma, np.float64)[:, 0], (N_new, 1))
    elif gamma is not None and np.abs(gamma).sum() > 0:
        raise ValueError(
            "the model was fit with prevalence covariates (gamma_hat "
            "present); pass X for the new documents"
        )
    elif eta_mean is not None:
        mu_user = np.tile(eta_mean, (N_new, 1))
    else:
        mu_user = np.zeros((N_new, K - 1))
    return mu_user.astype(np.float32)


def _n_docs(documents) -> int:
    if isinstance(documents, (list, tuple)):
        return len(documents)
    return documents.N


def infer_from_artifacts(model_dir: str, documents, X=None, beta_index=None, *,
                         mesh=None, device="cuda"):
    """Load the artifacts and configuration and infer (theta, eta) for new
    documents.  A content model needs ``beta_index``, their aspects.
    ``mesh``: see :func:`infer_theta`."""
    beta, sigma, gamma, eta_mean, cfg, train = _load_params(model_dir)
    _require_beta_index(beta, beta_index)
    mu_user = _prior_means(gamma, eta_mean, cfg, beta.shape[-2], _n_docs(documents), X,
                           train=train)
    return infer_theta(beta, sigma, mu_user, documents, cfg, aspects_user=beta_index,
                       mesh=mesh, device=device)


class ThetaServer:
    """Serving handle: load the artifacts ONCE, keep beta and sigma on
    the device, and serve theta per request::

        srv = ThetaServer("artifacts/fit", device="cuda")
        srv.warmup()                      # build the kernels, serve once
        theta, eta = srv.infer(docs, X=X)

    ``cfg`` (an :class:`STMConfig`) selects the Newton path and the
    schedule; replace it (``srv.cfg = srv.cfg.replace(pallas_iter=True)``)
    to serve on another path.  With ``mesh`` every request is sharded over
    it (:func:`infer_theta`): every rank serves every request.
    """

    def __init__(self, model_dir: str, *, mesh=None, device="cuda"):
        beta, sigma, gamma, eta_mean, cfg, train = _load_params(model_dir)
        self.device = torch.device(device)
        self.mesh = mesh
        self.cfg = cfg
        self.K = beta.shape[-2]
        self.V = beta.shape[-1]
        self.content = beta.ndim == 3
        self._gamma = gamma
        self._eta_mean = eta_mean
        self._train = train
        # the vocabulary (save_model writes it) is for raw-text requests
        self.vocab = None
        vocab_path = os.path.join(model_dir, "vocab.json")
        if os.path.exists(vocab_path):
            with open(vocab_path) as f:
                self.vocab = json.load(f)
        self._beta = torch.as_tensor(beta, device=self.device)
        self._sigma = torch.as_tensor(sigma, device=self.device)

    @true_float32
    def infer(self, documents, X=None, beta_index=None, full_convergence: bool = True):
        """(theta, eta) for new documents, in document order.
        ``full_convergence=False`` keeps the training schedule's capped
        Newton budget (see :func:`infer_theta`)."""
        _require_beta_index(self._beta, beta_index)
        mu_user = _prior_means(self._gamma, self._eta_mean, self.cfg, self.K,
                               _n_docs(documents), X, train=self._train)
        return infer_theta(self._beta, self._sigma, mu_user, documents, self.cfg,
                           aspects_user=beta_index, full_convergence=full_convergence,
                           mesh=self.mesh, device=self.device)

    def infer_text(self, texts, X=None, beta_index=None, full_convergence: bool = True,
                   stopwords="default"):
        """(theta, eta, report) for RAW TEXT requests: tokenizes and
        encodes against the model's saved vocabulary (align_corpus),
        then infers.  ``report`` is align_corpus's OOV loss summary
        plus the encoded BoW under ``"bow"``."""
        if self.vocab is None:
            raise ValueError(
                "this artifact directory has no vocab.json (written by "
                "save_model); re-save the model or pass pre-encoded BoW "
                "documents to infer()"
            )
        if stopwords == "default":
            stopwords = DEFAULT_STOPWORDS
        bow, report = align_corpus(texts, self.vocab, stopwords=stopwords)
        theta, eta = self.infer(bow, X=X, beta_index=beta_index,
                                full_convergence=full_convergence)
        return theta, eta, dict(report, bow=bow)

    def warmup(self, n_docs: int = 1, doc_len: int = 64) -> None:
        """Build the kernels (on a GPU) and serve one request of ``n_docs``
        documents with ``doc_len`` distinct terms."""
        if self.device.type == "cuda":
            build.load()
        rng = np.random.default_rng(0)
        docs = [
            [(int(w), 1) for w in rng.choice(self.V, size=min(doc_len, self.V), replace=False)]
            for _ in range(n_docs)
        ]
        X = None
        if self._gamma is not None:
            P = self._gamma.shape[1]
            if self.cfg.fit_intercept:
                # the intercept is prepended by _prior_means
                X = None if P <= 1 else np.zeros((n_docs, P - 1))
            else:
                X = np.zeros((n_docs, P))
        aspects = np.zeros(n_docs, np.int32) if self.content else None
        self.infer(docs, X=X, beta_index=aspects)
