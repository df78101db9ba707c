"""The user-facing STM estimator (twin of ``strutopy_tpu/models/stm.py``).

Same construction, fitting, inference (``transform``) and artifact
(``save_model``) surface as the JAX ``STM``, on one device: the card
(``device="cuda"``, the default) unless the caller asks for the CPU
(``device="cpu"``); nothing is detected.
Not ported yet: spectral init (ROADMAP.md Queue A item 10), the content
model (item 11), meshes and streaming (items 12 and 14), checkpoints.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from strutopy_tpu_torch.corpus.bow import PaddedCorpus, Vocabulary, pad_corpus
from strutopy_tpu_torch.corpus.bucketing import (
    gather_per_bucket,
    make_bucket_plan,
    split_corpus_by_plan,
)
from strutopy_tpu_torch.models.config import STMConfig
from strutopy_tpu_torch.models.em import CorpusData, make_em_step
from strutopy_tpu_torch.models.state import init_state
from strutopy_tpu_torch.ops import mstep

logger = logging.getLogger(__name__)


class STM:
    """Structural Topic Model on PyTorch::

        model = STM(documents, dictionary, K=10, X=meta, max_em_iter=25,
                    init_type="random", model_type="STM", mode="ols",
                    device="cuda")
        model.expectation_maximization()

    ``documents`` is a BoW list of ``[(word_id, count), ...]`` or a
    :class:`PaddedCorpus`.  ``init_beta`` injects an explicit (K, V)
    initialization.  Advanced knobs live on :class:`STMConfig`
    (``config=``), which then overrides the keyword arguments.
    """

    def __init__(
        self,
        documents,
        dictionary=None,
        content: bool = False,
        K: int = 10,
        X=None,
        max_em_iter: int = 100,
        sigma_prior: float = 0.0,
        convergence_threshold: float = 1e-5,
        init_type: str = "spectral",
        model_type: str = "STM",
        mode: str = "ols",
        config: Optional[STMConfig] = None,
        batch_size: Optional[int] = None,
        seed: int = 123456,
        beta_smoothing: float = 0.0,
        init_beta=None,
        *,
        device="cuda",
    ):
        if config is not None and seed != 123456 and config.seed != seed:
            raise ValueError(
                f"seed={seed} conflicts with config.seed={config.seed}: "
                "an explicit STMConfig overrides the seed kwarg — use "
                "config.replace(seed=...) instead"
            )
        if config is None:
            config = STMConfig(
                K=K,
                content=content,
                model_type=model_type,
                mode=mode,
                max_em_iter=max_em_iter,
                convergence_threshold=convergence_threshold,
                sigma_prior=sigma_prior,
                init_type=init_type,
                seed=seed,
                beta_smoothing=beta_smoothing,
                # the two-pass straggler schedule for fits of 10 EM
                # iterations or more, as the JAX default
                newton_pass1_iters=6 if max_em_iter >= 10 else 0,
                newton_straggler_frac=0.25,
            )
        if batch_size is not None:
            config = config.replace(batch_size=batch_size)
        self.config = config
        self.device = torch.device(device)

        # ----- corpus -----
        if isinstance(documents, PaddedCorpus):
            corpus = documents
        else:
            corpus = pad_corpus(documents, V=len(dictionary) if dictionary is not None else None)
        if dictionary is None:
            dictionary = Vocabulary.from_corpus(corpus)
        self.dictionary = dictionary
        self.V = max(corpus.V, len(dictionary))
        if corpus.V < self.V:
            corpus = PaddedCorpus(corpus.words, corpus.counts, corpus.doc_ok, self.V)
        self._corpus = corpus  # user order (transform's CTM prior mean)
        if corpus.n_docs == 0:
            raise ValueError("corpus contains no non-empty documents; nothing to fit")
        self.N = corpus.n_docs
        self.K = config.K

        # ----- length buckets -----
        plan = make_bucket_plan(
            corpus, config.batch_size, n_devices=1,
            max_buckets=config.max_buckets if config.auto_bucket else 1,
        )
        self._plan = plan
        buckets = split_corpus_by_plan(corpus, plan)
        # user doc i lives at storage row plan.storage_index[i]
        self._storage_index = plan.storage_index[: corpus.N]

        # ----- covariates (user order -> per-bucket rows) -----
        self.X = np.asarray(X) if X is not None else None
        X_storage = None
        if self.X is not None:
            Xa = self.X if self.X.ndim > 1 else self.X[:, None]
            if Xa.shape[0] != corpus.N:
                raise ValueError(
                    f"X has {Xa.shape[0]} rows but the corpus has "
                    f"{corpus.N} documents; covariates must cover every document"
                )
            X_storage = np.concatenate(
                gather_per_bucket(Xa.astype(np.float64), plan), axis=0)
        doc_ok_storage = np.concatenate([b.doc_ok for b in buckets])
        D_np, self._design = mstep.make_prevalence_design(
            X_storage, doc_ok_storage, fit_intercept=config.fit_intercept,
            ridge_alpha=config.ridge_alpha, device=self.device,
        )
        D_buckets = np.split(D_np, np.cumsum([b.N for b in buckets])[:-1], axis=0)

        # ----- init -----
        if init_beta is not None:
            beta_init = np.asarray(init_beta, np.float64)
            if beta_init.shape != (config.K, self.V):
                raise ValueError(
                    f"init_beta has shape {beta_init.shape}, expected "
                    f"(K={config.K}, V={self.V})")
            if not np.all(np.isfinite(beta_init)) or (beta_init < 0).any():
                raise ValueError("init_beta must be finite and >= 0")
            row = beta_init.sum(axis=1, keepdims=True)
            if (row <= 0).any():
                raise ValueError("init_beta has an all-zero topic row")
            beta_init = beta_init / row
        elif config.init_type == "spectral":
            raise NotImplementedError(
                "init_type='spectral' is not ported yet (ROADMAP.md Queue A "
                "item 10); pass init_type='random' or init_beta="
            )
        else:
            # normalized Gamma(0.1, 1) rows from the numpy RNG, exactly as
            # the JAX package draws them
            g = np.random.RandomState(config.seed).gamma(0.1, 1.0, (config.K, self.V))
            beta_init = g / np.maximum(g.sum(axis=1, keepdims=True), 1e-300)

        self._state = init_state(
            K=config.K, V=self.V, N=plan.n_storage, P=D_np.shape[1],
            beta_init=beta_init, device=self.device,
        )
        dev = self.device
        self._data = CorpusData(
            words=tuple(torch.as_tensor(b.words, device=dev) for b in buckets),
            counts=tuple(torch.as_tensor(b.counts, device=dev) for b in buckets),
            doc_ok=tuple(torch.as_tensor(b.doc_ok, device=dev) for b in buckets),
            D=tuple(torch.as_tensor(d, device=dev) for d in D_buckets),
        )
        self._em_step = make_em_step(config, self._design, plan.batch_sizes)
        # cold iterations (poor warm starts leave most documents
        # unconverged at the pass-1 cap) run the single-pass schedule
        self._em_step_cold = (
            make_em_step(config.replace(newton_pass1_iters=0), self._design,
                         plan.batch_sizes)
            if config.newton_pass1_iters > 0 and config.newton_warmup_iters > 0
            else None
        )

        self.last_bounds: list = []
        self.iter_seconds: list = []
        self.nonfinite_bound_iters: list = []
        self.time_processed: Optional[float] = None
        self.docs_per_sec: Optional[float] = None
        self._overflow_warned = False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def expectation_maximization(self):
        """Run EM until convergence or ``config.max_em_iter``.

        Each iteration's wall time (ending in a device synchronize) is
        kept in ``iter_seconds``; a non-finite bound is recorded in
        ``nonfinite_bound_iters`` and warned about once.
        """
        cfg = self.config
        self._sync()
        t0 = time.time()
        for it in range(cfg.max_em_iter):
            it_t0 = time.time()
            step = (
                self._em_step_cold
                if self._em_step_cold is not None and it < cfg.newton_warmup_iters
                else self._em_step
            )
            self._state = step(self._state, self._data)
            self._sync()
            it_dt = time.time() - it_t0
            bound = float(self._state.bound)
            if not np.isfinite(bound):
                self.nonfinite_bound_iters.append(it)
                if len(self.nonfinite_bound_iters) == 1:
                    logger.warning(
                        "EM iteration %d: NON-FINITE bound (%r) — the fit is "
                        "numerically damaged (model.nonfinite_bound_iters "
                        "records every occurrence)", it, bound,
                    )
            if cfg.newton_pass1_iters:
                ov = int(self._state.straggler_overflow)
                if ov > 0 and not self._overflow_warned:
                    self._overflow_warned = True
                    logger.warning(
                        "EM iteration %d: %d docs exceeded the two-pass "
                        "straggler budget and kept their pass-1 eta (further "
                        "occurrences logged at DEBUG; raise "
                        "newton_straggler_frac (%.2f) if the bound degrades)",
                        it, ov, cfg.newton_straggler_frac,
                    )
                elif ov > 0:
                    logger.debug("EM iteration %d: straggler overflow %d", it, ov)
            self.last_bounds.append(bound)
            self.iter_seconds.append(it_dt)
            self.docs_per_sec = self.N / max(it_dt, 1e-9)
            logger.info("EM iteration %d: bound %.4f (%.3fs, %.0f docs/s)",
                        it, bound, it_dt, self.docs_per_sec)
            if it >= 1:
                old = self.last_bounds[-2]
                rel = abs((bound - old) / abs(old)) if old != 0 else np.inf
                if rel < cfg.convergence_threshold:
                    self.time_processed = time.time() - t0
                    logger.info("converged in iteration %d after %.2fs",
                                it, self.time_processed)
                    break
        if self.time_processed is None:
            self.time_processed = time.time() - t0
        return self

    fit = expectation_maximization

    # ------------------------------------------------------------------
    # fitted parameters (padding documents trimmed, user order; C-order
    # arrays, as the JAX package's, so save_model writes the same files)
    # ------------------------------------------------------------------

    @property
    def beta(self) -> np.ndarray:
        return np.ascontiguousarray(self._state.beta.cpu().numpy())

    @property
    def theta(self) -> np.ndarray:
        return self._state.theta.cpu().numpy()[self._storage_index]

    @property
    def eta(self) -> np.ndarray:
        return self._state.eta.cpu().numpy()[self._storage_index]

    @property
    def mu(self) -> np.ndarray:
        return self._state.mu.cpu().numpy()[self._storage_index]

    @property
    def sigma(self) -> np.ndarray:
        return np.ascontiguousarray(self._state.sigma.cpu().numpy())

    @property
    def gamma(self) -> np.ndarray:
        return np.ascontiguousarray(self._state.gamma.cpu().numpy())

    @property
    def bound(self) -> float:
        return float(self._state.bound)

    @property
    def straggler_overflow(self) -> int:
        """Docs the last E-step's two-pass straggler budget could not
        admit (left at their pass-1 eta); 0 when the schedule is off."""
        return int(self._state.straggler_overflow)

    # ------------------------------------------------------------------
    # inference on new documents (serving)
    # ------------------------------------------------------------------

    def transform(self, documents, X=None, beta_index=None):
        """Infer (theta, eta) for NEW documents under the fitted model, in
        the documents' order: one batched E-step with the fitted beta and
        sigma and the prevalence prior mu = [1, X_new] @ gamma^T (or, for
        a CTM or a fit without covariates, the mean fitted eta).  Without
        an STM instance, see
        :func:`strutopy_tpu_torch.models.serving.infer_from_artifacts`.
        ``beta_index`` is read only by the content model (not ported).
        """
        from strutopy_tpu_torch.models.serving import infer_theta

        cfg = self.config
        N_new = documents.N if isinstance(documents, PaddedCorpus) else len(documents)
        if cfg.model_type == "CTM" or self.X is None:
            # mean over REAL documents only (the fitted mu divides by
            # doc_ok.sum()); self.eta is in user order with corpus.N rows
            ok = self._corpus.doc_ok
            mu_row = self.eta[ok].mean(axis=0) if ok.any() else self.eta.mean(axis=0)
            mu_user = np.tile(mu_row, (N_new, 1))
        else:
            if X is None:
                raise ValueError(
                    "the model was fit with prevalence covariates; pass X "
                    "for the new documents"
                )
            Xa = np.asarray(X, np.float64)
            if Xa.ndim == 1:
                Xa = Xa[:, None]
            # a 1-D categorical covariate was one-hot encoded at fit time:
            # encode the new values with the TRAINING levels
            enc = mstep.encode_new_covariates(Xa, self.X, self._corpus.doc_ok)
            if enc is not None:
                Xa = enc
            D_new = np.c_[np.ones(N_new), Xa] if cfg.fit_intercept else Xa
            if D_new.shape[1] != self.gamma.shape[1]:
                raise ValueError(
                    f"X has {Xa.shape[1]} column(s) but the fitted gamma "
                    f"expects a {self.gamma.shape[1]}-column design; "
                    "multi-column covariates must be passed with the same "
                    "encoding used at training"
                )
            mu_user = D_new @ np.asarray(self.gamma, np.float64).T
        return infer_theta(self._state.beta, self._state.sigma, mu_user.astype(np.float32),
                           documents, cfg, device=self.device)

    # ------------------------------------------------------------------
    # persistence (the JAX package's save_model artifact set)
    # ------------------------------------------------------------------

    def save_model(self, output_dir):
        """Write the ``*_hat.npy`` artifact set, ``lower_bound.pickle``,
        ``fit_health.json``, ``stm_config.json`` and ``vocab.json``,
        file for file as the JAX package's ``STM.save_model`` writes
        them; either package's loader reads them."""
        os.makedirs(output_dir, exist_ok=True)
        np.save(os.path.join(output_dir, "beta_hat"), self.beta)
        np.save(os.path.join(output_dir, "theta_hat"), self.theta)
        np.save(os.path.join(output_dir, "sigma_hat"), self.sigma)
        np.save(os.path.join(output_dir, "eta_hat"), self.eta)
        np.save(os.path.join(output_dir, "mu_hat"), self.mu)
        if self.X is not None:
            np.save(os.path.join(output_dir, "X"), self.X)
        if self.config.model_type == "STM":
            np.save(os.path.join(output_dir, "gamma_hat"), self.gamma)
        with open(os.path.join(output_dir, "lower_bound.pickle"), "wb") as f:
            pickle.dump(self.last_bounds, f)
        # non-finite bounds propagate into the artifact set
        nfi = list(self.nonfinite_bound_iters)
        with open(os.path.join(output_dir, "fit_health.json"), "w") as f:
            json.dump({"bound_finite": not nfi, "nonfinite_bound_iters": nfi}, f)
        with open(os.path.join(output_dir, "stm_config.json"), "w") as f:
            f.write(self.config.to_json())
        with open(os.path.join(output_dir, "vocab.json"), "w") as f:
            json.dump(list(self.dictionary), f)
