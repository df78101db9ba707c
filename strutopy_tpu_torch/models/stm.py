"""The user-facing STM estimator (twin of ``strutopy_tpu/models/stm.py``).

Same construction, fitting, inference (``transform``) and artifact
(``save_model``) surface as the JAX ``STM``: on the card (``device="cuda"``,
the default) unless the caller asks for the CPU (``device="cpu"``);
nothing is detected.  Spectral or random initialization, the LDA beta or
the content model (per-aspect beta from the kappa regression), resumable
checkpoints, out-of-core fits (``stream_parts=``, ``models/streaming.py``),
multi-device fits (``mesh=``, ``parallel/``) and the post-fit analysis
methods (``eval/``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from strutopy_tpu_torch.eval import diagnostics
from strutopy_tpu_torch.corpus.bow import PaddedCorpus, Vocabulary, pad_corpus
from strutopy_tpu_torch.corpus.bucketing import (
    gather_per_bucket,
    make_bucket_plan,
    split_corpus_by_plan,
)
from strutopy_tpu_torch.models.config import STMConfig, refuse_tpu_only
from strutopy_tpu_torch.models.em import CorpusData, make_em_step
from strutopy_tpu_torch.models.state import init_state
from strutopy_tpu_torch.ops import mstep
from strutopy_tpu_torch.parallel.mesh import barrier, doc_axis, is_first, vocab_axis
from strutopy_tpu_torch.parallel.sharding import (
    gather_state,
    make_sharded_em_step,
    replicate_from_first,
    shard_corpus,
    shard_state,
)
from strutopy_tpu_torch.ops.spectral import spectral_init
from strutopy_tpu_torch.utils.debug import validate_state
from strutopy_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from strutopy_tpu_torch.utils.precision import true_float32

logger = logging.getLogger(__name__)


class STM:
    """Structural Topic Model on PyTorch::

        model = STM(documents, dictionary, content=False, K=10, X=meta,
                    kappa_interactions=False, max_em_iter=25,
                    init_type="spectral", model_type="STM", mode="ols",
                    device="cuda")
        model.expectation_maximization(saving=True, output_dir=...)

    ``documents`` is a BoW list of ``[(word_id, count), ...]`` or a
    :class:`PaddedCorpus`.  ``content=True`` fits the content model:
    ``beta_index`` gives every document its aspect level in ``[0, A)``.
    ``init_beta`` injects an explicit (K, V)
    initialization.  ``stream_parts=P`` (P > 1) keeps the corpus in host
    memory and moves one of P equal parts at a time to the device
    (:class:`~strutopy_tpu_torch.models.streaming.StreamedEM`).
    ``dtype`` is accepted and unused, as in the JAX package.  Advanced
    knobs live on :class:`STMConfig` (``config=``), which then overrides
    the keyword arguments.

    ``mesh`` (``parallel.make_mesh(n)`` or ``make_mesh_2d(n_doc,
    n_vocab)``, over a ``torch.distributed`` world of one process a
    device) shards the fit: each rank keeps its document shard on
    ``device`` (its own card) and, on a 2-D mesh, its block of beta's
    vocabulary.  Every rank must build the STM with the same arguments
    and the same full corpus and call every method that fits, saves or
    checkpoints, as the JAX package's single controller does; the fitted
    parameters are gathered on every rank at the end of
    ``expectation_maximization``, so reading them needs no collective,
    and only the first rank writes files.
    """

    @true_float32
    def __init__(
        self,
        documents,
        dictionary=None,
        content: bool = False,
        K: int = 10,
        X=None,
        kappa_interactions: bool = False,
        max_em_iter: int = 100,
        sigma_prior: float = 0.0,
        convergence_threshold: float = 1e-5,
        lda_beta: bool = True,
        beta_index=None,
        A: Optional[int] = None,
        dtype=np.float32,
        init_type: str = "spectral",
        model_type: str = "STM",
        mode: str = "ols",
        config: Optional[STMConfig] = None,
        mesh=None,
        batch_size: Optional[int] = None,
        seed: int = 123456,
        beta_smoothing: float = 0.0,
        stream_parts: int = 0,
        init_beta=None,
        *,
        device="cuda",
    ):
        self.mesh = mesh
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
                A=A if A is not None else (2 if content else 1),
                kappa_interactions=kappa_interactions,
                lda_beta=lda_beta and not content,
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
        self.A = config.A

        # ----- length buckets -----
        self._stream_parts = int(stream_parts or 0)
        streamed = self._stream_parts > 1
        # the plan is sized by the document axis, not the world: the
        # vocab axis of a 2-D mesh replicates documents
        n_doc = doc_axis(mesh).size if mesh is not None else 1
        # row blocks of the per-document state: a streamed fit's parts
        # are each split over the document axis
        self._row_blocks = self._stream_parts if streamed else 1
        # streaming needs equal single-bucket parts; bucket padding to a
        # multiple of stream_parts * n_doc * batch gives the part shape
        plan = make_bucket_plan(
            corpus, config.batch_size,
            n_devices=n_doc * (self._stream_parts if streamed else 1),
            max_buckets=(1 if streamed or not config.auto_bucket
                         else config.max_buckets),
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
        aspects_user = np.zeros(corpus.N, np.int32)
        if config.content:
            if beta_index is None:
                raise ValueError("content=True requires beta_index (per-doc aspect)")
            bi = np.asarray(beta_index).astype(np.int32).ravel()
            # a short array would zero-fill and an out-of-range aspect
            # would index past beta: both must fail here
            if len(bi) != corpus.N:
                raise ValueError(
                    f"beta_index has {len(bi)} entries but the corpus "
                    f"has {corpus.N} documents"
                )
            if bi.size and (bi.min() < 0 or bi.max() >= config.A):
                raise ValueError(
                    f"beta_index values must lie in [0, A={config.A}); "
                    f"got range [{bi.min()}, {bi.max()}]"
                )
            aspects_user[:] = bi
        self.betaindex = aspects_user

        doc_ok_storage = np.concatenate([b.doc_ok for b in buckets])
        self._D_np, self._design = mstep.make_prevalence_design(
            X_storage, doc_ok_storage, fit_intercept=config.fit_intercept,
            ridge_alpha=config.ridge_alpha, device=self.device,
        )
        D_buckets = np.split(self._D_np, np.cumsum([b.N for b in buckets])[:-1], axis=0)
        aspect_buckets = gather_per_bucket(aspects_user, plan)

        # the content model needs the covariate design; lda_beta=False
        # without content covariates is the A=1 SAGE topic model
        self._kappa_design = (
            mstep.build_kappa_design(
                config.K, config.A,
                config.kappa_interactions if config.content else False,
            )
            if (config.content or not config.lda_beta)
            else None
        )
        self._wcounts = corpus.word_counts()

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
            # the Gram scan shards over a 1-D mesh only, as in JAX
            one_d = mesh is not None and vocab_axis(mesh) is None and not streamed
            beta_init = spectral_init(
                corpus, config.K, self.V, maxV=config.spectral_max_v,
                device=self.device, mesh=mesh if one_d else None,
            )
            if mesh is not None:
                # every rank starts from the first rank's bits, exactly
                beta_init = replicate_from_first(mesh, beta_init, self.device)
        else:
            # normalized Gamma(0.1, 1) rows from the numpy RNG, exactly as
            # the JAX package draws them
            beta_init = self._random_beta(config.seed)

        dev = self.device
        self._set_state(init_state(
            None, K=config.K, V=self.V, N=plan.n_storage, P=self._D_np.shape[1],
            beta_init=beta_init, device=dev, A=config.A, content=config.content,
            # kappa keeps the actual design width across EM iterations
            kappa_p=(self._kappa_design.shape[1]
                     if (self._kappa_design is not None and not config.lda_beta)
                     else 0),
        ))
        kd_dev = wc_dev = None
        if not config.lda_beta:
            kd_dev = torch.as_tensor(self._kappa_design, dtype=torch.float32, device=dev)
            wc_dev = torch.as_tensor(self._wcounts, dtype=torch.float32, device=dev)

        if streamed:
            # out-of-core: the corpus stays in host memory, one part at a
            # time moves to the device
            self._data = None

            def build_step(c):
                return self._make_streamed_step(
                    c, buckets[0], aspect_buckets[0], D_buckets[0], kd_dev, wc_dev)
        else:
            data = CorpusData(
                words=tuple(torch.as_tensor(b.words) for b in buckets),
                counts=tuple(torch.as_tensor(b.counts) for b in buckets),
                aspects=tuple(torch.as_tensor(a) for a in aspect_buckets),
                doc_ok=tuple(torch.as_tensor(b.doc_ok) for b in buckets),
                D=tuple(torch.as_tensor(d) for d in D_buckets),
            )
            if mesh is not None:
                # this rank's rows, cut on the host
                data = shard_corpus(mesh, data)
            self._data = data.to(dev)

            def build_step(c):
                if mesh is not None:
                    return make_sharded_em_step(mesh, c, self._design, kd_dev, wc_dev,
                                                n_buckets=plan.n_buckets,
                                                bucket_batches=plan.batch_sizes)
                return make_em_step(c, self._design, kd_dev, wc_dev,
                                    bucket_batches=plan.batch_sizes)

        self._em_step = build_step(config)
        # cold iterations (poor warm starts leave most documents
        # unconverged at the pass-1 cap) run the single-pass schedule
        self._em_step_cold = (
            build_step(config.replace(newton_pass1_iters=0))
            if config.newton_pass1_iters > 0 and config.newton_warmup_iters > 0
            else None
        )

        self.last_bounds: list = []
        self.iter_seconds: list = []
        self.nonfinite_bound_iters: list = []
        self.time_processed: Optional[float] = None
        self.docs_per_sec: Optional[float] = None
        self._overflow_warned = False

    def _make_streamed_step(self, cfg, bucket, aspects_np, D_bucket, kappa_design,
                            wcounts):
        """(state, _) -> state over host-resident corpus parts.

        Wraps :class:`~strutopy_tpu_torch.models.streaming.StreamedEM`
        behind the signature of ``make_em_step``'s step, so
        ``expectation_maximization`` (checkpoints, resume and the
        two-pass warm-up switch included) works unchanged: per-part state
        slices come from the assembled state each call, and the new parts
        concatenate back.

        The per-iteration reassembly transiently holds about twice the
        per-document state (eta/mu/theta) on the device; for the tightest
        memory budget drive ``StreamedEM`` directly and keep the part
        states."""
        from strutopy_tpu_torch.models.streaming import StreamedEM

        P = self._stream_parts
        n_total = bucket.words.shape[0]
        if n_total % P:
            # the bucket plan is built with n_devices=stream_parts, which
            # guarantees divisibility today; pin the invariant so a plan
            # change cannot silently drop tail documents
            raise ValueError(
                f"bucket size {n_total} is not divisible by "
                f"stream_parts={P}; the padding plan must round to a "
                "multiple of stream_parts * batch_size"
            )
        part = n_total // P
        # this rank's rows of each part (StreamedEM cuts them from the
        # whole part the provider returns)
        m = part // (doc_axis(self.mesh).size if self.mesh is not None else 1)
        W, C, OK = bucket.words, bucket.counts, bucket.doc_ok
        A = np.ascontiguousarray(aspects_np, np.int32)
        D32 = np.ascontiguousarray(D_bucket, np.float32)

        def provider(p):
            s = slice(p * part, (p + 1) * part)
            return (W[s], C[s], A[s], OK[s], D32[s])

        sem = StreamedEM(
            cfg, self._design, provider, n_parts=P,
            kappa_design=kappa_design, wcounts=wcounts, mesh=self.mesh,
            device=self.device,
        )

        def step(state, _data):
            parts = [
                dataclasses.replace(
                    state,
                    eta=state.eta[i * m:(i + 1) * m],
                    mu=state.mu[i * m:(i + 1) * m],
                    theta=state.theta[i * m:(i + 1) * m],
                    opt_iters=state.opt_iters[i * m:(i + 1) * m],
                )
                for i in range(P)
            ]
            shared, new_parts = sem.em_iteration(state, parts)
            return dataclasses.replace(
                shared,
                eta=torch.cat([s.eta for s in new_parts]),
                mu=torch.cat([s.mu for s in new_parts]),
                theta=torch.cat([s.theta for s in new_parts]),
                opt_iters=torch.cat([s.opt_iters for s in new_parts]),
            )

        return step

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _set_state(self, state) -> None:
        """Take a whole state (on the device): under a mesh keep this
        rank's shard to fit on, and the whole one as the gathered state."""
        if self.mesh is None:
            self._state = state
            return
        self._state = shard_state(self.mesh, state, self.config.content, self._row_blocks)
        self._gathered = state

    def _gather(self):
        """The whole state on every rank (a collective under a mesh)."""
        if self.mesh is None:
            return self._state
        self._gathered = gather_state(self.mesh, self._state, self.config.content,
                                      self._row_blocks)
        return self._gathered

    def _whole(self):
        """The whole state the fitted parameters read: the state itself on
        one device, the state gathered at the end of the last fit (or at
        init) under a mesh, so a read on one rank needs no collective."""
        if self.mesh is None:
            return self._state
        if self._gathered is None:
            raise RuntimeError("the sharded state is gathered at the end of "
                               "expectation_maximization; it is mid-fit")
        return self._gathered

    def _first_writes(self, write) -> None:
        """Run ``write()`` on the mesh's first rank only; the others wait
        until it is done (files every rank may read next)."""
        if is_first(self.mesh):
            write()
        if self.mesh is not None:
            barrier(self.mesh, self.device)

    def _random_beta(self, seed: int) -> np.ndarray:
        """Normalized Gamma(0.1, 1) rows from the numpy RNG, exactly as
        the JAX package draws them."""
        g = np.random.RandomState(seed).gamma(0.1, 1.0, (self.config.K, self.V))
        return g / np.maximum(g.sum(axis=1, keepdims=True), 1e-300)

    def reinitialize(self, seed: int) -> "STM":
        """Re-draw the random initial state under a new seed, keeping the
        corpus, the designs and the EM step (multi-restart protocols).
        Only meaningful for ``init_type='random'``: spectral init is
        deterministic, so restarts would all coincide."""
        cfg = self.config
        if cfg.init_type != "random":
            raise ValueError(
                "reinitialize requires init_type='random': spectral "
                "init is deterministic, so re-seeded restarts would "
                "all produce the same model"
            )
        self._set_state(init_state(
            None, K=cfg.K, V=self.V, N=self._plan.n_storage, P=self._D_np.shape[1],
            beta_init=self._random_beta(seed), device=self.device, A=cfg.A,
            content=cfg.content, kappa_p=self._state.kappa.shape[0],
        ))
        self.last_bounds = []
        self.iter_seconds = []
        self.nonfinite_bound_iters = []
        self.time_processed = None
        self.docs_per_sec = None
        self._overflow_warned = False
        return self

    @true_float32
    def expectation_maximization(
        self,
        saving: bool = False,
        output_dir=None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 5,
        resume: bool = False,
        profile_dir: Optional[str] = None,
        start_iter: int = 0,
    ):
        """Run EM until convergence or ``config.max_em_iter`` (JAX's
        arguments in JAX's order).

        Each iteration's wall time (ending in a device synchronize) is
        kept in ``iter_seconds``; a non-finite bound is recorded in
        ``nonfinite_bound_iters`` and warned about once.

        ``checkpoint_path`` writes a resumable checkpoint every
        ``checkpoint_every`` iterations and at the end; ``resume=True``
        continues from it when it exists.  ``start_iter`` continues a
        partial fit in place (the state and ``last_bounds`` carry over):
        iterations run from ``start_iter`` to ``config.max_em_iter``.
        ``saving`` writes the artifact set to ``output_dir`` at the end.
        ``profile_dir`` (JAX's ``jax.profiler`` trace) is TPU-only: any
        value but None raises; ``profile_torch.py`` profiles the port.

        Under a mesh every rank calls it: a checkpoint is gathered on every
        rank and written by the first, and every rank resumes from it.
        """
        refuse_tpu_only("profile_dir", profile_dir)
        cfg = self.config
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            state, self.last_bounds, start_iter, _ = load_checkpoint(
                checkpoint_path, device=self.device)
            self._set_state(state)
            logger.info("resumed from %s at EM iteration %d", checkpoint_path, start_iter)
        self._sync()
        t0 = time.time()
        for it in range(start_iter, cfg.max_em_iter):
            it_t0 = time.time()
            step = (
                self._em_step_cold
                if self._em_step_cold is not None and it < cfg.newton_warmup_iters
                else self._em_step
            )
            self._state = step(self._state, self._data)
            self._gathered = None
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
            if cfg.debug_checks:
                validate_state(self._state, it)
            self.last_bounds.append(bound)
            self.iter_seconds.append(it_dt)
            self.docs_per_sec = self.N / max(it_dt, 1e-9)
            logger.info("EM iteration %d: bound %.4f (%.3fs, %.0f docs/s)",
                        it, bound, it_dt, self.docs_per_sec)
            if checkpoint_path and (it + 1) % checkpoint_every == 0:
                self._checkpoint(checkpoint_path, it + 1)
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
            logger.info("max EM iterations (%d) reached after %.2fs",
                        cfg.max_em_iter, self.time_processed)
        # the fitted parameters, whole on every rank
        state = self._gather()
        if checkpoint_path:
            self._checkpoint(checkpoint_path, len(self.last_bounds), state)
        if saving:
            if output_dir is None:
                raise ValueError("saving=True needs output_dir")
            self.save_model(output_dir)
        return self

    fit = expectation_maximization

    def _checkpoint(self, path, em_iter, state=None):
        state = self._gather() if state is None else state
        bounds = list(self.last_bounds)
        self._first_writes(lambda: save_checkpoint(path, state, bounds, em_iter,
                                                   self.config.to_json()))

    # ------------------------------------------------------------------
    # fitted parameters (padding documents trimmed, user order; C-order
    # arrays, as the JAX package's, so save_model writes the same files)
    # ------------------------------------------------------------------

    @property
    def beta(self) -> np.ndarray:
        return np.ascontiguousarray(self._whole().beta.cpu().numpy())

    @property
    def theta(self) -> np.ndarray:
        return self._whole().theta.cpu().numpy()[self._storage_index]

    @property
    def eta(self) -> np.ndarray:
        return self._whole().eta.cpu().numpy()[self._storage_index]

    @property
    def mu(self) -> np.ndarray:
        return self._whole().mu.cpu().numpy()[self._storage_index]

    @property
    def sigma(self) -> np.ndarray:
        return np.ascontiguousarray(self._whole().sigma.cpu().numpy())

    @property
    def gamma(self) -> np.ndarray:
        return np.ascontiguousarray(self._whole().gamma.cpu().numpy())

    @property
    def kappa(self) -> np.ndarray:
        return np.ascontiguousarray(self._whole().kappa.cpu().numpy())

    @property
    def bound(self) -> float:
        return float(self._state.bound)

    @property
    def wcounts(self) -> np.ndarray:
        return self._wcounts

    @property
    def straggler_overflow(self) -> int:
        """Docs the last E-step's two-pass straggler budget could not
        admit (left at their pass-1 eta); 0 when the schedule is off."""
        return int(self._state.straggler_overflow)

    # ------------------------------------------------------------------
    # inference on new documents (serving)
    # ------------------------------------------------------------------

    @true_float32
    def transform(self, documents, X=None, beta_index=None):
        """Infer (theta, eta) for NEW documents under the fitted model, in
        the documents' order: one batched E-step with the fitted beta and
        sigma and the prevalence prior mu = [1, X_new] @ gamma^T (or, for
        a CTM or a fit without covariates, the mean fitted eta).  Without
        an STM instance, see
        :func:`strutopy_tpu_torch.models.serving.infer_from_artifacts`.
        A content model needs ``beta_index``, the new documents' aspects.
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
        aspects_user = None
        if cfg.content:
            if beta_index is None:
                raise ValueError("content model requires beta_index for new docs")
            aspects_user = np.asarray(beta_index, np.int32).ravel()
        whole = self._whole()
        return infer_theta(whole.beta, whole.sigma, mu_user.astype(np.float32),
                           documents, cfg, aspects_user=aspects_user, device=self.device)

    # ------------------------------------------------------------------
    # persistence (the JAX package's save_model artifact set)
    # ------------------------------------------------------------------

    def save_model(self, output_dir):
        """Write the ``*_hat.npy`` artifact set, ``lower_bound.pickle``,
        ``fit_health.json``, ``stm_config.json`` and ``vocab.json``,
        file for file as the JAX package's ``STM.save_model`` writes
        them; either package's loader reads them.  Under a mesh every rank
        calls it and the first writes."""
        self._first_writes(lambda: self._write_model(output_dir))

    def _write_model(self, output_dir):
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
        if self.config.content:
            np.save(os.path.join(output_dir, "kappa_hat"), self.kappa)
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

    # ------------------------------------------------------------------
    # post-fit analysis (host numpy; see eval/)
    # ------------------------------------------------------------------

    def label_topics(self, topics=None, n: int = 10, frexweight: float = 0.5,
                     print_labels: bool = False):
        return diagnostics.label_topics(
            self.beta, self.dictionary, topics=topics, n=n,
            frexweight=frexweight, print_labels=print_labels,
        )

    def frex(self, w: float = 0.5) -> np.ndarray:
        beta = self.beta
        if beta.ndim == 3:
            beta = beta.mean(axis=0)
        return diagnostics.frex(beta, w=w)

    def find_thoughts(self, topics, threshold: float = 0.0, n: int = 3):
        return diagnostics.find_thoughts(self.theta, topics, threshold=threshold, n=n)

    def find_topic(self, query, n: int = 10, weighting: str = "prob",
                   frexweight: float = 0.5):
        """Topics most associated with a set of query words (R-stm
        ``findTopic``; see eval/diagnostics.py::find_topic)."""
        return diagnostics.find_topic(
            self.beta, query, self.dictionary, n=n, weighting=weighting,
            frexweight=frexweight, wcounts=self.wcounts,
        )

    def sage_labels(self, n: int = 7):
        """Per-(aspect, topic) top words of a content model (R-stm
        ``sageLabels`` analogue; see eval/diagnostics.py)."""
        if self.beta.ndim != 3:
            raise ValueError("sage_labels needs a content model (A-aspect beta)")
        return diagnostics.sage_labels(
            self.beta, self.dictionary, kappa=self.kappa,
            kappa_design=self._kappa_design, n=n,
        )

    def exclusivity(self, M: int = 10, w: float = 0.7) -> np.ndarray:
        beta = self.beta
        if beta.ndim == 3:
            beta = beta.mean(axis=0)
        return diagnostics.exclusivity(beta, M=M, w=w)

    def semantic_coherence(self, M: int = 10) -> np.ndarray:
        beta = self.beta
        if beta.ndim == 3:
            beta = beta.mean(axis=0)
        return diagnostics.semantic_coherence(beta, self._corpus, M=M)

    def topic_quality(self, M: int = 10, w: float = 0.7) -> dict:
        """Per-topic coherence/exclusivity pair (R-stm ``topicQuality``
        axes); plot with :func:`eval.diagnostics.plot_topic_quality`."""
        return diagnostics.topic_quality(self.beta, self._corpus, M=M, w=w)

    def to_ldavis(self, R: int = 30, lambda_step: float = 0.01,
                  path: Optional[str] = None) -> dict:
        """LDAvis JSON payload for the standard topic browser (R-stm
        ``toLDAvis``); see :func:`strutopy_tpu_torch.eval.ldavis.to_ldavis`."""
        from strutopy_tpu_torch.eval.ldavis import model_to_ldavis

        return model_to_ldavis(self, R=R, lambda_step=lambda_step, path=path)

    def topic_corr(self, method: str = "simple", cutoff: float = 0.01,
                   **huge_kwargs):
        """Topic correlation graph (R-stm ``topicCorr``).

        method="simple": threshold the fitted logistic-normal
        correlations (returns (adjacency, edges)); method="huge":
        sparse Gaussian-copula graph on theta via MB neighborhoods +
        StARS (returns the :func:`eval.graph.topic_graph_huge` dict).
        Plot either with :func:`eval.graph.plot_topic_graph`.
        """
        from strutopy_tpu_torch.eval import graph as _graph

        if method == "simple":
            return _graph.topic_graph(np.asarray(self.sigma), cutoff=cutoff)
        if method == "huge":
            return _graph.topic_graph_huge(np.asarray(self.theta),
                                           **huge_kwargs)
        raise ValueError(f"method must be 'simple' or 'huge', got {method!r}")

    def check_residuals(self, tol: float = 0.01) -> dict:
        """Multinomial dispersion of the fit's residuals (R-stm
        ``checkResiduals``, Taddy 2012; see eval/residuals.py).
        Dispersion >> 1 suggests raising K."""
        from strutopy_tpu_torch.eval.residuals import check_residuals

        beta = self.beta
        aspect = self.betaindex if beta.ndim == 3 else None
        return check_residuals(
            self._corpus, self.theta, beta, tol=tol, aspect=aspect
        )

    def summary(self, n: int = 5, print_summary: bool = True) -> str:
        """Printable model overview (R-stm ``summary.STM``): dimensions,
        convergence, and each topic's highest-probability words."""
        K = self.config.K
        lines = [
            f"A topic model with {K} topics, {self._corpus.N} documents "
            f"and a {len(self.dictionary)} word dictionary.",
            f"model_type={self.config.model_type} mode={self.config.mode} "
            f"content={self.config.content} "
            f"em_iterations={len(self.last_bounds)} "
            f"final_bound={self.last_bounds[-1]:.2f}"
            if self.last_bounds else "(not fitted yet)",
        ]
        if self.last_bounds:
            prob_labels, _frex_labels = self.label_topics(n=n)
            prop = self.theta.mean(axis=0)
            lines.append("Topics (highest probability words, mean proportion):")
            for k in range(K):
                words = ", ".join(str(w) for w in prob_labels[k])
                lines.append(f"  {k:>3} ({prop[k]:.3f}): {words}")
        out = "\n".join(lines)
        if print_summary:
            print(out)
        return out
