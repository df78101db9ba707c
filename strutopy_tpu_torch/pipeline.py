"""Experiment pipeline (a copy of ``strutopy_tpu/pipeline.py`` for the port).

The reference's scripted flows as library functions, exposed on the
command line (``strutopy_tpu_torch/cli.py``): fit one model and save
its artifacts, the synthetic corpus grid, document-completion heldout,
K selection (``find_k``, ``search_k``) and multi-restart selection
(``select_model``, ``many_topics``).  Every function that builds a
model runs it on ``device`` (the card unless the caller asks for the
CPU), sharded over ``mesh`` when one is given (``parallel/``: every rank
calls with the same arguments, and only the first writes files).
"""

from __future__ import annotations

import copy
import json
import logging
import os
import pickle
import time
from typing import Optional, Sequence

import numpy as np

from strutopy_tpu_torch.corpus.bow import PaddedCorpus, Vocabulary
from strutopy_tpu_torch.dgp.corpus_creation import CorpusCreation
from strutopy_tpu_torch.eval.heldout import cut_in_half, eval_heldout, split_corpus
from strutopy_tpu_torch.models.state import state_to
from strutopy_tpu_torch.models.stm import STM
from strutopy_tpu_torch.parallel.mesh import is_first
from strutopy_tpu_torch.utils.precision import true_float32

logger = logging.getLogger(__name__)


@true_float32
def fit_model(
    documents,
    K: int,
    X=None,
    dictionary=None,
    output_dir: Optional[str] = None,
    max_em_iter: int = 25,
    init_type: str = "random",
    model_type: str = "STM",
    mode: str = "ols",
    mesh=None,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    *,
    device="cuda",
    **kwargs,
) -> STM:
    """Fit one STM and optionally save the artifact set, with
    ``fit_config.json`` beside it."""
    if dictionary is None:
        dictionary = Vocabulary.from_corpus(documents)
    model = STM(
        documents=documents,
        dictionary=dictionary,
        K=K,
        X=X,
        max_em_iter=max_em_iter,
        init_type=init_type,
        model_type=model_type,
        mode=mode,
        mesh=mesh,
        device=device,
        **kwargs,
    )
    model.expectation_maximization(
        saving=output_dir is not None,
        output_dir=output_dir,
        checkpoint_path=checkpoint_path,
        resume=resume,
    )
    if output_dir is not None and is_first(mesh):
        config = {
            "num_topics": K,
            "length_dictionary": len(dictionary),
            "number_of_docs": documents.n_docs if isinstance(documents, PaddedCorpus)
            else len(documents),
            "init_type": init_type,
            "model_type": model_type,
            "mode": mode,
            "max_em_iter": max_em_iter,
            "final_bound": model.last_bounds[-1] if model.last_bounds else None,
            "time_processed": model.time_processed,
        }
        with open(os.path.join(output_dir, "fit_config.json"), "w") as f:
            json.dump(config, f, indent=2)
    return model


def create_synthetic_corpora(
    K: int,
    beta: Optional[np.ndarray] = None,
    gamma: Optional[np.ndarray] = None,
    gamma_factors: Sequence[float] = (1, 5, 10),
    n_corpora: int = 20,
    n_docs: int = 1500,
    n_words: int = 150,
    V: int = 5000,
    level: int = 1,
    train_proportion: float = 0.8,
    output_dir: Optional[str] = None,
    seed: int = 12345,
):
    """Synthetic corpus grid.

    For each gamma factor, generates ``n_corpora`` corpora (optionally
    seeded with a fitted beta/gamma), splits train/test + document
    completion halves, and pickles artifacts when ``output_dir`` is set:
    the same files, names and seeds as the JAX package's.  Returns the
    nested dict of corpora.
    """
    out = {}
    for gf in gamma_factors:
        corpora = []
        for i in range(n_corpora):
            cc = CorpusCreation(
                n_topics=K,
                n_docs=n_docs,
                n_words=n_words,
                V=V if beta is None else beta.shape[1],
                level=level,
                dgp="STM",
                beta=beta,
                gamma=None if gamma is None else gamma * gf,
                seed=seed + 1000 * i + int(gf),
            )
            cc.generate_documents(remove_terms=True)
            cc.split_corpus(proportion=train_proportion)
            corpora.append(cc)
            if output_dir is not None:
                d = os.path.join(output_dir, f"K{K}_gf{gf}", str(i))
                os.makedirs(d, exist_ok=True)
                for name in ("train_docs", "test_docs", "test_1_docs", "test_2_docs"):
                    with open(os.path.join(d, f"{name}.pickle"), "wb") as f:
                        pickle.dump(getattr(cc, name), f)
                np.save(os.path.join(d, "metadata"), cc.metadata)
                np.save(os.path.join(d, "theta_true"), cc.theta)
                np.save(os.path.join(d, "beta_true"), cc.beta)
                np.save(os.path.join(d, "gamma_true"), cc.gamma)
        out[gf] = corpora
    return out


@true_float32
def train_and_eval_heldout(
    train_docs,
    test_docs,
    K: int,
    X=None,
    model_type: str = "STM",
    init_type: str = "spectral",
    max_em_iter: int = 10,
    mesh=None,
    fast: bool = False,
    *,
    device="cuda",
    **kwargs,
):
    """Document-completion heldout evaluation of one configuration.

    Train ``model_beta`` on train+test and ``model_theta`` on
    train+test_1 (the first halves), then score ``test_2`` with
    ``eval_heldout(theta, beta)``.
    Returns (heldout_ll, model_beta, model_theta).

    ``fast=True`` skips the second fit: theta for the completion halves
    comes from ``model_beta.transform(test_1)`` (one E-step under the
    fitted parameters), halving the cost of a find-K sweep.
    """
    # materialize up front: generators would be consumed by cut_in_half
    # and the first list() below, silently emptying the later uses
    train_docs = list(train_docs)
    test_docs = list(test_docs)
    test_1, test_2 = cut_in_half(test_docs)
    beta_train_corpus = train_docs + test_docs
    theta_train_corpus = train_docs + list(test_1)

    dict_beta = Vocabulary.from_corpus(beta_train_corpus)
    dict_theta = Vocabulary.from_corpus(theta_train_corpus)
    V = max(len(dict_beta), len(dict_theta))
    dict_all = Vocabulary([str(i) for i in range(V)])

    def _X_for(n):
        if X is None:
            return None
        Xa = np.asarray(X)
        if len(Xa) < n:
            raise ValueError(
                f"X has {len(Xa)} rows but the heldout protocol fits "
                f"{n} documents (train + split test); pass covariates for "
                "the full corpus — fabricating rows by tiling would skew "
                "the comparison"
            )
        return Xa[:n]

    model_beta = STM(
        documents=beta_train_corpus,
        dictionary=dict_all,
        K=K,
        X=_X_for(len(beta_train_corpus)),
        model_type=model_type,
        init_type=init_type,
        max_em_iter=max_em_iter,
        mesh=mesh,
        device=device,
        **kwargs,
    )
    model_beta.expectation_maximization(saving=False)

    n_train = len(train_docs)
    if fast:
        X_test = None
        if X is not None and model_type == "STM":
            Xa = _X_for(len(beta_train_corpus))
            X_test = np.asarray(Xa)[n_train : n_train + len(test_1)]
        theta_heldout, _ = model_beta.transform(test_1, X=X_test)
        ll = eval_heldout(test_2, theta_heldout, model_beta.beta)
        return ll, model_beta, model_beta

    model_theta = STM(
        documents=theta_train_corpus,
        dictionary=dict_all,
        K=K,
        X=_X_for(len(theta_train_corpus)),
        model_type=model_type,
        init_type=init_type,
        max_em_iter=max_em_iter,
        mesh=mesh,
        device=device,
        **kwargs,
    )
    model_theta.expectation_maximization(saving=False)

    # theta rows for the completion docs are the tail of theta_train_corpus
    theta_heldout = model_theta.theta[n_train : n_train + len(test_1)]
    ll = eval_heldout(test_2, theta_heldout, model_beta.beta)
    return ll, model_beta, model_theta


@true_float32
def find_k(
    documents,
    K_candidates: Sequence[int],
    X=None,
    model_types: Sequence[str] = ("STM",),
    proportion: float = 0.8,
    init_type: str = "spectral",
    max_em_iter: int = 10,
    mesh=None,
    fast: bool = False,
    *,
    device="cuda",
    **kwargs,
):
    """Heldout model selection over a K grid.

    ``fast=True`` uses the single-fit transform-based completion
    (see train_and_eval_heldout), halving the sweep cost.
    Returns {model_type: {K: heldout_ll}}.
    """
    sp = split_corpus(documents, proportion, document_completion=False)
    train, test = sp["train"], sp["test"]
    results = {}
    for mt in model_types:
        results[mt] = {}
        for K in K_candidates:
            ll, _, _ = train_and_eval_heldout(
                train,
                test,
                K=K,
                X=X,
                model_type=mt,
                init_type=init_type,
                max_em_iter=max_em_iter,
                mesh=mesh,
                fast=fast,
                device=device,
                **kwargs,
            )
            logger.info("find_k: model=%s K=%d heldout=%.5f", mt, K, ll)
            results[mt][K] = ll
    return results


@true_float32
def search_k(
    documents,
    K_candidates: Sequence[int],
    X=None,
    proportion: float = 0.8,
    init_type: str = "spectral",
    max_em_iter: int = 10,
    mesh=None,
    M: int = 10,
    tol: float = 0.01,
    fast: bool = True,
    *,
    device="cuda",
    **kwargs,
):
    """Full per-K diagnostic table (R-stm ``searchK`` analog).

    :func:`find_k` selects by heldout only; this also reports the
    converged bound, semantic coherence, exclusivity and the Taddy
    residual dispersion per K, so the K choice can weigh fit against
    interpretability:

      {K: {"heldout", "bound", "coherence", "exclusivity",
           "dispersion", "fit_seconds"}}

    Heldout uses the fast transform-based document-completion protocol
    by default (one fit per K; ``fast=False`` switches to the two-fit
    protocol); coherence/exclusivity average over topics on the fitted
    beta; dispersion scores the (full-corpus) beta fit's own documents.
    """
    from strutopy_tpu_torch.eval.diagnostics import exclusivity, semantic_coherence
    from strutopy_tpu_torch.eval.residuals import check_residuals

    sp = split_corpus(documents, proportion, document_completion=False)
    documents = sp["train"] + sp["test"]
    results = {}
    for K in K_candidates:
        t0 = time.monotonic()
        ll, model, _ = train_and_eval_heldout(
            sp["train"],
            sp["test"],
            K=K,
            X=X,
            init_type=init_type,
            max_em_iter=max_em_iter,
            mesh=mesh,
            fast=fast,
            device=device,
            **kwargs,
        )
        # model (the beta fit) was trained on train + test = all of
        # `documents`; its theta rows are in that user order
        beta = model.beta
        beta2d = beta if beta.ndim == 2 else beta.mean(axis=0)
        aspect = model.betaindex if beta.ndim == 3 else None
        disp = check_residuals(
            documents, model.theta, beta, tol=tol, aspect=aspect
        )["dispersion"]
        results[int(K)] = {
            "heldout": float(ll),
            "bound": float(model.last_bounds[-1]),
            "coherence": float(np.mean(semantic_coherence(beta2d, documents, M=M))),
            "exclusivity": float(np.mean(exclusivity(beta2d, M=M))),
            "dispersion": float(disp),
            "fit_seconds": time.monotonic() - t0,
        }
        logger.info("search_k: K=%d %s", K, results[int(K)])
    return results


@true_float32
def select_model(
    documents,
    K: int,
    runs: int = 10,
    X=None,
    cast_iters: int = 4,
    keep: Optional[int] = None,
    max_em_iter: int = 50,
    M: int = 10,
    seed: int = 123456,
    mesh=None,
    return_models: bool = True,
    *,
    device="cuda",
    **kwargs,
):
    """Multi-random-restart model selection at fixed K (R-stm
    ``selectModel`` analog).

    Protocol (R-stm's cast-out schedule): fit ``runs`` random
    initializations for ``cast_iters`` EM iterations each, keep the
    top ``keep`` (default ~20%, at least 2) by variational bound, run
    the survivors on to ``max_em_iter`` iterations in all, and score
    each survivor's per-topic semantic coherence and exclusivity so
    the user can pick from the interpretability frontier (R-stm
    ``plotModels``; see :func:`strutopy_tpu_torch.eval.plots.plot_select_model`).

    One :class:`STM` serves every restart through
    :meth:`STM.reinitialize` (one corpus on the device, one set of
    designs); between the two stages each run's whole state is parked on
    the host, so the device holds one state whatever ``runs`` is, and is
    sharded over ``mesh`` again when its run goes on.

    Returns ``{"runs": [per-run dict], "kept": [run indices],
    "selected": int, "models": [fitted STM per kept run]}``.  Each
    per-run dict has the stage-1 ``cast_bound``; kept runs add final
    ``bound``, ``coherence``/``exclusivity`` (means), and the
    per-topic arrays.  ``selected`` is the kept run with the best
    final bound — the frontier data is there to overrule it.
    """
    from strutopy_tpu_torch.eval.diagnostics import exclusivity, semantic_coherence

    if runs < 1:
        raise ValueError("runs must be >= 1")
    if keep is None:
        keep = max(2, round(0.2 * runs))
    keep = min(keep, runs)
    if cast_iters < 1:
        raise ValueError(f"cast_iters ({cast_iters}) must be >= 1")
    if cast_iters >= max_em_iter:
        raise ValueError(
            f"cast_iters ({cast_iters}) must be < max_em_iter "
            f"({max_em_iter}); stage 2 would have no iterations to run"
        )

    if not isinstance(documents, PaddedCorpus):
        documents = list(documents)  # a generator must survive two uses
    model = STM(
        documents, K=K, X=X, init_type="random",
        max_em_iter=max_em_iter, seed=seed, mesh=mesh, device=device, **kwargs,
    )
    base_cfg = model.config
    run_seeds = [int(s) for s in
                 np.random.SeedSequence(seed).generate_state(runs)]

    # stage 1: cast the net — every run gets cast_iters iterations, and
    # its state parks on the host until stage 2
    stage1 = []
    model.config = base_cfg.replace(max_em_iter=cast_iters)
    for r, rs in enumerate(run_seeds):
        model.reinitialize(rs)
        model.expectation_maximization(saving=False)
        stage1.append((state_to(model._whole(), "cpu"), list(model.last_bounds)))
        logger.info(
            "select_model: run %d/%d cast bound %.4f",
            r + 1, runs, model.last_bounds[-1],
        )

    order = np.argsort([-b[-1] for _, b in stage1], kind="stable")
    kept = sorted(int(i) for i in order[:keep])

    results = [
        {"seed": run_seeds[r], "cast_bound": float(stage1[r][1][-1]),
         "kept": r in kept}
        for r in range(runs)
    ]

    # stage 2: run survivors onward from their stage-1 state
    model.config = base_cfg
    models = []
    for r in kept:
        model._set_state(state_to(stage1[r][0], model.device))
        model.last_bounds = list(stage1[r][1])
        model.time_processed = None
        model.expectation_maximization(saving=False, start_iter=cast_iters)
        beta = model.beta
        beta2d = beta if beta.ndim == 2 else beta.mean(axis=0)
        semcoh = semantic_coherence(beta2d, documents, M=M)
        excl = exclusivity(beta2d, M=M)
        results[r].update(
            bound=float(model.last_bounds[-1]),
            coherence=float(np.mean(semcoh)),
            exclusivity=float(np.mean(excl)),
            semcoh_topics=[float(x) for x in semcoh],
            exclusivity_topics=[float(x) for x in excl],
        )
        logger.info(
            "select_model: kept run %d final bound %.4f semcoh %.3f "
            "excl %.3f", r, results[r]["bound"], results[r]["coherence"],
            results[r]["exclusivity"],
        )
        if return_models:
            # snapshot: a shallow copy owning its own state/bound lists
            # (the corpus, designs, and EM step stay shared)
            snap = copy.copy(model)
            snap.last_bounds = list(model.last_bounds)
            models.append(snap)

    selected = kept[int(np.argmax([results[r]["bound"] for r in kept]))]
    return {
        "runs": results,
        "kept": kept,
        "selected": selected,
        "models": models,
    }


@true_float32
def many_topics(
    documents,
    K_candidates: Sequence[int],
    runs: int = 10,
    X=None,
    cast_iters: int = 4,
    keep: Optional[int] = None,
    max_em_iter: int = 50,
    M: int = 10,
    seed: int = 123456,
    mesh=None,
    return_models: bool = True,
    *,
    device="cuda",
    **kwargs,
):
    """R-stm ``manyTopics`` analog: :func:`select_model` at each K, so
    the K comparison is over each K's best-of-restarts model rather than
    one arbitrary seed.

    Returns ``{K: {"selected_run", "seed", "bound", "coherence",
    "exclusivity", "model"}}`` — per-K frontier metrics of the
    bound-selected survivor.  Use :func:`search_k` when heldout and
    residual diagnostics should drive the K choice instead.
    """
    out = {}
    for K in K_candidates:
        res = select_model(
            documents, K=K, runs=runs, X=X, cast_iters=cast_iters,
            keep=keep, max_em_iter=max_em_iter, M=M, seed=seed, mesh=mesh,
            return_models=return_models, device=device, **kwargs,
        )
        sel = res["selected"]
        row = res["runs"][sel]
        out[int(K)] = {
            "selected_run": sel,
            "seed": row["seed"],
            "bound": row["bound"],
            "coherence": row["coherence"],
            "exclusivity": row["exclusivity"],
            "model": (
                res["models"][res["kept"].index(sel)]
                if return_models else None
            ),
        }
        logger.info("many_topics: K=%d best run %d bound %.4f", K, sel,
                    row["bound"])
    return out
