"""Experiment pipeline (twin of part of ``strutopy_tpu/pipeline.py``):
the document-completion heldout evaluation of one configuration.  The
rest of the pipeline (fit_model, the synthetic corpus grid, find_k,
select_model) and the CLI are not ported yet (ROADMAP.md Queue A).
"""

from __future__ import annotations

import numpy as np

from strutopy_tpu_torch.corpus.bow import Vocabulary
from strutopy_tpu_torch.eval.heldout import cut_in_half, eval_heldout
from strutopy_tpu_torch.models.stm import STM
from strutopy_tpu_torch.utils.precision import true_float32


@true_float32
def train_and_eval_heldout(
    train_docs,
    test_docs,
    K: int,
    X=None,
    model_type: str = "STM",
    init_type: str = "spectral",
    max_em_iter: int = 10,
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
        device=device,
        **kwargs,
    )
    model_theta.expectation_maximization(saving=False)

    # theta rows for the completion docs are the tail of theta_train_corpus
    theta_heldout = model_theta.theta[n_train : n_train + len(test_1)]
    ll = eval_heldout(test_2, theta_heldout, model_beta.beta)
    return ll, model_beta, model_theta
