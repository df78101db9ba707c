"""LDAvis export (R-stm ``toLDAvis``; absent upstream).

R-stm's ``toLDAvis`` hands the fitted model to ``LDAvis::createJSON``
(phi = beta, theta, document lengths, vocab, term frequencies) and
serves the interactive topic browser.  This module implements
createJSON's data preparation directly — no LDAvis/pyLDAvis
dependency — producing the exact JSON payload the standard
``ldavis.js`` front end consumes (the same schema pyLDAvis emits):

  * ``mdsDat``      — 2-D topic map: classical MDS of the pairwise
                      Jensen-Shannon divergences between topic-word
                      distributions, marker area = topic share;
  * ``tinfo``       — the term barchart data: per-topic top-R terms by
                      relevance(lambda) = lambda*log(phi) +
                      (1-lambda)*log(lift), unioned over the lambda
                      grid, plus the Default saliency-ranked overview;
  * ``token.table`` — per-term topic shares for the hover view;
  * ``R``, ``lambda.step``, ``plot.opts``, ``topic.order``.

For a content model (A > 1 aspects), pass the aspect-marginalized beta
(``beta.mean(axis=0)`` weighted by aspect shares) or one aspect's slice.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np


def _jensen_shannon(P: np.ndarray) -> np.ndarray:
    """Pairwise Jensen-Shannon divergence between rows (K, V) -> (K, K)
    (the shared implementation lives in eval/align.py)."""
    from strutopy_tpu_torch.eval.align import topic_dissimilarity

    D = topic_dissimilarity(P, P, metric="js")
    np.fill_diagonal(D, 0.0)
    return D


def _classical_mds(D: np.ndarray, dims: int = 2) -> np.ndarray:
    """Torgerson classical MDS of a distance matrix (LDAvis ``jsPCA``
    uses cmdscale of the JS divergences)."""
    K = D.shape[0]
    D2 = D**2
    J = np.eye(K) - np.ones((K, K)) / K
    B = -0.5 * J @ D2 @ J
    w, V = np.linalg.eigh(B)
    order = np.argsort(-w)[:dims]
    coords = V[:, order] * np.sqrt(np.maximum(w[order], 0.0))[None, :]
    if coords.shape[1] < dims:  # degenerate K
        coords = np.pad(coords, ((0, 0), (0, dims - coords.shape[1])))
    return coords


def to_ldavis(
    beta: np.ndarray,
    theta: np.ndarray,
    doc_lengths: np.ndarray,
    vocab: Sequence[str],
    R: int = 30,
    lambda_step: float = 0.01,
    path: Optional[str] = None,
):
    """Build the LDAvis JSON payload (R-stm ``toLDAvis`` analog).

    ``beta`` (K, V) topic-word rows, ``theta`` (N, K) document-topic
    rows, ``doc_lengths`` (N,) token counts, ``vocab`` length-V term
    strings.  Returns the payload as a dict (JSON-serializable; write
    it next to ``ldavis.js``/``d3`` to serve the standard browser);
    ``path`` additionally writes it to disk.
    """
    beta = np.asarray(beta, np.float64)
    if beta.ndim == 3:
        raise ValueError(
            "content-model beta (A, K, V): marginalize or slice an "
            "aspect first, e.g. beta.mean(axis=0)"
        )
    theta = np.asarray(theta, np.float64)
    doc_lengths = np.asarray(doc_lengths, np.float64).ravel()
    K, V = beta.shape
    if theta.shape[1] != K or len(vocab) != V or len(doc_lengths) != len(theta):
        raise ValueError(
            f"shape mismatch: beta {beta.shape}, theta {theta.shape}, "
            f"|vocab|={len(vocab)}, |doc_lengths|={len(doc_lengths)}"
        )
    if not (0 < lambda_step <= 1):
        raise ValueError("lambda_step must be in (0, 1]")
    phi = beta / beta.sum(axis=1, keepdims=True)

    # topic frequencies/order (createJSON: theta weighted by doc length,
    # topics re-labeled 1..K by decreasing share)
    topic_freq = doc_lengths @ theta  # (K,)
    topic_prop = topic_freq / topic_freq.sum()
    order = np.argsort(-topic_prop, kind="stable")
    phi = phi[order]
    topic_freq = topic_freq[order]
    topic_prop = topic_prop[order]

    # term-topic expected counts and (recomputed) term frequencies
    tt = phi * topic_freq[:, None]  # (K, V)
    term_freq = tt.sum(axis=0)
    term_prop = term_freq / term_freq.sum()

    eps = 1e-300
    log_phi = np.log(np.maximum(phi, eps))
    lift = phi / np.maximum(term_prop[None, :], eps)
    log_lift = np.log(np.maximum(lift, eps))

    # saliency(term) = P(w) * sum_k P(k|w) log(P(k|w)/P(k))  (Chuang et al.)
    p_k_given_w = tt / np.maximum(tt.sum(axis=0, keepdims=True), eps)
    distinct = np.sum(
        p_k_given_w
        * np.log(np.maximum(p_k_given_w, eps) / topic_prop[:, None]),
        axis=0,
    )
    saliency = term_prop * distinct
    default_terms = np.argsort(-saliency, kind="stable")[:R]

    # candidate terms per topic: union over the lambda grid of top-R
    # by relevance = lambda*log(phi) + (1-lambda)*log(lift)
    lambdas = np.arange(0.0, 1.0 + lambda_step / 2, lambda_step)
    tinfo_term, tinfo_cat, tinfo_freq, tinfo_total = [], [], [], []
    tinfo_logprob, tinfo_loglift = [], []
    # Default overview rows: Freq/Total carry the term's corpus
    # frequency (what the "Most Salient Terms" bars draw), while
    # logprob/loglift hold the saliency rank scale R..1 (createJSON's
    # convention for keeping the overview sorted)
    for rank, v in enumerate(default_terms):
        tinfo_term.append(str(vocab[v]))
        tinfo_cat.append("Default")
        tinfo_freq.append(round(float(term_freq[v]), 4))
        tinfo_total.append(round(float(term_freq[v]), 4))
        tinfo_logprob.append(float(R - rank))
        tinfo_loglift.append(float(R - rank))
    candidates_per_topic = []
    for k in range(K):
        rel = lambdas[:, None] * log_phi[k][None, :] + (
            1.0 - lambdas[:, None]
        ) * log_lift[k][None, :]
        idx = np.argpartition(-rel, min(R, V - 1), axis=1)[:, :R]
        cand = np.unique(idx)
        candidates_per_topic.append(cand)
        for v in cand:
            tinfo_term.append(str(vocab[v]))
            tinfo_cat.append(f"Topic{k + 1}")
            tinfo_freq.append(float(tt[k, v]))
            tinfo_total.append(float(term_freq[v]))
            tinfo_logprob.append(round(float(log_phi[k, v]), 4))
            tinfo_loglift.append(round(float(log_lift[k, v]), 4))

    # token table: for every term that appears in tinfo, each topic's
    # share of that term's tokens (createJSON drops zero rows)
    shown = sorted({v for cand in candidates_per_topic for v in cand}
                   | set(int(v) for v in default_terms))
    tok_topic, tok_freq, tok_term = [], [], []
    for v in shown:
        shares = p_k_given_w[:, v]
        for k in np.nonzero(shares > 1e-8)[0]:
            tok_topic.append(int(k + 1))
            tok_freq.append(round(float(shares[k]), 8))
            tok_term.append(str(vocab[v]))

    coords = _classical_mds(_jensen_shannon(phi))
    payload = {
        "mdsDat": {
            "x": [float(c) for c in coords[:, 0]],
            "y": [float(c) for c in coords[:, 1]],
            "topics": list(range(1, K + 1)),
            "Freq": [float(100.0 * p) for p in topic_prop],
            "cluster": [1] * K,
        },
        "tinfo": {
            "Term": tinfo_term,
            "Freq": tinfo_freq,
            "Total": tinfo_total,
            "Category": tinfo_cat,
            "logprob": tinfo_logprob,
            "loglift": tinfo_loglift,
        },
        "token.table": {
            "Topic": tok_topic,
            "Freq": tok_freq,
            "Term": tok_term,
        },
        "R": int(min(R, V)),
        "lambda.step": float(lambda_step),
        "plot.opts": {"xlab": "PC1", "ylab": "PC2"},
        "topic.order": [int(o + 1) for o in order],
    }
    if path:
        with open(path, "w") as f:
            json.dump(payload, f)
    return payload


def model_to_ldavis(model, R: int = 30, lambda_step: float = 0.01,
                    path: Optional[str] = None):
    """``to_ldavis`` from a fitted :class:`~strutopy_tpu_torch.models.stm.STM`
    (R-stm ``toLDAvis(mod, docs)`` call shape).  Content-model betas are
    marginalized over aspects weighted by each aspect's document share.
    """
    beta = np.asarray(model.beta, np.float64)
    if beta.ndim == 3:
        asp = np.asarray(model.betaindex)
        w = np.bincount(asp, minlength=beta.shape[0]).astype(np.float64)
        beta = np.einsum("a,akv->kv", w / w.sum(), beta)
    doc_lengths = np.asarray(model._corpus.doc_lengths, np.float64)
    vocab = (
        list(model.dictionary)
        if getattr(model, "dictionary", None) is not None
        else [str(v) for v in range(beta.shape[1])]
    )
    return to_ldavis(
        beta, np.asarray(model.theta, np.float64), doc_lengths, vocab,
        R=R, lambda_step=lambda_step, path=path,
    )
