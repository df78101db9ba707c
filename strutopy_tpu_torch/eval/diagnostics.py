"""Topic-quality diagnostics: FREX, labels, thoughts, coherence, exclusivity.

FREX/label_topics/find_thoughts mirror the reference
(src/modules/stm.py:1151-1259).  Semantic coherence and exclusivity are
README-promised by the reference (README.md:36-38) but absent from its
code; they are implemented here from the standard definitions (Mimno et
al. 2011; Roberts et al. / R-stm ``exclusivity``), closing the gap
noted in SURVEY.md §4.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np



def ecdf(arr: np.ndarray) -> np.ndarray:
    """Empirical CDF by max-rank (reference ecdf, stm.py:1257-1259)."""
    arr = np.asarray(arr)
    # max-rank of ties = count of values <= x, i.e. rankdata(method="max")
    sorted_vals = np.sort(arr)
    ranks = np.searchsorted(sorted_vals, arr, side="right")
    return ranks / arr.size


def frex(beta: np.ndarray, w: float = 0.5) -> np.ndarray:
    """FREX score matrix (K, V) (reference frex, stm.py:1203-1219).

    Harmonic mean of the within-topic ECDF of log-exclusivity
    (column-logsumexp-normalized log beta) and of log-frequency.
    """
    beta = np.asarray(beta, np.float64)
    with np.errstate(divide="ignore"):
        logbeta = np.log(beta)
    # scipy's logsumexp, not a hand-rolled one: exact ties in real
    # corpora (words with identical counts) must stay exact ties, or
    # the max-rank ECDF shifts whole tie-groups vs the reference
    import scipy.special

    col_lse = scipy.special.logsumexp(logbeta, axis=0)
    with np.errstate(invalid="ignore"):
        # a word with zero mass in EVERY topic (unsmoothed beta, term
        # absent from the fit corpus) gives -inf - -inf = nan; its FREX
        # is meaningless either way and never ranks into top words
        log_exclusivity = logbeta - col_lse[None, :]
    exclusivity_ecdf = np.apply_along_axis(ecdf, 1, log_exclusivity)
    freq_ecdf = np.apply_along_axis(ecdf, 1, logbeta)
    return 1.0 / (w / exclusivity_ecdf + (1 - w) / freq_ecdf)


def label_topics(
    beta: np.ndarray,
    vocab,
    topics: Optional[Sequence[int]] = None,
    n: int = 10,
    frexweight: float = 0.5,
    print_labels: bool = False,
):
    """Top-n words per topic by probability and by FREX
    (reference label_topics, stm.py:1151-1201).
    """
    assert n >= 1, "n must be 1 or greater"
    beta = np.asarray(beta, np.float64)
    if beta.ndim == 3:  # content model: marginalize aspects for labeling
        beta = beta.mean(axis=0)
    K = beta.shape[0]
    topics = range(K) if topics is None else topics

    fx = frex(beta, w=frexweight)
    problabels = np.argsort(-beta, axis=1)[:, :n]
    frexlabels = np.argsort(-fx, axis=1)[:, :n]

    out_prob, out_frex = [], []
    for k in topics:
        probwords = [vocab[i] for i in problabels[k]]
        frexwords = [vocab[i] for i in frexlabels[k]]
        if print_labels:
            print(f"Topic {k}:\n \t Highest Prob: {probwords}")
            print(f"Topic {k}:\n \t FREX: {frexwords}")
        out_prob.append(probwords)
        out_frex.append(frexwords)
    return out_prob, out_frex


def find_topic(
    beta: np.ndarray,
    query: Sequence[str],
    vocab,
    n: int = 10,
    weighting: str = "prob",
    frexweight: float = 0.5,
    wcounts: Optional[np.ndarray] = None,
):
    """Topics most associated with a set of query words (R-stm
    ``findTopic``; absent upstream).

    For each topic, every query word gets its within-topic percentile
    rank under the chosen ``weighting`` matrix — ``"prob"`` (beta),
    ``"frex"`` (:func:`frex`), or ``"lift"`` (beta over the corpus
    word-frequency marginal, which needs ``wcounts``, the (V,) corpus
    word counts) — and the topic's score is the mean percentile over
    the query.  Percentile ranks (not raw weights) make words of very
    different corpus frequency commensurable, which is the point of
    querying by word set.

    ``beta`` is (K, V) or (A, K, V) (content models marginalize
    aspects, as in :func:`label_topics`).  Unknown query words raise —
    a silent drop would quietly change the question being asked.

    Returns ``{"topics": (n,) int array (best first), "scores": (n,)
    mean percentile in [0, 1], "ranks": (n, W) per-word percentiles in
    query order}``.
    """
    beta = np.asarray(beta, np.float64)
    if beta.ndim == 3:
        beta = beta.mean(axis=0)
    K, V = beta.shape
    if isinstance(query, str):
        query = [query]
    if len(query) == 0:
        raise ValueError("query must contain at least one word")
    index = {w: i for i, w in enumerate(vocab)}
    missing = [w for w in query if w not in index]
    if missing:
        raise ValueError(f"query words not in vocab: {missing}")
    cols = np.asarray([index[w] for w in query])

    if weighting == "prob":
        W = beta
    elif weighting == "frex":
        W = frex(beta, w=frexweight)
    elif weighting == "lift":
        if wcounts is None:
            raise ValueError('weighting="lift" needs wcounts (corpus '
                             "word counts, shape (V,))")
        marginal = np.asarray(wcounts, np.float64)
        marginal = marginal / marginal.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            W = beta / marginal[None, :]
        W = np.where(np.isfinite(W), W, 0.0)
    else:
        raise ValueError(f"unknown weighting {weighting!r}: "
                         'use "prob", "frex" or "lift"')

    # within-topic percentile of each query word (max-rank ECDF, the
    # same tie convention as frex())
    pct = np.apply_along_axis(ecdf, 1, W)[:, cols]   # (K, W)
    scores = pct.mean(axis=1)
    n = min(n, K)
    order = np.argsort(-scores, kind="stable")[:n]
    return {"topics": order, "scores": scores[order], "ranks": pct[order]}


def find_thoughts(
    theta: np.ndarray,
    topics: Sequence[int],
    threshold: float = 0.0,
    n: int = 3,
):
    """Most representative documents per topic
    (reference find_thoughts, stm.py:1221-1255).
    """
    theta = np.asarray(theta)
    N = theta.shape[0]
    n = min(n, N)
    results = []
    for k in topics:
        order = np.argsort(-theta[:, k])[:n]
        vals = theta[order, k]
        results.append(order[vals >= threshold])
    if len(results) == 1:
        return results[0]
    return results


def exclusivity(beta: np.ndarray, M: int = 10, w: float = 0.7) -> np.ndarray:
    """Per-topic exclusivity (R-stm ``exclusivity()`` definition).

    FREX with weight ``w`` on exclusivity, summed over each topic's top
    ``M`` most probable words.  Promised by the reference README
    (README.md:36-38) but never implemented there.
    """
    beta = np.asarray(beta, np.float64)
    col = beta.sum(axis=0)
    mat = beta / np.maximum(col[None, :], 1e-300)  # p(topic | word)
    ex = np.apply_along_axis(ecdf, 1, mat)
    fr = np.apply_along_axis(ecdf, 1, beta)
    fx = 1.0 / (w / ex + (1 - w) / fr)
    top = np.argsort(-beta, axis=1)[:, :M]
    return np.array([fx[k, top[k]].sum() for k in range(beta.shape[0])])


def semantic_coherence(beta: np.ndarray, documents, M: int = 10) -> np.ndarray:
    """Per-topic semantic coherence (Mimno et al. 2011).

    C_k = sum_{i<j over the top-M words} log((D(v_i, v_j) + 1) / D(v_j))
    where D counts documents containing the word(s).  Promised by the
    reference README but never implemented there.

    Memory-bounded: only the (at most K*M) top-word columns of the
    binary document-term matrix are materialized, so this scales to
    pod-size corpora (a full dense DTM at N=100k, V=50k would be 40 GB).
    """
    beta = np.asarray(beta, np.float64)
    K, V = beta.shape
    top = np.argsort(-beta, axis=1)[:, :M]

    need = np.unique(top)
    U = len(need)
    col_pos = np.full(V, -1, np.int32)
    col_pos[need] = np.arange(U, dtype=np.int32)

    # accumulate the (U, U) co-document matrix over document chunks so
    # host memory stays O(chunk * U), not O(N * U)
    co_full = np.zeros((U, U), np.float64)
    if isinstance(documents, np.ndarray):  # pre-built (dense) DTM
        D = documents.shape[0]
        for s in range(0, D, 65536):
            cols = (documents[s : s + 65536][:, need] > 0).astype(np.float32)
            co_full += (cols.T @ cols).astype(np.float64)
    else:
        from strutopy_tpu_torch.corpus.bow import PaddedCorpus, pad_corpus

        corpus = documents if isinstance(documents, PaddedCorpus) else pad_corpus(
            documents, V=V
        )
        D = corpus.N
        B = 65536
        for s in range(0, D, B):
            w = corpus.words[s : s + B]
            c = corpus.counts[s : s + B]
            pos = col_pos[w]
            mask = (c > 0) & (pos >= 0)
            nb = w.shape[0]
            cols = np.zeros((nb, U), np.float32)
            rows = np.broadcast_to(np.arange(nb)[:, None], w.shape)[mask]
            cols[rows, pos[mask]] = 1.0
            co_full += (cols.T @ cols).astype(np.float64)

    scores = np.zeros(K)
    for k in range(K):
        ix = col_pos[top[k]]
        co = co_full[np.ix_(ix, ix)]  # (M, M) co-document counts
        doc_freq = np.diag(co)
        s = 0.0
        for i in range(1, M):
            for j in range(i):
                s += np.log((co[i, j] + 1.0) / max(doc_freq[j], 1.0))
        scores[k] = s
    return scores


def sage_labels(
    beta: np.ndarray,
    vocab,
    kappa: Optional[np.ndarray] = None,
    kappa_design: Optional[np.ndarray] = None,
    n: int = 7,
):
    """Per-(aspect, topic) top words for content models — the R-stm
    ``sageLabels`` analogue (the reference's label_topics marginalizes
    aspects away; its README promises content-covariate summaries,
    README.md:44-45, with no implementation).

    Returns a dict with:
      ``marginal``: top-n words per topic of the aspect-averaged beta;
      ``by_aspect``: [A][K] lists of top-n words of beta[a, k];
      ``kappa_aspect`` (when ``kappa``+``kappa_design`` are given):
        per aspect, the n words with the largest aspect-column kappa
        coefficients — the words each covariate level loads on,
        independent of topic.
    """
    beta = np.asarray(beta, np.float64)
    assert beta.ndim == 3, "sage_labels needs an (A, K, V) content beta"
    A, K, V = beta.shape

    def top(row):
        return [vocab[i] for i in np.argsort(-row)[:n]]

    out = {
        "marginal": [top(r) for r in beta.mean(axis=0)],
        "by_aspect": [[top(beta[a, k]) for k in range(K)] for a in range(A)],
    }
    if kappa is not None and kappa_design is not None:
        kappa = np.asarray(kappa, np.float64)  # (P, V)
        Xd = np.asarray(kappa_design)  # ((A*K), P)
        # aspect-indicator columns: the design's K..K+A block
        # (build_kappa_design layout) when A >= 2
        if Xd.shape[1] >= K + A and A >= 2:
            asp_cols = kappa[K : K + A]  # (A, V)
            out["kappa_aspect"] = [top(asp_cols[a]) for a in range(A)]
    return out


def topic_quality(beta: np.ndarray, documents, M: int = 10,
                  w: float = 0.7) -> dict:
    """Per-topic (semantic_coherence, exclusivity) pair — the two axes
    of R-stm's ``topicQuality`` plot.  Neither metric exists in the
    python reference (its README.md:36-38 promises them); both follow
    the R-stm definitions implemented above.

    ``beta`` may be (K, V) or a content model's (A, K, V) (aspects are
    marginalized for scoring, as in :func:`label_topics`).
    """
    beta = np.asarray(beta, np.float64)
    if beta.ndim == 3:
        beta = beta.mean(axis=0)
    return {
        "semantic_coherence": semantic_coherence(beta, documents, M=M),
        "exclusivity": exclusivity(beta, M=M, w=w),
    }


def plot_topic_quality(beta: np.ndarray, documents, M: int = 10,
                       w: float = 0.7, path: Optional[str] = None,
                       theta: Optional[np.ndarray] = None):
    """R-stm ``topicQuality``: scatter of semantic coherence (x) vs
    exclusivity (y), each topic drawn as its index.  With ``theta``,
    marker size scales with the topic's expected corpus proportion.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    q = topic_quality(beta, documents, M=M, w=w)
    x, y = q["semantic_coherence"], q["exclusivity"]
    size = None
    if theta is not None:
        props = np.asarray(theta, np.float64).mean(axis=0)
        size = 2000.0 * props / props.max()
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.scatter(x, y, s=size if size is not None else 40,
               alpha=0.25, color="tab:blue")
    for k in range(len(x)):
        ax.annotate(str(k), (x[k], y[k]), ha="center", va="center",
                    fontsize=8)
    ax.set_xlabel(f"semantic coherence (top {M} words)")
    ax.set_ylabel(f"exclusivity (FREX w={w})")
    ax.set_title("Topic quality")
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def check_beta(beta: np.ndarray, tolerance: float = 0.01, vocab=None):
    """Degenerate-topic check (R-stm ``checkBeta``): flag words that a
    topic assigns essentially ALL of its mass (beta[k, v] >= 1 -
    tolerance) — the signature of a collapsed topic-word distribution
    (a topic that emits one word), which usually means K is too large
    or the vocabulary pruning left near-singleton terms.

    ``beta`` is (K, V) or (A, K, V) for a content model (every aspect
    is checked).  Returns {"ok": bool, "problem": [(aspect, topic,
    word, prob)], "topic_totals": (K,) flags per topic}.
    """
    beta = np.asarray(beta, np.float64)
    squeeze = beta.ndim == 2
    if squeeze:
        beta = beta[None]
    A, K, V = beta.shape
    hits = np.argwhere(beta >= 1.0 - tolerance)
    problem = [
        (
            int(a), int(k),
            (vocab[v] if vocab is not None else str(v)),
            float(beta[a, k, v]),
        )
        for a, k, v in hits
    ]
    topic_totals = np.zeros(K, dtype=int)
    for _a, k, _w, _p in problem:
        topic_totals[k] += 1
    return {
        "ok": len(problem) == 0,
        "problem": problem,
        "topic_totals": topic_totals,
    }
