"""Plotting utilities: the reference's matplotlib surfaces.

Covers CorpusCreation.display_props (generate_docs.py:353-379), the
convergence plot drawn from lower_bound.pickle
(06_example_application.py:226-246) and the heldout-by-K model
selection plot (06_example_application.py:198-224).  All functions
return the matplotlib Figure and only import matplotlib lazily.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def display_props(theta: np.ndarray, path: Optional[str] = None):
    """Stacked horizontal bars of per-document topic proportions
    (reference display_props, generate_docs.py:353-379, generalized
    beyond K=3)."""
    plt = _plt()
    theta = np.asarray(theta)
    N, K = theta.shape
    fig, ax = plt.subplots(figsize=(8, max(3, N * 0.12)))
    left = np.zeros(N)
    for k in range(K):
        ax.barh(range(N), theta[:, k], left=left, label=f"p(k={k + 1})")
        left += theta[:, k]
    ax.set_title(f"Topic Distribution for {N} sample documents ({K} topics)")
    ax.legend(loc="upper right", fontsize="small")
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_convergence(bounds: Sequence[float], path: Optional[str] = None):
    """ELBO trajectory over EM iterations
    (reference 06_example_application.py:226-246)."""
    plt = _plt()
    fig, ax = plt.subplots()
    ax.plot(range(len(bounds)), bounds, marker="o")
    ax.set_xlabel("EM iteration")
    ax.set_ylabel("approximate ELBO")
    ax.set_title("Convergence of the variational bound")
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_topic_words(
    beta: np.ndarray, vocab, topics: Optional[Sequence[int]] = None,
    n: int = 12, path: Optional[str] = None,
):
    """Per-topic top-word bar charts — the dependency-free stand-in for
    the reference's wordclouds (06_example_application.py:361-411;
    the wordcloud package is not available here)."""
    plt = _plt()
    beta = np.asarray(beta, np.float64)
    if beta.ndim == 3:
        beta = beta.mean(axis=0)
    K = beta.shape[0]
    n = min(n, beta.shape[1])
    topics = list(range(K)) if topics is None else list(topics)
    cols = min(len(topics), 4)
    rows = -(-len(topics) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 2.6 * rows),
                             squeeze=False)
    for ax in axes.flat:
        ax.set_axis_off()
    for i, k in enumerate(topics):
        ax = axes[i // cols][i % cols]
        ax.set_axis_on()
        top = np.argsort(-beta[k])[:n][::-1]
        ax.barh(range(n), beta[k, top])
        ax.set_yticks(range(n))
        ax.set_yticklabels([vocab[j] for j in top], fontsize=7)
        ax.set_title(f"Topic {k}", fontsize=9)
    fig.tight_layout()
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_word_frequencies(documents, vocab, n: int = 30, path: Optional[str] = None):
    """Corpus-level top word frequencies (README §5 'word frequencies')."""
    from strutopy_tpu_torch.corpus.bow import PaddedCorpus, pad_corpus

    plt = _plt()
    corpus = documents if isinstance(documents, PaddedCorpus) else pad_corpus(
        documents, V=len(vocab)
    )
    counts = corpus.word_counts()
    n = min(n, len(counts))
    top = np.argsort(-counts)[:n][::-1]
    fig, ax = plt.subplots(figsize=(6, 0.25 * n + 1))
    ax.barh(range(n), counts[top])
    ax.set_yticks(range(n))
    ax.set_yticklabels([vocab[j] for j in top], fontsize=7)
    ax.set_title(f"Top {n} word frequencies")
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_tsne_tfidf(
    documents, labels=None, perplexity: float = 20.0,
    path: Optional[str] = None, seed: int = 0,
):
    """tf-idf -> t-SNE corpus scatter (README §5).

    Uses sklearn's TSNE on the tf-idf-weighted document-term matrix;
    points optionally colored by a per-document label.
    """
    from sklearn.manifold import TSNE

    from strutopy_tpu_torch.corpus.bow import create_dtm

    plt = _plt()
    dtm = create_dtm(documents)
    tf = dtm / np.maximum(dtm.sum(axis=1, keepdims=True), 1.0)
    df = (dtm > 0).sum(axis=0)
    idf = np.log(dtm.shape[0] / np.maximum(df, 1.0)) + 1.0
    tfidf = tf * idf[None, :]
    emb = TSNE(
        n_components=2, perplexity=min(perplexity, max(2, dtm.shape[0] // 4)),
        random_state=seed, init="random",
    ).fit_transform(tfidf)
    fig, ax = plt.subplots(figsize=(6, 6))
    c = None if labels is None else np.asarray(labels)
    sc = ax.scatter(emb[:, 0], emb[:, 1], s=8, c=c, cmap="tab10", alpha=0.7)
    if labels is not None:
        fig.colorbar(sc, ax=ax, shrink=0.7)
    ax.set_title("tf-idf t-SNE of documents")
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_heldout_by_k(results: Mapping, path: Optional[str] = None):
    """Heldout log-likelihood per K per model — the find-K selection
    plot (reference 06_example_application.py:198-224).  ``results``
    is the dict returned by pipeline.find_k."""
    plt = _plt()
    fig, ax = plt.subplots()
    for model_type, by_k in results.items():
        ks = sorted(by_k)
        ax.plot(ks, [by_k[k] for k in ks], marker="o", label=model_type)
    ax.set_xlabel("number of topics K")
    ax.set_ylabel("heldout log-likelihood")
    ax.set_title("Document-completion heldout by K")
    ax.legend()
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_removed(stats: Mapping, path: Optional[str] = None):
    """R-stm ``plotRemoved``: words/tokens/documents dropped as a
    function of the lower document-frequency threshold.  ``stats`` is
    the dict from corpus.preprocess.removed_by_threshold."""
    plt = _plt()
    thr = stats["threshold"]
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2))
    for ax, key, label in zip(
        axes,
        ("words_removed", "tokens_removed", "docs_removed"),
        ("vocabulary terms removed", "tokens removed", "documents emptied"),
    ):
        ax.plot(thr, stats[key], marker="o")
        ax.set_xlabel("min document frequency")
        ax.set_ylabel(label)
    fig.suptitle("Preprocessing threshold diagnostics (plotRemoved)")
    fig.tight_layout()
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_perspectives(
    beta,
    vocab,
    topics,
    aspects=None,
    n: int = 25,
    path: Optional[str] = None,
):
    """R-stm ``plot.STM(type="perspectives")``: contrast two topics —
    or ONE topic across two aspects of a content model — as words
    placed by their probability contrast, sized by combined mass.

    ``beta``: (K, V), with ``topics=(k1, k2)``; or (A, K, V) with
    ``topics=k`` and ``aspects=(a1, a2)``.
    """
    plt = _plt()
    beta = np.asarray(beta, np.float64)
    if beta.ndim == 3:
        if aspects is None or np.ndim(topics) != 0:
            raise ValueError(
                "content-model beta needs topics=<one topic>, aspects=(a1, a2)"
            )
        k = int(topics)
        b1, b2 = beta[int(aspects[0]), k], beta[int(aspects[1]), k]
        labels = (f"topic {k} / aspect {aspects[0]}",
                  f"topic {k} / aspect {aspects[1]}")
    else:
        k1, k2 = topics
        b1, b2 = beta[int(k1)], beta[int(k2)]
        labels = (f"topic {k1}", f"topic {k2}")
    mass = b1 + b2
    top = np.argsort(-mass)[:n]
    # x in [-1, 1]: relative leaning; y spreads ties for readability
    x = (b2[top] - b1[top]) / np.maximum(mass[top], 1e-300)
    size = mass[top] / mass[top].max()
    order = np.argsort(x)
    fig, ax = plt.subplots(figsize=(8, 6))
    for rank, i in enumerate(order):
        ax.text(x[i], rank, str(vocab[int(top[i])]),
                fontsize=7 + 13 * size[i], ha="center", va="center")
    ax.set_xlim(-1.15, 1.15)
    ax.set_ylim(-1, n)
    ax.set_yticks([])
    ax.set_xticks([-1, 0, 1])
    ax.set_xticklabels([labels[0], "shared", labels[1]])
    ax.set_title("Perspectives: word-probability contrast")
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_search_k(results: Mapping, path: Optional[str] = None):
    """R-stm ``plot.searchK``: the four model-selection panels
    (heldout, residual dispersion, semantic coherence, bound) over K.
    ``results`` is the dict from pipeline.search_k."""
    plt = _plt()
    # tolerate string keys (results round-tripped through JSON)
    results = {int(k): v for k, v in results.items()}
    Ks = sorted(results)
    panels = (
        ("heldout", "heldout log-likelihood"),
        ("dispersion", "residual dispersion"),
        ("coherence", "semantic coherence"),
        ("bound", "variational bound"),
    )
    fig, axes = plt.subplots(2, 2, figsize=(9, 7))
    for ax, (key, label) in zip(axes.ravel(), panels):
        ax.plot(Ks, [results[k][key] for k in Ks], marker="o")
        ax.set_xlabel("K")
        ax.set_title(label)
    if "dispersion" in results[Ks[0]]:
        axes.ravel()[1].axhline(1.0, color="gray", lw=1, ls="--")
    fig.suptitle("search_k model-selection diagnostics")
    fig.tight_layout()
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_select_model(result: Mapping, path: Optional[str] = None):
    """R-stm ``plotModels``: the semantic-coherence / exclusivity
    frontier over the kept runs of :func:`pipeline.select_model`.

    Per-topic points are drawn small per run; the run means large with
    the run index as label, the bound-selected run circled.
    """
    plt = _plt()
    runs = result["runs"]
    kept = result["kept"]
    fig, ax = plt.subplots(figsize=(7, 5))
    cmap = plt.get_cmap("tab10")
    for j, r in enumerate(kept):
        row = runs[r]
        c = cmap(j % 10)
        ax.scatter(row["semcoh_topics"], row["exclusivity_topics"],
                   s=12, alpha=0.35, color=c)
        ax.scatter([row["coherence"]], [row["exclusivity"]],
                   s=120, color=c, edgecolor="black", zorder=3)
        ax.annotate(str(r), (row["coherence"], row["exclusivity"]),
                    ha="center", va="center", fontsize=8, zorder=4)
        if r == result.get("selected"):
            ax.scatter([row["coherence"]], [row["exclusivity"]],
                       s=320, facecolor="none", edgecolor="black",
                       lw=1.5, zorder=2)
    ax.set_xlabel("semantic coherence")
    ax.set_ylabel("exclusivity")
    ax.set_title("select_model: coherence/exclusivity frontier "
                 "(small = topics, large = run means)")
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_quote(
    texts: Sequence[str],
    width: int = 60,
    maxlen: int = 800,
    path: Optional[str] = None,
):
    """R-stm ``plotQuote``: render example documents (usually the
    output of ``find_thoughts``) as a text figure for inclusion next to
    topic summaries."""
    import textwrap

    plt = _plt()
    if isinstance(texts, str):
        texts = [texts]
    blocks = []
    for t in texts:
        t = str(t)
        if len(t) > maxlen:
            t = t[: maxlen - 1] + "…"
        blocks.append(textwrap.fill(t, width=width))
    body = ("\n" + "—" * width + "\n").join(blocks)
    n_lines = body.count("\n") + 1
    fig, ax = plt.subplots(figsize=(0.11 * width + 1, 0.22 * n_lines + 0.8))
    ax.axis("off")
    ax.text(0.0, 1.0, body, ha="left", va="top", family="monospace",
            fontsize=9, wrap=False, transform=ax.transAxes)
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_cloud(
    beta_k: np.ndarray,
    vocab,
    max_words: int = 80,
    min_fontsize: float = 7.0,
    max_fontsize: float = 44.0,
    seed: int = 0,
    path: Optional[str] = None,
):
    """R-stm ``cloud``: a word cloud of one topic's distribution, with
    no wordcloud-package dependency — greedy Archimedean-spiral
    placement of the top ``max_words`` words, font size proportional to
    sqrt(beta) (the standard area~probability convention), rectangle
    collision checks on estimated text extents.

    ``beta_k`` is one topic's (V,) word distribution (e.g.
    ``model.beta[k]``; for a content model pass an aspect row or the
    aspect mean).  Returns the figure.
    """
    plt = _plt()
    beta_k = np.asarray(beta_k, np.float64).ravel()
    order = np.argsort(-beta_k)[:max_words]
    order = order[beta_k[order] > 0]
    if order.size == 0:
        raise ValueError("plot_cloud: the topic row has no positive mass")
    w = np.sqrt(beta_k[order])
    sizes = min_fontsize + (max_fontsize - min_fontsize) * (
        (w - w[-1]) / max(w[0] - w[-1], 1e-12)
    )
    rng = np.random.default_rng(seed)

    # text extents in point units: width ~ 0.62 * size * chars (mixed-
    # case average for DejaVu Sans), height ~ 1.15 * size
    placed = []  # (x0, y0, x1, y1)

    def collides(box):
        x0, y0, x1, y1 = box
        for a0, b0, a1, b1 in placed:
            if x0 < a1 and a0 < x1 and y0 < b1 and b0 < y1:
                return True
        return False

    coords = []
    for word, size in zip((vocab[i] for i in order), sizes):
        tw = 0.62 * size * max(len(str(word)), 1)
        th = 1.15 * size
        theta0 = float(rng.uniform(0.0, 2 * np.pi))
        t = 0.0
        while True:
            r = 2.2 * t
            x = r * np.cos(t + theta0)
            y = 0.62 * r * np.sin(t + theta0)  # wider than tall
            box = (x - tw / 2, y - th / 2, x + tw / 2, y + th / 2)
            if not collides(box):
                placed.append(box)
                coords.append((x, y, str(word), size))
                break
            t += 0.35
    xs0, ys0, xs1, ys1 = (np.array([b[i] for b in placed]) for i in range(4))
    fig, ax = plt.subplots(figsize=(8, 5.5))
    ax.axis("off")
    ax.set_xlim(xs0.min() - 5, xs1.max() + 5)
    ax.set_ylim(ys0.min() - 5, ys1.max() + 5)
    cmap = plt.get_cmap("viridis")
    smin, smax = sizes.min(), sizes.max()
    for x, y, word, size in coords:
        ax.text(x, y, word, ha="center", va="center", fontsize=size,
                color=cmap(0.15 + 0.7 * (size - smin) / max(smax - smin, 1e-12)))
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_theta_hist(
    theta: np.ndarray,
    topics: Optional[Sequence[int]] = None,
    bins: int = 20,
    path: Optional[str] = None,
):
    """R-stm ``plot.STM(type="hist")``: per-topic histograms of the
    documents' MAP topic proportions — the quick view of whether a
    topic is broad background mass or concentrated in few documents."""
    plt = _plt()
    theta = np.asarray(theta, np.float64)
    K = theta.shape[1]
    topics = list(range(K)) if topics is None else list(topics)
    ncol = min(4, len(topics))
    nrow = -(-len(topics) // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(3.2 * ncol, 2.4 * nrow),
                             squeeze=False, sharex=True)
    for ax in axes.ravel()[len(topics):]:
        ax.axis("off")
    for ax, k in zip(axes.ravel(), topics):
        ax.hist(theta[:, k], bins=bins, range=(0.0, 1.0),
                color="#4878d0", edgecolor="white")
        ax.set_title(f"topic {k}", fontsize=9)
    fig.suptitle("distribution of document topic proportions")
    fig.tight_layout()
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_topic_summary(
    theta: np.ndarray,
    beta: np.ndarray,
    vocab,
    topics: Optional[Sequence[int]] = None,
    n_words: int = 3,
    path: Optional[str] = None,
):
    """R-stm ``plot.STM(type="summary")``: expected topic proportions
    as horizontal bars sorted largest-first, each annotated with the
    topic's top words — the standard one-glance model summary."""
    plt = _plt()
    theta = np.asarray(theta, np.float64)
    beta = np.asarray(beta, np.float64)
    if beta.ndim == 3:
        beta = beta.mean(axis=0)
    K = beta.shape[0]
    topics = list(range(K)) if topics is None else list(topics)
    share = theta.mean(axis=0)
    order = sorted(topics, key=lambda k: share[k])  # barh: largest on top
    words = [
        ", ".join(str(vocab[i]) for i in np.argsort(-beta[k])[:n_words])
        for k in order
    ]
    fig, ax = plt.subplots(figsize=(7.5, 0.34 * len(order) + 1.2))
    y = np.arange(len(order))
    ax.barh(y, share[order], color="#4878d0")
    ax.set_yticks(y, [f"topic {k}" for k in order], fontsize=8)
    xmax = float(share[order].max())
    for yi, k, w in zip(y, order, words):
        ax.text(share[k] + 0.01 * xmax, yi, w, va="center", fontsize=7.5)
    ax.set_xlim(0, xmax * 1.55)  # room for the word annotations
    ax.set_xlabel("expected topic proportion")
    ax.set_title("top topics")
    fig.tight_layout()
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig
