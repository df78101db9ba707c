"""Topic correlation graph.

The reference README promises a "topic graph" whose only trace is a
networkx prototype in notebooks/graph.ipynb (SURVEY.md §2.4).  The
principled version — the R stm package's ``topicCorr`` — derives topic
correlations from the fitted logistic-normal covariance and thresholds
them into an adjacency structure; implemented here without a graph
library dependency.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def topic_correlations(sigma: np.ndarray) -> np.ndarray:
    """(K, K) correlation matrix of the logistic-normal prevalence.

    sigma is the fitted (K-1, K-1) covariance of the K-1 free eta
    coordinates; the pinned K-th topic is mapped through the softmax
    basis (covariance of [eta, 0] differences), matching R stm's
    simple correlation on the expanded covariance.
    """
    sigma = np.asarray(sigma, np.float64)
    Km1 = sigma.shape[0]
    K = Km1 + 1
    # expand to K x K THROUGH the softmax basis: e = [eta, 0] centered
    # (log-ratio representation, invariant to the pinned coordinate).
    # cov(e - mean(e) 1) = A [[sigma, 0], [0, 0]] A^T with
    # A = I - (1/K) 1 1^T.  A plain zero-pad would give the pinned
    # K-th topic structurally zero correlation with every other topic
    # — an always-isolated node in the graph.
    pad = np.zeros((K, K))
    pad[:Km1, :Km1] = sigma
    A = np.eye(K) - np.full((K, K), 1.0 / K)
    full = A @ pad @ A.T
    d = np.sqrt(np.maximum(np.diagonal(full), 1e-12))
    corr = full / np.outer(d, d)
    np.fill_diagonal(corr, 1.0)
    return corr


def topic_graph(sigma: np.ndarray, cutoff: float = 0.01):
    """Threshold positive correlations into an edge list.

    Returns (adjacency (K, K) bool, edges [(i, j, corr), ...]) —
    the structure R stm's ``topicCorr(model, method="simple")`` plots.
    """
    corr = topic_correlations(sigma)
    K = corr.shape[0]
    adj = np.zeros((K, K), bool)
    edges = []
    for i in range(K):
        for j in range(i + 1, K):
            if corr[i, j] > cutoff:
                adj[i, j] = adj[j, i] = True
                edges.append((i, j, float(corr[i, j])))
    return adj, edges


def nonparanormal(X: np.ndarray) -> np.ndarray:
    """Column-wise nonparanormal (Gaussian copula) transform: shrunk
    ECDF ranks through the normal quantile, rescaled to the column's
    original sd (the ``huge.npn(..., npn.func="shrinkage")`` transform
    R-stm's ``topicCorr(method="huge")`` applies to theta before graph
    estimation)."""
    from scipy.stats import norm, rankdata

    X = np.asarray(X, np.float64)
    n = X.shape[0]
    ranks = np.apply_along_axis(rankdata, 0, X)
    Z = norm.ppf(ranks / (n + 1))
    sd_z = Z.std(axis=0, ddof=1)
    return Z / np.where(sd_z > 0, sd_z, 1.0) * X.std(axis=0, ddof=1)


def _mb_adjacency(X: np.ndarray, lambdas: np.ndarray) -> np.ndarray:
    """Meinshausen-Buhlmann neighborhood selection along a lambda path.

    X is (n, K) with standardized columns.  For each node k, lasso-
    regress column k on the others (warm-started down the path); an
    edge (i, j) exists when EITHER coefficient is nonzero (the OR rule
    huge's ``refit`` uses).  Returns (n_lambda, K, K) bool."""
    from strutopy_tpu_torch.eval.predict import _cd_gaussian

    n, K = X.shape
    adj = np.zeros((len(lambdas), K, K), bool)
    pen = np.ones(K - 1)
    for k in range(K):
        others = [j for j in range(K) if j != k]
        Xmk, y = X[:, others], X[:, k]
        b = np.zeros(K - 1)
        for li, lam in enumerate(lambdas):
            b = _cd_gaussian(Xmk, y - y.mean(), float(lam), pen, b)
            for bj, j in zip(b, others):
                if bj != 0.0:
                    adj[li, k, j] = adj[li, j, k] = True
    return adj


def topic_graph_huge(
    theta: np.ndarray,
    n_lambda: int = 10,
    lambda_ratio: float = 0.1,
    stars_threshold: float = 0.1,
    n_subsamples: int = 20,
    seed: int = 0,
):
    """Sparse topic graph via Gaussian-copula neighborhood selection
    (R-stm ``topicCorr(model, method="huge")``): nonparanormal
    transform of theta, Meinshausen-Buhlmann lasso neighborhoods over
    a geometric lambda path, and StARS stability selection of the
    regularization (huge.select's well-known criterion; huge's default
    RIC is a rotation heuristic with no population target — StARS is
    the documented deviation, PARITY_NOTES.md).

    Returns {"adjacency" (K, K) bool, "edges" [(i, j), ...],
    "lambda" (selected), "lambdas", "instability"} — the refit
    adjacency is estimated on the FULL sample at the selected lambda
    and, like R-stm's ``posadj = refit * (cor(theta) > 0)``, masked to
    positively correlated topic pairs; the unmasked MB adjacency is
    kept under "adjacency_raw".
    """
    theta = np.asarray(theta, np.float64)
    n, K = theta.shape
    if K < 2 or n < 10:
        raise ValueError(f"need n >= 10 docs and K >= 2 topics, got {theta.shape}")
    Z = nonparanormal(theta)
    Z = (Z - Z.mean(axis=0)) / np.where(Z.std(axis=0) > 0, Z.std(axis=0), 1.0)

    # global lambda_max: the smallest lambda with an empty MB graph
    # (max absolute off-diagonal correlation), as huge computes it
    corr = np.abs(Z.T @ Z) / n
    np.fill_diagonal(corr, 0.0)
    lam_max = float(corr.max())
    lambdas = lam_max * np.geomspace(1.0, lambda_ratio, n_lambda)

    # StARS: edge frequency over subsamples of size b = 10*sqrt(n)
    rng = np.random.default_rng(seed)
    b = min(n, int(np.floor(10.0 * np.sqrt(n))))
    freq = np.zeros((n_lambda, K, K))
    for _ in range(n_subsamples):
        idx = rng.choice(n, size=b, replace=False)
        S = Z[idx]
        S = (S - S.mean(axis=0)) / np.where(S.std(axis=0) > 0, S.std(axis=0), 1.0)
        freq += _mb_adjacency(S, lambdas)
    p = freq / n_subsamples
    xi = 2.0 * p * (1.0 - p)                      # per-edge instability
    iu = np.triu_indices(K, 1)
    instability = xi[:, iu[0], iu[1]].mean(axis=1)
    # monotonize from the sparse end, then take the densest graph whose
    # cumulative instability stays under the threshold
    mono = np.maximum.accumulate(instability)
    ok = np.nonzero(mono <= stars_threshold)[0]
    sel = int(ok[-1]) if len(ok) else 0
    adj_raw = _mb_adjacency(Z, lambdas[sel: sel + 1])[0]
    # R-stm keeps only positive-association edges in the reported graph
    # (topicCorr's posadj): mask by the empirical correlation of theta.
    # A zero-variance topic column makes corrcoef emit NaN rows (plus a
    # RuntimeWarning); treat NaN as no-edge explicitly.
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = np.corrcoef(theta.T)
    adj = adj_raw & (np.nan_to_num(corr) > 0)
    edges = [(int(i), int(j)) for i, j in zip(*np.nonzero(np.triu(adj, 1)))]
    return {
        "adjacency": adj,
        "adjacency_raw": adj_raw,
        "edges": edges,
        "lambda": float(lambdas[sel]),
        "lambdas": lambdas,
        "instability": instability,
    }


def plot_topic_graph(sigma: Optional[np.ndarray] = None, cutoff: float = 0.01,
                     path: Optional[str] = None, graph: Optional[dict] = None):
    """Circular-layout plot of the topic graph (matplotlib only).

    Pass ``sigma`` for the simple correlation graph, or ``graph`` (a
    :func:`topic_graph_huge` result) for the sparse copula graph —
    the two renderings R-stm's ``plot.topicCorr`` provides.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if (sigma is None) == (graph is None):
        raise ValueError("pass exactly one of sigma or graph")
    if graph is not None:
        K = graph["adjacency"].shape[0]
        # constant-strength edges: MB adjacency has no edge weight
        edges = [(i, j, 0.25) for i, j in graph["edges"]]
    else:
        K = np.asarray(sigma).shape[0] + 1
        _, edges = topic_graph(sigma, cutoff)
    # circular layout (deterministic, dependency-free)
    ang = 2 * np.pi * np.arange(K) / K
    xy = np.c_[np.cos(ang), np.sin(ang)]
    fig, ax = plt.subplots(figsize=(6, 6))
    for i, j, w in edges:
        ax.plot(
            [xy[i, 0], xy[j, 0]], [xy[i, 1], xy[j, 1]],
            lw=0.5 + 4 * w, color="tab:blue", alpha=0.6,
        )
    ax.scatter(xy[:, 0], xy[:, 1], s=200, color="tab:orange", zorder=3)
    for k in range(K):
        ax.annotate(str(k), xy[k], ha="center", va="center", zorder=4)
    ax.set_axis_off()
    ax.set_title(
        f"Topic graph (MB/StARS, lambda {graph['lambda']:.3g})"
        if graph is not None
        else f"Topic correlation graph (cutoff {cutoff})"
    )
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig
