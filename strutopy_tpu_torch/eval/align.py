"""Topic alignment and stability across model runs (R-stm ``multiSTM``
analog; absent upstream — the reference pins one seed per fit,
src/modules/stm.py:425-428, so it never faces the matching problem).

``pipeline.select_model`` surfaces several converged restarts of the
same configuration; their topics come back in arbitrary order and with
run-to-run variation.  This module solves the matching problem the
R-stm ``multiSTM`` workflow addresses: align every run's topics to a
reference run by optimal assignment (Hungarian algorithm on a pairwise
topic-dissimilarity matrix), then report per-topic stability — how
reproducible each topic is across random restarts.

All host-side NumPy/SciPy: the inputs are (K, V) betas, K at most a
few hundred.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _as_2d_beta(beta) -> np.ndarray:
    beta = np.asarray(beta, np.float64)
    if beta.ndim == 3:  # content model: aspect-marginal, as in label_topics
        beta = beta.mean(axis=0)
    if beta.ndim != 2:
        raise ValueError(f"expected a (K, V) or (A, K, V) beta, got "
                         f"shape {beta.shape}")
    return beta / np.maximum(beta.sum(axis=1, keepdims=True), 1e-300)


def topic_dissimilarity(beta_a: np.ndarray, beta_b: np.ndarray,
                        metric: str = "js") -> np.ndarray:
    """Pairwise dissimilarity between two runs' topic-word rows.

    ``"js"`` — Jensen-Shannon divergence (bounded [0, log 2], the
    LDAvis/topic-map metric); ``"l1"`` — half total-variation,
    0.5*sum|p-q| in [0, 1] (multiSTM's L1 convention up to the half);
    ``"cosine"`` — 1 - cosine similarity.
    Returns (K_a, K_b).
    """
    A = _as_2d_beta(beta_a)
    B = _as_2d_beta(beta_b)
    if A.shape[1] != B.shape[1]:
        raise ValueError(f"vocab sizes differ: {A.shape[1]} vs {B.shape[1]}")
    if metric == "l1":
        return 0.5 * np.abs(A[:, None, :] - B[None, :, :]).sum(axis=2)
    if metric == "cosine":
        # guard dead topics: update_beta_lda zeroes a row whose suff
        # stats are zero, and 0/0 here would feed NaNs into the
        # Hungarian assignment.  A zero row gets similarity 0 to
        # everything — maximally dissimilar, like the js branch.
        An = A / np.maximum(np.linalg.norm(A, axis=1, keepdims=True), 1e-300)
        Bn = B / np.maximum(np.linalg.norm(B, axis=1, keepdims=True), 1e-300)
        return 1.0 - An @ Bn.T
    if metric == "js":
        logA = np.where(A > 0, np.log(np.maximum(A, 1e-300)), 0.0)
        logB = np.where(B > 0, np.log(np.maximum(B, 1e-300)), 0.0)
        D = np.empty((A.shape[0], B.shape[0]))
        for i in range(A.shape[0]):
            M = 0.5 * (A[i][None] + B)              # (K_b, V)
            logM = np.log(np.maximum(M, 1e-300))
            kl_a = np.sum(A[i][None] * (logA[i][None] - logM), axis=1)
            kl_b = np.sum(B * (logB - logM), axis=1)
            D[i] = 0.5 * (kl_a + kl_b)
        return np.maximum(D, 0.0)
    raise ValueError(f'unknown metric {metric!r}: use "js", "l1" or "cosine"')


def align_topics(
    betas: Sequence[np.ndarray],
    reference: int = 0,
    metric: str = "js",
):
    """Align every run's topics to one reference run by optimal
    assignment, and score per-topic stability.

    ``betas`` — one (K, V) (or (A, K, V)) beta per run, same K and V.
    ``reference`` — index of the run whose topic order defines the
    alignment.  For each run r, the Hungarian algorithm on
    :func:`topic_dissimilarity` yields ``perm[r]`` with run r's topic
    ``perm[r][i]`` matched to reference topic ``i`` (``perm[reference]``
    is the identity), minimizing total matched dissimilarity.

    Returns a dict:

    * ``"perms"``       — (R, K) int; apply as ``beta_r[perm[r]]`` to
      re-order run r into the reference topic order;
    * ``"matched"``     — (R, K) matched dissimilarity per (run,
      reference topic); row ``reference`` is zero;
    * ``"stability"``   — (K,) mean matched dissimilarity over the
      other runs (0 = the topic reappears exactly in every restart);
    * ``"run_distance"``— (R,) mean matched dissimilarity per run (the
      multiSTM-style distance of each run from the reference);
    * ``"metric"``, ``"reference"``.
    """
    from scipy.optimize import linear_sum_assignment

    R = len(betas)
    if R < 2:
        raise ValueError("align_topics needs at least two runs")
    if not (0 <= reference < R):
        raise ValueError(f"reference {reference} out of range for {R} runs")
    ref = _as_2d_beta(betas[reference])
    K = ref.shape[0]
    perms = np.tile(np.arange(K), (R, 1))
    matched = np.zeros((R, K))
    for r in range(R):
        if r == reference:
            continue
        D = topic_dissimilarity(ref, betas[r], metric=metric)
        if D.shape[1] != K:
            raise ValueError(f"run {r} has K={D.shape[1]}, reference has {K}")
        rows, cols = linear_sum_assignment(D)
        perms[r] = cols[np.argsort(rows)]
        matched[r] = D[np.arange(K), perms[r]]
    others = [r for r in range(R) if r != reference]
    return {
        "perms": perms,
        "matched": matched,
        "stability": matched[others].mean(axis=0),
        "run_distance": matched.mean(axis=1),
        "metric": metric,
        "reference": reference,
    }


def align_models(models: Sequence, reference: int = 0, metric: str = "js"):
    """:func:`align_topics` over fitted :class:`STM` instances (e.g.
    ``select_model(...)["models"]``)."""
    return align_topics([m.beta for m in models], reference=reference,
                        metric=metric)


def plot_alignment(
    alignment: dict,
    run_labels: Optional[Sequence[str]] = None,
    path: Optional[str] = None,
):
    """Stability heatmap: runs x reference topics, color = matched
    dissimilarity (the multiSTM stability view).  Topics sorted most-
    stable first."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    matched = np.asarray(alignment["matched"])
    R, K = matched.shape
    order = np.argsort(alignment["stability"], kind="stable")
    fig, ax = plt.subplots(figsize=(0.45 * K + 2.5, 0.4 * R + 1.8))
    im = ax.imshow(matched[:, order], aspect="auto", cmap="magma_r")
    ax.set_xticks(range(K), [str(k) for k in order], fontsize=7)
    ax.set_yticks(range(R), run_labels or [f"run {r}" for r in range(R)],
                  fontsize=8)
    ax.set_xlabel("reference topic (sorted most stable first)")
    fig.colorbar(im, ax=ax, label=f'matched {alignment["metric"]} '
                 "dissimilarity")
    ax.set_title("topic stability across restarts")
    fig.tight_layout()
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig
