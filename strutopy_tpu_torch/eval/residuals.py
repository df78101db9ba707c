"""Multinomial dispersion of STM residuals (Taddy 2012).

R-stm exposes this as ``checkResiduals``: under the model, document
``d``'s counts are Multinomial(m_d, q_d) with q_d = theta_d @ beta, so
the Pearson chi-square statistic over word cells should have unit
dispersion.  Appreciable overdispersion (sigma^2 >> 1) indicates the
K topics cannot absorb the count variation — the standard "is K too
small" diagnostic.  Neither the reference (mkrcke/strutopy) nor its
README implements it; this is a beyond-reference addition feeding
:func:`strutopy_tpu_torch.pipeline.search_k`.

Convention (documented because the df choice varies across software):

- cells with expected count e_dv = m_d q_dv <= tol are EXCLUDED from
  both the statistic and the degrees of freedom (the chi-square
  normal approximation fails for near-zero expectations; this is the
  standard sparse-cell exclusion, and why the test needs a tol at all)
- chi^2_d = sum_{v: e>tol, observed} (x_dv - e_dv)^2 / e_dv
          + sum_{v: e>tol, unobserved} e_dv
  (a zero-count cell contributes (0 - e)^2 / e = e)
- per-doc degrees of freedom: #{v : e_dv > tol} - 1
- nu = sum_d df_d - (K - 1); dispersion sigma2 = sum_d chi^2_d / nu
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from strutopy_tpu_torch.corpus.bow import PaddedCorpus, to_bow


def check_residuals(
    documents,
    theta: np.ndarray,
    beta: np.ndarray,
    tol: float = 0.01,
    aspect: Optional[np.ndarray] = None,
    chunk: int = 4096,
) -> dict:
    """Multinomial dispersion test of the fitted model's residuals.

    Args:
      documents: BoW list of (word_id, count) pairs or a PaddedCorpus.
      theta: (N, K) fitted topic proportions.
      beta: (K, V) topic-word distributions, or (A, K, V) for content
        models (pass ``aspect``: (N,) int aspect index per document).
      tol: expected-count threshold below which a cell is excluded
        from the degrees of freedom.
      chunk: documents per theta @ beta block (host memory bound).

    Returns dict with ``dispersion``, ``chisq`` (total statistic),
    ``df`` (nu) and ``n_docs``.  Dispersion near 1 means the model's
    multinomial explains the count variance; >> 1 suggests raising K.
    """
    theta = np.asarray(theta, np.float64)
    beta = np.asarray(beta, np.float64)
    if isinstance(documents, PaddedCorpus):
        documents = to_bow(documents)
    documents = list(documents)
    N = len(documents)
    if theta.shape[0] != N:
        raise ValueError(f"theta has {theta.shape[0]} rows for {N} documents")
    K = theta.shape[1]
    if beta.ndim == 3:
        if aspect is None:
            raise ValueError("content-model beta (A, K, V) needs aspect=(N,) ids")
        aspect = np.asarray(aspect).ravel()
        if len(aspect) != N:
            # a short aspect array would leave np.empty rows of q
            # uninitialized — garbage statistics, no error
            raise ValueError(
                f"aspect has {len(aspect)} entries for {N} documents"
            )
        if aspect.min() < 0 or aspect.max() >= beta.shape[0]:
            raise ValueError(
                f"aspect ids must lie in [0, {beta.shape[0]}) for an "
                f"(A={beta.shape[0]}, K, V) beta"
            )
    elif aspect is not None:
        raise ValueError("aspect given but beta is not (A, K, V)")

    chisq = 0.0
    df = 0.0
    n_used = 0
    for s in range(0, N, chunk):
        docs = documents[s : s + chunk]
        th = theta[s : s + chunk]
        if beta.ndim == 3:
            # q rows per aspect group within the chunk
            q = np.empty((len(docs), beta.shape[2]), np.float64)
            for a in np.unique(aspect[s : s + chunk]):
                rows = np.where(aspect[s : s + chunk] == a)[0]
                q[rows] = th[rows] @ beta[int(a)]
        else:
            q = th @ beta  # (chunk, V)
        m = np.array([sum(c for _, c in doc) for doc in docs], np.float64)
        q *= m[:, None]  # in place: q becomes the expected counts e
        e = q  # (chunk, V); no second float64 (chunk, V) temporary
        big = e > tol
        df += float(np.count_nonzero(big)) - np.count_nonzero(m)
        n_used += int(np.count_nonzero(m))
        # all admitted cells as if unobserved: sum of e over big cells;
        # observed cells then swap their e for the Pearson term.
        # einsum iterates instead of materializing e*big — at V=70k /
        # chunk=4096 the dense temporaries here were multi-GB
        row_e_big = np.einsum("dv,dv->d", e, big)
        for i, doc in enumerate(docs):
            if not doc or m[i] == 0:
                continue
            ids = np.asarray([w for w, _ in doc], np.int64)
            cts = np.asarray([c for _, c in doc], np.float64)
            e_obs = e[i, ids]
            keep = e_obs > tol
            pearson = float(np.sum((cts[keep] - e_obs[keep]) ** 2 / e_obs[keep]))
            chisq += pearson + float(row_e_big[i] - e_obs[keep].sum())
    nu = df - (K - 1)
    if nu <= 0:
        raise ValueError(
            f"non-positive degrees of freedom ({nu}); corpus too small "
            "for the dispersion test at this tol"
        )
    return {
        "dispersion": chisq / nu,
        "chisq": chisq,
        "df": nu,
        "n_docs": n_used,
    }
