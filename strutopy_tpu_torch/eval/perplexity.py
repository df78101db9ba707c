"""Per-word perplexity of a fitted model on a corpus (numpy copy of
``strutopy_tpu/eval/perplexity.py``): perplexity = exp(-avg per-word log
likelihood) with p(w | d) = theta_d @ beta[:, w].
"""

from __future__ import annotations

import numpy as np

from strutopy_tpu_torch.corpus.bow import PaddedCorpus, to_bow


def perplexity(documents, theta: np.ndarray, beta: np.ndarray) -> float:
    """exp(- sum_d sum_v c_dv log(theta_d beta_v) / total_tokens)."""
    theta = np.asarray(theta, np.float64)
    beta = np.asarray(beta, np.float64)
    if beta.ndim == 3:
        beta = beta.mean(axis=0)
    if isinstance(documents, PaddedCorpus):
        documents = to_bow(documents)
    total_ll = 0.0
    total_tokens = 0.0
    for i, doc in enumerate(documents):
        if not doc:
            continue
        ids = np.asarray([w for w, _ in doc], np.int64)
        cts = np.asarray([c for _, c in doc], np.float64)
        p = np.maximum(theta[i] @ beta[:, ids], 1e-300)
        total_ll += float(cts @ np.log(p))
        total_tokens += float(cts.sum())
    return float(np.exp(-total_ll / max(total_tokens, 1.0)))
