"""Document-completion heldout likelihood and corpus splitting (twin of
``strutopy_tpu/eval/heldout.py``).

The float64 numpy :func:`eval_heldout` is the parity anchor; the torch
version is the batched variant that runs on the device of its tensors.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from strutopy_tpu_torch.corpus.bow import PaddedCorpus, to_bow
from strutopy_tpu_torch.utils.precision import true_float32


def eval_heldout(heldout, theta, beta) -> float:
    """Mean per-document, count-weighted log p(w | theta_d, beta).

    Per document, sum_v c_v * log(theta_d @ beta[:, v]) / sum_v c_v, then
    the mean over documents.  float64 on the host for parity.
    """
    theta = np.asarray(theta, np.float64)
    beta = np.asarray(beta, np.float64)
    if isinstance(heldout, PaddedCorpus):
        heldout = to_bow(heldout)
    doc_ll = []
    for i, doc in enumerate(heldout):
        if len(doc) == 0:
            continue
        ids = np.asarray([w for w, _ in doc], dtype=np.int64)
        cts = np.asarray([c for _, c in doc], dtype=np.float64)
        p = theta[i] @ beta[:, ids]
        with np.errstate(divide="ignore"):
            word_ll = cts * np.log(p)
        doc_ll.append(np.sum(word_ll) / np.sum(cts))
    return float(np.mean(doc_ll))


@true_float32
def eval_heldout_torch(words, counts, doc_ok, theta, beta, *, device="cuda"):
    """Batched heldout likelihood on ``device`` (twin of
    ``eval_heldout_jax``); returns a scalar tensor.

    words/counts: (N, L) padded heldout halves; theta (N, K) from the
    completion fit; beta (K, V) from the full fit.  Arrays or tensors;
    float32 on the device.

    Word ids are validated against beta's vocabulary on the host first:
    an out-of-range id means the heldout set was encoded with another
    vocabulary, and the numpy anchor (:func:`eval_heldout`) raises on the
    same input.
    """
    V = beta.shape[-1]
    wh = words.cpu().numpy() if torch.is_tensor(words) else np.asarray(words)
    ch = counts.cpu().numpy() if torch.is_tensor(counts) else np.asarray(counts)
    live = ch > 0
    max_id = int(wh[live].max()) if live.any() else -1
    if max_id >= V:
        raise ValueError(
            f"heldout contains word id {max_id} but beta has only {V} "
            "terms — encoded with a different vocabulary?"
        )
    dev = torch.device(device)

    def T(x, dt=torch.float32):
        return torch.as_tensor(x, device=dev).to(dt)

    words, counts, doc_ok = T(words, torch.int64), T(counts), T(doc_ok, torch.bool)
    theta, beta = T(theta), T(beta)
    N, L = words.shape
    K = beta.shape[0]
    # (K, N, L) gather -> p[n, l] = sum_k theta[n, k] beta[k, w[n, l]]
    bd = torch.index_select(beta, 1, words.reshape(-1)).reshape(K, N, L)
    p = torch.einsum("nk,knl->nl", theta, bd)
    mask = counts > 0
    logp = torch.where(mask, torch.log(torch.clamp_min(p, 1e-35)), 0.0)
    doc_tot = torch.sum(counts * logp, dim=1)
    doc_n = torch.clamp_min(torch.sum(counts, dim=1), 1e-30)
    per_doc = doc_tot / doc_n
    w = doc_ok.to(per_doc.dtype)
    return torch.sum(per_doc * w) / torch.clamp_min(torch.sum(w), 1.0)


def cut_in_half(doc_set):
    """Even/odd unique-term split of each document."""
    if isinstance(doc_set, PaddedCorpus):
        doc_set = to_bow(doc_set)
    first, second = [], []
    for doc in doc_set:
        first.append(list(doc[0::2]))
        second.append(list(doc[1::2]))
    return first, second


def split_corpus(
    documents: Sequence,
    proportion: float = 0.8,
    validation_set: bool = False,
    document_completion: bool = True,
):
    """Sequential train/test(/validate) split + document-completion halves.

    Mirrors ``CorpusCreation.split_corpus``: returns a dict with
    train/test (and test_1/test_2, validate).
    """
    if isinstance(documents, PaddedCorpus):
        documents = to_bow(documents)
    documents = list(documents)
    n = len(documents)
    test_idx = int(proportion * n)
    out = {"train": documents[:test_idx]}
    if validation_set:
        val_idx = int((proportion + (1 - proportion) / 2) * n)
        out["test"] = documents[test_idx:val_idx]
        out["validate"] = documents[val_idx:]
    else:
        out["test"] = documents[test_idx:]
    if document_completion:
        out["test_1"], out["test_2"] = cut_in_half(out["test"])
    return out
