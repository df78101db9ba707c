"""Spectral (anchor-word) initialization, Arora et al. 2013 (twin of
``strutopy_tpu/ops/spectral.py``).

  * the Gram matrix Q = H~ᵀ H~ - diag(H^) is accumulated as chunked dense
    (B, V') matmuls over document chunks;
  * the greedy anchor search runs K steps over the dense Q with a mask
    vector instead of in-place basis zeroing;
  * RecoverL2 is a batched non-negative least squares: for every word,
    ``min_{z>=0} 0.5 zᵀ M Mᵀ z - (M q_i)ᵀ z`` with M the anchor rows,
    solved for all V' words at once by projected gradient (FISTA).

Every product is a true float32 ``torch.matmul`` (the package turns TF32
off at import).  Nothing here synchronizes with the host: the loops are
host loops of launches.

Over a 1-D document mesh the Gram scan shards: each rank scans its rows
and the (V', V') sums are all-reduced once (:func:`_gram_scan_sharded`);
the anchors and the recovery run replicated.

The final re-expanded beta is row-normalized per topic.  Q is
unnormalized by default (``gram_norm="none"``), as in the JAX package.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from strutopy_tpu_torch.corpus.bow import PaddedCorpus, pad_corpus
from strutopy_tpu_torch.parallel.mesh import all_sum, doc_axis
from strutopy_tpu_torch.utils.precision import true_float32

logger = logging.getLogger(__name__)


def _gram_accum(words, counts, n_chunks: int, Vp: int):
    """Sums of the Gram statistics over documents, chunk by chunk.

    Returns (sum_d outer(h~_d, h~_d), sum_d dtm_d / div_d).
    """
    N, L = words.shape
    B = N // n_chunks
    Q = torch.zeros(Vp, Vp, dtype=counts.dtype, device=counts.device)
    hhat = torch.zeros(Vp, dtype=counts.dtype, device=counts.device)
    for i in range(n_chunks):
        w = words[i * B:(i + 1) * B].long()
        c = counts[i * B:(i + 1) * B]
        nd = torch.sum(c, dim=1)  # (B,)
        div = nd * (nd - 1.0)
        inv_div = torch.where(div > 0, 1.0 / torch.clamp_min(div, 1e-30), 0.0)
        # a scatter-ADD: padding slots all point at word 0 (count 0), and
        # a plain indexed assignment would keep only one of them
        rows = torch.zeros(B, Vp, dtype=c.dtype, device=c.device).scatter_add_(1, w, c)
        htilde = rows * torch.sqrt(inv_div)[:, None]
        Q = Q + htilde.T @ htilde
        hhat = hhat + torch.sum(rows * inv_div[:, None], dim=0)
    return Q, hhat


def _gram_finish(Q, hhat, norm: str = "none"):
    """Subtract the diagonal correction and (optionally) normalize rows.

    ``norm="none"`` returns the raw Gram (the default); ``"l1"`` divides
    rows by their sums (the conditional-distribution semantics of Arora
    et al.); ``"l2"`` by their Euclidean norms.  Returns (Q, row sums of
    the unnormalized Q).
    """
    Q = Q - torch.diag(hhat)
    row_sums = torch.sum(Q, dim=1, keepdim=True)
    if norm == "l1":
        Q = Q / torch.clamp_min(row_sums, 1e-30)
    elif norm == "l2":
        Q = Q / torch.clamp_min(
            torch.sqrt(torch.sum(Q * Q, dim=1, keepdim=True)), 1e-30)
    return Q, row_sums[:, 0]


def _gram_scan(words, counts, n_chunks: int, Vp: int, norm: str = "none"):
    """Q = sum_d outer(h_d, h_d) - diag(sum_d dtm_d / div_d), chunked.

    words/counts: (N, L) already remapped to the filtered vocabulary
    (dropped terms have count 0); documents with < 2 tokens must have
    all-zero counts.
    """
    return _gram_finish(*_gram_accum(words, counts, n_chunks, Vp), norm=norm)


def _gram_scan_sharded(mesh, words_f, counts_f, B: int, Vp: int, norm: str = "none",
                       dtype=torch.float32, *, device="cuda"):
    """The Gram matrix over a document mesh: the host arrays are padded
    to a multiple of mesh size x ``B`` rows (zero counts add nothing),
    each rank scans its shard on ``device`` with the counts in ``dtype``
    (as :func:`spectral_init` casts them unsharded) and the (Vp, Vp) ``Q`` and
    ``hhat`` sums are all-reduced once over the docs axis; the
    normalization runs replicated.  Only this rank's rows go to the
    device."""
    ax = doc_axis(mesh)
    N = words_f.shape[0]
    gran = ax.size * B
    N_pad = -(-N // gran) * gran
    if N_pad != N:
        words_f = np.pad(words_f, ((0, N_pad - N), (0, 0)))
        counts_f = np.pad(counts_f, ((0, N_pad - N), (0, 0)))
    n_local = N_pad // ax.size
    rows = slice(ax.rank * n_local, (ax.rank + 1) * n_local)
    Q, hhat = _gram_accum(torch.as_tensor(words_f[rows], device=device),
                          torch.as_tensor(counts_f[rows], device=device).to(dtype),
                          n_local // B, Vp)
    return _gram_finish(all_sum(Q, ax), all_sum(hhat, ax), norm=norm)


def anchor_rss(Q, used):
    """The score of every candidate row at one anchor step: the squared
    column norms of the projected Q, zero where a row is already used."""
    return torch.sum(Q * Q, dim=0) * (1.0 - used)


def anchor_step(Q, used, maxind, rss):
    """Take row ``maxind`` (a 0-d int64 tensor) as the next anchor:
    normalize it by its score in ``rss`` (this step's
    :func:`anchor_rss`), mark it used and project it out of every unused
    row.  ``Q`` and ``used`` change in place."""
    sel = maxind.reshape(1)
    rss_max = torch.clamp_min(rss.index_select(0, sel), 1e-30)
    q_row = Q.index_select(0, sel)[0] / torch.sqrt(rss_max)
    Q.index_copy_(0, sel, q_row[None])
    inner = Q @ q_row  # (Vp,)
    used.index_fill_(0, sel, 1.0)
    # subtract the projection, keeping every chosen basis row (the
    # current one included) intact
    Q -= (inner * (1.0 - used))[:, None] * q_row[None, :]


def fast_anchor(Q, K: int):
    """Greedy anchor selection -> (K,) int32 row indices, in the order
    chosen.  ``torch.argmax`` returns the first maximum, as ``jnp.argmax``
    does, so an exact tie in the scores goes to the lower row in both
    packages."""
    Q = Q.clone()
    Vp = Q.shape[0]
    used = torch.zeros(Vp, dtype=Q.dtype, device=Q.device)
    basis = []
    for _ in range(K):
        rss = anchor_rss(Q, used)
        maxind = torch.argmax(rss)
        anchor_step(Q, used, maxind, rss)
        basis.append(maxind)
    return torch.stack(basis).to(torch.int32)


def recover_l2(Q, anchor, wprob, iters: int = 500):
    """Batched NNLS recovery of p(w|z) -> (K, Vp).

    For every word i: z_i = argmin_{z>=0} ||Mᵀ z - Q_i||² with
    M = Q[anchor] (K, Vp); anchors get one-hot rows; then Bayes-invert
    p(z|w) -> p(w|z) with the empirical word probabilities.
    """
    K = anchor.shape[0]
    anchor = anchor.long()
    M = Q.index_select(0, anchor)  # (K, Vp)
    P = M @ M.T  # (K, K)
    Qt = M @ Q.T  # (K, Vp): column i is M @ Q_i

    # Lipschitz constant by power iteration
    v = torch.ones(K, dtype=Q.dtype, device=Q.device) / np.sqrt(K)
    for _ in range(64):
        v = P @ v
        v = v / torch.clamp_min(torch.linalg.norm(v), 1e-30)
    lam = torch.clamp_min(torch.dot(v, P @ v), 1e-30)
    step = 1.0 / lam

    Z = torch.zeros_like(Qt)
    Y = Z
    t = torch.ones((), dtype=Q.dtype, device=Q.device)
    for _ in range(iters):
        G = P @ Y - Qt  # (K, Vp)
        Z_new = torch.clamp_min(Y - step * G, 0.0)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        Y = Z_new + ((t - 1.0) / t_new) * (Z_new - Z)
        Z, t = Z_new, t_new

    # anchors: one-hot p(z|w)
    Z = Z.index_copy(1, anchor, torch.eye(K, dtype=Q.dtype, device=Q.device))

    A = Z.T * wprob[:, None]  # (Vp, K) = p(z|w) p(w)
    A = A / torch.clamp_min(torch.sum(A, dim=0, keepdim=True), 1e-30)
    return A.T  # (K, Vp) = p(w | z)


def filter_corpus(corpus: PaddedCorpus, V: int, maxV: int, chunk: int = 1024,
                  verbose: bool = False):
    """Host-side preparation of the Gram inputs -> (words_f, counts_f,
    keep, wprob, n_chunks).

    Keeps the ``maxV`` most frequent terms (ids remapped, the rest
    dropped), zeroes documents with fewer than two surviving tokens, and
    pads the document axis to ``n_chunks`` chunks of ``min(chunk, N)``.
    """
    wcounts = corpus.word_counts()
    wprob = wcounts / max(wcounts.sum(), 1e-300)
    keep = np.argsort(-wprob)[: min(maxV, V)]
    Vp = len(keep)

    lookup = np.full(V, -1, np.int64)
    lookup[keep] = np.arange(Vp)
    words_f = lookup[np.minimum(corpus.words, V - 1)]
    counts_f = np.where(words_f >= 0, corpus.counts, 0.0).astype(np.float32)
    words_f = np.maximum(words_f, 0).astype(np.int32)

    nd = counts_f.sum(axis=1)
    ok = nd >= 2
    if verbose and (~ok).sum():
        logger.info("spectral_init: dropping %d short documents", int((~ok).sum()))
    counts_f = counts_f * ok[:, None]

    N = words_f.shape[0]
    B = min(chunk, N)
    n_chunks = -(-N // B)
    N_pad = n_chunks * B
    if N_pad != N:
        words_f = np.pad(words_f, ((0, N_pad - N), (0, 0)))
        counts_f = np.pad(counts_f, ((0, N_pad - N), (0, 0)))
    return words_f, counts_f, keep, wprob, n_chunks


def expand_beta(beta_p, keep, K: int, V: int) -> np.ndarray:
    """Re-expand the recovered (K, Vp) rows to the full vocabulary in
    float64, with a ``0.001/V`` pseudocount, rows on the simplex."""
    beta = np.zeros((K, V))
    beta[:, keep] = np.asarray(beta_p, np.float64)
    beta = beta + 0.001 / V
    return beta / beta.sum(axis=1, keepdims=True)


@true_float32
def spectral_init(
    corpus,
    K: int,
    V: int | None = None,
    maxV: int = 5000,
    verbose: bool = False,
    dtype=torch.float32,
    mesh=None,
    gram_norm: str = "none",
    *,
    device="cuda",
) -> np.ndarray:
    """Deterministic anchor-word beta initialization (K, V), float64.

    Accepts BoW lists or a :class:`PaddedCorpus`: top-``maxV`` frequency
    filter, Gram matrix, greedy anchors, L2 recovery, re-expansion with a
    ``0.001/V`` pseudocount.  The three device stages run on ``device``.

    ``mesh``: a 1-D document mesh to shard the Gram scan over (every
    rank calls with the whole corpus; see :func:`_gram_scan_sharded`).
    ``gram_norm``: row normalization of Q — ``"none"`` (default),
    ``"l1"`` or ``"l2"``; see :func:`_gram_finish`.
    """
    if not isinstance(corpus, PaddedCorpus):
        corpus = pad_corpus(corpus, V=V)
    V = corpus.V if V is None else V
    dev = torch.device(device)

    words_f, counts_f, keep, wprob, n_chunks = filter_corpus(corpus, V, maxV, verbose=verbose)
    Vp = len(keep)
    if mesh is not None:
        Q, _row_sums = _gram_scan_sharded(mesh, words_f, counts_f,
                                          words_f.shape[0] // n_chunks, Vp, norm=gram_norm,
                                          dtype=dtype, device=dev)
    else:
        Q, _row_sums = _gram_scan(
            torch.as_tensor(words_f, device=dev),
            torch.as_tensor(counts_f, device=dev).to(dtype), n_chunks, Vp, norm=gram_norm)
    if verbose:
        logger.info("spectral_init: gram done, finding %d anchors", K)
    anchor = fast_anchor(Q, K)
    beta_p = recover_l2(Q, anchor, torch.as_tensor(wprob[keep], device=dev).to(dtype))
    return expand_beta(beta_p.cpu().numpy(), keep, K, V)
