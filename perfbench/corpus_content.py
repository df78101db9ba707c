"""The content DGP: a corpus whose word use depends on an aspect, made from
``--seed`` at a configuration's sizes (its top level, its ``corpus``
block and, in the rehearsal, its ``toy`` block).  Nothing here imports
the program.

The recipe is the content STM's own generative model (Roberts, Stewart
& Tingley 2019, J. Stat. Softw. 91(2), section 3.4), the SAGE-style
log-linear beta that the program's kappa regression fits:

* ``m``: a Zipf log-frequency, m_v = log(p_v), p_v proportional to
  (v + 1)^-s;
* ``kappa_topic`` (K, V), ``kappa_aspect`` (A, V), ``kappa_int`` (A, K,
  V): sparse Laplace deviations (each entry non-zero with its density,
  then Laplace(0, scale));
* beta[a, k] = softmax_v(m + kappa_topic[k] + kappa_aspect[a] +
  kappa_int[a, k]);
* a binary ``rating`` (the aspect) and a ``day`` uniform on 1..days; the
  prevalence design D = [1, rating, bs(day, df)] (R's ``splines::bs``,
  the engine of stm's ``s()``);
* eta ~ N(D gamma, Sigma) over K-1 coordinates, theta = softmax([eta, 0]);
* document lengths lognormal(mu, sigma) with mean ``mean_tokens`` before
  clipping to [min_tokens, max_tokens], and each token a topic from
  theta and a word from that topic's beta[aspect].

Every draw comes from the seed's generator in a fixed order, so the same
seed gives the same corpus.
"""

from __future__ import annotations

import numpy as np

from perfbench.corpus import rng_for

TOKEN_BLOCK = 1 << 18  # tokens whose topics are drawn together


def sizes(config: dict, toy: bool) -> dict:
    """K, V, N, A of the configuration (the ``toy`` block laid over them
    in the rehearsal)."""
    out = {k: config[k] for k in ("K", "V", "N", "A")}
    if toy:
        out.update({k: v for k, v in config["toy"].items() if k in out})
    return out


def bspline_basis(x, df: int, degree: int = 3) -> np.ndarray:
    """R's ``splines::bs(x, df)`` without its intercept column, (N, df):
    ``df - degree`` interior knots at quantiles of x, boundary knots at
    its range repeated ``degree + 1`` times."""
    from scipy.interpolate import BSpline

    x = np.asarray(x, np.float64)
    lo, hi = x.min(), x.max()
    interior = np.quantile(x, np.linspace(0, 1, df - degree + 2)[1:-1])
    knots = np.concatenate([np.repeat(lo, degree + 1), interior, np.repeat(hi, degree + 1)])
    return BSpline.design_matrix(x, knots, degree).toarray()[:, 1:]


def sparse_laplace(rng, shape, density: float, scale: float) -> np.ndarray:
    keep = rng.random(shape) < density
    return np.where(keep, rng.laplace(0.0, scale, shape), 0.0)


def true_beta(rng, K: int, V: int, A: int, c: dict) -> np.ndarray:
    """The DGP's beta (A, K, V)."""
    p = (np.arange(V) + 1.0) ** -c["zipf_s"]
    m = np.log(p / p.sum())
    kt = sparse_laplace(rng, (K, V), *c["kappa_topic"])
    ka = sparse_laplace(rng, (A, V), *c["kappa_aspect"])
    ki = sparse_laplace(rng, (A, K, V), *c["kappa_int"])
    z = m[None, None, :] + kt[None, :, :] + ka[:, None, :] + ki
    z -= z.max(axis=-1, keepdims=True)
    beta = np.exp(z)
    return beta / beta.sum(axis=-1, keepdims=True)


def draw_documents(rng, theta, beta, aspects, lengths) -> list:
    """Every document's tokens, each a topic z ~ theta[d] and then a word ~
    beta[aspect[d], z] (inverse CDFs), counted a document: the same law as
    one multinomial draw of theta[d] @ beta[aspect[d]] a document ->
    [[(word id, count), ...], ...]."""
    A, K, V = beta.shape
    doc_of = np.repeat(np.arange(len(lengths)), lengths)
    cth = np.cumsum(theta, axis=1)
    cth[:, -1] = 1.0
    z = np.empty(len(doc_of), np.int64)
    for lo in range(0, len(doc_of), TOKEN_BLOCK):
        d = doc_of[lo:lo + TOKEN_BLOCK]
        u = rng.random(len(d))
        z[lo:lo + len(d)] = np.minimum((cth[d] <= u[:, None]).sum(axis=1), K - 1)
    row = aspects[doc_of] * K + z
    cb = np.cumsum(beta.reshape(A * K, V), axis=1)
    cb[:, -1] = 1.0
    # row r's CDF shifted into (r, r + 1]: one sorted array for every row
    flat = (cb + np.arange(A * K)[:, None]).ravel()
    w = np.searchsorted(flat, rng.random(len(doc_of)) + row, side="right") - row * V
    w = np.minimum(w, V - 1)
    keys, counts = np.unique(doc_of * V + w, return_counts=True)
    doc, word = np.divmod(keys, V)
    cut = np.searchsorted(doc, np.arange(1, len(lengths)))
    return [list(zip(ws.tolist(), cs.tolist()))
            for ws, cs in zip(np.split(word, cut), np.split(counts, cut))]


def content_corpus(config: dict, seed: int, toy: bool = False) -> dict:
    """The configuration's training corpus: ``docs`` (a list of [(word id,
    count), ...]), ``X`` (N, 1 + df): rating and the day's spline basis,
    ``aspects`` (N,) int, ``day`` (N,), ``beta`` (A, K, V), the true
    beta."""
    s = sizes(config, toy)
    K, V, N, A = s["K"], s["V"], s["N"], s["A"]
    c = config["corpus"]
    rng = rng_for(seed)
    beta = true_beta(rng, K, V, A, c)
    aspects = (rng.random(N) < c["rating_share"]).astype(np.int64)
    day = rng.integers(1, c["days"] + 1, N).astype(np.float64)
    X = np.c_[aspects.astype(np.float64), bspline_basis(day, c["spline_df"])]
    D = np.c_[np.ones(N), X]
    gamma = rng.normal(0.0, c["gamma_sd"], (D.shape[1], K - 1))
    eta = D @ gamma + rng.normal(0.0, c["eta_sd"], (N, K - 1))
    full = np.c_[eta, np.zeros(N)]
    theta = np.exp(full - full.max(axis=1, keepdims=True))
    theta /= theta.sum(axis=1, keepdims=True)
    mean = c["mean_tokens"] if not toy else config["toy"]["mean_tokens"]
    mu = np.log(mean) - 0.5 * c["length_sigma"] ** 2
    lengths = np.clip(np.rint(rng.lognormal(mu, c["length_sigma"], N)),
                      c["min_tokens"], c["max_tokens"]).astype(np.int64)
    docs = draw_documents(rng, theta, beta, aspects, lengths)
    return {"docs": docs, "X": X, "aspects": aspects, "day": day, "beta": beta}
