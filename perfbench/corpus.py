"""Inputs made from ``--seed``: the corpus a configuration fits and its
initial beta.  The generator reads the sizes of a configuration file
(its top level and its ``corpus`` block).  Nothing here imports the
program.

* ``stm_bench``: the synthetic STM-DGP recipe of the repository's
  ``bench_torch.py::make_corpus`` (itself ``bench.py``'s), frozen here
  bit for bit: beta rows ~ Dirichlet(0.05), eta ~ N(0, I) over K-1
  coordinates, a binary covariate that moves no topic, and one
  multinomial draw of a fixed length a document.  Every seed makes the
  same amount of work.
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """numpy's generator for ``seed`` (any whole number: negative ones
    wrap into [0, 2**64)); stream 0 is ``default_rng(seed)`` itself."""
    s = int(seed) % (1 << 64)
    return np.random.default_rng(s if stream == 0 else [s, stream])


def bench_corpus(K: int, V: int, N: int, n_words: int, seed: int = 0):
    """The frozen copy of ``bench_torch.make_corpus``: (docs, X,
    beta_true), the same documents and X bit for bit for the same seed."""
    rng = rng_for(seed)
    beta_true = rng.dirichlet(np.full(V, 0.05), size=K)
    eta_true = rng.normal(0.0, 1.0, (N, K - 1))
    eta_full = np.concatenate([eta_true, np.zeros((N, 1))], axis=1)
    theta = np.exp(eta_full - eta_full.max(axis=1, keepdims=True))
    theta /= theta.sum(axis=1, keepdims=True)
    X = rng.integers(0, 2, N).astype(np.float64)
    p = theta @ beta_true
    docs = []
    for d in range(N):
        draw = rng.multinomial(n_words, p[d])
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    return docs, X, beta_true


def sizes(config: dict, toy: bool) -> dict:
    """The configuration's sizes: its top level, or its ``toy`` block
    (the CPU rehearsal's) laid over it."""
    out = {k: config[k] for k in ("K", "V", "N", "doc_tokens") if k in config}
    if toy:
        out.update({k: v for k, v in config["toy"].items() if k in out})
    return out


def fit_corpus(config: dict, seed: int, toy: bool = False):
    """(docs, X) of the configuration's training corpus."""
    s = sizes(config, toy)
    dgp = config["corpus"]["dgp"]
    if dgp != "stm_bench":
        raise ValueError(f"unknown corpus dgp {dgp!r}")
    docs, X, _beta = bench_corpus(s["K"], s["V"], s["N"], s["doc_tokens"], seed)
    return docs, X


def random_beta(K: int, V: int, seed: int) -> np.ndarray:
    """The benchmark's random initial beta: rows of Gamma(0.1, 1) draws
    normalized to the simplex (the random init the program would draw),
    from the seed's own stream."""
    g = rng_for(seed, 1).gamma(0.1, 1.0, (K, V))
    return g / np.maximum(g.sum(axis=1, keepdims=True), 1e-300)
