"""Float64 NumPy/SciPy oracle of the STM EM step (a copy of
``strutopy_tpu/utils/reference_numpy.py``, function for function and
operation for operation, so both give the same bits).

The port keeps its own copy because importing any module of the JAX
package imports jax, which the card's machine does not have.  It serves:
  1. the correctness oracle for tests and for ``chip_smoke.py`` phase 14
     (same math contract as the reference src/modules/stm.py, with its
     two numerical bugs fixed: the gradient's missing e^eta scaling
     (stm.py:946-958) and the elementwise-product "inverse" of sigma
     (stm.py:501) — see PARITY_NOTES.md #1, #2);
  2. the CPU baseline of the port's benchmark: the reference-equivalent
     per-document scipy BFGS E-step whose docs/sec the card's E-step is
     compared against, measured on the card machine's own CPU.

Intentionally written the way the reference is architected — a serial
python loop over documents calling scipy.optimize.minimize — so the
baseline measurement is honest.  It imports numpy and scipy only (the
content M-step's sklearn inside the function, as in the JAX copy) and is
on no fit path.
"""

from __future__ import annotations

import numpy as np
import scipy.optimize
import scipy.special


def doc_f(eta, c, beta_doc, mu, siginv):
    eta_full = np.append(eta, 0.0)
    Nd = c.sum()
    s = np.exp(eta_full) @ beta_doc
    diff = eta - mu
    return 0.5 * diff @ siginv @ diff - (
        c @ np.log(np.maximum(s, 1e-300)) - Nd * scipy.special.logsumexp(eta_full)
    )


def doc_grad(eta, c, beta_doc, mu, siginv):
    eta_full = np.append(eta, 0.0)
    Nd = c.sum()
    e = np.exp(eta_full)
    a = e[:, None] * beta_doc
    s = np.maximum(a.sum(axis=0), 1e-300)
    theta = e / e.sum()
    return siginv @ (eta - mu) + (Nd * theta - (a / s) @ c)[:-1]


def doc_hess(eta, c, beta_doc, mu, siginv):
    K = beta_doc.shape[0]
    eta_full = np.append(eta, 0.0)
    Nd = c.sum()
    e = np.exp(eta_full)
    a = e[:, None] * beta_doc
    s = np.maximum(a.sum(axis=0), 1e-300)
    phi_hat = a / s
    theta = e / e.sum()
    B = phi_hat * np.sqrt(c)
    q = phi_hat @ c
    H = B @ B.T - Nd * np.outer(theta, theta) + np.diag(Nd * theta - q)
    return H[: K - 1, : K - 1] + siginv


def make_pd(M):
    dvec = np.diagonal(M).copy()
    mag = np.abs(M).sum(axis=1) - np.abs(dvec)
    dvec = np.maximum(dvec, mag)
    out = M.copy()
    np.fill_diagonal(out, dvec)
    return out


def safe_chol(H, jitter=1e-5):
    try:
        return np.linalg.cholesky(H)
    except np.linalg.LinAlgError:
        try:
            return np.linalg.cholesky(make_pd(H))
        except np.linalg.LinAlgError:
            return np.linalg.cholesky(make_pd(H) + jitter * np.eye(H.shape[0]))


def e_step(documents, beta, mu, eta, sigma, betaindex=None, interactions=False):
    """Serial per-document E-step (the reference's architecture,
    stm.py:489-597).  documents: BoW list of [(idx, count), ...].

    Returns (beta_ss, sigma_ss, bound, eta_new, theta).
    """
    N = len(documents)
    K = beta.shape[-2]
    L_s = np.linalg.cholesky(sigma)
    sigmaentropy = np.log(np.diag(L_s)).sum()
    Linv = np.linalg.inv(L_s)
    siginv = Linv.T @ Linv

    beta_ss = np.zeros(beta.shape)
    sigma_ss = np.zeros((K - 1, K - 1))
    bound = 0.0
    eta_new = np.zeros((N, K - 1))
    theta_all = np.zeros((N, K))

    for i, doc in enumerate(documents):
        ids = np.asarray([w for w, _ in doc], np.int64)
        c = np.asarray([ct for _, ct in doc], np.float64)
        if interactions:
            beta_doc = beta[betaindex[i]][:, ids]
        else:
            beta_doc = beta[:, ids]
        res = scipy.optimize.minimize(
            doc_f,
            eta[i],
            args=(c, beta_doc, mu[i], siginv),
            jac=doc_grad,
            method="BFGS",
        )
        et = res.x
        eta_new[i] = et
        eta_full = np.append(et, 0.0)
        e = np.exp(eta_full - eta_full.max())
        theta = e / e.sum()
        theta_all[i] = theta

        H = doc_hess(et, c, beta_doc, mu[i], siginv)
        L = safe_chol(H)
        Linv_h = np.linalg.inv(L)
        nu = Linv_h.T @ Linv_h
        sigma_ss += nu

        a = np.exp(eta_full)[:, None] * beta_doc
        s = np.maximum(a.sum(axis=0), 1e-300)
        phi = a / s * c
        if interactions:
            np.add.at(beta_ss[betaindex[i]], (slice(None), ids), phi)
        else:
            np.add.at(beta_ss, (slice(None), ids), phi)

        diff = et - mu[i]
        bound += (
            c @ np.log(np.maximum(theta @ (beta_doc * np.exp(eta_full)[:, None]), 1e-300))
            - np.log(np.diag(L)).sum()
            - 0.5 * diff @ siginv @ diff
            - sigmaentropy
        )

    return beta_ss, sigma_ss, bound, eta_new, theta_all


def _ctm_mu_sigma(eta, sigma_ss, N, sigma_prior=0.0):
    """Shared CTM mu (column mean) + sigma update."""
    mu = np.tile(eta.mean(axis=0), (N, 1))
    resid = (eta - mu).T @ (eta - mu)
    sigma = (resid + sigma_ss) / N
    sigma = np.diag(np.diag(sigma)) * sigma_prior + (1 - sigma_prior) * sigma
    return mu, sigma


def m_step_ctm_lda(beta_ss, sigma_ss, eta, N, sigma_prior=0.0):
    """CTM prevalence (column-mean mu) + LDA beta row-normalization."""
    mu, sigma = _ctm_mu_sigma(eta, sigma_ss, N, sigma_prior)
    rs = beta_ss.sum(axis=-1, keepdims=True)
    beta = np.divide(beta_ss, rs, out=np.zeros_like(beta_ss), where=rs > 0)
    return beta, mu, sigma


def fit_ctm_lda(documents, V, K, n_iter=4, seed=123456):
    """Mini EM driver (CTM + LDA-beta) for oracle comparisons."""
    rng = np.random.RandomState(seed)
    g = rng.gamma(0.1, 1.0, (K, V))
    beta = g / g.sum(axis=1, keepdims=True)
    N = len(documents)
    mu = np.zeros((N, K - 1))
    eta = np.zeros((N, K - 1))
    sigma = 20.0 * np.eye(K - 1)
    bounds = []
    for _ in range(n_iter):
        beta_ss, sigma_ss, bound, eta, theta = e_step(documents, beta, mu, eta, sigma)
        beta, mu, sigma = m_step_ctm_lda(beta_ss, sigma_ss, eta, N)
        bounds.append(bound)
    return bounds, beta, theta, sigma


def m_step_stm_ols(beta_ss, sigma_ss, eta, D, sigma_prior=0.0):
    """STM prevalence: OLS of eta on the design D (with intercept col),
    then sigma and LDA-beta updates — the float64 twin of
    strutopy_tpu/ops/mstep.py's default path."""
    N = eta.shape[0]
    gammaT, *_ = np.linalg.lstsq(D, eta, rcond=None)  # (P, K-1)
    mu = D @ gammaT
    resid = (eta - mu).T @ (eta - mu)
    sigma = (resid + sigma_ss) / N
    sigma = np.diag(np.diag(sigma)) * sigma_prior + (1 - sigma_prior) * sigma
    rs = beta_ss.sum(axis=-1, keepdims=True)
    beta = np.divide(beta_ss, rs, out=np.zeros_like(beta_ss), where=rs > 0)
    return beta, mu, sigma, gammaT.T


def fit_stm_ols(documents, V, K, X, n_iter=4, seed=123456):
    """Mini EM driver (STM-OLS prevalence + LDA-beta), float64 oracle."""
    rng = np.random.RandomState(seed)
    g = rng.gamma(0.1, 1.0, (K, V))
    beta = g / g.sum(axis=1, keepdims=True)
    N = len(documents)
    X = np.asarray(X, np.float64)
    if X.ndim == 1:
        X = X[:, None]
    D = np.c_[np.ones(N), X]
    mu = np.zeros((N, K - 1))
    eta = np.zeros((N, K - 1))
    sigma = 20.0 * np.eye(K - 1)
    bounds = []
    gamma = None
    for _ in range(n_iter):
        beta_ss, sigma_ss, bound, eta, theta = e_step(documents, beta, mu, eta, sigma)
        beta, mu, sigma, gamma = m_step_stm_ols(beta_ss, sigma_ss, eta, D)
        bounds.append(bound)
    return bounds, beta, theta, sigma, gamma


def m_step_content(beta_ss, sigma_ss, eta, wcounts, kappa_design, N,
                   alpha=250.0, sigma_prior=0.0):
    """Content-model M-step oracle: CTM mu + per-word sklearn
    PoissonRegressor fits (the reference's engine, with its per-word
    column bug fixed) -> (beta (A,K,V), mu, sigma, kappa)."""
    import sklearn.linear_model

    mu, sigma = _ctm_mu_sigma(eta, sigma_ss, N, sigma_prior)

    counts = beta_ss.reshape(-1, beta_ss.shape[-1])  # ((A*K), V)
    V = counts.shape[1]
    m = np.log(np.maximum(wcounts, 1e-10)) - np.log(max(wcounts.sum(), 1e-10))
    offset = np.log(np.maximum(counts.sum(axis=1), 1e-10))
    coefs = []
    for i in range(V):
        # sklearn has no offset; absorb exp(m_i + offset) as sample
        # weights via the identity: Poisson LL with offset o equals a
        # weighted fit of y/exp(o) with weights exp(o)
        w = np.exp(m[i] + offset)
        y = counts[:, i] / w
        # sklearn normalizes the weighted deviance by sum(w), our TPU
        # objective by n rows: rescale the penalty to match
        n_rows = counts.shape[0]
        clf = sklearn.linear_model.PoissonRegressor(
            fit_intercept=False, alpha=alpha * n_rows / w.sum(),
            tol=1e-10, max_iter=20000,
        )
        clf.fit(kappa_design, y, sample_weight=w)
        coefs.append(clf.coef_)
    kappa = np.stack(coefs, axis=1)  # (P, V)
    linpred = m[None, :] + kappa_design @ kappa
    expl = np.exp(linpred - linpred.max(axis=1, keepdims=True))
    beta = expl / expl.sum(axis=1, keepdims=True)
    return beta.reshape(beta_ss.shape), mu, sigma, kappa


def fit_content(documents, V, K, A, betaindex, kappa_design, n_iter=2,
                seed=123456, alpha=250.0):
    """Mini EM driver for the content model (CTM prevalence), float64."""
    rng = np.random.RandomState(seed)
    g = rng.gamma(0.1, 1.0, (K, V))
    b0 = g / g.sum(axis=1, keepdims=True)
    beta = np.tile(b0[None], (A, 1, 1))
    N = len(documents)
    mu = np.zeros((N, K - 1))
    eta = np.zeros((N, K - 1))
    sigma = 20.0 * np.eye(K - 1)
    wcounts = np.zeros(V)
    for doc in documents:
        for w, c in doc:
            wcounts[w] += c
    bounds = []
    kappa = None
    for _ in range(n_iter):
        beta_ss, sigma_ss, bound, eta, theta = e_step(
            documents, beta, mu, eta, sigma, betaindex=betaindex,
            interactions=True,
        )
        beta, mu, sigma, kappa = m_step_content(
            beta_ss, sigma_ss, eta, wcounts, kappa_design, N, alpha=alpha
        )
        bounds.append(bound)
    return bounds, beta, kappa
