"""Predicting external document outcomes from topic proportions
(R-stm ``topicLasso``; absent upstream).

R-stm's ``topicLasso`` regresses a document-level outcome on the
fitted topic proportions with an L1 penalty (glmnet), optionally with
unpenalized confounder covariates, and reports the regularization path
plus the topics selected at a cross-validated penalty.  This module
implements the same protocol without glmnet/sklearn:

  * gaussian family — cyclic coordinate descent on the elastic-net-free
    lasso objective  (1/2N)·||y − Xb||² + λ·Σ_j w_j|b_j|  with
    per-coefficient penalty factors w_j (0 = unpenalized), warm starts
    down a geometric λ path from λ_max (the glmnet algorithm);
  * binomial family — proximal-gradient (FISTA) on the mean logistic
    deviance with the same penalty structure;
  * k-fold cross-validation over the path, λ_min / λ_1se selection
    (the glmnet ``cv.glmnet`` rule), and the selected-topic report.

All solvers are plain NumPy — the design here is (N, K+P) with K ≤ a
few hundred, so this is host-side analysis, not a device kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _soft(x, t):
    return np.sign(x) * np.maximum(np.abs(x) - t, 0.0)


def _cd_gaussian(X, y, lam, pen, b0, n_iter=1000, tol=1e-9):
    """Cyclic coordinate descent for (1/2N)||y - Xb||^2 + lam*sum pen_j|b_j|.
    Columns of X are assumed standardized (mean 0 handled by centering y).
    Returns b (no intercept column; intercept = mean(y) by centering)."""
    N, P = X.shape
    b = b0.copy()
    r = y - X @ b
    col_sq = np.einsum("np,np->p", X, X) / N
    for _ in range(n_iter):
        b_max = 0.0
        d_max = 0.0
        for j in range(P):
            if col_sq[j] == 0.0:
                continue
            bj_old = b[j]
            rho = (X[:, j] @ r) / N + col_sq[j] * bj_old
            bj = _soft(rho, lam * pen[j]) / col_sq[j]
            if bj != bj_old:
                r += X[:, j] * (bj_old - bj)
                b[j] = bj
            d_max = max(d_max, abs(bj - bj_old))
            b_max = max(b_max, abs(bj))
        if d_max <= tol * max(b_max, 1.0):
            break
    return b


def _fista_binomial(X, y, lam, pen, b0, c0, n_iter=2000, tol=1e-10):
    """FISTA on mean logistic deviance + lam*sum pen_j|b_j| with an
    unpenalized intercept c."""
    N = X.shape[0]
    L = 0.25 * (np.linalg.norm(X, 2) ** 2 / N + 1.0) + 1e-12  # lipschitz
    b, c = b0.copy(), float(c0)
    zb, zc, t = b.copy(), c, 1.0
    prev = np.inf
    for _ in range(n_iter):
        eta = X @ zb + zc
        p = 1.0 / (1.0 + np.exp(-eta))
        g = (p - y) / N
        gb = X.T @ g
        gc = g.sum()
        b_new = _soft(zb - gb / L, lam * pen / L)
        c_new = zc - gc / L
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        zb = b_new + ((t - 1.0) / t_new) * (b_new - b)
        zc = c_new + ((t - 1.0) / t_new) * (c_new - c)
        b, c, t = b_new, c_new, t_new
        obj = (
            np.mean(np.logaddexp(0.0, X @ b + c) - y * (X @ b + c))
            + lam * np.sum(pen * np.abs(b))
        )
        if abs(prev - obj) <= tol * max(abs(obj), 1.0):
            break
        prev = obj
    return b, c


def _deviance(family, y, eta):
    if family == "gaussian":
        return float(np.mean((y - eta) ** 2))
    p = 1.0 / (1.0 + np.exp(-eta))
    p = np.clip(p, 1e-12, 1.0 - 1e-12)
    return float(-2.0 * np.mean(y * np.log(p) + (1 - y) * np.log1p(-p)))


def topic_lasso(
    theta: np.ndarray,
    y: np.ndarray,
    covariates: Optional[np.ndarray] = None,
    family: str = "gaussian",
    nlambda: int = 50,
    lambda_min_ratio: float = 1e-3,
    nfolds: int = 10,
    seed: int = 0,
    topic_names: Optional[Sequence[str]] = None,
):
    """L1-penalized regression of an external outcome on topic
    proportions (R-stm ``topicLasso``).

    ``theta`` (N, K) document-topic proportions (penalized regressors,
    standardized internally as glmnet does); ``covariates`` (N, P) are
    optional confounders entering UNPENALIZED (glmnet penalty.factor=0)
    so topics only pick up signal the confounders cannot explain.
    ``family`` is "gaussian" (continuous y) or "binomial" (0/1 y).

    Fits the whole geometric λ path from λ_max (all topics zero) with
    warm starts, cross-validates deviance over ``nfolds`` document
    folds, and reports coefficients at both ``lambda_min`` (best mean
    CV deviance) and the more conservative ``lambda_1se`` (largest λ
    within one CV standard error — the glmnet default reporting rule,
    which R-stm's printout mirrors).

    Returns a dict with the path (``lambdas``, ``coef_path`` in
    ORIGINAL theta units, ``intercept_path``), the CV curve
    (``cv_mean``, ``cv_se``), the chosen penalties and coefficients,
    and ``selected_topics`` (nonzero topics at λ_1se, by name).
    """
    theta = np.asarray(theta, np.float64)
    y = np.asarray(y, np.float64).ravel()
    N, K = theta.shape
    if len(y) != N:
        raise ValueError(f"y has {len(y)} entries for {N} documents")
    if family not in ("gaussian", "binomial"):
        raise ValueError("family must be 'gaussian' or 'binomial'")
    if family == "binomial" and not set(np.unique(y)) <= {0.0, 1.0}:
        raise ValueError("binomial family needs a 0/1 outcome")
    if covariates is not None:
        covariates = np.asarray(covariates, np.float64)
        if covariates.ndim == 1:
            covariates = covariates[:, None]
        if len(covariates) != N:
            raise ValueError("covariates row count mismatch")
        X_raw = np.c_[covariates, theta]
        pen = np.r_[np.zeros(covariates.shape[1]), np.ones(K)]
    else:
        X_raw = theta
        pen = np.ones(K)
    P = X_raw.shape[1]
    names = (
        list(topic_names) if topic_names is not None
        else [f"topic {k}" for k in range(K)]
    )
    if len(names) != K:
        raise ValueError(f"{len(names)} topic_names for {K} topics")

    # glmnet-style standardization of the regressors
    mean = X_raw.mean(axis=0)
    scale = X_raw.std(axis=0)
    scale[scale == 0] = 1.0
    Xs = (X_raw - mean) / scale

    # lambda path: lambda_max kills every penalized coefficient
    if family == "gaussian":
        yc = y - y.mean()
        grad0 = np.abs(Xs.T @ yc) / N
    else:
        grad0 = np.abs(Xs.T @ (y - y.mean())) / N
    lam_max = float(np.max(grad0[pen > 0])) + 1e-12
    lambdas = lam_max * np.geomspace(1.0, lambda_min_ratio, nlambda)

    def fit_path(X, yy):
        """Warm-started path fit; returns (nlambda, P) coefs +
        (nlambda,) intercepts in STANDARDIZED coordinates."""
        coefs = np.zeros((nlambda, P))
        icpts = np.zeros(nlambda)
        b = np.zeros(P)
        c = float(yy.mean()) if family == "gaussian" else float(
            np.log(np.clip(yy.mean(), 1e-6, 1 - 1e-6)
                   / np.clip(1 - yy.mean(), 1e-6, 1 - 1e-6))
        )
        for i, lam in enumerate(lambdas):
            if family == "gaussian":
                b = _cd_gaussian(X, yy - yy.mean(), lam, pen, b)
                c = float(yy.mean())
            else:
                b, c = _fista_binomial(X, yy, lam, pen, b, c)
            coefs[i] = b
            icpts[i] = c
        return coefs, icpts

    coefs_s, icpts = fit_path(Xs, y)

    # k-fold CV deviance over the same lambda path.  Standardization is
    # per TRAINING fold (cv.glmnet's rule): reusing the full-data
    # mean/std would leak test-fold statistics into the fit, and a fold
    # subset of globally-centered columns is no longer mean-zero, which
    # _cd_gaussian's implicit mean(y)-intercept assumes.
    rng = np.random.default_rng(seed)
    nfolds = int(min(max(nfolds, 2), N))
    fold = rng.permutation(np.arange(N) % nfolds)
    dev = np.zeros((nfolds, nlambda))
    for f in range(nfolds):
        tr, te = fold != f, fold == f
        m_f = X_raw[tr].mean(axis=0)
        s_f = X_raw[tr].std(axis=0)
        s_f[s_f == 0] = 1.0
        cf, ic = fit_path((X_raw[tr] - m_f) / s_f, y[tr])
        Xte = (X_raw[te] - m_f) / s_f
        for i in range(nlambda):
            eta = Xte @ cf[i] + ic[i]
            dev[f, i] = _deviance(family, y[te], eta)
    cv_mean = dev.mean(axis=0)
    cv_se = dev.std(axis=0, ddof=1) / np.sqrt(nfolds)
    i_min = int(np.argmin(cv_mean))
    thresh = cv_mean[i_min] + cv_se[i_min]
    i_1se = int(np.nonzero(cv_mean <= thresh)[0][0])  # largest lambda

    # back to original units: b_orig = b_std / scale, intercept adjusts
    coef_path = coefs_s / scale[None, :]
    icpt_path = icpts - coef_path @ mean
    topic_slice = slice(P - K, P)

    def report(i):
        ctop = coef_path[i, topic_slice]
        return {
            "lambda": float(lambdas[i]),
            "intercept": float(icpt_path[i]),
            "coef": coef_path[i].copy(),
            "topic_coef": ctop.copy(),
            "selected": [names[k] for k in np.nonzero(ctop)[0]],
        }

    at_min, at_1se = report(i_min), report(i_1se)
    return {
        "family": family,
        "lambdas": lambdas,
        "coef_path": coef_path,
        "intercept_path": icpt_path,
        "topic_slice": (P - K, P),
        "topic_names": names,
        "cv_mean": cv_mean,
        "cv_se": cv_se,
        "lambda_min": at_min,
        "lambda_1se": at_1se,
        "selected_topics": at_1se["selected"],
    }


def plot_topic_lasso(result: dict, path: Optional[str] = None):
    """R-stm ``topicLasso`` figure: the topic-coefficient
    regularization path vs log(λ) with the CV-chosen penalties marked,
    plus the CV deviance curve."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lo, hi = result["topic_slice"]
    lam = np.log(result["lambdas"])
    paths = result["coef_path"][:, lo:hi]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
    cmap = plt.get_cmap("tab20")
    final = result["lambda_1se"]["topic_coef"]
    for k in range(paths.shape[1]):
        lw = 2.0 if final[k] != 0 else 0.8
        ax1.plot(lam, paths[:, k], color=cmap(k % 20), lw=lw,
                 label=result["topic_names"][k] if final[k] != 0 else None)
    for key, ls in (("lambda_min", ":"), ("lambda_1se", "--")):
        ax1.axvline(np.log(result[key]["lambda"]), color="gray", ls=ls, lw=1)
        ax2.axvline(np.log(result[key]["lambda"]), color="gray", ls=ls, lw=1)
    ax1.set_xlabel("log lambda")
    ax1.set_ylabel("topic coefficient")
    ax1.set_title("topicLasso regularization path")
    if np.any(final != 0):
        ax1.legend(fontsize=8, loc="best")
    ax2.errorbar(lam, result["cv_mean"], yerr=result["cv_se"],
                 fmt="o-", ms=3, capsize=2)
    ax2.set_xlabel("log lambda")
    ax2.set_ylabel("CV deviance")
    ax2.set_title("cross-validation curve (:: min, -- 1se)")
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig
