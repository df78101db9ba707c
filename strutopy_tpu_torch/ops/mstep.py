"""M-step: global parameter updates from the E-step's sufficient
statistics (twin of ``strutopy_tpu/ops/mstep.py:37-348``, LDA-beta path),
and the serving-time covariate encoder.

Every update works on small dense moments (Dᵀeta, DᵀD, the residual
moment, beta_ss, sigma_ss), so the M-step is a handful of (K|P)-sized
linear-algebra ops on the device of the statistics.  The design's
normal-equation operators are computed once on the host in float64
(:func:`make_prevalence_design`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class PrevalenceDesign(NamedTuple):
    """Static design statistics for the prevalence regression.

    The (N, P) design matrix itself is per-document data
    (``CorpusData.D``): it holds the intercept column (if fitted) and
    all-zero rows for padding documents.
    """

    DtD: torch.Tensor  # (P, P)
    pen_mask: torch.Tensor  # (P,) 1.0 where penalized (0.0 on the intercept)
    n_docs: torch.Tensor  # scalar: number of real documents
    # float64 host solves of the normal equations
    pinv_ols: torch.Tensor  # (P, P) = pinv(DtD)
    inv_ridge: torch.Tensor  # (P, P) = inv(DtD + a diag(pen))
    built_ridge_alpha: float  # the alpha in inv_ridge


class EtaMoments(NamedTuple):
    Dt_eta: torch.Tensor  # (P, K-1)
    eta_sum: torch.Tensor  # (K-1,)


def build_design(
    X: Optional[np.ndarray],
    doc_ok: np.ndarray,
    fit_intercept: bool = True,
    one_hot_threshold: bool = True,
) -> np.ndarray:
    """Host-side design matrix (numpy copy of the JAX ``build_design``).

    Non-binary 1-D covariates with at most 32 levels are one-hot
    encoded; an intercept column is prepended; padding rows are zeroed.
    """
    N = len(doc_ok)
    cols = []
    if X is not None:
        X = np.asarray(X)
        if X.ndim == 1:
            X = X[:, None]
        if X.ndim > 2:
            X = X.reshape(X.shape[0], -1)
        X = X.astype(np.float64)
        is_binary = np.all((X == 0) | (X == 1))
        if not is_binary and one_hot_threshold and X.shape[1] == 1:
            # levels from REAL documents only: padding rows are zero-filled
            real = doc_ok.astype(bool)
            levels = np.unique(X[real, 0]) if real.any() else np.unique(X[:, 0])
            if 0 < len(levels) <= 32:
                X = (X[:, :1] == levels[None, :]).astype(np.float64)
        cols.append(X)
    if fit_intercept or not cols:
        cols.insert(0, np.ones((N, 1)))
    D = np.concatenate(cols, axis=1)
    D = D * doc_ok[:, None].astype(np.float64)
    return D


def encode_new_covariates(
    X_new: np.ndarray,
    X_train: Optional[np.ndarray],
    doc_ok_train: np.ndarray,
) -> Optional[np.ndarray]:
    """Encode NEW documents' covariates as :func:`build_design` encoded
    the training X (numpy copy of the JAX ``encode_new_covariates``), or
    None when training used no one-hot encoding (binary, numeric or
    multi-column X passes through unchanged).

    A model fit on a 1-D categorical covariate has one gamma column per
    training level; levels inferred from the new batch alone would
    misalign them whenever a level is absent from it.
    """
    if X_train is None:
        return None
    Xt = np.asarray(X_train, np.float64)
    if Xt.ndim == 1:
        Xt = Xt[:, None]
    if Xt.ndim > 2:
        Xt = Xt.reshape(Xt.shape[0], -1)
    if Xt.shape[1] != 1 or np.all((Xt == 0) | (Xt == 1)):
        return None  # build_design passed it through unencoded
    real = np.asarray(doc_ok_train, bool)
    levels = np.unique(Xt[real, 0]) if real.any() else np.unique(Xt[:, 0])
    if not (0 < len(levels) <= 32):
        return None  # too many levels: build_design kept it numeric
    Xn = np.asarray(X_new, np.float64)
    if Xn.ndim == 1:
        Xn = Xn[:, None]
    if Xn.shape[1] == len(levels):
        return Xn  # the caller passed the one-hot encoding already
    if Xn.shape[1] != 1:
        raise ValueError(
            f"the model was fit on a 1-column categorical covariate "
            f"({len(levels)} levels); pass new X as the raw 1-column "
            f"values or as the {len(levels)}-column one-hot encoding, "
            f"got {Xn.shape[1]} columns"
        )
    unseen = ~np.isin(Xn[:, 0], levels)
    if unseen.any():
        raise ValueError(
            f"new documents carry covariate value(s) "
            f"{np.unique(Xn[unseen, 0]).tolist()} not among the training "
            f"levels {levels.tolist()}; the fitted gamma has no "
            "coefficient for them"
        )
    return (Xn[:, :1] == levels[None, :]).astype(np.float64)


def make_prevalence_design(
    X: Optional[np.ndarray],
    doc_ok: np.ndarray,
    fit_intercept: bool = True,
    ridge_alpha: float = 0.1,
    device="cpu",
):
    """Returns (D (N, P) float32 numpy, PrevalenceDesign on ``device``).

    The OLS pseudoinverse and the ridge inverse of the normal equations
    are computed here in float64 (rcond matched to the float32 moments,
    as in the JAX twin).
    """
    D = build_design(X, doc_ok, fit_intercept=fit_intercept)
    P = D.shape[1]
    pen = np.ones(P)
    if fit_intercept or X is None:
        pen[0] = 0.0
    DtD = D.T @ D

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    design = PrevalenceDesign(
        DtD=dev(DtD),
        pen_mask=dev(pen),
        n_docs=dev(float(doc_ok.sum())),
        pinv_ols=dev(np.linalg.pinv(DtD, rcond=1e-7)),
        inv_ridge=dev(np.linalg.inv(DtD + ridge_alpha * np.diag(pen))),
        built_ridge_alpha=float(ridge_alpha),
    )
    return D.astype(np.float32), design


def eta_moments(D: torch.Tensor, eta: torch.Tensor) -> EtaMoments:
    """Moment statistics of eta for the prevalence regression."""
    return EtaMoments(Dt_eta=D.T @ eta, eta_sum=torch.sum(eta, dim=0))


# ---------------------------------------------------------------------------
# prevalence regression (gamma, mu)
# ---------------------------------------------------------------------------


def _fista_lasso(DtD, Dty, pen_mask, n, alpha, iters: int = 600):
    """FISTA for the sklearn Lasso objective on normal-equation moments:
    (1/(2n))||y - D w||² + alpha ||w_pen||₁, jointly over targets.

    DtD (P, P); Dty (P, T); returns W (P, T).
    """
    P, T = Dty.shape
    # Lipschitz constant of the smooth part: lambda_max(DtD)/n by power iteration
    v = torch.ones(P, dtype=DtD.dtype, device=DtD.device) / np.sqrt(P)
    for _ in range(64):
        v = DtD @ v
        v = v / torch.clamp_min(torch.linalg.norm(v), 1e-30)
    lam_max = torch.dot(v, DtD @ v)
    Lc = torch.clamp_min(lam_max / n, 1e-12)
    step = 1.0 / Lc
    thresh = step * alpha * pen_mask[:, None]

    w = torch.zeros(P, T, dtype=DtD.dtype, device=DtD.device)
    z = w
    t = torch.ones((), dtype=DtD.dtype, device=DtD.device)
    for _ in range(iters):
        grad = (DtD @ z - Dty) / n
        w_new = z - step * grad
        w_new = torch.sign(w_new) * torch.clamp_min(torch.abs(w_new) - thresh, 0.0)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        z = w_new + ((t - 1.0) / t_new) * (w_new - w)
        w, t = w_new, t_new
    return w


def update_prevalence(
    moments: EtaMoments,
    design: PrevalenceDesign,
    model_type: str,
    mode: str,
    ridge_alpha: float = 0.1,
    lasso_alpha: float = 1.0,
):
    """Solve for gamma; returns (gamma (K-1, P), mu_mean or None).

    CTM: mu is the column mean of eta.  STM: regression of eta on the
    design by OLS, ridge or lasso.
    """
    if model_type == "CTM":
        P = design.DtD.shape[0]
        Km1 = moments.eta_sum.shape[0]
        gamma = torch.zeros(Km1, P, dtype=design.DtD.dtype, device=design.DtD.device)
        mu_mean = moments.eta_sum / torch.clamp_min(design.n_docs, 1.0)
        return gamma, mu_mean

    if mode == "ols":
        gammaT = design.pinv_ols @ moments.Dt_eta
    elif mode == "ridge":
        if design.built_ridge_alpha == ridge_alpha:
            gammaT = design.inv_ridge @ moments.Dt_eta
        else:
            A = design.DtD + ridge_alpha * torch.diag(design.pen_mask)
            gammaT = torch.linalg.solve(A, moments.Dt_eta)
    elif mode == "lasso":
        gammaT = _fista_lasso(
            design.DtD,
            moments.Dt_eta,
            design.pen_mask,
            torch.clamp_min(design.n_docs, 1.0),
            lasso_alpha,
        )
    else:
        raise ValueError(f"unknown prevalence mode {mode}")
    return gammaT.T, None


def compute_mu(D, gamma, mu_mean, doc_ok, model_type: str):
    """Per-document mu (zero rows for padding documents)."""
    if model_type == "CTM":
        mu = mu_mean[None, :].expand(D.shape[0], mu_mean.shape[0])
        return mu * doc_ok[:, None].to(mu.dtype)
    return D @ gamma.T


# ---------------------------------------------------------------------------
# sigma and beta
# ---------------------------------------------------------------------------


def residual_moment(eta: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """(eta - mu)ᵀ(eta - mu), from the residuals directly (a moment
    expansion cancels catastrophically in float32)."""
    r = eta - mu
    return r.T @ r


def update_sigma(resid, sigma_ss, n_docs, sigma_prior: float):
    """sigma = ((eta-mu)ᵀ(eta-mu) + Σ nu) / N with diagonal shrinkage."""
    n = torch.clamp_min(n_docs, 1.0)
    sigma = (resid + sigma_ss) / n
    sigma = 0.5 * (sigma + sigma.T)
    return torch.diag(torch.diagonal(sigma)) * sigma_prior + (1.0 - sigma_prior) * sigma


def update_beta_lda(beta_ss, smoothing: float = 0.0):
    """Row-normalize the phi statistics (reference update_beta), after an
    optional pseudocount per (topic, word) cell."""
    if smoothing and smoothing > 0.0:
        beta_ss = beta_ss + smoothing
    row_sums = torch.sum(beta_ss, dim=-1, keepdim=True)
    return torch.where(row_sums > 0, beta_ss / torch.clamp_min(row_sums, 1e-30), 0.0)
