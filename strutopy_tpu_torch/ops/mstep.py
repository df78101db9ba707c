"""M-step: global parameter updates from the E-step's sufficient
statistics (twin of ``strutopy_tpu/ops/mstep.py``): the prevalence
regression, sigma, the LDA beta and the content model's kappa, and the
serving-time covariate encoder.

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

from strutopy_tpu_torch.utils import trace


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
    dtype=np.float32,
    ridge_alpha: float = 0.1,
    *,
    device="cuda",
):
    """Returns (D (N, P) numpy, PrevalenceDesign on ``device``, the card
    unless the caller asks for the CPU, as every entry point).

    ``dtype`` (float32 or float64, numpy's or torch's) is that of D and
    of the design's tensors.  The OLS pseudoinverse and the ridge inverse
    of the normal equations are computed here in float64 (rcond matched
    to the float32 moments, as in the JAX twin).
    """
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty(0, dtype=dtype).numpy().dtype
    np_dtype = np.dtype(dtype)
    if np_dtype not in (np.float32, np.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype!r}")
    D = build_design(X, doc_ok, fit_intercept=fit_intercept)
    P = D.shape[1]
    pen = np.ones(P)
    if fit_intercept or X is None:
        pen[0] = 0.0
    DtD = D.T @ D

    def dev(a):
        return torch.as_tensor(np.asarray(a, np_dtype), device=device)

    design = PrevalenceDesign(
        DtD=dev(DtD),
        pen_mask=dev(pen),
        n_docs=dev(float(doc_ok.sum())),
        pinv_ols=dev(np.linalg.pinv(DtD, rcond=1e-7)),
        inv_ridge=dev(np.linalg.inv(DtD + ridge_alpha * np.diag(pen))),
        built_ridge_alpha=float(ridge_alpha),
    )
    return D.astype(np_dtype), design


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


def update_beta_lda(beta_ss, smoothing: float = 0.0, row_psum=None):
    """Row-normalize the phi statistics (reference update_beta), after an
    optional pseudocount per (topic, word) cell.

    ``row_psum`` sums the (K, 1) row sums over the vocab axis when
    beta_ss is a block of the vocabulary (the M-step's one vocab
    collective); the normalization of each cell stays local."""
    if smoothing and smoothing > 0.0:
        beta_ss = beta_ss + smoothing
    row_sums = torch.sum(beta_ss, dim=-1, keepdim=True)
    if row_psum is not None:
        row_sums = row_psum(row_sums)
    return torch.where(row_sums > 0, beta_ss / torch.clamp_min(row_sums, 1e-30), 0.0)


# ---------------------------------------------------------------------------
# content model: kappa (twin of strutopy_tpu/ops/mstep.py:351-625)
# ---------------------------------------------------------------------------


def build_kappa_design(K: int, A: int, interactions: bool) -> np.ndarray:
    """Dense covariate design for the content model, ((A*K), P).

    Rows are (aspect a, topic k) in a-major order, matching the stacked
    per-aspect beta_ss.  Columns: K topic indicators, A aspect
    indicators, and A*K interaction indicators when requested.
    """
    if A == 1:
        return np.eye(K)
    rows = A * K
    a_idx = np.repeat(np.arange(A), K)
    k_idx = np.tile(np.arange(K), A)
    P = K + A + (A * K if interactions else 0)
    X = np.zeros((rows, P))
    X[np.arange(rows), k_idx] = 1.0
    X[np.arange(rows), K + a_idx] = 1.0
    if interactions:
        X[np.arange(rows), K + A + np.arange(rows)] = 1.0
    return X


def _poisson_newton_batch(Y, m, Xd, offset, alpha, n, iters, W0,
                          tol=1e-6, lp_clip=30.0, ftol_rel=0.0):
    """Batched damped Newton for a chunk of penalized Poisson regressions.

    One word's sklearn PoissonRegressor objective (fit_intercept=False):
      (1/n) sum_r [exp(z_r) - y_r z_r] + (alpha/2)||w||²,
      z = m_v + offset + X w.
    All Vc words of the chunk solve together:
      * gradient: one (P, R) @ (R, Vc) matmul;
      * Hessians: one (Vc, R) @ (R, P·P) matmul against the row outer
        products of the design, formed once per call — (R, Vc, P, P) is
        never materialized;
      * solves: batched Cholesky (H is SPD by construction: + alpha·I);
      * line search: 6 halving steps evaluated for every word at once.
    Where no step's objective is below F (for a frequent word |F| is
    ~1e4, and its float32 rounding hides the decrease of a step while
    max|g| is still far above ``tol``), the full Newton step's decrease
    F(W + D) - F(W) is computed from the current point instead, without
    subtracting two objectives, and the step is taken where that decrease
    is below minus twice the rounding bound of its own sum.  A word that
    a step of either kind does not improve is done.
    The loop ends when every word is done (one host read an iteration) or
    after ``iters`` steps.  A done word never moves, so the result does
    not depend on which other words share its chunk.  Warm-started solves
    (W0 from the previous EM iteration) typically finish in a few steps;
    words whose warm start already meets ``tol`` skip the body.

    Y (R, Vc); m (Vc,); Xd (R, P); offset (R,); W0 (P, Vc).
    Returns (W (P, Vc), number of Newton iterations run, an int).

    While recording (``utils/trace.py``) it counts ``kappa.word_steps``
    (the words not done at each step) and ``kappa.floor_exits`` (words
    that leave with max|g| >= ``tol`` because no step improved them).
    """
    R, P = Xd.shape
    dtype, dev = Xd.dtype, Xd.device
    eps = torch.finfo(dtype).eps
    eyeP = alpha * torch.eye(P, dtype=dtype, device=dev)
    base = m[None, :] + offset[:, None]  # (R, Vc)
    ts = torch.tensor([1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125], dtype=dtype, device=dev)
    XX = (Xd[:, :, None] * Xd[:, None, :]).reshape(R, P * P)

    def obj(W):
        Z = torch.clamp(base + Xd @ W, -lp_clip, lp_clip)
        return (torch.sum(torch.exp(Z) - Y * Z, dim=0) / n
                + 0.5 * alpha * torch.sum(W * W, dim=0))  # (Vc,)

    # words whose warm start already meets tol never enter the body
    Z0 = torch.clamp(base + Xd @ W0, -lp_clip, lp_clip)
    G0 = Xd.T @ ((torch.exp(Z0) - Y) / n) + alpha * W0
    done = torch.amax(torch.abs(G0), dim=0) < tol
    W, F = W0, obj(W0)
    n_it = 0
    while n_it < iters and not trace.read("kappa.done", bool, torch.all(done)):
        Z = torch.clamp(base + Xd @ W, -lp_clip, lp_clip)
        lam = torch.exp(Z)  # (R, Vc)
        G = Xd.T @ ((lam - Y) / n) + alpha * W  # (P, Vc)
        H = (lam.T @ XX).reshape(-1, P, P) / n + eyeP[None]  # (Vc, P, P)
        L, _info = torch.linalg.cholesky_ex(H)
        D = -torch.cholesky_solve(G.T[:, :, None], L)[:, :, 0].T  # (P, Vc)

        # halving line search, all (step, word) pairs at once; the
        # candidate objectives are evaluated on W + t*D directly, so an
        # accepted step agrees with the next iteration's fresh evaluation
        Ws = W[None] + ts[:, None, None] * D[None]  # (T, P, Vc)
        Zs = torch.clamp(base[None] + torch.matmul(Xd, Ws), -lp_clip, lp_clip)  # (T, R, Vc)
        Fs = (torch.sum(torch.exp(Zs) - Y[None] * Zs, dim=1) / n
              + 0.5 * alpha * torch.sum(Ws * Ws, dim=1))  # (T, Vc)
        # ties go to the first (largest) step, as jnp.argmin
        f_new, best = torch.min(Fs, dim=0)
        t_best = ts[best]
        improved = f_new < F
        gnorm = torch.amax(torch.abs(G), dim=0)  # (Vc,)
        # the full step's decrease from the current point, and the bound
        # of its sum's rounding, for the words whose objectives F's
        # rounding hides it from; U is its own product, not the t = 1
        # candidate's linear predictor less Z, whose difference would lose
        # a small step's digits to cancellation
        U = Xd @ D
        a, b = lam * torch.expm1(U), Y * U
        wd, dd = torch.sum(W * D, dim=0), 0.5 * torch.sum(D * D, dim=0)
        dF = torch.sum(a - b, dim=0) / n + alpha * (wd + dd)
        err = eps * (torch.sum(torch.abs(a) + torch.abs(b), dim=0) / n
                     + alpha * (torch.abs(wd) + dd))
        rescued = ~improved & ~done & (gnorm >= tol) & (dF < -2.0 * err)
        moved = improved | rescued
        if trace.active():
            trace.count("kappa.word_steps", ~done)
            trace.count("kappa.floor_exits", ~done & ~moved & (gnorm >= tol))
        step = improved & ~done
        W = torch.where(step[None, :], W + t_best[None, :] * D,
                        torch.where(rescued[None, :], W + D, W))
        F = torch.where(step, f_new, torch.where(rescued, Fs[0], F))
        # a word is done when its gradient meets tol, or when no step
        # improves it (the float32 floor of a convex objective).
        # ftol_rel is read as the JAX package reads it: against the
        # objective AFTER the step is taken, so a word that moved has
        # rel_impr = 0 and any ftol_rel > 0 freezes it after that one
        # step (ROADMAP.md Queue C); 0 leaves the exit to the two tests
        # above
        rel_impr = (F - f_new) / torch.clamp_min(torch.abs(F), 1e-30)
        done = done | (gnorm < tol) | ~moved | (rel_impr < ftol_rel)
        n_it += 1
    return W, n_it


def _poisson_newton_word(y, m_v, Xd, offset, alpha, n, iters,
                         w0=None, tol=1e-7, lp_clip=30.0):
    """Single-word wrapper over :func:`_poisson_newton_batch` (tests)."""
    if w0 is None:
        w0 = torch.zeros(Xd.shape[1], dtype=Xd.dtype, device=Xd.device)
    W, _ = _poisson_newton_batch(
        y[:, None], m_v.reshape(1), Xd, offset, alpha, n, iters,
        w0[:, None], tol=tol, lp_clip=lp_clip,
    )
    return W[:, 0]


def _kappa_vchunk(V: int, P: int, budget_floats: int = 16_000_000) -> int:
    """Words per chunk: the largest power of two whose (Vc, P, P)
    Hessian workspace stays within ``budget_floats``, at least 128.
    Each word freezes on its own, so the chunk size changes no word's
    result, only the workspace and how many words ride along to the
    chunk's slowest one."""
    c = max(128, budget_floats // max(P * P, 1))
    c = 1 << (c.bit_length() - 1)  # round down to a power of two
    return min(V, c)


def update_beta_content(
    beta_ss,  # (A, K, V) or (K, V)
    wcounts,  # (V,) corpus-wide word counts
    kappa_design,  # ((A*K), P) from build_kappa_design
    alpha: float = 250.0,
    iters: int = 40,
    kappa0=None,  # (P, V) warm start (the previous EM iteration's kappa)
    tol: float = 1e-6,
    vocab_psum=None,  # sum over the vocab axis (beta_ss a block of words)
    vocab_pmax=None,  # max over the vocab axis
    wcounts_total=None,  # the sum of the FULL vocabulary's word counts
    ftol_rel: float = 0.0,
):
    """Content model: V parallel Poisson regressions -> (beta, kappa).

    Counts ((A*K), V) = stacked beta_ss; fixed intercept m = log relative
    word frequency; offset = log row totals; one penalized Poisson
    regression per word; predictions row-softmaxed into beta.  The V fits
    run as word-chunked batched damped Newton
    (:func:`_poisson_newton_batch`), warm-started from ``kappa0``.

    Words are sorted by corpus frequency before chunking (a stable sort):
    a chunk runs to its slowest word's count, and solve difficulty tracks
    word frequency, so rare words exit together.  The permutation only
    relabels independent solves.

    While recording (``utils/trace.py``) the solves are the span
    ``mstep.kappa`` (its attributes ``chunks`` and ``words``; a CUDA event
    at each end on a card), and each chunk adds its Newton steps to
    ``kappa.chunk_steps`` and its width times them to ``kappa.slot_steps``.

    Vocabulary sharding: the per-word solves are independent, so each
    rank fits the words of its block (``beta_ss``, ``wcounts`` and
    ``kappa0`` are then that block's); what crosses blocks is three
    (A·K)-sized reductions — the offset's row totals (``vocab_psum``),
    the softmax's row max (``vocab_pmax``) and normaliser
    (``vocab_psum``) — and the scalar ``wcounts_total``.
    """
    dtype, dev = beta_ss.dtype, beta_ss.device
    counts = beta_ss.reshape(-1, beta_ss.shape[-1]) if beta_ss.ndim == 3 else beta_ss
    R, V = counts.shape
    n = float(R)

    wcounts = torch.as_tensor(wcounts, device=dev).to(dtype)
    wc_total = torch.sum(wcounts) if wcounts_total is None else wcounts_total
    m = (torch.log(torch.clamp_min(wcounts, 1e-10))
         - torch.log(torch.clamp_min(wc_total, 1e-10)))
    row_tot = torch.sum(counts, dim=1)  # ((A*K),)
    if vocab_psum is not None:
        row_tot = vocab_psum(row_tot)
    offset = torch.log(torch.clamp_min(row_tot, 1e-10))
    Xd = torch.as_tensor(kappa_design, device=dev).to(dtype)
    P = Xd.shape[1]
    if kappa0 is None:
        kappa0 = torch.zeros(P, V, dtype=dtype, device=dev)

    order = torch.argsort(wcounts[:V], stable=True)
    inv_order = torch.argsort(order, stable=True)
    m_user = m  # unsorted: the final linear predictor is in user order
    counts = counts[:, order]
    m = m[order]
    kappa0 = kappa0[:, order]

    Vc = _kappa_vchunk(V, P)
    Ws = []
    with trace.span("mstep.kappa", dev, {"chunks": -(-V // Vc), "words": V}):
        for lo in range(0, V, Vc):
            W, n_it = _poisson_newton_batch(
                counts[:, lo:lo + Vc], m[lo:lo + Vc], Xd, offset, alpha, n, iters,
                kappa0[:, lo:lo + Vc], tol=tol, ftol_rel=ftol_rel)
            Ws.append(W)
            trace.count("kappa.chunk_steps", n_it)
            trace.count("kappa.slot_steps", n_it * W.shape[1])
        kappa = torch.cat(Ws, dim=1)[:, inv_order]

    linpred = m_user[None, :V] + Xd @ kappa  # ((A*K), V)
    if vocab_psum is None:
        beta = torch.softmax(linpred, dim=1)
    else:
        mx = vocab_pmax(torch.amax(linpred, dim=1, keepdim=True))
        expl = torch.exp(linpred - mx)
        beta = expl / vocab_psum(torch.sum(expl, dim=1, keepdim=True))
    if beta_ss.ndim == 3:
        beta = beta.reshape(beta_ss.shape)
    return beta, kappa
