"""Plain PyTorch reference of the content STM's EM iteration, batched:
the per-aspect E-step, the kappa regression of the M-step, and the
prevalence regression and sigma.

The E-step is ``stm_ref.e_step`` run on each aspect's documents with that
aspect's beta (A, K, V) -> (K, V); the statistics are summed over the
aspects (beta_ss stays per aspect).  The prevalence OLS and sigma are
``stm_ref.m_step_lda_ols``'s.  The kappa regression solves, for every
word v, the penalised Poisson objective the program's docstring states

    F_v(w) = (1/n) sum_r [exp(z_r) - y_rv z_r] + (alpha/2) ||w||^2,
    z = m_v + offset + X w,

with n = R = A·K rows (aspect-major, topic-minor, as ``beta_ss``
stacks), y the stacked beta_ss, the intercept m_v = log(word count /
total count) held fixed, offset = log of each row's total, and X the
(R, P) kappa design: K topic, A aspect and, with interactions, A·K
interaction indicators.  Each word is solved by exact Newton (Cholesky
of the Hessian, which alpha·I keeps positive definite) to max|g| <=
``prec.tol`` (1e-9 in float64), with a backtracking Armijo search whose
decrease F(w + t d) - F(w) is computed from the current point,

    (1/n) sum_r [lambda_r expm1(t u_r) - y_r t u_r] + alpha (t w.d + t^2/2 d.d),
    u = X d,

so that no two objectives of size |F| are subtracted: for a frequent
word |F| is ~1e4 and a float64 difference of two such values stops
carrying the decrease long before the gradient reaches 1e-9.  beta is
the row softmax of m + X kappa.

Departures from stm's R code (``estimateBeta``, ``mnreg``): the penalty
is L2 with a fixed alpha (``kappa_l2``), where stm runs glmnet's L1 path
and picks its lambda per word; the objective is scaled by 1/n as
sklearn's ``PoissonRegressor``; nothing clips the linear predictor (the
program clips it to +-30, which no fitted value reaches).

It imports nothing of the program.  ``Prec("tf32")`` is the control:
the same code in float32 with every matrix product's operands rounded to
TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import stm_ref

WORD_BLOCK = 4096  # words solved together: the (words, P, P) Hessians


def _put(a, prec: stm_ref.Prec, device):
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(
        device=device, dtype=prec.dtype)


def e_step(docs, aspects, beta, mu, eta0, sigma, prec: stm_ref.Prec, device="cpu",
           at=()):
    """The E-step of a content model: ``stm_ref.e_step`` over each
    aspect's documents with beta[a] (beta (A, K, V), ``aspects`` (N,)
    ints) -> the same dict, beta_ss (A, K, V) and every per-document
    entry in the documents' order."""
    docs = stm_ref.Docs.of(docs)
    aspects = np.asarray(aspects)
    beta = _put(beta, prec, device)
    mu, eta0 = np.asarray(mu, np.float64), np.asarray(eta0, np.float64)
    at = [a.detach().cpu().double().numpy() if torch.is_tensor(a) else np.asarray(a, np.float64)
          for a in at]
    A, K, V = beta.shape
    N, dt = len(docs), prec.dtype
    out = {"eta": torch.empty(N, K - 1, dtype=dt, device=device),
           "theta": torch.empty(N, K, dtype=dt, device=device),
           "bound": torch.empty(N, dtype=dt, device=device),
           "f": torch.empty(N, dtype=dt, device=device),
           "beta_ss": torch.zeros_like(beta),
           "sigma_ss": torch.zeros(K - 1, K - 1, dtype=dt, device=device),
           "f_at": [torch.empty(N, dtype=dt, device=device) for _ in at]}
    for a in range(A):
        idx = np.nonzero(aspects == a)[0]
        if not len(idx):
            continue
        e = stm_ref.e_step(docs.take(idx), beta[a], mu[idx], eta0[idx], sigma, prec,
                           device=device, at=[x[idx] for x in at])
        sl = torch.as_tensor(idx, device=device)
        for k in ("eta", "theta", "bound", "f"):
            out[k][sl] = e[k]
        for f_at, got in zip(out["f_at"], e["f_at"]):
            f_at[sl] = got
        out["beta_ss"][a] = e["beta_ss"]
        out["sigma_ss"] += e["sigma_ss"]
    return out


def kappa_design(K: int, A: int, interactions: bool) -> np.ndarray:
    """The (A·K, P) design: rows (a, k) aspect-major; columns K topic
    indicators, A aspect indicators, A·K interaction indicators."""
    R = A * K
    a_idx, k_idx = np.repeat(np.arange(A), K), np.tile(np.arange(K), A)
    X = np.zeros((R, K + A + (R if interactions else 0)))
    X[np.arange(R), k_idx] = 1.0
    X[np.arange(R), K + a_idx] = 1.0
    if interactions:
        X[np.arange(R), K + A + np.arange(R)] = 1.0
    return X


def kappa_problem(beta_ss, wcounts, Xd, prec: stm_ref.Prec, device="cpu") -> dict:
    """The regression's data: Y (R, V) the stacked beta_ss, m (V,), offset
    (R,), X (R, P), all in ``prec``'s type."""
    ss = _put(beta_ss, prec, device)
    Y = ss.reshape(-1, ss.shape[-1])
    wc = _put(wcounts, prec, device)
    m = torch.log(torch.clamp_min(wc, 1e-300)) - torch.log(wc.sum())
    offset = torch.log(torch.clamp_min(Y.sum(1), 1e-300))
    return {"Y": Y, "m": m, "offset": offset, "X": _put(Xd, prec, device)}


def _decrease(lam, Y, U, W, D, t, alpha, n):
    """F(W + t D) - F(W) for every column, from the current point: lam =
    exp(z) at W (R, v), U = X D (R, v), t (v,)."""
    tU = t[None, :] * U
    return (torch.sum(lam * torch.expm1(tU) - Y * tU, dim=0) / n
            + alpha * (t * torch.sum(W * D, dim=0) + 0.5 * t * t * torch.sum(D * D, dim=0)))


def solve_kappa(prob: dict, alpha: float, prec: stm_ref.Prec, kappa0=None,
                max_iter: int = 100) -> dict:
    """Every word's optimum -> {"kappa" (P, V), "iters", "gmax" (V,) the
    final max|g|}, from ``kappa0`` (zeros when None)."""
    Y, m, offset, X = prob["Y"], prob["m"], prob["offset"], prob["X"]
    R, P = X.shape
    n = float(R)
    V = Y.shape[1]
    dev, dt = Y.device, Y.dtype
    W = (torch.zeros(P, V, dtype=dt, device=dev) if kappa0 is None
         else _put(kappa0, prec, dev).clone())
    XX = (X[:, :, None] * X[:, None, :]).reshape(R, P * P)
    eye = alpha * torch.eye(P, dtype=dt, device=dev)
    gmax = torch.zeros(V, dtype=dt, device=dev)
    iters = 0
    for lo in range(0, V, WORD_BLOCK):
        live = torch.arange(lo, min(V, lo + WORD_BLOCK), device=dev)
        for it in range(max_iter):
            w, y = W[:, live], Y[:, live]
            lam = torch.exp(m[live][None, :] + offset[:, None] + prec.mm(X, w))
            G = prec.mm(X.T, (lam - y) / n) + alpha * w
            g = torch.amax(torch.abs(G), dim=0)
            gmax[live] = g
            keep = g > prec.tol
            live, w, y, lam, G = live[keep], w[:, keep], y[:, keep], lam[:, keep], G[:, keep]
            if live.numel() == 0:
                break
            iters = max(iters, it + 1)
            H = prec.mm(lam.T / n, XX).reshape(-1, P, P) + eye
            L, _info = torch.linalg.cholesky_ex(H)
            D = -torch.cholesky_solve(G.T[:, :, None], L)[:, :, 0].T
            gTd = torch.sum(G * D, dim=0)
            U = prec.mm(X, D)
            t = torch.ones_like(gTd)
            moved = torch.zeros_like(gTd, dtype=torch.bool)
            pend = torch.arange(live.numel(), device=dev)
            for _ in range(40):
                dF = _decrease(lam[:, pend], y[:, pend], U[:, pend], w[:, pend], D[:, pend],
                               t[pend], alpha, n)
                ok = dF <= 1e-4 * t[pend] * gTd[pend]
                moved[pend[ok]] = True
                pend = pend[~ok]
                if pend.numel() == 0:
                    break
                t[pend] = 0.5 * t[pend]
            W[:, live[moved]] = w[:, moved] + t[moved][None, :] * D[:, moved]
            live = live[moved]  # no step decreases F: at the floor
            if live.numel() == 0:
                break
    return {"kappa": W, "iters": iters, "gmax": gmax}


def beta_of(prob: dict, kappa, shape) -> torch.Tensor:
    """beta = the row softmax of m + X kappa, reshaped to ``shape``."""
    kappa = kappa.to(prob["X"].dtype)
    return torch.softmax(prob["m"][None, :] + prob["X"] @ kappa, dim=1).reshape(shape)


def kappa_gap(prob: dict, kappa, kappa_star, alpha: float) -> torch.Tensor:
    """Each word's F at ``kappa`` less F at ``kappa_star`` (V,), in
    float64, computed from ``kappa_star`` as :func:`_decrease` does."""
    f64 = {k: v.to(torch.float64) for k, v in prob.items()}
    W = torch.as_tensor(np.asarray(kappa) if not torch.is_tensor(kappa) else kappa).to(
        device=f64["Y"].device, dtype=torch.float64)
    Ws = kappa_star.to(torch.float64)
    R = f64["X"].shape[0]
    lam = torch.exp(f64["m"][None, :] + f64["offset"][:, None] + f64["X"] @ Ws)
    D = W - Ws
    one = torch.ones(W.shape[1], dtype=torch.float64, device=W.device)
    return _decrease(lam, f64["Y"], f64["X"] @ D, Ws, D, one, alpha, float(R))


def gap_numbers(gap: torch.Tensor) -> dict:
    """``kgap_max``, ``kgap_mean``, ``kgap_p90`` over the words."""
    q = torch.quantile(gap, torch.tensor(0.9, dtype=gap.dtype, device=gap.device))
    return {"kgap_max": float(gap.max()), "kgap_mean": float(gap.mean()),
            "kgap_p90": float(q)}


def m_step(est: dict, D, wcounts, Xd, alpha: float, prec: stm_ref.Prec, kappa0=None) -> dict:
    """The content model's M-step from the E-step's statistics ``est``
    (beta_ss (A, K, V), sigma_ss, eta): the prevalence OLS and sigma of
    ``stm_ref.m_step_lda_ols``, then kappa and beta -> dict of beta (A,
    K, V), kappa (P, V), mu, sigma, gamma, and ``problem``, the kappa
    regression's data."""
    out = stm_ref.m_step_lda_ols(est, D)
    dev = est["beta_ss"].device
    prob = kappa_problem(est["beta_ss"], wcounts, Xd, prec, dev)
    sol = solve_kappa(prob, alpha, prec, kappa0)
    out.update(beta=beta_of(prob, sol["kappa"], est["beta_ss"].shape), kappa=sol["kappa"],
               problem=prob)
    return out
