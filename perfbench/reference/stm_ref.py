"""Plain PyTorch reference of the STM E-step and LDA M-step, batched.

It follows the float64 oracle (``oracle_numpy.py``, a frozen copy of the
repository's serial scipy oracle) formula for formula, but solves a block
of documents at once on whatever device its tensors are on: an exact
Newton solve per document (Cholesky of the Hessian, raised by a growing
multiple of the identity where it is not positive definite, and a
backtracking Armijo search), run until every document's largest gradient
entry is below ``tol`` or no step decreases its objective.  It imports
nothing of the program, and takes from the caller only raw inputs: the
BoW documents, the design, and the parameters the iteration starts from.

``Prec("float64")`` is the reference.  ``Prec("tf32")`` is the control:
the same code in float32 with every matrix product's operands rounded to
TF32 (10 mantissa bits, round to nearest even), as a TF32 tensor-core
product takes them, on every device alike.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Prec:
    name: str = "float64"  # "float64" or "tf32"

    @property
    def dtype(self):
        return torch.float64 if self.name == "float64" else torch.float32

    @property
    def tol(self) -> float:
        return 1e-9 if self.name == "float64" else 1e-5

    def round(self, x: torch.Tensor) -> torch.Tensor:
        return tf32_round(x) if self.name == "tf32" else x

    def mm(self, a, b):
        return torch.matmul(self.round(a), self.round(b))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits; ties
    to even), kept in float32."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = (i + 0xFFF + lsb) & ~0x1FFF
    return r.view(torch.float32)


# ---------------------------------------------------------------------------
# documents
# ---------------------------------------------------------------------------


class Docs:
    """A BoW corpus in compressed rows: document i's word ids and counts
    are ``ids[indptr[i]:indptr[i + 1]]`` and ``counts[...]`` (numpy).
    Holds no Python object a document, so the garbage collector has
    nothing of it to walk."""

    def __init__(self, indptr, ids, counts):
        self.indptr, self.ids, self.counts = indptr, ids, counts

    @classmethod
    def of(cls, docs):
        """From a list of [(word id, count), ...] (or a Docs as it is)."""
        if isinstance(docs, cls):
            return docs
        lens = np.fromiter((len(d) for d in docs), np.int64, len(docs))
        indptr = np.concatenate([[0], np.cumsum(lens)])
        flat = np.fromiter(itertools.chain.from_iterable(itertools.chain.from_iterable(docs)),
                           np.int64, 2 * int(indptr[-1])).reshape(-1, 2)
        return cls(indptr, flat[:, 0], flat[:, 1].astype(np.float64))

    def __len__(self):
        return len(self.indptr) - 1

    def n_words(self, i) -> int:
        return int(self.indptr[i + 1] - self.indptr[i])

    def row(self, i):
        a, b = self.indptr[i], self.indptr[i + 1]
        return self.ids[a:b], self.counts[a:b]

    def take(self, idx) -> "Docs":
        rows = [self.row(i) for i in idx]
        lens = np.array([len(w) for w, _ in rows], np.int64)
        return Docs(np.concatenate([[0], np.cumsum(lens)]),
                    np.concatenate([w for w, _ in rows] or [np.zeros(0, np.int64)]),
                    np.concatenate([c for _, c in rows] or [np.zeros(0)]))

    def word_counts(self, V: int) -> np.ndarray:
        return np.bincount(self.ids, weights=self.counts, minlength=V)


def pad_block(docs: Docs, idx, device):
    """(words int64 (n, L), counts float64 (n, L)) of documents ``idx``,
    L the block's largest number of distinct words (>= 1)."""
    L = max(1, max(docs.n_words(i) for i in idx))
    words = np.zeros((len(idx), L), np.int64)
    counts = np.zeros((len(idx), L), np.float64)
    for r, i in enumerate(idx):
        w, c = docs.row(i)
        words[r, :len(w)] = w
        counts[r, :len(c)] = c
    return torch.as_tensor(words, device=device), torch.as_tensor(counts, device=device)


def blocks(docs: Docs, idx, K: int, budget_bytes: float = 2.0e9):
    """Consecutive runs of ``idx`` whose (n, K, L) float64 blocks stay
    within ``budget_bytes``."""
    out, cur, L = [], [], 1
    for i in idx:
        n = max(docs.n_words(i), 1)
        L2 = max(L, n)
        if cur and (len(cur) + 1) * K * L2 * 8 > budget_bytes:
            out.append(cur)
            cur, L2 = [], n
        cur.append(i)
        L = L2
    if cur:
        out.append(cur)
    return out


# ---------------------------------------------------------------------------
# one document's objective, gradient and Hessian (oracle doc_f, doc_grad,
# doc_hess), batched
# ---------------------------------------------------------------------------


def _full(eta):
    return torch.cat([eta, torch.zeros_like(eta[:, :1])], dim=1)


def objective(eta, bd, c, mu, siginv, prec: Prec):
    """f(eta) of every document of a block (the oracle's ``doc_f``)."""
    ef = _full(eta)
    m = torch.amax(ef, dim=1, keepdim=True)
    e = torch.exp(ef - m)
    s = prec.mm(e[:, None, :], bd)[:, 0, :]
    loglik = torch.sum(torch.where(c > 0, c * (torch.log(torch.clamp_min(s, 1e-300))
                                               + m), 0.0), dim=1)
    lse = m[:, 0] + torch.log(torch.sum(e, dim=1))
    diff = eta - mu
    quad = 0.5 * torch.sum(prec.mm(diff, siginv) * diff, dim=1)
    return quad - (loglik - c.sum(1) * lse)


def grad_hess(eta, bd, c, mu, siginv, prec: Prec):
    """(g, H) of every document of a block (``doc_grad``, ``doc_hess``)."""
    ef = _full(eta)
    m = torch.amax(ef, dim=1, keepdim=True)
    e = torch.exp(ef - m)
    a = e[:, :, None] * bd
    s = torch.clamp_min(torch.sum(a, dim=1, keepdim=True), 1e-300)
    phi = a / s
    theta = e / torch.sum(e, dim=1, keepdim=True)
    Nd = c.sum(1, keepdim=True)
    q = torch.sum(phi * c[:, None, :], dim=2)
    diff = eta - mu
    g = prec.mm(diff, siginv) + (Nd * theta - q)[:, :-1]
    Bm = phi * torch.sqrt(c)[:, None, :]
    H = prec.mm(Bm, Bm.transpose(1, 2)) - Nd[:, :, None] * theta[:, :, None] * theta[:, None, :]
    H = H + torch.diag_embed(Nd * theta - q)
    return g, H[:, :-1, :-1] + siginv


def _direction(g, H):
    """-H⁻¹g by Cholesky, H raised by tau·I where it is not positive
    definite (tau growing tenfold from 1e-10·(1 + max|diag H|))."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    scale = 1.0 + torch.amax(torch.abs(torch.diagonal(H, dim1=1, dim2=2)), dim=1)
    L, info = torch.linalg.cholesky_ex(H)
    tau = 1e-10 * scale
    for _ in range(14):
        bad = info != 0
        if not bool(torch.any(bad)):
            break
        L2, info2 = torch.linalg.cholesky_ex(H + tau[:, None, None] * eye)
        L = torch.where(bad[:, None, None], L2, L)
        info = torch.where(bad, info2, info)
        tau = tau * 10.0
    return torch.cholesky_solve(-g[:, :, None], L)[:, :, 0]


def newton(eta0, bd, c, mu, siginv, prec: Prec, max_iter: int = 200):
    """Minimize every document's objective from ``eta0`` -> eta.  Each
    iteration works on the documents still live: those whose largest
    gradient entry is above ``prec.tol`` and that the last step moved."""
    eta = eta0.clone()
    live = torch.arange(eta.shape[0], device=eta.device)
    for _ in range(max_iter):
        if live.numel() == 0:
            break
        e, b, cc, m = eta[live], bd[live], c[live], mu[live]
        g, H = grad_hess(e, b, cc, m, siginv, prec)
        keep = torch.amax(torch.abs(g), dim=1) > prec.tol
        live, e, b, cc, m, g, H = (x[keep] for x in (live, e, b, cc, m, g, H))
        if live.numel() == 0:
            break
        f = objective(e, b, cc, m, siginv, prec)
        p = _direction(g, H)
        gTp = torch.sum(g * p, dim=1)
        p = torch.where((gTp < 0)[:, None], p, -g)
        gTp = torch.where(gTp < 0, gTp, -torch.sum(g * g, dim=1))
        # backtracking Armijo search on the pending documents only
        t = torch.ones_like(f)
        pend = torch.arange(live.numel(), device=eta.device)
        moved = torch.zeros_like(f, dtype=torch.bool)
        for _ in range(40):
            fn = objective(e[pend] + t[pend, None] * p[pend], b[pend], cc[pend], m[pend],
                           siginv, prec)
            ok = fn <= f[pend] + 1e-4 * t[pend] * gTp[pend]
            acc = pend[ok]
            e[acc] = e[acc] + t[acc, None] * p[acc]
            moved[acc] = True
            pend = pend[~ok]
            if pend.numel() == 0:
                break
            t[pend] = 0.5 * t[pend]
        eta[live] = e
        live = live[moved]  # no step decreases f: at the floor
    return eta


def _safe_chol(H):
    """The oracle's ``safe_chol`` ladder, batched: the factor, else that of
    the diagonal-dominance repair, else the repair plus 1e-5·I."""
    L, info = torch.linalg.cholesky_ex(H)
    if bool(torch.all(info == 0)):
        return L
    dvec = torch.diagonal(H, dim1=1, dim2=2)
    mag = torch.sum(torch.abs(H), dim=2) - torch.abs(dvec)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    H2 = H * (1 - eye) + torch.maximum(dvec, mag)[:, :, None] * eye
    L2, info2 = torch.linalg.cholesky_ex(H2)
    L3, _ = torch.linalg.cholesky_ex(H2 + 1e-5 * eye)
    fix = torch.where((info2 == 0)[:, None, None], L2, L3)
    return torch.where((info == 0)[:, None, None], L, fix)


def finalize(eta, bd, c, mu, siginv, sigmaentropy, prec: Prec):
    """The oracle's per-document tail of ``e_step`` at eta: (theta, nu
    (n, K-1, K-1), bound (n,), phi (n, K, L))."""
    ef = _full(eta)
    m = torch.amax(ef, dim=1, keepdim=True)
    e = torch.exp(ef - m)
    theta = e / torch.sum(e, dim=1, keepdim=True)
    a = e[:, :, None] * bd
    phi_hat = a / torch.clamp_min(torch.sum(a, dim=1, keepdim=True), 1e-300)
    _g, H = grad_hess(eta, bd, c, mu, siginv, prec)
    L = _safe_chol(H)
    nu = torch.cholesky_inverse(L)
    t_l = prec.mm((theta * e)[:, None, :], bd)[:, 0, :]
    loglik = torch.sum(torch.where(c > 0, c * (torch.log(torch.clamp_min(t_l, 1e-300)) + m),
                                   0.0), dim=1)
    diff = eta - mu
    bound = (loglik - torch.sum(torch.log(torch.diagonal(L, dim1=1, dim2=2)), dim=1)
             - 0.5 * torch.sum(prec.mm(diff, siginv) * diff, dim=1) - sigmaentropy)
    return theta, nu, bound, phi_hat * c[:, None, :]


def sigma_terms(sigma, prec: Prec):
    """(siginv, sigmaentropy) of sigma, as the oracle's ``e_step`` opens."""
    L = torch.linalg.cholesky(sigma)
    Linv = torch.linalg.inv(L)
    return prec.mm(Linv.T, Linv), torch.sum(torch.log(torch.diagonal(L)))


def gather(beta, words):
    """beta_doc (n, K, L) from beta (K, V)."""
    return beta[:, words].permute(1, 0, 2)


def e_step(docs, beta, mu, eta0, sigma, prec: Prec, device="cpu", solve: bool = True,
           at=()):
    """The E-step over every document of ``docs`` (a BoW list or a
    :class:`Docs`) from
    ``eta0`` -> dict of eta (N, K-1), theta, bound (N,) per document,
    f (N,) the objective at eta, beta_ss, sigma_ss, and ``f_at``: the
    objective at each of the etas ``at`` (N, K-1).  With ``solve`` False
    eta is ``eta0`` as given (the statistics of a given solution).  All
    inputs are numpy or tensors; they are cast to ``prec``'s type on
    ``device``."""
    dt = prec.dtype

    def put(a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a).to(
            device=device, dtype=dt)

    docs = Docs.of(docs)
    beta, mu, eta0, sigma = put(beta), put(mu), put(eta0), put(sigma)
    at = [put(a) for a in at]
    siginv, sigmaentropy = sigma_terms(sigma, prec)
    K = beta.shape[-2]
    N = len(docs)
    out = {"eta": torch.empty(N, K - 1, dtype=dt, device=device),
           "theta": torch.empty(N, K, dtype=dt, device=device),
           "bound": torch.empty(N, dtype=dt, device=device),
           "f": torch.empty(N, dtype=dt, device=device),
           "beta_ss": torch.zeros_like(beta),
           "sigma_ss": torch.zeros(K - 1, K - 1, dtype=dt, device=device),
           "f_at": [torch.empty(N, dtype=dt, device=device) for _ in at]}
    for blk in blocks(docs, range(N), K):
        sl = torch.as_tensor(blk, device=device)
        words, counts = pad_block(docs, blk, device)
        c = counts.to(dt)
        bd = gather(beta, words)
        eta = newton(eta0[sl], bd, c, mu[sl], siginv, prec) if solve else eta0[sl]
        theta, nu, bound, phi = finalize(eta, bd, c, mu[sl], siginv, sigmaentropy, prec)
        out["eta"][sl], out["theta"][sl], out["bound"][sl] = eta, theta, bound
        out["f"][sl] = objective(eta, bd, c, mu[sl], siginv, prec)
        for f_at, a in zip(out["f_at"], at):
            f_at[sl] = objective(a[sl], bd, c, mu[sl], siginv, prec)
        out["sigma_ss"] += torch.sum(nu, dim=0)
        out["beta_ss"].index_add_(1, words.reshape(-1), phi.permute(1, 0, 2).reshape(K, -1))
    return out


def objective_at(docs, beta, mu, sigma, eta, device="cpu"):
    """Every document's float64 objective at a given eta (N,)."""
    return e_step(docs, beta, mu, eta, sigma, Prec("float64"), device=device, solve=False)["f"]


def start(beta0, N: int) -> dict:
    """stm's initial state for an initial beta (K, V): its rows normalized,
    eta = mu = 0 (N, K-1), sigma = 20 I."""
    beta = np.asarray(beta0, np.float64)
    K = beta.shape[0]
    return {"beta": beta / beta.sum(axis=1, keepdims=True), "eta": np.zeros((N, K - 1)),
            "mu": np.zeros((N, K - 1)), "sigma": 20.0 * np.eye(K - 1)}


def m_step_lda_ols(est: dict, D):
    """STM prevalence by OLS of eta on the design D (N, P), sigma, and the
    LDA beta (the oracle's ``m_step_stm_ols``) -> dict of beta, mu,
    sigma, gamma (K-1, P)."""
    eta = est["eta"]
    D = torch.as_tensor(np.asarray(D), dtype=eta.dtype, device=eta.device)
    gammaT = torch.linalg.lstsq(D, eta).solution
    mu = D @ gammaT
    r = eta - mu
    sigma = (r.T @ r + est["sigma_ss"]) / eta.shape[0]
    rs = est["beta_ss"].sum(dim=-1, keepdim=True)
    beta = torch.where(rs > 0, est["beta_ss"] / torch.clamp_min(rs, 1e-300), 0.0)
    return {"beta": beta, "mu": mu, "sigma": sigma, "gamma": gammaT.T}
