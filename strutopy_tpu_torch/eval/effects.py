"""Metadata-effect estimation on topic proportions.

The reference README promises "Metadata estimates ... visualised w.r.t.
their effect on the expected topic proportions" (README.md §5); its
code only prints raw gamma differences (06_example_application.py:
343-351).  This module provides the R-stm ``estimateEffect``-style
analysis: per-topic OLS of theta on a covariate design with
normal-approximation confidence intervals, plus the effect plot.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from strutopy_tpu_torch.utils.precision import true_float32


def estimate_effect(
    theta: np.ndarray,
    D: np.ndarray,
    topics: Optional[Sequence[int]] = None,
    add_intercept: bool = True,
):
    """Per-topic OLS of theta[:, k] on the covariate design.

    Returns a dict with ``coef`` (K_sel, P), ``se`` (K_sel, P) and
    ``ci`` ((K_sel, P, 2), 95% normal approx).
    """
    theta = np.asarray(theta, np.float64)
    D, topics = _build_design(D, len(theta), add_intercept), (
        list(range(theta.shape[1])) if topics is None else list(topics)
    )
    coef, se, vcov = _ols_fit(theta, D, topics, return_vcov=True)
    ci = np.stack([coef - 1.96 * se, coef + 1.96 * se], axis=-1)
    return {
        "coef": coef, "se": se, "ci": ci, "topics": topics,
        "vcov": vcov, "design_means": D.mean(axis=0),
    }


def _build_design(D, N: int, add_intercept: bool) -> np.ndarray:
    D = np.asarray(D, np.float64)
    if D.ndim == 1:
        D = D[:, None]
    if len(D) != N:
        raise ValueError(f"design has {len(D)} rows for {N} documents")
    if add_intercept:
        D = np.c_[np.ones(len(D)), D]
    return D


def _ols_fit(theta, D, topics, return_vcov: bool = False, ops=None):
    """Per-topic OLS coef (K_sel, P), normal-approx se (K_sel, P) and,
    optionally, the full coefficient covariance (K_sel, P, P) — the
    latter is what the continuous/difference effect methods propagate
    through arbitrary design points.

    ``ops=(DtD_inv, H)`` supplies the design-only factorization, so
    callers fitting many responses against ONE design (the composition
    loop) don't re-factor it per fit."""
    N, P = D.shape
    if ops is None:
        DtD_inv = np.linalg.pinv(D.T @ D)
        H = DtD_inv @ D.T
    else:
        DtD_inv, H = ops
    coefs, ses, vcovs = [], [], []
    for k in topics:
        y = theta[:, k]
        b = H @ y
        resid = y - D @ b
        dof = max(N - P, 1)
        s2 = float(resid @ resid) / dof
        vcov = DtD_inv * s2
        se = np.sqrt(np.maximum(np.diagonal(vcov), 0.0))
        coefs.append(b)
        ses.append(se)
        vcovs.append(vcov)
    if return_vcov:
        return np.asarray(coefs), np.asarray(ses), np.asarray(vcovs)
    return np.asarray(coefs), np.asarray(ses)


def plot_effect(
    effect: dict,
    covariate: int = 1,
    path: Optional[str] = None,
):
    """Point estimates + 95% CIs of one covariate's effect per topic."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    coef = effect["coef"][:, covariate]
    ci = effect["ci"][:, covariate]
    topics = effect["topics"]
    fig, ax = plt.subplots(figsize=(6, 0.35 * len(topics) + 1))
    y = np.arange(len(topics))
    ax.errorbar(
        coef, y,
        xerr=np.stack([coef - ci[:, 0], ci[:, 1] - coef]),
        fmt="o", capsize=3,
    )
    ax.axvline(0.0, color="gray", lw=1, ls="--")
    ax.set_yticks(y)
    ax.set_yticklabels([f"topic {k}" for k in topics])
    ax.set_xlabel("effect on expected topic proportion")
    ax.set_title("Covariate effect on topic prevalence (95% CI)")
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def _design_points(effect: dict, covariate: int, values, at=None):
    """Design rows varying one coefficient column over ``values`` while
    holding every other column at the estimation-sample mean (or the
    ``at`` override, a {column: value} dict)."""
    means = np.asarray(effect["design_means"], np.float64)
    values = np.atleast_1d(np.asarray(values, np.float64))
    if not (0 <= covariate < means.shape[0]):
        raise ValueError(
            f"covariate {covariate} out of range for a design with "
            f"{means.shape[0]} columns (column 0 is the intercept when "
            "the effect was estimated with add_intercept=True)"
        )
    rows = np.tile(means, (len(values), 1))
    for col, v in (at or {}).items():
        rows[:, col] = v
    rows[:, covariate] = values
    return rows


def effect_curve(
    effect: dict,
    covariate: int,
    values,
    topics: Optional[Sequence[int]] = None,
    at=None,
):
    """Expected topic proportion over a covariate grid with pointwise
    95% CIs (R-stm ``plot.estimateEffect(method="continuous")``, the
    evaluation half).

    ``effect`` is an :func:`estimate_effect` /
    :func:`estimate_effect_composition` result (both carry the full
    per-topic coefficient covariance).  Other covariates are held at
    their estimation-sample means; ``at`` ({design column: value})
    overrides that.  ``covariate`` indexes coefficient columns —
    column 0 is the intercept when the effect used add_intercept=True.

    Returns {"values", "mean" (K_sel, G), "ci" (K_sel, G, 2), "topics"}.
    """
    rows = _design_points(effect, covariate, values, at)
    values = rows[:, covariate]
    sel = (
        list(range(len(effect["topics"]))) if topics is None
        else [effect["topics"].index(k) for k in topics]
    )
    coef = effect["coef"][sel]          # (K_sel, P)
    vcov = effect["vcov"][sel]          # (K_sel, P, P)
    mean = coef @ rows.T                # (K_sel, G)
    var = np.einsum("gp,kpq,gq->kg", rows, vcov, rows)
    se = np.sqrt(np.maximum(var, 0.0))
    ci = np.stack([mean - 1.96 * se, mean + 1.96 * se], axis=-1)
    return {
        "values": values, "mean": mean, "ci": ci,
        "topics": [effect["topics"][i] for i in sel],
    }


def effect_difference(
    effect: dict,
    covariate: int,
    v0,
    v1,
    topics: Optional[Sequence[int]] = None,
    at=None,
):
    """Per-topic difference in expected proportion between two covariate
    values (R-stm ``plot.estimateEffect(method="difference")``):
    r(v1)·b − r(v0)·b with se = sqrt(dᵀ V d), d = r(v1) − r(v0).

    Returns {"diff" (K_sel,), "se", "ci" (K_sel, 2), "topics"}.
    """
    rows = _design_points(effect, covariate, [v0, v1], at)
    d = rows[1] - rows[0]
    sel = (
        list(range(len(effect["topics"]))) if topics is None
        else [effect["topics"].index(k) for k in topics]
    )
    coef = effect["coef"][sel]
    vcov = effect["vcov"][sel]
    diff = coef @ d
    se = np.sqrt(np.maximum(np.einsum("p,kpq,q->k", d, vcov, d), 0.0))
    ci = np.stack([diff - 1.96 * se, diff + 1.96 * se], axis=-1)
    return {
        "diff": diff, "se": se, "ci": ci,
        "topics": [effect["topics"][i] for i in sel],
        "values": (float(np.asarray(v0).ravel()[0]) if np.ndim(v0) else float(v0),
                   float(np.asarray(v1).ravel()[0]) if np.ndim(v1) else float(v1)),
    }


def effect_point_estimates(
    effect: dict,
    covariate: int,
    values,
    topics: Optional[Sequence[int]] = None,
    at=None,
):
    """Expected topic proportion AT each discrete covariate level with
    95% CIs (R-stm ``plot.estimateEffect(method="pointestimate")``, the
    evaluation half).  Unlike :func:`plot_effect` (which shows the
    regression SLOPE per topic), this evaluates the fitted regression
    at specific covariate values — the natural view for categorical
    covariates such as a treatment indicator.

    Same conventions as :func:`effect_curve` (which it delegates to):
    other covariates held at estimation-sample means, ``at`` overrides,
    ``covariate`` indexes coefficient columns.

    Returns {"values" (G,), "mean" (K_sel, G), "ci" (K_sel, G, 2),
    "topics"}.
    """
    return effect_curve(effect, covariate, values, topics=topics, at=at)


def plot_effect_pointestimate(
    effect: dict,
    covariate: int,
    values,
    topics: Optional[Sequence[int]] = None,
    at=None,
    labels: Optional[Sequence[str]] = None,
    value_labels: Optional[Sequence[str]] = None,
    path: Optional[str] = None,
):
    """R-stm ``plot.estimateEffect(method="pointestimate")``: one
    dot-whisker per (topic, covariate level) of the expected topic
    proportion, topics on the y axis, levels distinguished by marker."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    res = effect_point_estimates(effect, covariate, values, topics=topics,
                                 at=at)
    mean, ci, tps = res["mean"], res["ci"], res["topics"]
    G = mean.shape[1]
    y = np.arange(len(tps))
    cmap = plt.get_cmap("tab10")
    fig, ax = plt.subplots(figsize=(6, 0.45 * len(tps) + 1))
    for g in range(G):
        off = (g - (G - 1) / 2) * min(0.8 / max(G, 1), 0.25)
        name = (value_labels[g] if value_labels is not None
                else f"{res['values'][g]:g}")
        ax.errorbar(
            mean[:, g], y + off,
            xerr=np.stack([mean[:, g] - ci[:, g, 0], ci[:, g, 1] - mean[:, g]]),
            fmt="o", capsize=3, color=cmap(g % 10), label=name,
        )
    ax.set_yticks(y)
    ax.set_yticklabels(
        labels if labels is not None else [f"topic {k}" for k in tps]
    )
    ax.set_xlabel("expected topic proportion")
    ax.set_title("Topic prevalence at covariate levels (95% CI)")
    ax.legend(loc="best", fontsize=8, title=f"design column {covariate}")
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_effect_continuous(
    effect: dict,
    covariate: int,
    values,
    topics: Optional[Sequence[int]] = None,
    at=None,
    labels: Optional[Sequence[str]] = None,
    path: Optional[str] = None,
):
    """R-stm ``plot.estimateEffect(method="continuous")``: expected
    topic proportion vs a continuous covariate, one line + 95% band
    per topic."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    curve = effect_curve(effect, covariate, values, topics=topics, at=at)
    fig, ax = plt.subplots(figsize=(7, 5))
    cmap = plt.get_cmap("tab10")
    for i, k in enumerate(curve["topics"]):
        c = cmap(i % 10)
        name = labels[i] if labels is not None else f"topic {k}"
        ax.plot(curve["values"], curve["mean"][i], color=c, label=name)
        ax.fill_between(curve["values"], curve["ci"][i, :, 0],
                        curve["ci"][i, :, 1], color=c, alpha=0.18)
    ax.set_xlabel(f"covariate (design column {covariate})")
    ax.set_ylabel("expected topic proportion")
    ax.set_title("Topic prevalence vs covariate (95% CI)")
    ax.legend(loc="best", fontsize=8)
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def plot_effect_difference(
    effect: dict,
    covariate: int,
    v0,
    v1,
    topics: Optional[Sequence[int]] = None,
    at=None,
    labels: Optional[Sequence[str]] = None,
    path: Optional[str] = None,
):
    """R-stm ``plot.estimateEffect(method="difference")``: per-topic
    change in expected proportion moving the covariate v0 → v1."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    res = effect_difference(effect, covariate, v0, v1, topics=topics, at=at)
    diff, ci, tps = res["diff"], res["ci"], res["topics"]
    y = np.arange(len(tps))
    fig, ax = plt.subplots(figsize=(6, 0.35 * len(tps) + 1))
    ax.errorbar(
        diff, y,
        xerr=np.stack([diff - ci[:, 0], ci[:, 1] - diff]),
        fmt="o", capsize=3,
    )
    ax.axvline(0.0, color="gray", lw=1, ls="--")
    ax.set_yticks(y)
    ax.set_yticklabels(
        labels if labels is not None else [f"topic {k}" for k in tps]
    )
    ax.set_xlabel(
        f"difference in expected proportion ({res['values'][0]:g} → "
        f"{res['values'][1]:g})"
    )
    ax.set_title("Covariate contrast on topic prevalence (95% CI)")
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def _draw_chunk(beta_full, siginv, words, counts, eta_c, mu_c, asp_c, z,
                return_eta: bool):
    """Posterior draws of one chunk: (S, B, K-1) eta draws, or their
    softmax (S, B, K).  H comes from ``stages.fgh`` in its float32 mode:
    the hand kernel on CUDA tensors, its plain version on CPU tensors."""
    from strutopy_tpu_torch.ops import stages
    from strutopy_tpu_torch.ops.estep import _gather_beta

    K = beta_full.shape[-2]
    beta_doc = _gather_beta(beta_full, words, asp_c)
    _f, _g, H = stages.fgh(eta_c, beta_doc, counts, mu_c, siginv, bf16=False)
    L, _nu, _rung = stages.chol_pd_inverse(H, inverse=False)
    # x = L^{-T} z  =>  cov(x) = L^{-T} L^{-1} = (L L^T)^{-1} = nu;
    # one batched solve with the S draws as right-hand-side columns
    x = torch.linalg.solve_triangular(L.mT, z.permute(1, 2, 0), upper=True)  # (B, K-1, S)
    draws = eta_c[None] + x.permute(2, 0, 1)  # (S, B, K-1)
    if return_eta:
        return draws
    S, B = draws.shape[:2]
    return torch.softmax(
        stages.pad_eta(draws.reshape(S * B, K - 1)), dim=-1
    ).reshape(S, B, K)


@true_float32
def simulate_theta(
    model,
    n_draws: int = 25,
    seed: int = 0,
    chunk: int = 512,
    return_eta: bool = False,
) -> np.ndarray:
    """Draw theta from each document's variational (Laplace) posterior.

    The E-step's per-document posterior is N(eta_d, nu_d) with
    nu_d = H_d^{-1} the inverse Hessian at the converged eta.  The fit
    keeps only sum_d nu_d (it is all the M-step needs), so this
    recomputes H_d from the fitted model in chunks with the E-step's own
    f/g/H stage (``stages.fgh`` with ``bf16=False``), draws
    eta_d + L_d^{-T} z  (cov = (L L^T)^{-1} = nu_d), and maps each draw
    through the softmax.  It runs on ``model.device``; z comes from
    ``np.random.default_rng(seed)`` on the host, chunk by chunk, so the
    draws are those of the JAX package for the same seed.

    Returns ``(n_draws, N, K)`` theta samples in document order — the
    input to method-of-composition effect estimation
    (:func:`estimate_effect_composition`).
    """
    # Streamed fits (stream_parts>1) also work: the STM-level state
    # re-concatenates every part's eta/mu/theta each iteration
    # (models/stm.py streamed step), so the full per-document posterior
    # parameters are available here just like an in-memory fit.
    dev = model.device
    beta = np.asarray(model.beta, np.float32)
    eta = np.asarray(model.eta, np.float32)
    mu = np.asarray(model.mu, np.float32)
    corpus = model._corpus
    aspects = np.asarray(model.betaindex, np.int32)
    siginv = np.linalg.inv(np.asarray(model.sigma, np.float64)).astype(
        np.float32
    )
    N, K = corpus.N, beta.shape[-2]
    beta_full = torch.as_tensor(beta if beta.ndim == 3 else beta[None], device=dev)
    siginv_t = torch.as_tensor(siginv, device=dev)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    rng = np.random.default_rng(seed)
    out = np.empty((n_draws, N, K - 1 if return_eta else K), np.float32)
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        B = hi - lo
        pad = chunk - B  # every chunk has one shape, as in the JAX package
        sl = slice(lo, hi)
        words = np.pad(corpus.words[sl], ((0, pad), (0, 0)))
        counts = np.pad(corpus.counts[sl], ((0, pad), (0, 0)))
        z = rng.standard_normal((n_draws, chunk, K - 1)).astype(np.float32)
        theta_s = _draw_chunk(
            beta_full, siginv_t,
            put(words.astype(np.int32)), put(counts.astype(np.float32)),
            put(np.pad(eta[sl], ((0, pad), (0, 0)))),
            put(np.pad(mu[sl], ((0, pad), (0, 0)))),
            put(np.pad(aspects[sl], (0, pad))),
            put(z),
            return_eta,
        )
        out[:, sl] = theta_s[:, :B].cpu().numpy()
    return out


def estimate_effect_composition(
    model,
    D=None,
    topics: Optional[Sequence[int]] = None,
    add_intercept: bool = True,
    n_draws: int = 25,
    seed: int = 0,
    chunk: int = 512,
):
    """Method-of-composition effect estimation (R-stm ``estimateEffect``
    with ``uncertainty="Global"``).

    Plain :func:`estimate_effect` treats the point estimate theta_hat as
    data, so its CIs carry only regression sampling noise and understate
    the uncertainty of inferred proportions.  This draws ``n_draws``
    theta samples from each document's variational posterior
    (:func:`simulate_theta`), fits the per-topic OLS on every draw, and
    combines with Rubin's rules:

        coef = mean_s b_s
        var  = mean_s se_s^2  +  (1 + 1/S) * var_s(b_s)

    ``D`` defaults to the model's own prevalence covariates (model.X).
    Returns the :func:`estimate_effect` dict plus ``within``/``between``
    variance components and ``n_draws``.
    """
    if D is None:
        if model.X is None:
            raise ValueError(
                "the model was fit without covariates; pass D explicitly"
            )
        D = model.X
    thetas = simulate_theta(model, n_draws=n_draws, seed=seed, chunk=chunk)
    D = _build_design(D, thetas.shape[1], add_intercept)
    # drop empty (doc_ok=False) documents: their eta is frozen at 0 and
    # the draws are pure prior noise — regressing those phantom rows
    # against real covariate values biases coefficients toward zero and
    # corrupts the between-draw variance
    ok = np.asarray(getattr(model._corpus, "doc_ok", np.ones(len(D), bool)))
    if not ok.all():
        thetas = thetas[:, ok]
        D = D[ok]
    K = thetas.shape[2]
    topics = list(range(K)) if topics is None else list(topics)

    # the design is identical across draws: factor it once
    DtD_inv = np.linalg.pinv(D.T @ D)
    ops = (DtD_inv, DtD_inv @ D.T)
    coefs, vcovs = [], []
    for s in range(n_draws):
        b, _se, v = _ols_fit(
            np.asarray(thetas[s], np.float64), D, topics, return_vcov=True,
            ops=ops,
        )
        coefs.append(b)
        vcovs.append(v)
    bs = np.stack(coefs)  # (S, K_sel, P)
    within_v = np.mean(np.stack(vcovs), axis=0)  # (K_sel, P, P)
    if n_draws > 1:
        dev = bs - bs.mean(axis=0)  # (S, K_sel, P)
        between_v = (
            np.einsum("skp,skq->kpq", dev, dev) / (n_draws - 1)
        )
    else:
        between_v = np.zeros_like(within_v)
    vcov = within_v + (1.0 + 1.0 / n_draws) * between_v
    within = np.diagonal(within_v, axis1=1, axis2=2)
    between = np.diagonal(between_v, axis1=1, axis2=2)
    coef = bs.mean(axis=0)
    se = np.sqrt(np.maximum(np.diagonal(vcov, axis1=1, axis2=2), 0.0))
    ci = np.stack([coef - 1.96 * se, coef + 1.96 * se], axis=-1)
    return {
        "coef": coef, "se": se, "ci": ci, "topics": topics,
        "within": within, "between": between, "n_draws": n_draws,
        "vcov": vcov, "design_means": D.mean(axis=0),
    }


def estimate_content_effect(
    beta: np.ndarray,
    theta: np.ndarray,
    doc_lengths: np.ndarray,
    aspect_index: np.ndarray,
    topics: Optional[Sequence[int]] = None,
    aspects=(0, 1),
    n: int = 10,
    vocab=None,
):
    """Per-topic differential word weight across content-covariate levels.

    The reference README promises metadata estimates "on the topical
    content" as well as prevalence (reference README.md:44-45); its code
    never implements them.  For each topic k this contrasts the fitted
    aspect betas:

        c_kv = log beta[a1, k, v] - log beta[a0, k, v]

    with a plug-in Poisson log-rate-ratio standard error from the
    expected token counts  E[count_akv] ~= beta[a,k,v] * M_ak, where
    M_ak = sum_{d: aspect_d=a} theta[d,k] * N_d  (the expected tokens
    topic k emits under aspect a):

        se_kv = sqrt(1/max(E1,eps) + 1/max(E0,eps)).

    Words with tiny expected counts in either aspect get huge se, so the
    z-ranking surfaces only well-supported contrasts.

    Returns a dict with ``contrast`` (K_sel, V), ``se`` (K_sel, V),
    ``z`` and per-topic ``top`` lists of (word, contrast, se, z) for the
    n most positive (favoring ``aspects[1]``) and n most negative.
    """
    beta = np.asarray(beta, np.float64)
    assert beta.ndim == 3, "content effects need an (A, K, V) beta"
    theta = np.asarray(theta, np.float64)
    doc_lengths = np.asarray(doc_lengths, np.float64).ravel()
    aspect_index = np.asarray(aspect_index).ravel()
    a0, a1 = aspects
    A, K, V = beta.shape
    topics = list(range(K)) if topics is None else list(topics)
    eps = 1e-8

    # expected tokens per (aspect, topic): M_ak
    tok = theta * doc_lengths[:, None]  # (N, K)
    M = np.zeros((A, K))
    for a in range(A):
        sel = aspect_index == a
        if sel.any():
            M[a] = tok[sel].sum(axis=0)

    logb = np.log(np.maximum(beta, 1e-30))
    contrast = logb[a1, topics] - logb[a0, topics]  # (K_sel, V)
    E1 = beta[a1, topics] * M[a1, topics, None]
    E0 = beta[a0, topics] * M[a0, topics, None]
    se = np.sqrt(1.0 / np.maximum(E1, eps) + 1.0 / np.maximum(E0, eps))
    z = contrast / se

    top = []
    for i, k in enumerate(topics):
        order = np.argsort(-z[i])
        pos = [j for j in order[:n]]
        neg = [j for j in order[::-1][:n]]

        def row(j):
            w = vocab[j] if vocab is not None else str(j)
            return (w, float(contrast[i, j]), float(se[i, j]), float(z[i, j]))

        top.append({"topic": int(k),
                    "favoring_a1": [row(j) for j in pos],
                    "favoring_a0": [row(j) for j in neg]})
    return {
        "contrast": contrast, "se": se, "z": z,
        "topics": topics, "aspects": (int(a0), int(a1)), "top": top,
    }


def plot_content_effect(effect: dict, topic_pos: int = 0, n: int = 8,
                        path: Optional[str] = None):
    """Horizontal bar chart of the top differential words (±1.96 se)
    for one topic of an :func:`estimate_content_effect` result."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    entry = effect["top"][topic_pos]
    rows = entry["favoring_a1"][:n][::-1] + entry["favoring_a0"][:n]
    words = [r[0] for r in rows]
    vals = np.asarray([r[1] for r in rows])
    errs = 1.96 * np.asarray([r[2] for r in rows])
    y = np.arange(len(rows))
    fig, ax = plt.subplots(figsize=(6, 0.3 * len(rows) + 1))
    ax.barh(y, vals, xerr=errs, capsize=2,
            color=["#4477aa" if v > 0 else "#ee6677" for v in vals])
    ax.axvline(0.0, color="gray", lw=1, ls="--")
    ax.set_yticks(y)
    ax.set_yticklabels(words)
    a0, a1 = effect["aspects"]
    ax.set_xlabel(f"log beta(aspect {a1}) - log beta(aspect {a0})")
    ax.set_title(f"Topic {entry['topic']}: content-covariate effect (95% CI)")
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig


def permutation_test(
    documents,
    treatment: np.ndarray,
    K: int,
    nruns: int = 20,
    seed: int = 0,
    init_type: str = "spectral",
    max_em_iter: int = 10,
    *,
    device="cuda",
    **stm_kwargs,
):
    """Treatment permutation test (R-stm ``permutationTest``; absent
    upstream — the reference estimates effects but never validates
    them against a permuted-assignment null).

    Fits the STM once with the TRUE binary treatment as the prevalence
    covariate, then ``nruns`` more times with the treatment labels
    permuted.  Each run reports the treatment coefficient + 95% CI on
    that run's MAXIMAL-|effect| topic (the maximal statistic makes the
    null distribution conservative, as in R-stm).  A real effect shows
    the true-assignment run well outside the permuted runs' CIs; a
    model that mechanically manufactures treatment effects shows the
    permuted runs matching the true one.

    Every fit runs on ``device`` (the card unless the caller asks for
    the CPU).

    Returns {"ref": {"coef", "ci", "topic"},
             "permuted": [{"coef", "ci", "topic"}, ...],
             "pvalue": share of permuted |coef| >= the true |coef|
                       (add-one permutation p-value)}.
    """
    from strutopy_tpu_torch.models.stm import STM

    treatment = np.asarray(treatment, np.float64).ravel()
    documents = list(documents)
    if len(treatment) != len(documents):
        raise ValueError(
            f"treatment has {len(treatment)} entries for {len(documents)} documents"
        )
    rng = np.random.default_rng(seed)

    def one_run(assign):
        model = STM(
            documents=documents,
            K=K,
            X=assign[:, None],
            init_type=init_type,
            max_em_iter=max_em_iter,
            device=device,
            **stm_kwargs,
        )
        model.expectation_maximization(saving=False)
        # empty (doc_ok=False) documents keep a uniform 1/K theta no
        # matter the assignment — regressing those phantom rows against
        # real treatment values attenuates every run's coefficient
        # toward zero (same mask estimate_effect_composition applies)
        ok = np.asarray(model._corpus.doc_ok)
        eff = estimate_effect(model.theta[ok], assign[ok])
        k = int(np.argmax(np.abs(eff["coef"][:, 1])))
        return {
            "coef": float(eff["coef"][k, 1]),
            "ci": [float(eff["ci"][k, 1, 0]), float(eff["ci"][k, 1, 1])],
            "topic": k,
        }

    ref = one_run(treatment)
    permuted = [one_run(rng.permutation(treatment)) for _ in range(nruns)]
    exceed = sum(1 for r in permuted if abs(r["coef"]) >= abs(ref["coef"]))
    return {
        "ref": ref,
        "permuted": permuted,
        "pvalue": (exceed + 1) / (nruns + 1),
    }


def plot_permutation_test(result: dict, path: Optional[str] = None):
    """R-stm ``plot.STMpermute``: each run's maximal treatment effect
    with its 95% CI; the true assignment drawn first and highlighted."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    runs = [result["ref"]] + list(result["permuted"])
    coefs = np.asarray([r["coef"] for r in runs])
    cis = np.asarray([r["ci"] for r in runs])
    y = np.arange(len(runs))
    fig, ax = plt.subplots(figsize=(6, 0.3 * len(runs) + 1))
    colors = ["#bb5566"] + ["#4477aa"] * (len(runs) - 1)
    for i in range(len(runs)):
        ax.errorbar(
            coefs[i], y[i],
            xerr=[[coefs[i] - cis[i, 0]], [cis[i, 1] - coefs[i]]],
            fmt="o", capsize=3, color=colors[i],
        )
    ax.axvline(0.0, color="gray", lw=1, ls="--")
    ax.set_yticks(y)
    ax.set_yticklabels(
        ["true assignment"] + [f"permutation {i}" for i in range(len(runs) - 1)]
    )
    ax.set_xlabel("maximal treatment effect on topic prevalence")
    ax.set_title(f"Permutation test (p = {result['pvalue']:.3f})")
    if path:
        fig.savefig(path, bbox_inches="tight")
    return fig
