"""One EM iteration (twin of ``strutopy_tpu/models/em.py``, one device).

Sigma factorization, the bucketed E-step, the moment reduction and the
prevalence / sigma / beta (LDA or content model) updates, as one function of ``(state, data)``.

Length bucketing: every per-document field of :class:`CorpusData` is a
tuple with one entry per length bucket.  Buckets are contiguous row
ranges of the per-document state, so each bucket's slice of eta/mu
follows from the bucket shapes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from strutopy_tpu_torch.models.config import STMConfig
from strutopy_tpu_torch.models.state import STMState
from strutopy_tpu_torch.ops import mstep
from strutopy_tpu_torch.ops.estep import NewtonConfig, run_estep
from strutopy_tpu_torch.ops.linalg import precompute_sigma


@dataclasses.dataclass(frozen=True)
class CorpusData:
    """Corpus and covariate design on the device, per length bucket."""

    words: Tuple[torch.Tensor, ...]  # each (N_b, L_b) int32
    counts: Tuple[torch.Tensor, ...]  # each (N_b, L_b) float32
    aspects: Tuple[torch.Tensor, ...]  # each (N_b,) int32
    doc_ok: Tuple[torch.Tensor, ...]  # each (N_b,) bool
    D: Tuple[torch.Tensor, ...]  # each (N_b, P); zero rows for padding

    @property
    def n_buckets(self) -> int:
        return len(self.words)


class GlobalStats(NamedTuple):
    beta_ss: torch.Tensor
    sigma_ss: torch.Tensor
    bound: torch.Tensor
    Dt_eta: torch.Tensor
    eta_sum: torch.Tensor
    straggler_overflow: torch.Tensor


def _newton_cfg(cfg: STMConfig) -> NewtonConfig:
    return NewtonConfig(
        max_iters=cfg.newton_max_iters,
        grad_tol=cfg.newton_grad_tol,
        max_backtracks=cfg.newton_max_backtracks,
        cg_iters=cfg.newton_cg_iters,
        bf16_hessian=cfg.newton_bf16_hessian,
        fixed_iters=cfg.newton_fixed_iters,
        pallas_iter=cfg.pallas_iter,
        likelihood_temper=cfg.likelihood_temper,
        bf16_beta=cfg.newton_bf16_beta,
    )


def local_estep_stats(state: STMState, data: CorpusData, cfg: STMConfig,
                      bucket_batches: Optional[Tuple[int, ...]] = None):
    """E-step over all buckets.

    Returns (GlobalStats, eta, theta, newton_iters), the per-document
    outputs in storage order.  Within a bucket, documents run in
    ascending order of last iteration's Newton count (a stable sort, as
    ``jnp.argsort``), so a chunk's Newton loop runs about its own
    documents' iterations rather than the bucket's worst case.
    """
    siginv, sigmaentropy = precompute_sigma(state.sigma)
    ncfg = _newton_cfg(cfg)
    dev = state.beta.device

    beta_ss = torch.zeros_like(state.beta)
    sigma_ss = torch.zeros_like(state.sigma)
    bound = torch.zeros((), dtype=state.beta.dtype, device=dev)
    Dt_eta = None
    eta_sum = torch.zeros(state.eta.shape[1], dtype=state.eta.dtype, device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    etas, thetas, iters = [], [], []

    lo = 0
    for b in range(data.n_buckets):
        words_b, counts_b = data.words[b], data.counts[b]
        aspects_b, ok_b = data.aspects[b], data.doc_ok[b]
        n_b = words_b.shape[0]
        hi = lo + n_b
        B_b = (bucket_batches[b] if bucket_batches is not None
               else min(cfg.batch_size, n_b))
        mu_b, eta_b = state.mu[lo:hi], state.eta[lo:hi]

        perm = None
        if cfg.sort_by_difficulty and n_b > B_b:
            perm = torch.argsort(state.opt_iters[lo:hi], stable=True)
            mu_b, eta_b = mu_b[perm], eta_b[perm]
            words_b, counts_b = words_b[perm], counts_b[perm]
            aspects_b, ok_b = aspects_b[perm], ok_b[perm]

        res = run_estep(
            state.beta, mu_b, eta_b, siginv, sigmaentropy, words_b, counts_b,
            aspects_b, ok_b,
            cfg=ncfg, batch_size=B_b, pass1_iters=cfg.newton_pass1_iters,
            straggler_frac=cfg.newton_straggler_frac, use_pallas=cfg.use_pallas,
            fused_finalize=cfg.two_pass_fused,
        )
        eta_out, theta_out, iters_out = res.eta, res.theta, res.newton_iters
        if perm is not None:
            eta_out = torch.empty_like(eta_out).index_copy_(0, perm, eta_out)
            theta_out = torch.empty_like(theta_out).index_copy_(0, perm, theta_out)
            iters_out = torch.empty_like(iters_out).index_copy_(0, perm, iters_out)

        mom = mstep.eta_moments(data.D[b], eta_out)
        beta_ss = beta_ss + res.beta_ss
        sigma_ss = sigma_ss + res.sigma_ss
        bound = bound + res.bound
        overflow = overflow + res.straggler_overflow
        Dt_eta = mom.Dt_eta if Dt_eta is None else Dt_eta + mom.Dt_eta
        eta_sum = eta_sum + mom.eta_sum
        etas.append(eta_out)
        thetas.append(theta_out)
        iters.append(iters_out)
        lo = hi

    stats = GlobalStats(beta_ss, sigma_ss, bound, Dt_eta, eta_sum, overflow)
    return stats, torch.cat(etas), torch.cat(thetas), torch.cat(iters)


def em_iteration(state: STMState, data: CorpusData, design: mstep.PrevalenceDesign,
                 kappa_design, wcounts, cfg: STMConfig,
                 bucket_batches: Optional[Tuple[int, ...]] = None) -> STMState:
    """One full EM iteration on one device (the JAX ``psum`` is the identity)."""
    stats, eta, theta, newton_iters = local_estep_stats(state, data, cfg, bucket_batches)

    mom = mstep.EtaMoments(Dt_eta=stats.Dt_eta, eta_sum=stats.eta_sum)
    gamma, mu_mean = mstep.update_prevalence(
        mom, design, cfg.model_type, cfg.mode,
        ridge_alpha=cfg.ridge_alpha, lasso_alpha=cfg.lasso_alpha,
    )
    mu = torch.cat([
        mstep.compute_mu(D_b, gamma, mu_mean, ok_b, cfg.model_type)
        for D_b, ok_b in zip(data.D, data.doc_ok)
    ])
    resid = mstep.residual_moment(eta, mu)
    sigma = mstep.update_sigma(resid, stats.sigma_ss, design.n_docs, cfg.sigma_prior)
    if cfg.lda_beta:
        beta = mstep.update_beta_lda(stats.beta_ss, cfg.beta_smoothing)
        kappa = state.kappa
    else:
        # warm start from the previous EM iteration's kappa (zeros, the
        # cold start, at iteration 0)
        beta, kappa = mstep.update_beta_content(
            stats.beta_ss, wcounts, kappa_design, alpha=cfg.kappa_l2,
            iters=cfg.kappa_newton_iters, kappa0=state.kappa,
            tol=cfg.kappa_grad_tol, ftol_rel=cfg.kappa_ftol_rel,
        )
    return STMState(
        beta=beta, mu=mu, sigma=sigma, eta=eta, theta=theta, gamma=gamma,
        kappa=kappa, bound=stats.bound, opt_iters=newton_iters,
        straggler_overflow=stats.straggler_overflow,
    )


def make_em_step(cfg: STMConfig, design: mstep.PrevalenceDesign, kappa_design,
                 wcounts, bucket_batches: Optional[Tuple[int, ...]] = None):
    """The single-device EM step: state, data -> state.  ``kappa_design``
    and ``wcounts`` (tensors on the state's device, or None) are read by
    the content-model beta update only."""

    def em_step(state: STMState, data: CorpusData) -> STMState:
        return em_iteration(state, data, design, kappa_design, wcounts, cfg,
                            bucket_batches=bucket_batches)

    return em_step
