"""One EM iteration (twin of ``strutopy_tpu/models/em.py``).

Sigma factorization, the bucketed E-step, the moment reduction and the
prevalence / sigma / beta (LDA or content model) updates, as one function of ``(state, data)``.
On one device, or on this rank's shard under a mesh
(``parallel/sharding.py``): then ``psum`` sums the statistics over the
document axis, and ``vocab`` names the vocab axis of a 2-D mesh.

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
from strutopy_tpu_torch.parallel.mesh import MeshAxis, all_max, all_sum


@dataclasses.dataclass(frozen=True)
class CorpusData:
    """Corpus and covariate design on the device, per length bucket."""

    words: Tuple[torch.Tensor, ...]  # each (N_b, L_b) int32
    counts: Tuple[torch.Tensor, ...]  # each (N_b, L_b) float32
    aspects: Tuple[torch.Tensor, ...]  # each (N_b,) int32
    doc_ok: Tuple[torch.Tensor, ...]  # each (N_b,) bool
    D: Tuple[torch.Tensor, ...]  # each (N_b, P); zero rows for padding

    @classmethod
    def single(cls, words, counts, aspects, doc_ok, D) -> "CorpusData":
        """One length bucket."""
        return cls((words,), (counts,), (aspects,), (doc_ok,), (D,))

    @property
    def n_buckets(self) -> int:
        return len(self.words)

    def to(self, device) -> "CorpusData":
        return CorpusData(**{f.name: tuple(x.to(device) for x in getattr(self, f.name))
                             for f in dataclasses.fields(self)})


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
                      bucket_batches: Optional[Tuple[int, ...]] = None,
                      vocab: Optional[MeshAxis] = None):
    """E-step over all buckets (of this rank's shard under a mesh; with
    ``vocab`` the beta of ``state`` and the returned beta_ss are this
    rank's block of the vocabulary).

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
            fused_finalize=cfg.two_pass_fused, vocab=vocab,
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
                 kappa_design, wcounts, cfg: STMConfig, psum=None,
                 bucket_batches: Optional[Tuple[int, ...]] = None,
                 vocab: Optional[MeshAxis] = None) -> STMState:
    """One full EM iteration.

    ``psum`` sums this rank's statistics over the document axis (None,
    one device: the identity, and the step is exactly the single-device
    one).  With ``vocab`` set, beta, beta_ss and kappa are this rank's
    block of words; the per-document quantities are the same on every
    rank of the vocab axis (each chunk's beta_doc is assembled whole), so
    the document-axis sum yields the full totals.  The sigma residual
    (eta - mu)ᵀ(eta - mu) is summed over documents once mu is known; the
    rest of the M-step runs replicated on summed statistics.
    """
    psum = psum or (lambda x: x)
    stats, eta, theta, newton_iters = local_estep_stats(state, data, cfg, bucket_batches,
                                                        vocab)
    stats = GlobalStats(*psum(tuple(stats)))

    mom = mstep.EtaMoments(Dt_eta=stats.Dt_eta, eta_sum=stats.eta_sum)
    gamma, mu_mean = mstep.update_prevalence(
        mom, design, cfg.model_type, cfg.mode,
        ridge_alpha=cfg.ridge_alpha, lasso_alpha=cfg.lasso_alpha,
    )
    mu = torch.cat([
        mstep.compute_mu(D_b, gamma, mu_mean, ok_b, cfg.model_type)
        for D_b, ok_b in zip(data.D, data.doc_ok)
    ])
    resid = psum(mstep.residual_moment(eta, mu))
    sigma = mstep.update_sigma(resid, stats.sigma_ss, design.n_docs, cfg.sigma_prior)
    beta, kappa = m_step_beta(stats.beta_ss, state.kappa, kappa_design, wcounts, cfg, vocab)
    return STMState(
        beta=beta, mu=mu, sigma=sigma, eta=eta, theta=theta, gamma=gamma,
        kappa=kappa, bound=stats.bound, opt_iters=newton_iters,
        straggler_overflow=stats.straggler_overflow,
    )


def m_step_beta(beta_ss, kappa, kappa_design, wcounts, cfg: STMConfig,
                vocab: Optional[MeshAxis] = None):
    """The beta update of the M-step -> (beta, kappa): the LDA row
    normalization, or the content model's kappa regression warm-started
    from the previous iteration's ``kappa`` (zeros, the cold start, at
    iteration 0).  ``wcounts`` is the full vocabulary's; with ``vocab``
    the per-word regressions run on this rank's block of words."""
    row_psum = vocab_psum = vocab_pmax = wc_total = None
    if vocab is not None:
        row_psum = vocab_psum = lambda x: all_sum(x, vocab)
        vocab_pmax = lambda x: all_max(x, vocab)
    if cfg.lda_beta:
        return mstep.update_beta_lda(beta_ss, cfg.beta_smoothing, row_psum), kappa
    if vocab is not None:
        Vl = beta_ss.shape[-1]
        wcounts = torch.as_tensor(wcounts, device=beta_ss.device).to(beta_ss.dtype)
        wc_total = torch.sum(wcounts)
        wcounts = wcounts[vocab.rank * Vl:(vocab.rank + 1) * Vl]
    return mstep.update_beta_content(
        beta_ss, wcounts, kappa_design, alpha=cfg.kappa_l2,
        iters=cfg.kappa_newton_iters, kappa0=kappa,
        tol=cfg.kappa_grad_tol, ftol_rel=cfg.kappa_ftol_rel,
        vocab_psum=vocab_psum, vocab_pmax=vocab_pmax, wcounts_total=wc_total,
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
