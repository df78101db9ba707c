"""Streamed (out-of-core) EM: corpora larger than device memory (twin of
``strutopy_tpu/models/streaming.py``).

The single-device EM step (models/em.py) keeps the whole corpus on the
device.  This driver splits the corpus into P equally-shaped parts and
streams one part at a time through the E-step:

  for each part:  E-step stats (sufficient statistics accumulate
                  on device; eta/theta warm starts persist per part)
  one M-step      on the summed stats (identical math to em.py:
                  prevalence -> mu -> sigma residual second pass ->
                  sigma/beta)

This is exactly em_iteration's dataflow with the document loop lifted to
the host, so the result matches the in-memory step to float32 summation
order.  Parts may live in host RAM as numpy arrays (moved to the device
per iteration and freed after — the out-of-core case), be tensors already
on the device, or be produced on demand by a callback.

Every part's Newton solve runs the hand-written CUDA kernels of
``ops/stages.py`` on the current stream, exactly as the in-memory fit.

Under a mesh every part is document-sharded: each rank takes its rows of
each part, and each part's statistics are summed over the docs axis; on a
2-D mesh beta, beta_ss and kappa are this rank's block of the vocabulary.
"""

from __future__ import annotations

import dataclasses
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from strutopy_tpu_torch.models.config import STMConfig
from strutopy_tpu_torch.models.em import (
    CorpusData,
    GlobalStats,
    local_estep_stats,
    m_step_beta,
)
from strutopy_tpu_torch.models.state import STMState, init_state
from strutopy_tpu_torch.ops import mstep
from strutopy_tpu_torch.parallel.mesh import doc_axis, vocab_axis
from strutopy_tpu_torch.parallel.sharding import psum_over, shard_rows
from strutopy_tpu_torch.utils.precision import true_float32

logger = logging.getLogger(__name__)

# a part: (words (n, L), counts (n, L), aspects (n,), doc_ok (n,), D (n, P))
Part = Tuple
PartProvider = Union[Sequence[Part], Callable[[int], Part]]

# the device dtypes of a part's fields, in order
_PART_DTYPES = (torch.int32, torch.float32, torch.int32, torch.bool, torch.float32)


class StreamedEM:
    """EM over ``n_parts`` equally-shaped corpus parts.

    Args:
      cfg: fit configuration.  Content models stream too: the kappa
        regression runs once per iteration on the summed beta_ss, which
        is (A, K, V)-small regardless of corpus size — pass
        ``kappa_design`` and ``wcounts``.
      design: prevalence design over the FULL corpus
        (``mstep.make_prevalence_design``), on ``device``.
      parts: either a sequence of Part tuples (host numpy arrays, or
        tensors) or a callable ``provider(p) -> Part`` invoked once per
        part per iteration (arrays it returns are freed after the part's
        E-step — regenerate or re-read them each call).
      n_parts: required when ``parts`` is a callable.
      prefetch: stage part p+1 while part p's E-step runs.  On the card
        the part goes through pinned host memory and a copy stream of
        its own, so the copy overlaps the kernels; the peak part memory
        is then two parts.
      mesh: a document mesh (``parallel.make_mesh``) or a 2-D (docs,
        vocab) mesh (``make_mesh_2d``).  Every rank builds the driver with
        the same whole parts and keeps its rows of each; ``shared`` and the
        part states of :meth:`em_iteration` are then this rank's shards
        (``parallel.sharding.shard_state``, :meth:`init_parts`).
      device: where the parts are moved and the E-step runs.

    Every part must have the same (n, L) shape with n a multiple of
    ``min(cfg.batch_size, n)`` (under a mesh, of the docs axis's size
    times that).
    """

    def __init__(
        self,
        cfg: STMConfig,
        design: mstep.PrevalenceDesign,
        parts: PartProvider,
        n_parts: Optional[int] = None,
        prefetch: bool = True,
        kappa_design=None,
        wcounts=None,
        mesh=None,
        *,
        device="cuda",
    ):
        if (cfg.content or not cfg.lda_beta) and (
            kappa_design is None or wcounts is None
        ):
            raise ValueError(
                "content/SAGE beta updates need kappa_design and wcounts"
            )
        self.cfg = cfg
        self.design = design
        self.kappa_design = kappa_design
        self.wcounts = wcounts
        self.mesh = mesh
        self._docs = doc_axis(mesh) if mesh is not None else None
        self._vocab = vocab_axis(mesh) if mesh is not None else None
        self._psum = psum_over(self._docs)
        self.device = torch.device(device)
        on = design.DtD.device
        if on.type != self.device.type or (
            self.device.index is not None and on.index != self.device.index
        ):
            # the design is used as given: on another device the first
            # M-step would fail mid-iteration
            raise ValueError(
                f"the prevalence design is on {on} but StreamedEM runs on "
                f"{self.device}: build it with make_prevalence_design(..., "
                f"device={str(self.device)!r})"
            )
        if callable(parts):
            if n_parts is None:
                raise ValueError("n_parts is required with a callable provider")
            self._provider = parts
            self.n_parts = n_parts
        else:
            parts = list(parts)
            if n_parts is not None and n_parts != len(parts):
                # a mismatch would silently drop tail parts from every
                # EM iteration (or IndexError mid-iteration if larger)
                raise ValueError(
                    f"n_parts={n_parts} does not match the {len(parts)} "
                    "parts provided; omit n_parts for sequence providers"
                )
            self._provider = lambda p: parts[p]
            self.n_parts = len(parts)

        self.prefetch = prefetch
        # always-on finite-bound sanitizer: count occurrences and warn
        # loudly on the first
        self.nonfinite_bound_count = 0
        # equal-shape contract (class docstring): pinned on first fetch,
        # checked on every later one — a ragged tail part would fail
        # opaquely against part_states
        self._part_shape: Optional[Tuple[int, ...]] = None
        self._cached_part0: Optional[Part] = None
        # host->device copies of prefetched parts run here, beside the
        # E-step's kernels on the current stream
        self._copy_stream = (
            torch.cuda.Stream(self.device)
            if prefetch and self.device.type == "cuda" else None
        )

    def _to_device(self, x, dtype, staged: bool):
        """One field of a part on the device.  Tensors already there pass
        through untouched; host arrays are moved (``staged``: through
        pinned memory, asynchronously on the current stream)."""
        if isinstance(x, torch.Tensor) and x.device.type == self.device.type and (
                self.device.index is None or x.device.index == self.device.index):
            return x
        t = torch.as_tensor(x)
        if t.dtype != dtype:
            t = t.to(dtype)
        if not staged:
            return t.to(self.device)
        return t.contiguous().pin_memory().to(self.device, non_blocking=True)

    def _fetch(self, p: int):
        """Materialize part p on the device (runs on the prefetch thread
        when ``prefetch`` is on) -> (CorpusData, event or None).

        Doing it one part ahead overlaps provider work (disk reads, numpy
        slicing, regeneration) and the transfer with the current part's
        E-step.  On the card a prefetched part is copied on the copy
        stream; the returned event marks the end of that copy and the
        consumer waits on it before the part's first kernel."""
        if p == 0 and self._cached_part0 is not None:
            # init_parts already materialized part 0 for its shapes;
            # reuse it once instead of a second provider(0) call
            raw, self._cached_part0 = self._cached_part0, None
        else:
            raw = self._provider(p)
        shp = tuple(np.shape(raw[0]))
        if self._part_shape is None:
            self._part_shape = shp
        elif shp != self._part_shape:
            raise ValueError(
                f"part {p} has words shape {shp} but earlier parts had "
                f"{self._part_shape}: every part must share one (n, L) "
                "shape (one compiled E-step graph serves all parts; pad "
                "a short tail part instead of shrinking it)"
            )
        if self._docs is not None:
            raw = tuple(shard_rows(torch.as_tensor(x), self._docs) for x in raw)
        if self._copy_stream is None:
            fields = [self._to_device(x, dt, False) for x, dt in zip(raw, _PART_DTYPES)]
            return CorpusData(*((f,) for f in fields)), None
        with torch.cuda.stream(self._copy_stream):
            fields = [self._to_device(x, dt, True) for x, dt in zip(raw, _PART_DTYPES)]
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return CorpusData(*((f,) for f in fields)), ready

    def _take(self, fetched) -> CorpusData:
        """Hand a fetched part to the current stream: wait for its copy,
        and tell the allocator that this stream reads its tensors."""
        data_p, ready = fetched
        if ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ready)
            for f in dataclasses.fields(data_p):
                getattr(data_p, f.name)[0].record_stream(cur)
        return data_p

    def _mu_resid(self, D_p, gamma, mu_mean, ok_p, eta_p):
        mu_p = mstep.compute_mu(D_p, gamma, mu_mean, ok_p, self.cfg.model_type)
        return mu_p, mstep.residual_moment(eta_p, mu_p)

    # -- driver -----------------------------------------------------------

    def init_parts(self, key, K: int, V: int) -> List[STMState]:
        """Per-part state slices (eta/mu/theta), all of one shape.

        ``key`` is accepted for the JAX signature and unused: this
        package's ``init_state`` draws nothing.  A part state's beta is a
        uniform placeholder, one tensor shared by all parts;
        ``em_iteration`` reads beta, sigma, gamma and kappa from the
        shared state."""
        part0 = self._provider(0)
        self._cached_part0 = part0  # reused by the first _fetch(0)
        n = np.shape(part0[0])[0] // (self._docs.size if self._docs is not None else 1)
        P = np.shape(part0[4])[1]
        beta0 = np.full((K, V), 1.0 / V, np.float32)
        states: List[STMState] = []
        for _ in range(self.n_parts):
            s = init_state(None, K=K, V=V, N=n, P=P, beta_init=beta0, device=self.device)
            states.append(dataclasses.replace(s, beta=states[0].beta) if states else s)
        return states

    @true_float32
    def em_iteration(self, shared: STMState, part_states: List[STMState]):
        """One full EM iteration across all parts.

        ``shared`` carries beta/sigma/gamma/kappa (its per-doc fields
        are ignored); ``part_states`` carry per-part eta/mu/theta.
        Returns (new shared state with summed bound, new part states).
        """
        cfg = self.cfg
        stats_sum = None
        etas, iters_l, thetas = [], [], []
        parts_cache = []  # doc_ok + D stay for the mu/resid second pass

        # one-part-ahead prefetch: the provider's host work and the
        # host->device copy of part p+1 overlap part p's E-step
        ex = ThreadPoolExecutor(max_workers=1) if self.prefetch else None
        try:
            nxt = ex.submit(self._fetch, 0) if ex else None
            for p in range(self.n_parts):
                data_p = self._take(nxt.result() if ex else self._fetch(p))
                if ex:
                    nxt = (ex.submit(self._fetch, p + 1)
                           if p + 1 < self.n_parts else None)
                state_p = dataclasses.replace(
                    part_states[p],
                    beta=shared.beta, sigma=shared.sigma, gamma=shared.gamma,
                    kappa=shared.kappa,
                )
                stats, eta_p, theta_p, it_p = local_estep_stats(state_p, data_p, cfg,
                                                                vocab=self._vocab)
                stats = GlobalStats(*self._psum(tuple(stats)))
                stats_sum = (
                    stats
                    if stats_sum is None
                    else GlobalStats(*(x + y for x, y in zip(stats_sum, stats)))
                )
                etas.append(eta_p)
                thetas.append(theta_p)
                iters_l.append(it_p)
                parts_cache.append((data_p.doc_ok[0], data_p.D[0]))
                del data_p  # free the part's corpus before the next
        finally:
            if ex:
                ex.shutdown(wait=True)

        mom = mstep.EtaMoments(Dt_eta=stats_sum.Dt_eta, eta_sum=stats_sum.eta_sum)
        gamma, mu_mean = mstep.update_prevalence(
            mom, self.design, cfg.model_type, cfg.mode,
            ridge_alpha=cfg.ridge_alpha, lasso_alpha=cfg.lasso_alpha,
        )

        resid = None
        mus = []
        for p in range(self.n_parts):
            ok, D = parts_cache[p]
            mu_p, r = self._mu_resid(D, gamma, mu_mean, ok, etas[p])
            r = self._psum(r)
            mus.append(mu_p)
            resid = r if resid is None else resid + r

        sigma = mstep.update_sigma(resid, stats_sum.sigma_ss, self.design.n_docs,
                                   cfg.sigma_prior)
        beta, kappa = m_step_beta(stats_sum.beta_ss, shared.kappa, self.kappa_design,
                                  self.wcounts, cfg, self._vocab)

        new_shared = dataclasses.replace(
            shared,
            beta=beta, sigma=sigma, gamma=gamma, kappa=kappa,
            bound=stats_sum.bound,
            straggler_overflow=stats_sum.straggler_overflow,
        )
        if not np.isfinite(float(stats_sum.bound)):
            self.nonfinite_bound_count += 1
            if self.nonfinite_bound_count == 1:
                logger.warning(
                    "streamed EM: NON-FINITE bound — the fit is "
                    "numerically damaged even if theta/beta look "
                    "sensible; check the init "
                    "(StreamedEM.nonfinite_bound_count accumulates)"
                )
        new_parts = [
            dataclasses.replace(
                part_states[p],
                eta=etas[p], theta=thetas[p], mu=mus[p], opt_iters=iters_l[p],
            )
            for p in range(self.n_parts)
        ]
        return new_shared, new_parts
