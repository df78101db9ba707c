"""Driver ``fit_content``: a content STM's EM iterations, in the cycle of
the fit they belong to.

Set-up makes the content corpus from the seed (``corpus_content.py``),
builds the fit as a user does (``STM(docs, vocab, K=, X=[rating,
bs(day, df)], content=True, beta_index=rating, config=)``: spectral
init, length buckets, the prevalence design, the kappa design with its
interactions) and runs the traffic's ``warm_iters`` EM iterations
(0 .. warm_iters - 1), keeping the state they leave.  The window runs
iterations ``warm_iters`` .. ``max_em_iter - 1`` of the configuration's
fit, each one call of ``STM.expectation_maximization(start_iter=it)``
with ``max_em_iter`` at ``it + 1``; on reaching ``max_em_iter`` it puts
the kept state back and runs them again, until ``--seconds`` have
passed.  A window that runs a whole cycle holds the fit's own mix of
heavy early and light late kappa solves (a warm-started solve takes
fewer steps as the fit settles).  One that runs less of it (51 s on an
H100 runs 47 to 81 iterations, against a cycle's 70) ends the earlier
in the fit the slower the program is, so a faster program's window
reaches more of the late iterations; their walls differ from the early
ones' by a few percent either way, as the single-pass E-step, not the
kappa solve, sets them.

``correct`` judges the window's last iteration from its input state
against the float64 reference (``reference/content_ref.py``): ``last.``
each document's objective gap (``compare.eta_numbers``), the worst of
the A·K beta rows, sigma, gamma and the bound (``compare.fit_numbers``),
and ``kgap_*``: each word's kappa objective, on the reference's
statistics, at the program's kappa less its value at the reference's
optimum.
"""

from __future__ import annotations

import gc

import numpy as np

from perfbench import compare, corpus_content, trace
from perfbench.drivers import fit as F
from perfbench.reference import content_ref, stm_ref

F64 = stm_ref.Prec("float64")


class ContentFit:
    """The content fit under test and what the check needs of it."""

    def __init__(self, cell, seed: int, device: str, toy: bool):
        import torch

        from strutopy_tpu_torch import STM
        from strutopy_tpu_torch.ops.design import bspline_basis

        self.torch, self.device = torch, device
        self.cfg = F.stm_config(cell, toy)
        c = cell.config["corpus"]
        made = corpus_content.content_corpus(cell.config, seed, toy)
        docs, self.aspects = made["docs"], made["aspects"]
        V = corpus_content.sizes(cell.config, toy)["V"]
        # the user's covariates: rating, and s(day) as the program's spline
        X = np.c_[self.aspects.astype(np.float64), bspline_basis(made["day"], df=c["spline_df"])]
        self.model = STM(docs, [f"w{v}" for v in range(V)], K=self.cfg.K, X=X,
                         content=True, beta_index=self.aspects, config=self.cfg,
                         device=device)
        # the reference's inputs: the DGP's own design, compressed rows
        self.D = np.c_[np.ones(len(docs)), made["X"]]
        self.docs = stm_ref.Docs.of(docs)
        del docs, made
        gc.collect()
        self.wcounts = self.docs.word_counts(V)
        self.Xd = content_ref.kappa_design(self.cfg.K, self.cfg.A, self.cfg.kappa_interactions)
        self.N = self.model.N
        self.it = 0
        self.first = self.kept = None

    def sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def params(self, state=None) -> dict:
        """The fit's parameters through the model's public attributes (user
        order, float64 on the host); ``state`` is read in place of the
        model's own."""
        m = self.model
        own = m._state
        if state is not None:
            m._state = state
        try:
            out = {"beta": m.beta, "mu": m.mu, "eta": m.eta, "sigma": m.sigma,
                   "gamma": m.gamma, "kappa": m.kappa}
            bound = m.bound
        finally:
            m._state = own
        out = {k: np.asarray(v, np.float64) for k, v in out.items()}
        out["bound"] = bound
        return out

    def iterate(self):
        """One EM iteration: one call of ``expectation_maximization``; at
        the end of the fit's iterations, the kept state goes back first."""
        m = self.model
        if self.it == self.cfg.max_em_iter:
            m._state, self.it = self.kept, self.first
        m.config = self.cfg.replace(max_em_iter=self.it + 1)
        m.expectation_maximization(start_iter=self.it)
        self.it += 1

    def warm(self, iters: int):
        for _ in range(iters):
            self.iterate()
        self.first, self.kept = self.it, self.model._state

    def window(self, seconds: float, clock):
        """Iterations back to back until ``seconds`` have passed -> (the
        window's length, each iteration's wall, the last one's input and
        output states, kept without a copy)."""
        t_start = clock.now()
        walls = []
        while True:
            t0 = clock.now()
            prev = self.kept if self.it == self.cfg.max_em_iter else self.model._state
            self.iterate()
            t1 = clock.now()
            walls.append(t1 - t0)
            if t1 - t_start >= seconds:
                return t1 - t_start, walls, prev, self.model._state

    def judged(self, prev, state) -> list:
        """(prefix, inputs, outputs) of the iterations the check compares:
        ``prev`` -> ``state``."""
        return [("last.", self.params(prev), self.params(state))]

    def free(self):
        """Drop the program's fit (what the check needs stays)."""
        self.model = self.kept = None


def reference(fit, inputs: dict, prec, device, at=()):
    """The reference's EM iteration from ``inputs`` in ``prec`` -> (E-step
    dict, M-step dict); ``at``: etas to take the objective at."""
    e = content_ref.e_step(fit.docs, fit.aspects, inputs["beta"], inputs["mu"], inputs["eta"],
                           inputs["sigma"], prec, device=device, at=at)
    return e, content_ref.m_step(e, fit.D, fit.wcounts, fit.Xd, fit.cfg.kappa_l2, prec,
                                 kappa0=inputs["kappa"])


def as_outputs(e: dict, m: dict) -> dict:
    """A reference run's iteration in the program's place."""
    return {"eta": e["eta"], "beta": m["beta"], "sigma": m["sigma"], "gamma": m["gamma"],
            "kappa": m["kappa"], "bound": float(e["bound"].sum())}


def reference_numbers(fit, inputs: dict, outputs: list, device, prec=None) -> list:
    """Judge each of ``outputs`` (dicts of eta, beta, sigma, gamma, kappa,
    bound) as the iteration from ``inputs`` -> a list of number dicts;
    with ``prec`` (the control's precision) the control's own iteration
    is judged after them."""
    outputs = list(outputs)
    if prec is not None:
        outputs.append(as_outputs(*reference(fit, inputs, prec, device)))
    ref_e, ref_m = reference(fit, inputs, F64, device, at=[o["eta"] for o in outputs])
    out = []
    for f, o in zip(ref_e["f_at"], outputs):
        nums = compare.fit_numbers(f, ref_e, ref_m, o)
        gap = content_ref.kappa_gap(ref_m["problem"], o["kappa"], ref_m["kappa"],
                                    fit.cfg.kappa_l2)
        nums.update(content_ref.gap_numbers(gap))
        out.append(nums)
    return out


def setup(cell, seed: int, device: str, toy: bool) -> ContentFit:
    """The fit, built and warmed up as a run's set-up makes it."""
    fit = ContentFit(cell, seed, device, toy)
    fit.warm(cell.traffic["warm_iters"])
    return fit


def kappa_timings(fit, seconds: float, clock) -> list:
    """The content beta update alone (``m_step_beta``) on the statistics of
    an E-step from the fit's state, warm-started from its kappa: at least
    3 calls and ``seconds``, each ended by a synchronize."""
    import torch

    from strutopy_tpu_torch.models.em import local_estep_stats, m_step_beta

    m, dev = fit.model, fit.model._state.beta.device
    stats = local_estep_stats(m._state, m._data, fit.cfg, m._plan.batch_sizes)[0]
    kd = torch.as_tensor(fit.Xd, dtype=torch.float32, device=dev)
    wc = torch.as_tensor(fit.wcounts, dtype=torch.float32, device=dev)
    out, t_all = [], clock.now()
    while len(out) < 3 or clock.now() - t_all < seconds:
        t0 = clock.now()
        m_step_beta(stats.beta_ss, m._state.kappa, kd, wc, fit.cfg)
        fit.sync()
        out.append(clock.now() - t0)
    return out


def traced(fit, opts, walls: list, clock, say) -> dict:
    """The traced run's readings: one iteration recorded by the program
    (``trace.recording()``, no profiler), one under the profiler, and the
    beta update alone."""
    from strutopy_tpu_torch.utils import trace as program_trace
    from strutopy_tpu_torch.utils.precision import float32_matmul

    ctx = {"kind": "fit", "iter_walls": walls, "timings": {}, "kappa_shape": fit.Xd.shape}
    with float32_matmul():
        with program_trace.recording():
            fit.iterate()
        ctx["record"] = fit.model.trace[-1] if fit.model.trace else None
        if opts.device != "cpu":
            ctx["trace"] = trace.profile(fit.iterate, fit.sync)
        else:
            ctx["trace"] = None
            fit.iterate()
        ctx["timings"]["kappa"] = kappa_timings(fit, 0.3, clock)
    rec = ctx["record"]
    say(f"recorded iteration: {None if rec is None else rec.resolve().counters}")
    return ctx


def run(cell, opts, clock, say):
    import torch

    t0 = clock.now()
    fit = setup(cell, opts.seed, opts.device, opts.toy)
    m = fit.model
    say(f"set-up: to the first line {t0 - clock.start:.2f} s, corpus, fit and "
        f"{fit.it} warm-up iterations {clock.now() - t0:.2f} s; bounds {m.last_bounds}")
    t_start = clock.now()
    window, walls, prev, state = fit.window(opts.seconds, clock)
    bounds = m.last_bounds[-len(walls):]
    say(f"window: {len(walls)} iterations in {window:.4f} s, the last one iteration "
        f"{fit.it - 1}; walls {walls}")
    say(f"bounds {bounds}")
    result = {"setup_s": t_start - clock.start,
              "attempted": len(walls),
              "failed": int(sum(not np.isfinite(b) for b in bounds)),
              "e2e": {"fit_docs_per_s": fit.N * len(walls) / window}}
    if opts.trace:
        result["ctx"] = traced(fit, opts, walls, clock, say)
    if opts.device != "cpu":
        result["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    judged = fit.judged(prev, state)
    fit.free()
    del prev, state, m
    if opts.device != "cpu":
        torch.cuda.empty_cache()
    numbers, t_ref = {}, clock.now()
    for prefix, inputs, outputs in judged:
        nums = reference_numbers(fit, inputs, [outputs], opts.device)[0]
        numbers.update({prefix + k: v for k, v in nums.items()})
        say(f"reference {prefix}: {clock.now() - t_ref:.2f} s so far")
    result["numbers"] = numbers
    return result
