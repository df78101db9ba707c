"""Driver ``fit``: steady EM iterations of an STM fit, back to back.

Set-up makes the corpus and the initial beta from the seed, builds the
fit as a user does (``STM(docs, K=, X=, config=, init_beta=)``: length
buckets, prevalence design, state, EM step) and runs the traffic's
``warm_iters`` EM iterations.  Every iteration, in set-up and in the
window, is one call of the user's entry point,
``STM.expectation_maximization(start_iter=it)`` with the configuration's
``max_em_iter`` at ``it + 1``: the step (single-pass for the
configuration's ``newton_warmup_iters``, then the two-pass schedule), a
synchronize, and the bound and the straggler overflow read to the host.

``correct`` judges, against the float64 reference:

* ``init.``: the state the fit starts from, read back through the
  model's public attributes, against stm's start for the benchmark's
  initial beta (its rows normalized, eta = mu = 0, sigma = 20 I);
* ``last.``: the window's last iteration, from the program's state
  before it: the reference follows the program step by step, and the
  window's iterations are all the same step.

The cold iterations of set-up (single-pass, from eta = 0 and sigma =
20 I) are not judged: there the program's Newton solve leaves some
documents far above their optimum on every seed (``PERF.md``, Open
questions).
"""

from __future__ import annotations

import gc

import numpy as np

from perfbench import compare, corpus, trace
from perfbench.reference import stm_ref

NEWTON = ("fgh", "cg", "linesearch")


def stm_config(cell, toy: bool):
    from strutopy_tpu_torch.models.config import STMConfig

    fields = dict(cell.config["stm"])
    if toy:
        fields.update(cell.config["toy"].get("stm", {}))
    return STMConfig(K=corpus.sizes(cell.config, toy)["K"], **fields)


class Fit:
    """The fit under test and what the check needs of it."""

    def __init__(self, cell, seed: int, device: str, toy: bool):
        import torch

        from strutopy_tpu_torch import STM

        self.torch, self.device = torch, device
        self.cfg = stm_config(cell, toy)
        if self.cfg.content or not self.cfg.lda_beta:
            raise ValueError("the reference has the LDA beta's M-step only")
        K = self.cfg.K
        docs, X = corpus.fit_corpus(cell.config, seed, toy)
        V = corpus.sizes(cell.config, toy)["V"]
        beta0 = corpus.random_beta(K, V, seed)
        self.start = stm_ref.start(beta0, len(docs))
        self.model = STM(docs, [f"w{v}" for v in range(V)], K=K, X=X, config=self.cfg,
                         init_beta=beta0, device=device)
        self.D = np.c_[np.ones(len(docs)), X]
        # the reference's copy of the corpus, in compressed rows: the lists
        # of tuples go, so no garbage collection walks them in the window
        self.docs = stm_ref.Docs.of(docs)
        del docs
        gc.collect()
        self.N = self.model.N
        self.it = 0
        self.started = self.params()

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
                   "gamma": m.gamma}
            bound = m.bound
        finally:
            m._state = own
        out = {k: np.asarray(v, np.float64) for k, v in out.items()}
        out["bound"] = bound
        return out

    def iterate(self):
        """One EM iteration: one call of ``expectation_maximization``."""
        m = self.model
        m.config = self.cfg.replace(max_em_iter=self.it + 1)
        m.expectation_maximization(start_iter=self.it)
        self.it += 1

    def warm(self, iters: int):
        for _ in range(iters):
            self.iterate()

    def window(self, seconds: float, clock):
        """Iterations back to back until ``seconds`` have passed -> (the
        window's length, each iteration's wall, the last one's input and
        output states, kept without a copy)."""
        t_start = clock.now()
        walls = []
        while True:
            t0 = clock.now()
            prev = self.model._state
            self.iterate()
            t1 = clock.now()
            walls.append(t1 - t0)
            if t1 - t_start >= seconds:
                return t1 - t_start, walls, prev, self.model._state

    def judged(self, prev, state) -> list:
        """(prefix, inputs, outputs) of the iterations the check compares:
        ``prev`` -> ``state``."""
        return [("last.", self.params(prev), self.params(state))]

    def ref_mstep(self, est: dict) -> dict:
        return stm_ref.m_step_lda_ols(est, self.D)

    def free(self):
        """Drop the program's fit (what the check needs stays)."""
        self.model = self.started = None


def reference_numbers(fit, inputs: dict, outputs: list, device, prec=None):
    """Run the reference over one EM iteration of ``fit``'s corpus from
    ``inputs`` (beta, mu, eta, sigma) and judge each of ``outputs`` (dicts
    of eta, beta, sigma, gamma, bound) -> a list of number dicts.  With
    ``prec`` (the control's precision) the control's own iteration is
    judged after them."""
    docs = fit.docs

    def iteration(p, at=()):
        e = stm_ref.e_step(docs, inputs["beta"], inputs["mu"], inputs["eta"],
                           inputs["sigma"], p, device=device, at=at)
        return e, fit.ref_mstep(e)

    ref_e, ref_m = iteration(stm_ref.Prec("float64"), [o["eta"] for o in outputs])
    out = [compare.fit_numbers(f, ref_e, ref_m, o) for f, o in zip(ref_e["f_at"], outputs)]
    if prec is not None:
        ctl, m = iteration(prec)
        f = stm_ref.objective_at(docs, inputs["beta"], inputs["mu"], inputs["sigma"],
                                 ctl["eta"], device=device)
        out.append(compare.fit_numbers(f, ref_e, ref_m, {
            "eta": ctl["eta"], "beta": m["beta"], "sigma": m["sigma"], "gamma": m["gamma"],
            "bound": float(ctl["bound"].sum())}))
    return out


def setup(cell, seed: int, device: str, toy: bool) -> Fit:
    """The fit, built and warmed up as a run's set-up makes it."""
    fit = Fit(cell, seed, device, toy)
    fit.warm(cell.traffic["warm_iters"])
    return fit


def run(cell, opts, clock, say):
    import torch

    from strutopy_tpu_torch.models.em import local_estep_stats, m_step_beta
    from strutopy_tpu_torch.ops import estep, stages
    from strutopy_tpu_torch.utils.precision import float32_matmul

    t0 = clock.now()
    fit = setup(cell, opts.seed, opts.device, opts.toy)
    m = fit.model
    say(f"set-up: to the first line {t0 - clock.start:.2f} s, corpus, fit and "
        f"{fit.it} warm-up iterations {clock.now() - t0:.2f} s; bounds {m.last_bounds}")
    t_start = clock.now()
    window, walls, prev, state = fit.window(opts.seconds, clock)
    bounds = m.last_bounds[-len(walls):]
    say(f"window: {len(walls)} iterations in {window:.4f} s; walls {walls}")
    say(f"bounds {bounds}; straggler overflow of the last {m.straggler_overflow}")
    result = {"setup_s": t_start - clock.start,
              "attempted": len(walls),
              "failed": int(sum(not np.isfinite(b) for b in bounds)),
              "e2e": {"fit_docs_per_s": fit.N * len(walls) / window}}

    if opts.trace:
        ctx = {"kind": "fit", "iter_walls": walls, "calls": [], "timings": {}}
        with float32_matmul():
            calls: list = []
            with trace.recorded_calls(stages, NEWTON, calls), \
                    trace.recorded_calls(estep, ("_finalize_chunk",), calls):
                before = dict(stages.LAUNCHES)
                ctx["trace"] = trace.profile(fit.iterate, fit.sync) if opts.device != "cpu" else None
                if ctx["trace"] is None:
                    fit.iterate()
                launched = {k: stages.LAUNCHES[k] - before[k] for k in ("fgh", "cg", "ls")}
            ctx["calls"] = calls
            say(f"profiled iteration: launches {launched}, recorded "
                f"{ {n: sum(c[0] == n for c in calls) for n in NEWTON + ('_finalize_chunk',)} }")
            # the E-step and the M-step's beta update alone, from the state
            # the profiled iteration left
            es, t_es = [], clock.now()
            while len(es) < 3 or clock.now() - t_es < 1.0:
                t0 = clock.now()
                stats = local_estep_stats(m._state, m._data, fit.cfg, m._plan.batch_sizes)[0]
                float(stats.bound)
                es.append(clock.now() - t0)
            ms, t_ms = [], clock.now()
            while len(ms) < 3 or clock.now() - t_ms < 0.3:
                t0 = clock.now()
                m_step_beta(stats.beta_ss, m._state.kappa, None, None, fit.cfg)
                fit.sync()
                ms.append(clock.now() - t0)
            ctx["timings"] = {"estep": es, "mstep": ms}
        result["ctx"] = ctx

    if opts.device != "cpu":
        result["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    # what is judged, on the host; then the program's state is freed
    started, judged = fit.started, fit.judged(prev, state)
    fit.free()
    del prev, state, m
    if opts.device != "cpu":
        torch.cuda.empty_cache()
    numbers = {"init." + k: v for k, v in compare.start_numbers(fit.start, started).items()}
    t_ref = clock.now()
    for prefix, inputs, outputs in judged:
        nums = reference_numbers(fit, inputs, [outputs], opts.device)[0]
        numbers.update({prefix + k: v for k, v in nums.items()})
        say(f"reference {prefix}: {clock.now() - t_ref:.2f} s so far")
    result["numbers"] = numbers
    return result
