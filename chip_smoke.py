#!/usr/bin/env python3
"""Build, check and drive the PyTorch/CUDA port of the STM fit on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure is reported and the script exits non-zero at the
end, without the final result line):

  1. device: the card's name and power limit (nvidia-smi), then the
     stage kernels built from strutopy_tpu_torch/csrc with nvcc for
     sm_90a, with ptxas' register and shared-memory report;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card at the main path's shapes (B=256, K=100, L = the bench
     corpus's bucket width, T=12, 6 CG steps), bf16 on and off, then
     kernel and plain timed in turns with CUDA events; then the same
     checks at K=200 and K=400, the kernels' large-K branches;
  3. the CUDA fit against the CPU fit of the same small corpus from the
     same numpy beta (3 EM iterations, float32 Hessian);
  4. the main path at full width: the bench.py corpus recipe (K=100,
     V=10,000, N=8,192, 300 tokens a document) and configuration
     (batch 256, two-pass schedule with pass-1 cap 6 and straggler
     fraction 0.25), 2 cold and 3 two-pass EM iterations through
     ``STM.expectation_maximization``, with every kernel's launch count.

The last three lines of standard output are the card line, one JSON
object of per-kernel results, and ``{"ok": true, "device": {...}}``.
It needs torch built for CUDA and nvcc; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

K_BENCH, V_BENCH, N_BENCH, WORDS_BENCH = 100, 10_000, 8_192, 300
REPLACES = {
    "fgh": "strutopy_tpu/ops/pallas_stages.py:52",
    "cg": "strutopy_tpu/ops/pallas_stages.py:172",
    "ls": "strutopy_tpu/ops/pallas_stages.py:249",
}
SOURCE = "strutopy_tpu_torch/csrc/stages.cu"
# Kernel against plain on the card, element by element:
#     |kernel - plain| <= RTOL[output] * scale + allowance.
# ``scale`` is, per element, the sum of the magnitudes of the float32
# terms that make it up (f, g, H, the sweep); float32 sums of n terms in
# another order differ by at most ~n * 2^-24 of that sum, ~1e-6 in
# practice.  For the CG direction the scale is each document's
# max |x|: rounding anywhere in the 6 steps moves the whole direction.
# The bf16 Hessian may also differ by flipped bf16 roundings of the B·Bᵀ
# operand: one flip moves B_il by one ulp (<= 2^-7 of it) and H_ij by at
# most 2^-7 · max_l B_il · max_l B_jl, twice that on the diagonal.
# ``allowance`` admits two flipped operand entries in one H entry even on
# the diagonal, 2^-5 · max_l B_il · max_l B_jl.  Besides, the kernel's
# output must lie far closer to its own mode's plain version than the
# other bf16 mode's plain version does (DISCRIMINATE, in Frobenius norm
# over the chunk), so a kernel that rounds where it should not, or not
# where it should, fails.
RTOL = {"fgh.f": 1e-5, "fgh.g": 1e-5, "fgh.H": 1e-5, "cg": 1e-4, "ls": 1e-5}
BF16_FLIPS = 4 * 2.0 ** -7
DISCRIMINATE = 0.05
FIT_RTOL = 1e-4  # CUDA vs CPU bound per EM iteration (the f64-oracle invariant)


def make_corpus(K, V, N, n_words, seed=0):
    """bench.py's synthetic STM-DGP corpus recipe (bench.py:38-55)."""
    rng = np.random.default_rng(seed)
    beta_true = rng.dirichlet(np.full(V, 0.05), size=K)
    eta_true = rng.normal(0.0, 1.0, (N, K - 1))
    eta_full = np.concatenate([eta_true, np.zeros((N, 1))], axis=1)
    theta = np.exp(eta_full - eta_full.max(axis=1, keepdims=True))
    theta /= theta.sum(axis=1, keepdims=True)
    X = rng.integers(0, 2, N).astype(np.float64)
    p = theta @ beta_true
    docs = []
    for d in range(N):
        draw = rng.multinomial(n_words, p[d])
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    return docs, X


def random_beta(K, V, seed):
    g = np.random.RandomState(seed).gamma(0.1, 1.0, (K, V))
    return g / np.maximum(g.sum(axis=1, keepdims=True), 1e-300)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


class Failures(list):
    def check(self, ok: bool, what: str):
        print(("  ok   " if ok else "  FAIL ") + what, flush=True)
        if not ok:
            self.append(what)


def worst_ratio(got, want, bound):
    """(max |got - want|, max of |got - want| / bound over the elements)."""
    err = (got - want).abs()
    return float(err.max()), float((err / bound).max())


def time_pair(torch, kernel_fn, plain_fn, reps=20):
    """ms per call of kernel and plain, timed in turns (plain, kernel,
    kernel, plain) with CUDA events; the median of each side's rounds."""
    for _ in range(3):
        kernel_fn()
        plain_fn()
    torch.cuda.synchronize()
    times = {"kernel": [], "plain": []}
    for side in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        fn = kernel_fn if side == "kernel" else plain_fn
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times[side].append(start.elapsed_time(end) / reps)
    return float(np.median(times["kernel"])), float(np.median(times["plain"]))


def stage_inputs(torch, words, counts, K, seed, device="cuda"):
    """One chunk's Newton-stage inputs: a random beta gathered at
    ``words``, random eta and mu, siginv of a random SPD sigma."""
    from strutopy_tpu_torch.ops.estep import _gather_beta
    from strutopy_tpu_torch.ops.linalg import precompute_sigma

    dev = torch.device(device)
    B = words.shape[0]
    rng = np.random.default_rng(seed)
    beta = torch.tensor(random_beta(K, V_BENCH, seed), dtype=torch.float32, device=dev)
    bd = _gather_beta(beta, torch.as_tensor(words, device=dev))
    c = torch.as_tensor(counts, device=dev)
    eta = torch.tensor(rng.normal(0, 0.5, (B, K - 1)), dtype=torch.float32, device=dev)
    mu = torch.tensor(rng.normal(0, 0.3, (B, K - 1)), dtype=torch.float32, device=dev)
    A = rng.normal(0, 0.1, (K - 1, K - 1))
    sigma = torch.tensor(np.eye(K - 1) + A @ A.T, dtype=torch.float32, device=dev)
    siginv, _ = precompute_sigma(sigma)
    return eta, bd, c, mu, siginv


def f_scale(torch, cand, bd, c, mu, siginv):
    """Sum of |terms| of f at each candidate: cand (B, T, K-1) -> (B, T)."""
    B, T, _ = cand.shape
    full = torch.cat([cand, cand.new_zeros(B, T, 1)], dim=2)
    m = torch.amax(full, dim=2, keepdim=True)
    e = torch.exp(full - m)
    log_s = torch.log(torch.clamp_min(torch.bmm(e, bd), 1e-35)) + m
    ll = torch.sum(torch.where(c[:, None, :] > 0, c[:, None, :] * log_s.abs(), 0.0), dim=2)
    lse = m[:, :, 0] + torch.log(torch.sum(e, dim=2))
    diff = (cand - mu[:, None, :]).abs()
    quad = 0.5 * torch.sum(diff * (diff @ siginv.abs()), dim=2)
    return quad + ll + torch.sum(c, dim=1)[:, None] * lse.abs()


def gh_scales(torch, stages, eta, bd, c, mu, siginv):
    """Sums of |terms| of g (B, K-1) and H (B, K-1, K-1), and the largest
    B·Bᵀ operand entry of each topic, max_l B_il (B, K-1)."""
    K = bd.shape[1]
    Nd = torch.sum(c, dim=1)
    *_, theta, phi = stages.f_g_H_batched(eta, bd, c, mu, siginv, Nd, False)
    Bm = phi * torch.sqrt(c)[:, None, :]
    q = torch.sum(phi * c[:, None, :], dim=2)
    nt = Nd[:, None] * theta
    g = (eta - mu).abs() @ siginv.abs() + (nt + q)[:, :-1]
    H = (torch.bmm(Bm, Bm.transpose(1, 2)) + nt[:, :, None] * theta[:, None, :]
         + torch.diag_embed(nt + q))[:, :K - 1, :K - 1] + siginv.abs()
    return g, H, torch.amax(Bm, dim=2)[:, :K - 1]


def plain_outputs(torch, stages, inputs, bf16):
    """The plain versions' outputs of one Newton step on a chunk, with the
    inputs the kernels take for cg and the sweep (the plain H and g, and
    the direction p), and the other bf16 mode's H and CG direction."""
    eta, bd, c, mu, siginv = inputs
    ts = torch.exp2(-torch.arange(12, dtype=torch.float32, device=eta.device))
    iters = min(6, bd.shape[1] - 1)
    f, g, H = stages.fgh_plain(eta, bd, c, mu, siginv, bf16=bf16)
    x = stages.cg_plain(H, g, iters, bf16=bf16)
    p = torch.where((torch.sum(g * x, 1) >= 0)[:, None], -g, x).contiguous()
    fs = stages.linesearch_plain(eta, p, ts, bd, c, mu, siginv)
    other = {"fgh.H": stages.fgh_plain(eta, bd, c, mu, siginv, bf16=not bf16)[2],
             "cg": stages.cg_plain(H, g, iters, bf16=not bf16)}
    return ({"fgh.f": f, "fgh.g": g, "fgh.H": H, "cg": x, "ls": fs},
            dict(g=g, H=H, p=p, ts=ts, iters=iters, other=other))


def kernel_outputs(stages, inputs, aux, bf16):
    """The kernels' outputs on the same chunk; cg and the sweep take the
    plain H, g and p, so each kernel's own error is measured."""
    eta, bd, c, mu, siginv = inputs
    f, g, H = stages.fgh(eta, bd, c, mu, siginv, bf16=bf16)
    x = stages.cg(aux["H"], aux["g"], aux["iters"], bf16=bf16)
    fs = stages.linesearch(eta, aux["p"], aux["ts"], bd, c, mu, siginv)
    return {"fgh.f": f, "fgh.g": g, "fgh.H": H, "cg": x, "ls": fs}


def judge(torch, stages, inputs, got, want, aux, bf16):
    """Per output: (max abs error, worst error / bound over its elements,
    every value finite).  Passing means worst <= 1 and finite.  For H and
    cg the worst also covers the DISCRIMINATE check (as its ratio)."""
    eta, bd, c, mu, siginv = inputs
    f_sc = f_scale(torch, eta[:, None, :], bd, c, mu, siginv)[:, 0]
    fs_sc = f_scale(torch, eta[:, None, :] + aux["ts"][None, :, None] * aux["p"][:, None, :],
                    bd, c, mu, siginv)
    g_sc, H_sc, u = gh_scales(torch, stages, eta, bd, c, mu, siginv)
    x_sc = torch.amax(want["cg"].abs(), dim=1, keepdim=True)
    H_bound = RTOL["fgh.H"] * H_sc
    if bf16:
        H_bound = H_bound + BF16_FLIPS * u[:, :, None] * u[:, None, :]
    bounds = {"fgh.f": RTOL["fgh.f"] * f_sc, "fgh.g": RTOL["fgh.g"] * g_sc,
              "fgh.H": H_bound, "cg": RTOL["cg"] * torch.clamp_min(x_sc, 1e-30),
              "ls": RTOL["ls"] * fs_sc}
    out = {}
    for name, bound in bounds.items():
        abs_e, worst = worst_ratio(got[name], want[name], bound)
        if name in aux["other"]:
            gap = float(torch.linalg.vector_norm(aux["other"][name] - want[name]))
            err = float(torch.linalg.vector_norm(got[name] - want[name]))
            worst = max(worst, err / max(DISCRIMINATE * gap, 1e-30))
        out[name] = (abs_e, worst, bool(torch.isfinite(got[name]).all()))
    return out


def check_stages(torch, stages, fails, inputs, label):
    """Each kernel against its plain version on one chunk, bf16 off and
    on.  Returns each kernel's max abs error (bf16 on) and the plain
    inputs the timing reuses."""
    for bf16 in (False, True):
        want, aux = plain_outputs(torch, stages, inputs, bf16)
        got = kernel_outputs(stages, inputs, aux, bf16)
        torch.cuda.synchronize()
        errs = judge(torch, stages, inputs, got, want, aux, bf16)
        for name, (abs_e, worst, finite) in errs.items():
            fails.check(finite and worst <= 1.0,
                        f"{label} {name} bf16={bf16}: max_abs_err={abs_e:.3e}, "
                        f"worst error/bound={worst:.3e} (must be <= 1)")
    max_abs = {"fgh": max(errs[k][0] for k in ("fgh.f", "fgh.g", "fgh.H")),
               "cg": errs["cg"][0], "ls": errs["ls"][0]}
    return max_abs, aux


def phase_kernels(torch, stages, fails, words, counts, K, seed=1):
    """Phase 2: kernels against plain versions at the main path's shapes,
    then timed in turns."""
    inputs = stage_inputs(torch, words, counts, K, seed)
    eta, bd, c, mu, siginv = inputs
    B, L = words.shape
    print(f"phase 2: kernels vs plain, B={B} K={K} L={L} T=12 cg={min(6, K - 1)}")
    max_abs, aux = check_stages(torch, stages, fails, inputs, f"K={K}")
    g0, H0, p, ts, cg_iters = (aux[k] for k in ("g", "H", "p", "ts", "iters"))
    results = {k: {"max_abs_err": v} for k, v in max_abs.items()}

    ms, pms = time_pair(torch, lambda: stages.fgh(eta, bd, c, mu, siginv, bf16=True),
                        lambda: stages.fgh_plain(eta, bd, c, mu, siginv, bf16=True))
    results["fgh"].update(ms=ms, plain_ms=pms)
    ms, pms = time_pair(torch, lambda: stages.cg(H0, g0, cg_iters, bf16=True),
                        lambda: stages.cg_plain(H0, g0, cg_iters, bf16=True))
    results["cg"].update(ms=ms, plain_ms=pms)
    ms, pms = time_pair(torch, lambda: stages.linesearch(eta, p, ts, bd, c, mu, siginv),
                        lambda: stages.linesearch_plain(eta, p, ts, bd, c, mu, siginv))
    results["ls"].update(ms=ms, plain_ms=pms)
    for name, r in results.items():
        print(f"  time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms "
              f"(bf16 on, median of 3 rounds of 20)")
    return results


def phase_widths(torch, stages, fails, B=32, L=256):
    """Phase 2b: the same checks at K=200 and K=400, where the kernels take
    their other branches — shared memory above the 48 KB default, and cg's
    Hessian and ls's siginv read from L2 once they no longer fit (K=400)."""
    rng = np.random.default_rng(5)
    words = np.stack([rng.choice(V_BENCH, L, replace=False) for _ in range(B)]).astype(np.int32)
    counts = np.zeros((B, L), np.float32)
    counts[:, :200] = rng.integers(1, 5, (B, 200))
    for K in (200, 400):
        print(f"phase 2b: kernels vs plain, B={B} K={K} L={L}")
        check_stages(torch, stages, fails, stage_inputs(torch, words, counts, K, seed=K),
                     f"K={K}")


def phase_small_fit(torch, fails):
    """Phase 3: the CUDA fit against the CPU fit of one small corpus."""
    from strutopy_tpu_torch import STM, STMConfig

    K, V, N = 10, 2000, 512
    docs, X = make_corpus(K, V, N, 100, seed=3)
    beta0 = random_beta(K, V, seed=7)
    cfg = STMConfig(K=K, init_type="random", max_em_iter=3, convergence_threshold=0.0,
                    newton_bf16_hessian=False, batch_size=128)
    bounds = {}
    for dev in ("cpu", "cuda"):
        m = STM(docs, K=K, X=X, config=cfg, init_beta=beta0, device=dev)
        m.expectation_maximization()
        bounds[dev] = np.asarray(m.last_bounds)
    rel = np.abs(bounds["cuda"] - bounds["cpu"]) / np.abs(bounds["cpu"])
    print(f"phase 3: K={K} V={V} N={N}, bounds cpu {bounds['cpu'].tolist()}")
    print(f"         bounds cuda {bounds['cuda'].tolist()}")
    fails.check(bool(np.all(np.isfinite(bounds["cuda"]))) and float(rel.max()) <= FIT_RTOL,
                f"CUDA fit vs CPU fit: max rel bound diff {rel.max():.3e} (tol {FIT_RTOL:.0e})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    t_start = time.time()
    from strutopy_tpu_torch import STM, STMConfig
    from strutopy_tpu_torch.corpus.bow import pad_corpus
    from strutopy_tpu_torch.corpus.bucketing import make_bucket_plan, split_corpus_by_plan
    from strutopy_tpu_torch.ops import build, stages

    fails = Failures()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"phase 1: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s)")
    t0 = time.time()
    lib_path = build.build()
    build.load()
    print(f"  built {lib_path.name} in {time.time() - t0:.1f} s; ptxas:")
    print("\n".join("    " + ln for ln in build.ptxas_report().strip().splitlines()))

    t0 = time.time()
    docs, X = make_corpus(K_BENCH, V_BENCH, N_BENCH, WORDS_BENCH)
    corpus = pad_corpus(docs, V=V_BENCH)
    plan = make_bucket_plan(corpus, 256)
    buckets = split_corpus_by_plan(corpus, plan)
    big = max(range(plan.n_buckets), key=lambda b: len(plan.doc_ids[b]))
    print(f"bench corpus in {time.time() - t0:.1f} s: buckets L={plan.Ls} "
          f"docs={[len(i) for i in plan.doc_ids]} batch={plan.batch_sizes}")

    kernels = phase_kernels(torch, stages, fails, buckets[big].words[:256],
                            buckets[big].counts[:256], K_BENCH)
    phase_widths(torch, stages, fails)
    phase_small_fit(torch, fails)

    # ----- phase 4: the main path at full width -----
    cfg = STMConfig(K=K_BENCH, init_type="random", batch_size=256, newton_pass1_iters=6,
                    newton_straggler_frac=0.25, max_em_iter=5, convergence_threshold=0.0)
    t0 = time.time()
    model = STM(docs, K=K_BENCH, X=X, config=cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"phase 4: K={K_BENCH} V={V_BENCH} N={N_BENCH}, STM built in "
          f"{time.time() - t0:.1f} s; {card}")
    for k in stages.LAUNCHES:
        stages.LAUNCHES[k] = 0
    model.expectation_maximization()
    launches = dict(stages.LAUNCHES)
    for it, (b, s) in enumerate(zip(model.last_bounds, model.iter_seconds)):
        kind = "cold" if it < cfg.newton_warmup_iters else "two-pass"
        print(f"  EM {it} ({kind}): bound {b:.6f}, {s:.4f} s, {model.N / s:.1f} docs/s "
              f"[{card}]")
    print(f"  straggler overflow (last iteration): {model.straggler_overflow}; "
          f"launches {launches}")
    fails.check(len(model.last_bounds) == 5 and bool(np.all(np.isfinite(model.last_bounds))),
                f"{len(model.last_bounds)} EM iterations, every bound finite")
    for k in ("fgh", "cg", "ls"):
        fails.check(launches[k] > 0, f"main path launched {k} {launches[k]} times")
    theta, beta = model.theta, model.beta
    fails.check(theta.shape == (N_BENCH, K_BENCH) and beta.shape == (K_BENCH, V_BENCH)
                and bool(np.isfinite(theta).all() and np.isfinite(beta).all())
                and np.allclose(theta.sum(1), 1, atol=1e-4)
                and np.allclose(beta.sum(1), 1, atol=1e-4),
                "theta (N, K) and beta (K, V) finite, rows on the simplex")

    print(f"total {time.time() - t_start:.1f} s")
    if fails:
        print(f"chip_smoke: {len(fails)} check(s) failed: {fails}", file=sys.stderr)
        return 1
    print(card_line())
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": kernels[k]["max_abs_err"],
         "ms": kernels[k]["ms"], "plain_ms": kernels[k]["plain_ms"]}
        for k in ("fgh", "cg", "ls")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
