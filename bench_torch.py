#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: E-step docs/s on one NVIDIA
GPU at K=100, V=10k (the twin of bench.py).

Prints ONE JSON line on standard output:
  {"metric": "estep_docs_per_sec_K100_V10k", "value": N, "unit": "docs/s",
   "vs_baseline": ratio}

``value`` is N / the median wall of 5 calls of
``strutopy_tpu_torch.models.em.local_estep_stats`` over the whole corpus
(the chunked E-step: beta_doc gather, the Newton solve on the CUDA
kernels B1-B3, the finalize and the phi scatter), each wall ending when
the summed bound is read to the host.  The corpus is bench.py's recipe
(K=100, V=10,000, N=8,192 synthetic STM-DGP documents of 300 tokens,
``make_corpus``) and the configuration bench.py's (batch 256, two-pass
with pass-1 cap 6 and straggler fraction 0.25, random init).  The state
is steady: 5 EM iterations through ``make_em_step``, two-pass from the
first, run before, so eta is warm-started and beta, sigma and mu fitted.

The random beta is drawn by torch from a CPU generator (seed 123456):
its bits are the same on every machine, but they are not ``jax.random``'s,
so this script's states are not bench.py's.

The baseline is the reference-equivalent serial float64 E-step
(``strutopy_tpu_torch/utils/reference_numpy.py``: one scipy BFGS a
document) on the first 512 documents, measured on this machine's CPU and
cached in ``.bench_baseline_torch.json`` beside this script under the
configuration and the CPU's name, so a rate from one CPU never stands for
another's.

Everything else goes to standard error: the card's name and power limit,
the 5 walls with their median and spread, the largest gap between their
bounds, the warm-up bounds and straggler overflow, the launches of B1-B3
and the two glue kernels during the timed calls, and the baseline with
its CPU.

    python3 bench_torch.py [--device cuda|cpu]
    python -m strutopy_tpu_torch.cli bench

``--device cuda`` (the default) exits non-zero where no CUDA device is
present; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

K = 100
V = 10_000
N = 8_192
N_WORDS = 300  # tokens per doc (~150 unique terms)
BASELINE_DOCS = 512
WARM_ITERS = 5
REPEATS = 5
BETA_SEED = 123456
METRIC = "estep_docs_per_sec_K100_V10k"
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ".bench_baseline_torch.json")
NEWTON_KERNELS = ("fgh", "cg", "ls", "direction", "accept")  # B1-B3 and the step's glue


def make_corpus(K=K, V=V, N=N, n_words=N_WORDS, seed=0, return_beta=False):
    """bench.py's synthetic STM-DGP corpus (bench.py:38-55), the same
    documents and X bit for bit; with ``return_beta`` also the true beta
    (K, V) the documents come from."""
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
    return (docs, X, beta_true) if return_beta else (docs, X)


def cpu_name() -> str:
    """The host CPU as /proc/cpuinfo names it: its model name, with its
    vendor, family and model numbers where the name is not given, and
    the count of processors."""
    info, n = {}, 0
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key, value = key.strip(), value.strip()
                n += key == "processor"
                info.setdefault(key, value)
    except OSError:
        return "CPU not named (no /proc/cpuinfo)"
    name = info.get("model name", "unknown")
    if name in ("", "unknown"):
        name = (f"model name {name!r}, {info.get('vendor_id', '?')} family "
                f"{info.get('cpu family', '?')} model {info.get('model', '?')}")
    return f"{name}, {n} processors"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def warm_up(docs, X, *, K=K, V=V, iters=WARM_ITERS, beta_init=None, device="cuda"):
    """bench.py's set-up (bench.py:62-90) in the port: the padded corpus
    as one length bucket, the configuration, the prevalence design, the
    state (beta drawn from ``torch.Generator("cpu")`` seeded 123456, or
    ``beta_init`` (K, V)) and ``iters`` EM iterations of ``make_em_step``.

    Returns (cfg, state, data, warm-up bounds, the last iteration's
    straggler overflow)."""
    import torch

    from strutopy_tpu_torch.corpus.bow import pad_corpus
    from strutopy_tpu_torch.models.config import STMConfig
    from strutopy_tpu_torch.models.em import CorpusData, make_em_step
    from strutopy_tpu_torch.models.state import init_state
    from strutopy_tpu_torch.ops.mstep import make_prevalence_design
    from strutopy_tpu_torch.utils.precision import float32_matmul

    corpus = pad_corpus(docs, V=V)
    cfg = STMConfig(K=K, model_type="STM", mode="ols", init_type="random",
                    batch_size=256, newton_pass1_iters=6, newton_straggler_frac=0.25)
    D_np, design = make_prevalence_design(X, corpus.doc_ok, device=device)
    data = CorpusData.single(
        words=torch.as_tensor(corpus.words, device=device),
        counts=torch.as_tensor(corpus.counts, device=device),
        aspects=torch.zeros(corpus.N, dtype=torch.int32, device=device),
        doc_ok=torch.as_tensor(corpus.doc_ok, device=device),
        D=torch.as_tensor(D_np, dtype=torch.float32, device=device),
    )
    generator = None if beta_init is not None else torch.Generator("cpu").manual_seed(BETA_SEED)
    state = init_state(generator, K, V, corpus.N, D_np.shape[1], beta_init=beta_init,
                       device=device)
    em = make_em_step(cfg, design, None, corpus.word_counts())
    bounds = []
    with float32_matmul():
        for _ in range(iters):
            state = em(state, data)
            bounds.append(state.bound.item())
    return cfg, state, data, bounds, int(state.straggler_overflow.item())


def time_estep(state, data, cfg, repeats=REPEATS):
    """One untimed call of ``local_estep_stats`` (the twin of bench.py's
    compile call), then ``repeats`` timed calls from the same state (the
    function is pure), each wall ending when the bound is read to the
    host.  Returns a dict: docs_per_sec (N / median wall), walls, bounds,
    bound_gap (the largest relative gap between the calls' bounds: 0,
    the E-step being a function of its inputs) and the launches
    of B1-B3 and the two glue kernels during the timed calls."""
    from strutopy_tpu_torch.models.em import local_estep_stats
    from strutopy_tpu_torch.ops import stages
    from strutopy_tpu_torch.utils.precision import float32_matmul

    n_docs = state.eta.shape[0]
    walls, bounds = [], []
    with float32_matmul():
        local_estep_stats(state, data, cfg)[0].bound.item()
        before = {k: stages.LAUNCHES[k] for k in NEWTON_KERNELS}
        for _ in range(repeats):
            t0 = time.perf_counter()
            bounds.append(local_estep_stats(state, data, cfg)[0].bound.item())
            walls.append(time.perf_counter() - t0)
        launches = {k: stages.LAUNCHES[k] - before[k] for k in NEWTON_KERNELS}
    median = float(np.median(walls))
    b = np.asarray(bounds)
    return {"docs_per_sec": n_docs / median, "walls": walls, "median": median,
            "bounds": bounds, "bound_gap": float((b.max() - b.min()) / abs(np.median(b))),
            "launches": launches}


def measure_card(docs, X, device="cuda", *, K=K, V=V, beta_init=None):
    """The twin of bench.py's ``measure_tpu``: the warm-up, then the
    timed E-step.  Returns ``time_estep``'s dict with the warm-up bounds
    and overflow."""
    cfg, state, data, warm, overflow = warm_up(docs, X, K=K, V=V, beta_init=beta_init,
                                               device=device)
    return dict(time_estep(state, data, cfg), warm_bounds=warm, overflow=overflow)


def measure_baseline(docs, X, path=BASELINE_PATH, *, K=K, V=V, n_words=N_WORDS,
                     n_docs=BASELINE_DOCS):
    """The reference-equivalent serial float64 E-step on the first
    ``n_docs`` documents (bench.py:108-140), on this machine's CPU: one
    warm ``e_step`` and ``m_step_ctm_lda``, then the best of 3 timed
    ``e_step`` calls.  Cached in ``path`` under [K, V, n_words] and
    ``cpu_name()``; measured again when either differs.

    Returns (docs_per_sec, the CPU's name, whether it came from the cache)."""
    cpu = cpu_name()
    if os.path.exists(path):
        with open(path) as f:
            cached = json.load(f)
        if cached.get("config") == [K, V, n_words] and cached.get("cpu") == cpu:
            return cached["docs_per_sec"], cpu, True

    from strutopy_tpu_torch.utils import reference_numpy as ref

    sub = docs[:n_docs]
    g = np.random.RandomState(BETA_SEED).gamma(0.1, 1.0, (K, V))
    beta = g / g.sum(axis=1, keepdims=True)
    n = len(sub)
    mu = np.zeros((n, K - 1))
    eta = np.zeros((n, K - 1))
    sigma = 20.0 * np.eye(K - 1)

    beta_ss, sigma_ss, _, eta, _ = ref.e_step(sub, beta, mu, eta, sigma)
    beta, mu, sigma = ref.m_step_ctm_lda(beta_ss, sigma_ss, eta, n)

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        ref.e_step(sub, beta, mu, eta, sigma)
        times.append(time.perf_counter() - t0)
    dps = n / min(times)
    with open(path, "w") as f:
        json.dump({"config": [K, V, n_words], "cpu": cpu, "docs_per_sec": dps,
                   "measured_docs": n, "seconds_per_repeat": times}, f, indent=2)
    return dps, cpu, False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_torch.py", description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the E-step runs (default: cuda)")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch.py: --device cuda asked for, and no CUDA device is "
                         "present (torch.cuda.is_available() is False)")

    def say(msg):
        print(msg, file=sys.stderr, flush=True)

    where = card_line() if args.device == "cuda" else "cpu"
    say(f"device: {where}; torch {torch.__version__}")
    docs, X = make_corpus()
    card = measure_card(docs, X, args.device)
    say(f"warm-up bounds: {card['warm_bounds']}")
    say(f"straggler overflow (last warm-up iteration): {card['overflow']}")
    say(f"walls (s): {card['walls']}")
    say(f"median {card['median']:.6f} s, spread {max(card['walls']) - min(card['walls']):.6f} s "
        f"(max - min); {card['docs_per_sec']:.1f} docs/s [{where}]")
    say(f"bounds: {card['bounds']}; largest relative gap {card['bound_gap']:.3e}")
    say(f"launches during the timed calls: {json.dumps(card['launches'])}")
    base, cpu, cached = measure_baseline(docs, X)
    say(f"baseline: {base!r} docs/s on {cpu} "
        f"({'from the cache' if cached else 'measured'}, {BASELINE_PATH})")
    dps = card["docs_per_sec"]
    print(json.dumps({"metric": METRIC, "value": round(dps, 1), "unit": "docs/s",
                      "vs_baseline": round(dps / base, 2)}))  # bench.py:145-150
    return 0


if __name__ == "__main__":
    sys.exit(main())
