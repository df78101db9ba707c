#!/usr/bin/env python3
"""Device-time breakdown of one steady EM iteration of the PyTorch port.

Run from the root of a checkout, on one CUDA card:

    python3 profile_torch.py [--trace build/profile/em_iter_trace.json] [--bf16-beta]

Fits the bench.py cell (``chip_smoke.make_corpus``: K=100, V=10,000,
N=8,192 documents of 300 tokens; batch 256, two-pass schedule with
pass-1 cap 6 and straggler fraction 0.25, random init) for 7 EM
iterations (2 cold, 5 two-pass), then runs one more two-pass
iteration under ``torch.profiler`` and prints:

  * the wall time of every iteration, the profiled one apart (the
    profiler slows the host, not the card);
  * the device time of the profiled iteration by kernel group, with each
    group's launches, from the kernel and memcpy/memset events of the
    exported chrome trace;
  * the busy share: the union of those events' intervals over the
    profiled iteration's wall time.

The chrome trace stays at ``--trace`` for a closer look.  With
``--bf16-beta`` the fit runs with ``newton_bf16_beta=True``: the Newton
search reads beta_doc in bf16, so B1 and B3 launch their bf16-beta_doc
modes (grouped apart, with their launches).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import chip_smoke

# kernel-name fragments (lower case) -> group, first match wins
GROUPS = (
    ("fgh kernel (B1)", ("fgh_kernel",)),
    ("ls kernel (B3)", ("ls_kernel",)),
    ("cg kernel (B2)", ("cg_kernel",)),
    ("newton kernel (B4 and B5)", ("newton_kernel",)),
    ("Cholesky / cholesky_inverse", ("potrf", "trsm", "magma", "cholesky", "zdisplace",
                                     "syrk", "trmm", "lauum", "cusolver")),
    ("gemm / bmm (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas")),
    ("ordered phi scatter", ("scatter_phi_kernel",)),
    ("sorts, searchsorted (the scatter's plan, the straggler budget)", ("sort", "searchsorted")),
    ("gather / scatter / index", ("index", "gather", "scatter")),
    ("reductions", ("reduce_kernel",)),
)
WARM = 7  # EM iterations before the profiled one
OTHER = "other elementwise (Newton-loop glue, finalize math)"
COPIES = "memcpy / memset"


BETA_GROUPS = ("fgh kernel (B1)", "ls kernel (B3)", "newton kernel (B4 and B5)")


def group_of(event: dict) -> str:
    if event["cat"] != "kernel":
        return COPIES
    name = event["name"].lower()
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            # a bf16 beta_doc's instantiation (newton_bf16_beta) apart
            return group + ", bf16 beta_doc" if group in BETA_GROUPS and "bfloat16" in name \
                else group
    return OTHER


def busy_us(events) -> float:
    """Length of the union of the events' [ts, ts + dur] intervals."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default="build/profile/em_iter_trace.json",
                    help="where the chrome trace of the profiled iteration goes")
    ap.add_argument("--bf16-beta", action="store_true",
                    help="fit with newton_bf16_beta=True (the Newton search on a bf16 beta_doc)")
    return ap.parse_args(argv)


def main() -> int:
    args = parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 2
    from strutopy_tpu_torch import STM, STMConfig
    from strutopy_tpu_torch.ops import stages

    card = chip_smoke.card_line()
    K, V, N = chip_smoke.K_BENCH, chip_smoke.V_BENCH, chip_smoke.N_BENCH
    docs, X = chip_smoke.make_corpus(K, V, N, chip_smoke.WORDS_BENCH)
    cfg = STMConfig(K=K, init_type="random", batch_size=256, newton_pass1_iters=6,
                    newton_straggler_frac=0.25, max_em_iter=WARM,
                    convergence_threshold=0.0, newton_bf16_beta=args.bf16_beta)
    model = STM(docs, K=K, X=X, config=cfg, device="cuda")
    model.expectation_maximization()
    print(f"K={K} V={V} N={N}, newton_bf16_beta={args.bf16_beta}; {card}")
    print("iteration s:", model.iter_seconds, "(the first", cfg.newton_warmup_iters, "cold)")

    # one more two-pass iteration, as expectation_maximization runs it
    for k in stages.LAUNCHES:
        stages.LAUNCHES[k] = 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        model._state = model._em_step(model._state, model._data)
        torch.cuda.synchronize()
        wall = time.time() - t0
    trace = pathlib.Path(args.trace)
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    print(f"profiled iteration: wall {wall:.4f} s, bound {float(model._state.bound):.6f}, "
          f"launches {dict(stages.LAUNCHES)}; {card}")

    by_group: dict = {}
    for e in events:
        ms, n = by_group.get(group_of(e), (0.0, 0))
        by_group[group_of(e)] = (ms + e["dur"] / 1e3, n + 1)
    device_ms = sum(ms for ms, _n in by_group.values())
    print(f"{len(events)} device events, {device_ms:.2f} ms of device time")
    print("| Group | ms | share of device time | launches |")
    print("|---|---|---|---|")
    for group, (ms, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f"| {group} | {ms:.2f} | {100 * ms / device_ms:.1f}% | {n:,} |")
    busy = busy_us(events) / 1e6
    print(f"busy share: {busy:.4f} s of the {wall:.4f} s profiled wall = {busy / wall:.3f}; "
          f"trace in {trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
