#!/usr/bin/env python3
"""Diagnostics of the stage kernels and of the fit's wall time, on one CUDA card.

Run from the root of a checkout:

    python3 kernel_diag.py ablate        # where B1 fgh's and B3 ls's time goes
    python3 kernel_diag.py stalls        # Newton documents left unconverged, per path
    python3 kernel_diag.py compare DIR   # the stage kernels against another checkout's
    python3 kernel_diag.py plans         # B5 on its streaming and its resident plan
    python3 kernel_diag.py fits DIR      # the default fit's iteration walls against another checkout's

``ablate`` compiles ``csrc/stages.cu`` against copies of
``csrc/newton_doc.cuh``, where B1's and B3's bodies live (under
``build/ablate/``), with parts of the work switched off (each copy is
wrong on purpose and used for timing only), then times ``stm_fgh`` and
``stm_ls`` of each copy against the unchanged kernel, in turns with CUDA
events, on a chunk of the bench corpus (B=256, K=100, L=384, T=12), with
a float32 and with a bf16 beta_doc.  Then each candidate plan of the
bf16 beta_doc modes alone (``csrc/stages.cu``'s plan lists ``kFghPlans``
and ``kBetaLs`` cut to that candidate in a copy), and the unchanged
kernels at B = 132, 264 and 528.

``compare`` builds the CUDA sources of the checkout at DIR (under
``build/diag/``) and times its ``stm_fgh``, ``stm_cg``, ``stm_ls``,
``stm_iter`` and ``stm_newton`` (B1-B5; B1, B3 and B4 with a float32 and
with a bf16 beta_doc, B1, B4 and B5 with the float32 Hessian too), the
finalize's ``stm_chol_pd_inverse`` (F) and ``stm_finalize`` (Z) against
this checkout's, in turns (theirs, ours, ours, theirs, ...), on the same
chunk (B4 and B5 on the recipe's documents), and says whether each one's
outputs equal theirs bit for bit, and for F each tree's L and nu against
float64; their C interfaces must be this checkout's.  Then B1-B3, F and Z
again on random chunks at K=20 (the content cell's width) and K=400 (the
kernels' large-K plans: B1's tile groups, B2's H in L2, F's blocked plan).

``plans`` builds the library twice, once with B5's streaming plans only
and once with its resident plan only (beta_doc held in shared memory for
the whole loop, one block an SM), and times ``stm_newton`` of each in
turns on 256 and on 128 documents of the bench recipe at K=100, and on
256 at K=50.

``fits`` runs ``STM(corpus, K=100, X=X)`` (spectral init, 2 cold
single-pass EM iterations and 1 two-pass one) on the bench corpus in a
process of its own for each checkout, in turns (theirs, ours, ours,
theirs, twice over), each process importing the package of the checkout
it runs in.  Every process fits once to warm up and then six times;
where the checkout's single-pass E-step is one loop over the chunks,
every second of the six runs the Newton solve and the finalize in two
loops instead (the only difference between the two forms, within one
process).  It prints every iteration's wall, the medians by checkout and
form, and the runs of Python's cyclic garbage collector of more than 10
ms that fell in a fit (the bench corpus is a list of 8,192 lists of ~200
tuples, and a full collection walks all of it).

``stalls`` runs the first E-step's Newton solve of the bench fit (random
init, 32 chunks of 256 documents, 24 iterations) on the stage kernels,
on B4 (one fused kernel an iteration), on B5 (the whole loop in one
kernel) and on the plain PyTorch stages, and counts the documents each
leaves with max|g| above 1e-4 and 1e-2, with the sum of their objectives.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

# (bit, what is switched off, [(text in newton_doc.cuh, its replacement)])
PARTS = (
    (1, "prior term", [
        ("    for (int idx = tid; idx < 2 * Km1; idx += kThreads) {",
         "    for (int idx = tid; idx < 2 * Km1 && !(ABLATE & 1); idx += kThreads) {"),
        ("    if (4 * tg < T) {\n      for (int j = jj;",
         "    if (4 * tg < T && !(ABLATE & 1)) {\n      for (int j = jj;"),
    ]),
    (2, "fgh's division by s_l, ls's logarithm", [
        ("e[k] * ldf(slab + k * W + col) / sl[u] : 0.f",
         "(ABLATE & 2 ? e[k] * ldf(slab + k * W + col) * sl[u]"
         " : e[k] * ldf(slab + k * W + col) / sl[u]) : 0.f"),
        ("logf(fmaxf(sm, kTiny))", "(ABLATE & 2 ? sm : logf(fmaxf(sm, kTiny)))"),
    ]),
    (4, "the product (fgh's MMA, ls's FMA loop)", [
        ("    if (BF16) {\n#pragma unroll\n      for (int kk",
         "    if (ABLATE & 4) {\n    } else if (BF16) {\n#pragma unroll\n      for (int kk"),
        ("    if (4 * tg < T) {\n      float a[4][4];",
         "    if (4 * tg < T && !(ABLATE & 4)) {\n      float a[4][4];"),
    ]),
    (8, "all slab work but the stream", [
        ("    // s_l: warp w sums", "    if (ABLATE & 8) continue;\n    // s_l: warp w sums"),
        ("    const TB* slab = ring + (size_t)(RESIDENT ? s : s % STAGES) * K * W;\n\n"
         "    if (4 * tg",
         "    const TB* slab = ring + (size_t)(RESIDENT ? s : s % STAGES) * K * W;\n"
         "    if (ABLATE & 8) continue;\n\n    if (4 * tg"),
    ]),
    (16, "fgh's H stores to device memory", [
        ("  if (staged) {\n    __syncthreads();",
         "  if (staged && !(ABLATE & 16)) {\n    __syncthreads();"),
    ]),
)
VARIANTS = (0, 1, 2, 4, 8, 9, 16, 25)


def ablated_source(text: str) -> str:
    for _bit, _what, subs in PARTS:
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"ablate: newton_doc.cuh no longer holds {old!r} once")
            text = text.replace(old, new)
    return text


# stages.cu's plan lists ({W, stages, blocks an SM}, the first that fits
# taken) and the candidates ablate times alone: B1's list serves both
# beta_doc element types, kBetaLs B3's bf16 slabs
PLAN_LISTS = {
    "fgh": ("constexpr int kFghPlans[][3] = {{64, 3, 2}, {32, 3, 2}, {32, 2, 1}};",
            ((64, 3, 2), (64, 2, 2), (32, 3, 2))),
    "ls": ("constexpr int kBetaLs[][3] = {{128, 2, 2}, {64, 2, 2}, {64, 2, 1}};",
           ((128, 2, 2), (64, 2, 2), (64, 3, 2))),
}
N_PLANS = 3


def planned_source(text: str, i: int) -> str:
    """stages.cu with each plan list of PLAN_LISTS cut to its candidate i."""
    for old, cands in PLAN_LISTS.values():
        if text.count(old) != 1:
            raise RuntimeError(f"ablate: stages.cu no longer holds {old!r} once")
        head = old.split("{{")[0]
        text = text.replace(old, head + "{{%d, %d, %d}};" % cands[i])
    return text


def build_variants(build, variants):
    """A library for each named (ABLATE value, plan candidate or None):
    ``stages.cu`` (its plan lists cut to the candidate) compiled against
    the ablated copy of ``newton_doc.cuh`` (under build/ablate/, in
    parallel): ({name: lib}, the ptxas report of the first)."""
    out = build.BUILD_DIR.parent / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    stages_text = (build.CSRC / "stages.cu").read_text()
    (out / "newton_doc.cuh").write_text(ablated_source((build.CSRC / "newton_doc.cuh").read_text()))
    nvcc = build._nvcc()
    procs = {}
    for i, (name, (ablate_v, plan)) in enumerate(variants.items()):
        src = out / f"stages{i}.cu"
        src.write_text(stages_text if plan is None else planned_source(stages_text, plan))
        procs[name] = subprocess.Popen([nvcc, *build.NVCC_FLAGS, f"-DABLATE={ablate_v}", "-shared",
                                        "-o", str(out / f"{i}.so"), str(src)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, report = {}, ""
    for i, (name, p) in enumerate(procs.items()):
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        lib = ctypes.CDLL(str(out / f"{i}.so"))
        for fn in ("stm_fgh", "stm_ls", "stm_stage_plan"):
            getattr(lib, fn).argtypes = build._SIGNATURES[fn]
        libs[name] = lib
        report = report or text
    return libs, report


def describe(v: int) -> str:
    return ", ".join(what for bit, what, _ in PARTS if v & bit) or "nothing (the kernel)"


def bench_chunk(torch, B=256):
    """The chunk the stage kernels are timed on: B documents of the bench
    corpus (256 by default) padded to L=384, random beta, eta, mu and
    siginv (chip_smoke.stage_inputs), with the plain H, g, direction and
    step sizes; and, per entry point and beta_doc element type,
    calls[name](lib): (a function that launches that library's kernel on
    the chunk, the outputs it writes; fresh outputs a call)."""
    import numpy as np

    from strutopy_tpu_torch.corpus.bow import pad_corpus
    from strutopy_tpu_torch.ops import stages

    K, L, T = cs.K_BENCH, 384, 12
    docs, _X = cs.make_corpus(K, cs.V_BENCH, B, cs.WORDS_BENCH)
    corpus = pad_corpus(docs, V=cs.V_BENCH)
    words = np.zeros((B, L), np.int32)
    counts = np.zeros((B, L), np.float32)
    words[:, :corpus.words.shape[1]] = corpus.words
    counts[:, :corpus.counts.shape[1]] = corpus.counts
    inputs = cs.stage_inputs(torch, words, counts, K, seed=1)
    eta, bd, c, mu, siginv = inputs
    beta = {0: bd, 1: bd.to(torch.bfloat16)}
    _want, aux = cs.plain_outputs(torch, stages, inputs, True)
    # B4 and B5 on the recipe's documents and true beta, from eta = mu
    lbd, lc, lmu, lsig = cs.dgp_chunk(torch, K, B, seed=0)
    lbeta = {0: lbd, 1: lbd.to(torch.bfloat16)}
    lts = cs.step_sizes(torch, "cuda")
    done = torch.zeros(B, dtype=torch.bool, device="cuda")

    def stream():  # the current one: a graph capture runs on its own
        return torch.cuda.current_stream().cuda_stream

    def ptrs(*ts):
        return (t.data_ptr() for t in ts)

    def fgh(beta_bf16, bf16=1):
        def call(lib):
            f, g = torch.empty(B, device="cuda"), torch.empty(B, K - 1, device="cuda")
            H = torch.empty(B, K - 1, K - 1, device="cuda")
            return (lambda: lib.stm_fgh(*ptrs(siginv, eta, mu, beta[beta_bf16], c, f, g, H), B,
                                        K, L, bf16, beta_bf16, stream())), (f, g, H)
        return call

    def cg(iters):
        def call(lib):
            x = torch.empty(B, K - 1, device="cuda")
            return (lambda: lib.stm_cg(*ptrs(aux["H"], aux["g"], x), B, K - 1, iters, 1,
                                       stream())), (x,)
        return call

    def ls(beta_bf16):
        def call(lib):
            fs = torch.empty(B, T, device="cuda")
            return (lambda: lib.stm_ls(*ptrs(siginv, aux["ts"], eta, aux["p"], mu,
                                             beta[beta_bf16], c, fs), B, K, L, T, beta_bf16,
                                       stream())), (fs,)
        return call

    def it(beta_bf16, bf16=1):
        def call(lib):
            e, d, a = torch.empty_like(lmu), torch.empty_like(done), torch.empty_like(done)
            return (lambda: lib.stm_iter(*ptrs(lsig, lts, lmu, lmu, done, lbeta[beta_bf16], lc),
                                         None, *ptrs(e, d, a), B, K, L, cs.N_STEPS,
                                         cs.GRAD_TOL, 6, bf16, beta_bf16, stream())), (e, d, a)
        return call

    def newton(bf16=1):
        def call(lib):
            e = torch.empty_like(lmu)
            n = torch.empty(B, dtype=torch.int32, device="cuda")
            return (lambda: lib.stm_newton(*ptrs(lsig, lts, lbd, lc, lmu, lmu), None,
                                           *ptrs(e, n), B, K, L, cs.N_STEPS, cs.LOOP_ITERS,
                                           cs.GRAD_TOL, 6, bf16, stream())), (e, n)
        return call

    calls = {
        "fgh": fgh(0), "fgh bf16 beta": fgh(1),
        # the float32 product (bf16 off): simulate_theta's B1 and every
        # Newton path under newton_bf16_hessian=False
        "fgh float32": fgh(0, bf16=0),
        "cg": cg(aux["iters"]),
        # H and g in and the set-up, no step: what the steps add is the rest
        "cg, 0 steps": cg(0),
        "ls": ls(0), "ls bf16 beta": ls(1),
        "iter": it(0), "iter bf16 beta": it(1), "iter float32": it(0, bf16=0),
        "newton": newton(), "newton float32": newton(bf16=0),
    }
    doc_w = torch.ones(B, device="cuda")
    calls.update(finalize_calls(torch, aux["H"], (eta, bd, c, mu, doc_w, siginv, c.sum(1))))
    return (B, K, L, T), calls


def _stream(torch):
    """The current stream's handle (a graph capture runs on its own)."""
    return torch.cuda.current_stream().cuda_stream


def _ptrs(*ts):
    return (t.data_ptr() for t in ts)


def finalize_calls(torch, H, args):
    """The finalize's kernels as compare's calls: F (``stm_chol_pd_inverse``,
    with nu) on the Hessians H, and Z (``stm_finalize``) on ``args`` =
    (eta, beta_doc, counts, mu, doc_w, siginv, Nd)."""
    eta, bd, c, mu, w, siginv, Nd = args
    B, K, L = bd.shape
    P = K - 1

    def factor(lib):
        plan = (ctypes.c_int * 3)()
        assert lib.stm_factor_plan(P, plan) == 0
        Lt, nu = torch.empty_like(H), torch.empty_like(H)
        rung = torch.empty(B, dtype=torch.int8, device="cuda")
        scratch = None if plan[2] else torch.empty(B, P * (P + 1), device="cuda")
        return (lambda: lib.stm_chol_pd_inverse(
            *_ptrs(H, Lt, nu, rung), None if scratch is None else scratch.data_ptr(), B, P, 1,
            1e-5, 1e-3, _stream(torch))), (Lt, nu, rung)

    def finalize(lib):
        out = (torch.empty(B, P, device="cuda"), torch.empty(B, P, P, device="cuda"),
               torch.empty(B, K, device="cuda"), torch.empty(B, L, K, device="cuda"),
               torch.empty(B, 2, device="cuda"))
        ins = (siginv, eta, mu, bd, c, Nd, w)
        return (lambda: lib.stm_finalize(*_ptrs(*ins, *out), B, K, L, _stream(torch))), out

    factor.H = H  # for factor_errors
    return {"factor": factor, "finalize": finalize}


def factor_errors(torch, H, Lt, nu, rung):
    """L's and nu's relative Frobenius errors against the float64 factor and
    inverse of the same H, over the documents that took rung 1."""
    ok = rung == 1
    if not bool(ok.any()):
        return float("nan"), float("nan")
    H64 = H[ok].double()

    def rel(x, want):
        return float(torch.linalg.norm(x.double() - want) / torch.linalg.norm(want))

    return rel(Lt.transpose(1, 2)[ok], torch.linalg.cholesky(H64)), rel(nu[ok],
                                                                        torch.linalg.inv(H64))


def chunk_calls(torch, B, K, L, seed):
    """B1-B3, F and Z as compare's calls on a random chunk
    (chip_smoke.finalize_inputs) of B documents at K, L distinct words
    each: B2 and F on the plain Hessian and gradient, B3 on the direction
    they give."""
    from strutopy_tpu_torch.ops import stages

    eta, bd, c, mu, w, siginv, _se, Nd = cs.finalize_inputs(torch, B, K, L, seed)
    _want, aux = cs.plain_outputs(torch, stages, (eta, bd, c, mu, siginv), True)
    T = aux["ts"].shape[0]

    def fgh(lib):
        f, g = torch.empty(B, device="cuda"), torch.empty(B, K - 1, device="cuda")
        H = torch.empty(B, K - 1, K - 1, device="cuda")
        return (lambda: lib.stm_fgh(*_ptrs(siginv, eta, mu, bd, c, f, g, H), B, K, L, 1, 0,
                                    _stream(torch))), (f, g, H)

    def cg(lib):
        x = torch.empty(B, K - 1, device="cuda")
        return (lambda: lib.stm_cg(*_ptrs(aux["H"], aux["g"], x), B, K - 1, aux["iters"], 1,
                                   _stream(torch))), (x,)

    def ls(lib):
        fs = torch.empty(B, T, device="cuda")
        return (lambda: lib.stm_ls(*_ptrs(siginv, aux["ts"], eta, aux["p"], mu, bd, c, fs), B,
                                   K, L, T, 0, _stream(torch))), (fs,)

    calls = {"fgh": fgh, "cg": cg, "ls": ls}
    calls.update(finalize_calls(torch, aux["H"], (eta, bd, c, mu, w, siginv, Nd)))
    return calls


def time_turns(torch, fn_a, fn_b, reps=50, rounds=4):
    """ms a call of fn_a and fn_b, each a CUDA graph of ``reps`` calls
    replayed in turns (a, b, b, a, ...) ``rounds`` times each: (a's
    rounds, b's rounds)."""
    graphs = [cs.graphed(torch, f, reps) for f in (fn_a, fn_b)]
    for g in graphs:
        g()
    times = ([], [])
    for i in range(2 * rounds):
        for side in ((0, 1) if i % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[side]()
            end.record()
            torch.cuda.synchronize()
            times[side].append(start.elapsed_time(end) / reps)
    return times


def spread(ms) -> str:
    import numpy as np

    return f"{np.median(ms):.4f} [{min(ms):.4f}-{max(ms):.4f}]"


# the entry points ablate takes apart (B1 and B3 in both beta_doc element types)
ABLATED = ("fgh", "fgh bf16 beta", "ls", "ls bf16 beta")


def stage_plan(lib, which, K, beta_bf16):
    """The plan stm_fgh (which 0) or stm_ls (1) takes at K (bf16 Hessian
    on): [bytes, W, stages, blocks an SM, where the prior term reads
    siginv (0 L2, 1 the ring)], or None."""
    out = (ctypes.c_int * 5)()
    return list(out) if lib.stm_stage_plan(which, K, 1, beta_bf16, out) == 0 else None


def ablate(torch):
    from strutopy_tpu_torch.ops import build

    variants = {v: (v, None) for v in VARIANTS}
    variants.update({f"plan {i}": (0, i) for i in range(N_PLANS)})
    libs, report = build_variants(build, variants)
    print("ablate: ptxas, the unchanged kernels:")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())
    (B, K, L, T), calls = bench_chunk(torch)
    print(f"ablate: B={B} K={K} L={L} T={T}, bf16 on; us a call, median [least-most] of 4 "
          f"rounds of a CUDA graph of 50 calls, each in turns with the unchanged kernel "
          f"[{cs.card_line()}]")
    for v in VARIANTS:
        print(f"  off: {describe(v)}:")
        for name in ABLATED:
            a, b = time_turns(torch, calls[name](libs[v])[0], calls[name](libs[0])[0])
            print(f"    {name}: {spread([1e3 * t for t in a])} "
                  f"(unchanged {spread([1e3 * t for t in b])})")
    print("ablate: each bf16 plan alone [bytes, W, stages, blocks an SM, siginv in the ring], "
          "us a call in turns with the unchanged plan lists")
    for i in range(N_PLANS):
        lib = libs[f"plan {i}"]
        for name, which in (("fgh bf16 beta", 0), ("ls bf16 beta", 1)):
            plan = stage_plan(lib, which, K, 1)
            if plan is None:
                continue
            a, b = time_turns(torch, calls[name](lib)[0], calls[name](libs[0])[0])
            print(f"  plan {i} {plan}: {name} {spread([1e3 * t for t in a])} "
                  f"(unchanged {spread([1e3 * t for t in b])})")
    print("ablate: the unchanged kernels by chunk size, 132 SMs; us a call, median [least-most]")
    for n in (132, 264, 528):
        _, c_n = bench_chunk(torch, B=n)
        for name in ABLATED:
            a, _b = time_turns(torch, c_n[name](libs[0])[0], c_n[name](libs[0])[0])
            print(f"  B={n} {name}: {spread([1e3 * t for t in a])}")


def build_lib(build, name, sources, flags=()):
    """One library from ``sources`` (compiled in parallel as ops/build.py
    compiles the kernels, with ``flags`` added), under build/diag/."""
    out = build.BUILD_DIR.parent / "diag"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    objs = [out / f"{name}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    for p in procs:
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed:\n{text}")
    lib_path = out / f"{name}.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib_path), *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
    return lib


def build_other(build, root):
    """The CUDA library of the checkout at ``root``."""
    sources = sorted((Path(root) / "strutopy_tpu_torch" / "csrc").glob("*.cu"))
    if not sources:
        raise RuntimeError(f"compare: no CUDA sources under {root}/strutopy_tpu_torch/csrc")
    return build_lib(build, "other", sources)


def compare(torch, root):
    from strutopy_tpu_torch.ops import build

    other = build_other(build, root)
    ours = build.load()
    (B, K, L, T), calls = bench_chunk(torch)
    print(f"compare: B={B} K={K} L={L} T={T}, bf16 on unless named float32, 6 CG steps; iter "
          f"and newton on the recipe's documents from eta = mu; ms a call, median "
          f"[least-most] of 4 rounds of a CUDA graph of 50 calls (newton 5), in turns with "
          f"{root}'s [{cs.card_line()}]")
    in_turns(torch, calls, ours, other, root)
    for B, K, L in ((256, 20, 160), (256, 400, 300)):
        print(f"compare: a random chunk, B={B} K={K} L={L}, bf16 on, float32 beta_doc, "
              f"{min(6, K - 1)} CG steps, F and Z on the plain H")
        in_turns(torch, chunk_calls(torch, B, K, L, seed=K), ours, other, root)


def in_turns(torch, calls, ours, other, root):
    """Each call's kernel from both libraries: bit-equality and times."""
    for name, call in calls.items():
        (fn, out), (fn_o, out_o) = call(ours), call(other)
        assert fn() == 0 and fn_o() == 0, name
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, b)) for a, b in zip(out, out_o))
        a, b = time_turns(torch, fn, fn_o, reps=5 if name.startswith("newton") else 50)
        errs = ""
        if name == "factor":
            e, e_o = factor_errors(torch, call.H, *out), factor_errors(torch, call.H, *out_o)
            errs = (f"; L, nu error vs float64: this checkout {e[0]:.3e}, {e[1]:.3e}, {root} "
                    f"{e_o[0]:.3e}, {e_o[1]:.3e}")
        print(f"  {name}: this checkout {spread(a)} ms, {root} {spread(b)} ms; outputs "
              f"bit-equal {same}{errs}")


def plans(torch):
    from strutopy_tpu_torch.ops import build

    libs = {name: build_lib(build, f"plan_{name}", build.SOURCES, [f"-DSTM_NEWTON_PLAN={flag}"])
            for name, flag in (("streaming", 1), ("resident", 2))}
    T = cs.N_STEPS
    print(f"plans: B5 (stm_newton), T={T}, {cs.LOOP_ITERS} iterations, 6 CG steps, bf16 on; ms "
          f"a call, median of 3 rounds of a CUDA graph of 5 calls, in turns [{cs.card_line()}]")
    for K, B in ((cs.K_BENCH, 256), (cs.K_BENCH, 128), (50, 256)):
        bd, c, mu, siginv = cs.dgp_chunk(torch, K, B, seed=0)
        L = bd.shape[2]
        ts = cs.step_sizes(torch, "cuda")
        out = {name: (torch.empty_like(mu), torch.empty(B, dtype=torch.int32, device="cuda"))
               for name in libs}

        def run(name):
            eta, n = out[name]
            return lambda: libs[name].stm_newton(
                *(t.data_ptr() for t in (siginv, ts, bd, c, mu, mu)), None, eta.data_ptr(),
                n.data_ptr(), B, K, L, T, cs.LOOP_ITERS, cs.GRAD_TOL, 6, 1,
                torch.cuda.current_stream().cuda_stream)

        for name, lib in libs.items():
            plan = (ctypes.c_int * 8)()
            lib.stm_newton_plan(K, L, 1, 0, 1, plan)
            assert run(name)() == 0, name
            print(f"  {name} plan at L={L}: {list(plan)}")
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(out["resident"], out["streaming"]))
        res, strm = cs.time_pair(torch, run("resident"), run("streaming"), reps=5)
        print(f"  K={K} B={B} L={L}: resident {res:.4f} ms, streaming {strm:.4f} ms; eta and "
              f"counts bit-equal {same}; slowest document {int(out['resident'][1].max())} steps")


def stalls(torch):
    from strutopy_tpu_torch import STM, STMConfig
    from strutopy_tpu_torch.ops import stages
    from strutopy_tpu_torch.ops.estep import NewtonConfig, _batched_newton, _gather_beta
    from strutopy_tpu_torch.ops.linalg import precompute_sigma

    K = cs.K_BENCH
    docs, X = cs.make_corpus(K, cs.V_BENCH, cs.N_BENCH, cs.WORDS_BENCH)
    cfg = STMConfig(K=K, init_type="random", batch_size=256, max_em_iter=1)
    model = STM(docs, K=K, X=X, config=cfg, device="cuda")
    st, data = model._state, model._data
    siginv, _ = precompute_sigma(st.sigma)
    ts = cs.step_sizes(torch, "cuda")
    paths = {
        "stage kernels": lambda *a: _batched_newton(*a, NewtonConfig())[0],
        "B4 iter": lambda *a: _batched_newton(*a, NewtonConfig(pallas_iter=True))[0],
        "B5 newton": lambda *a: stages.newton_loop(*a, ts, 24, cs.GRAD_TOL, 6, True)[0],
        "plain": lambda *a: stages.newton_loop_plain(*a, ts, 24, cs.GRAD_TOL, 6, True)[0],
    }
    tot = {p: [0, 0, 0.0] for p in paths}
    for b in range(data.n_buckets):
        n = data.words[b].shape[0]
        for lo in range(0, n, 256):
            sl = slice(lo, lo + 256)
            c = data.counts[b][sl].contiguous()
            bd = _gather_beta(st.beta, data.words[b][sl])
            mu, eta0 = st.mu[sl].contiguous(), st.eta[sl].contiguous()
            for p, run in paths.items():
                f, g, _H = stages.fgh_plain(run(bd, c, mu, eta0, siginv), bd, c, mu, siginv,
                                            bf16=False)
                gm = g.abs().amax(1)
                tot[p][0] += int((gm > 1e-4).sum())
                tot[p][1] += int((gm > 1e-2).sum())
                tot[p][2] += float(f.double().sum())
    ref = tot["B5 newton"][2]
    print(f"stalls: first E-step of the bench fit (K={K}, N={cs.N_BENCH}, random init), "
          f"24 Newton iterations [{cs.card_line()}]")
    for p, (n4, n2, f) in tot.items():
        print(f"  {p}: max|g| > 1e-4 on {n4} documents, > 1e-2 on {n2}; sum of f {f:.3f} "
              f"({(f - ref) / abs(ref):+.3e} relative to B5)")


# Runs in a process of its own, from the root of the checkout it measures.
FIT_CHILD = r"""
import gc, inspect, json, sys, time
import torch
import chip_smoke as cs
from strutopy_tpu_torch import STM
from strutopy_tpu_torch.corpus.bow import pad_corpus
from strutopy_tpu_torch.ops import estep

docs, X = cs.make_corpus(cs.K_BENCH, cs.V_BENCH, cs.N_BENCH, cs.WORDS_BENCH)
corpus = pad_corpus(docs, V=cs.V_BENCH)
events, started = [], {}

def on_gc(phase, info):
    if phase == "start":
        started["t"] = time.time()
    else:
        events.append((started["t"], time.time() - started["t"], info["generation"]))

gc.callbacks.append(on_gc)

def fit():
    del events[:]
    m = STM(corpus, K=cs.K_BENCH, X=X, device="cuda")
    m.config = m.config.replace(max_em_iter=3, convergence_threshold=0.0)
    torch.cuda.synchronize()
    t0 = time.time()
    m.expectation_maximization()
    long = [[round(t - t0, 3), round(d, 3), g] for t, d, g in events if t >= t0 and d > 0.01]
    return {"iter_seconds": [round(s, 4) for s in m.iter_seconds],
            "bounds": list(m.last_bounds), "gc_over_10ms": long}

def two_loops(beta, mu, eta0, siginv, sigmaentropy, words, counts, aspects, doc_ok, cfg, B,
              use_pallas, vocab=None):
    eta, iters = estep._newton_all(beta, mu, eta0, siginv, words, counts, aspects, cfg, B,
                                   vocab=vocab)[:2]
    if "acc" in inspect.signature(estep._finalize_all).parameters:  # sums into an accumulator
        acc = estep._StatsSum(beta, vocab)
        theta = estep._finalize_all(acc, beta, eta, mu, siginv, sigmaentropy, words, counts,
                                    aspects, doc_ok, B)
        beta_ss, sigma_ss, bound = acc.beta_ss, acc.sigma_ss, acc.bound
    else:
        beta_ss, sigma_ss, bound, theta = estep._finalize_all(
            beta, eta, mu, siginv, sigmaentropy, words, counts, aspects, doc_ok, B)
    overflow = torch.zeros((), dtype=torch.int32, device=words.device)
    return estep.EStepResult(beta_ss, sigma_ss, bound, eta, theta, iters, overflow)

fit()  # warm-up: the kernels' build, the allocator, cuSOLVER's handles
out = []
one_loop = getattr(estep, "_single_pass_estep", None)
for i in range(6):
    form = "one loop" if one_loop is not None else "two loops"
    if one_loop is not None and i % 2:
        estep._single_pass_estep, form = two_loops, "two loops"
    out.append(dict(fit(), form=form))
    if one_loop is not None:
        estep._single_pass_estep = one_loop
print("FITS " + json.dumps(out))
"""


def fits(root):
    import numpy as np

    here = str(Path(__file__).resolve().parent)
    print(f"fits: STM(corpus, K={cs.K_BENCH}, X=X), N={cs.N_BENCH}, 3 EM iterations (2 cold "
          f"single-pass, 1 two-pass), a process a checkout, in turns [{cs.card_line()}]")
    walls = {}
    for where in (root, here, here, root) * 2:
        run = subprocess.run([sys.executable, "-c", FIT_CHILD], cwd=where, capture_output=True,
                             text=True)
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("FITS ")]
        if run.returncode != 0 or not lines:
            raise RuntimeError(f"fits: the process in {where} failed:\n{run.stdout[-2000:]}"
                               f"\n{run.stderr[-4000:]}")
        name = "this checkout" if where == here else str(where)
        print(f"  {name}:")
        for r in json.loads(lines[-1][5:]):
            walls.setdefault((name, r["form"]), []).append(r["iter_seconds"])
            print(f"    {r['form']}: EM 0, 1, 2 {r['iter_seconds']} s; collections over 10 ms "
                  f"[s into the fit, s, generation] {r['gc_over_10ms']}; last bound "
                  f"{r['bounds'][-1]:.1f}")
    for (name, form), w in walls.items():
        w = np.asarray(w)
        print(f"  {name}, {form}: {len(w)} fits, median EM 0, 1, 2 "
              f"{np.median(w, axis=0).round(4).tolist()} s, least {w.min(axis=0).tolist()} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("ablate", "stalls", "compare", "plans", "fits"))
    ap.add_argument("other", nargs="?",
                    help="compare, fits: the root of the other checkout")
    args = ap.parse_args()
    if args.what in ("compare", "fits") and not args.other:
        ap.error(f"{args.what} needs the other checkout's root")
    import torch

    if not torch.cuda.is_available():
        print("kernel_diag: no CUDA device", file=sys.stderr)
        return 2
    if args.what == "compare":
        compare(torch, args.other)
    elif args.what == "fits":
        fits(args.other)
    else:
        {"ablate": ablate, "stalls": stalls, "plans": plans}[args.what](torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
