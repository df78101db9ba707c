#!/usr/bin/env python3
"""Two diagnostics of the stage kernels, on one CUDA card.

Run from the root of a checkout:

    python3 kernel_diag.py ablate   # where B1 fgh's and B3 ls's time goes
    python3 kernel_diag.py stalls   # Newton documents left unconverged, per path

``ablate`` compiles copies of ``csrc/stages.cu`` (under
``build/ablate/``) with parts of the work switched off (each copy is
wrong on purpose and used for timing only), then times ``stm_fgh`` and
``stm_ls`` of each copy against the unchanged kernel, in turns with CUDA
events, on a chunk of the bench corpus (B=256, K=100, L=384, T=12).

``stalls`` runs the first E-step's Newton solve of the bench fit (random
init, 32 chunks of 256 documents, 24 iterations) on the stage kernels,
on B4 (one fused kernel an iteration), on B5 (the whole loop in one
kernel) and on the plain PyTorch stages, and counts the documents each
leaves with max|g| above 1e-4 and 1e-2, with the sum of their objectives.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import chip_smoke as cs

# (bit, what is switched off, [(text in stages.cu, its replacement)])
PARTS = (
    (1, "prior term", [
        ("    for (int idx = tid; idx < 2 * Km1; idx += kThreads) {",
         "    for (int idx = tid; idx < 2 * Km1 && !(ABLATE & 1); idx += kThreads) {"),
        ("    if (4 * tg < T) {\n      for (int j = jj;",
         "    if (4 * tg < T && !(ABLATE & 1)) {\n      for (int j = jj;"),
    ]),
    (2, "fgh's division by s_l, ls's logarithm", [
        ("e[k] * slab[k * W + col] / sl[u] : 0.f",
         "(ABLATE & 2 ? e[k] * slab[k * W + col] * sl[u] : e[k] * slab[k * W + col] / sl[u])"
         " : 0.f"),
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
        ("    const float* slab = ring + (size_t)(s % STAGES) * K * W;\n\n    if (4 * tg",
         "    const float* slab = ring + (size_t)(s % STAGES) * K * W;\n"
         "    if (ABLATE & 8) continue;\n\n    if (4 * tg"),
    ]),
    (16, "fgh's H stores to device memory", [
        ("  if (stage) {\n    __syncthreads();", "  if (stage && !(ABLATE & 16)) {\n    __syncthreads();"),
    ]),
)
VARIANTS = (0, 1, 2, 4, 8, 9, 16, 25)


def ablated_source(text: str) -> str:
    for _bit, _what, subs in PARTS:
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"ablate: stages.cu no longer holds {old!r} once")
            text = text.replace(old, new)
    return text


def build_variants(build):
    out = build.BUILD_DIR.parent / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "stages_ablate.cu"
    src.write_text(ablated_source((build.CSRC / "stages.cu").read_text()))
    (out / "newton_doc.cuh").write_bytes((build.CSRC / "newton_doc.cuh").read_bytes())
    nvcc = build._nvcc()
    procs = {v: subprocess.Popen([nvcc, *build.NVCC_FLAGS, f"-DABLATE={v}", "-shared", "-o",
                                  str(out / f"ablate{v}.so"), str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for v in VARIANTS}
    libs = {}
    for v, p in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for ABLATE={v}:\n{text}")
        lib = ctypes.CDLL(str(out / f"ablate{v}.so"))
        for name in ("stm_fgh", "stm_ls"):
            getattr(lib, name).argtypes = build._SIGNATURES[name]
        libs[v] = lib
    return libs


def describe(v: int) -> str:
    return ", ".join(what for bit, what, _ in PARTS if v & bit) or "nothing (the kernel)"


def ablate(torch):
    import numpy as np

    from strutopy_tpu_torch.corpus.bow import pad_corpus
    from strutopy_tpu_torch.ops import build, stages

    libs = build_variants(build)
    B, K, L, T = 256, cs.K_BENCH, 384, 12
    docs, _X = cs.make_corpus(K, cs.V_BENCH, B, cs.WORDS_BENCH)
    corpus = pad_corpus(docs, V=cs.V_BENCH)
    words = np.zeros((B, L), np.int32)
    counts = np.zeros((B, L), np.float32)
    words[:, :corpus.words.shape[1]] = corpus.words
    counts[:, :corpus.counts.shape[1]] = corpus.counts
    inputs = cs.stage_inputs(torch, words, counts, K, seed=1)
    eta, bd, c, mu, siginv = inputs
    _want, aux = cs.plain_outputs(torch, stages, inputs, True)
    f = torch.empty(B, device="cuda")
    g = torch.empty(B, K - 1, device="cuda")
    H = torch.empty(B, K - 1, K - 1, device="cuda")
    fs = torch.empty(B, T, device="cuda")

    def stream():  # the current one: a graph capture runs on its own
        return torch.cuda.current_stream().cuda_stream

    def fgh(lib):
        return lambda: lib.stm_fgh(*(t.data_ptr() for t in (siginv, eta, mu, bd, c, f, g, H)),
                                   B, K, L, 1, stream())

    def ls(lib):
        return lambda: lib.stm_ls(*(t.data_ptr() for t in (siginv, aux["ts"], eta, aux["p"],
                                                           mu, bd, c, fs)), B, K, L, T, stream())

    print(f"ablate: B={B} K={K} L={L} T={T}, bf16 on; us a call, median of 3 rounds of a CUDA "
          f"graph of 50 calls, each beside the unchanged kernel [{cs.card_line()}]")
    for v in VARIANTS:
        a = cs.time_pair(torch, fgh(libs[v]), fgh(libs[0]), reps=50)
        b = cs.time_pair(torch, ls(libs[v]), ls(libs[0]), reps=50)
        print(f"  off: {describe(v)}: fgh {1e3 * a[0]:.1f} (unchanged {1e3 * a[1]:.1f}), "
              f"ls {1e3 * b[0]:.1f} (unchanged {1e3 * b[1]:.1f})")


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("ablate", "stalls"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_diag: no CUDA device", file=sys.stderr)
        return 2
    {"ablate": ablate, "stalls": stalls}[args.what](torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
