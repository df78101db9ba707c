#!/usr/bin/env python3
"""Build, check and drive the PyTorch/CUDA port of the STM on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure is reported and the script exits non-zero at the
end, without the final result line):

  1. device: the card's name and power limit (nvidia-smi), then the
     kernels built from strutopy_tpu_torch/csrc with nvcc for sm_90a,
     with ptxas' register and shared-memory report, the stage kernels'
     shared memory per block, the fused kernels' plan and B1's and B3's
     bf16-beta_doc plans (slab width, ring depth, blocks an SM, where
     siginv is read) at K = 3 to 400;
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card at the main path's shapes (B=256, K=100, L = the bench
     corpus's bucket width, T=12, 6 CG steps), bf16 on and off, then
     kernel and plain timed in turns with CUDA events: the stage kernels
     (fgh, cg, ls) on random inputs, the fused Newton kernels (iter: one
     iteration; newton: the whole loop) on the bench chunk with the
     recipe's true beta, the row gather (gather) on the chunk's words;
     each beside its least time on the card (bound) and its share of it,
     and the whole loop's time per step of its slowest document; fgh,
     cg, ls and newton, and fgh, ls and iter with a bf16 beta_doc, on a
     permuted half of the chunk, each document's outputs bit-equal to its
     outputs in the whole chunk;
     2b. the same checks at K=50 with L=200 (a partial slab) and L=201
     (not a multiple of 4), and at K=200 and K=400, the kernels' large-K
     branches;
     2c. the ordered phi scatter (scatter) at the bench chunk, phi from
     the finalize: kernel against plain bit for bit for (K, V), aspect
     (A=2), vocab-local and permuted keys, then timed (CUDA graphs, and
     call by call) beside its plan, its bound, the finalize's entry-major
     phi, atomic and deterministic ``index_add_``; plan and kernel must
     be no slower than deterministic ``index_add_``;
     2d. the stage path's two glue kernels (direction, accept) against
     their plain versions bit for bit (gTp within 4 ulps of its scale) at
     the bench chunk part-way along its trajectory and on planted inputs
     (done, NaN, not-descending, converged, no-step and all-done
     documents) at K=6, 100 and 400; a recorded stage-path loop launching
     each once a chunk step (B1-B3 and the two, no other op a step but
     the one read), the fused paths neither; their device and host times
     beside the PyTorch glue's;
     2e. (once phase 4 has a fitted state) the finalize's factor
     (factor: the PD-repair ladder, L and nu = (L Lᵀ)⁻¹ in one launch)
     against its plain version (the cholesky_ex ladder, its host read and
     cholesky_inverse) on one chunk's Hessians from phase 4's state (K=100,
     P=99), on a chunk shaped like the content cell's (K=20, P=19) at its
     Newton optimum and, on the blocked plan (P=399), on a random K=400
     chunk and a k400_fit-shaped one at its Newton optimum: rungs equal, L
     and nu within float32 rounding, nu's error against float64 at most
     twice plain's, two calls and the factor-only mode bit-equal; a
     planted batch taking rungs 1-4 and the all-fail NaN at each width;
     the kernel's time (a CUDA graph of 20 calls, at most FACTOR_MS_MAX at
     P=99 and FACTOR_MS_MAX_BLOCKED at P=399) beside its bound and share,
     plain's and the library pair's (cholesky_ex, cholesky_inverse) call
     by call, nu's float64 error beside the library pair's, the wrapper's
     host time a call and the rungs;
     2f. (likewise) the finalize's route (Z: g, H, theta, phi and the
     bound's terms in one kernel; F; the epilogue: three launches a
     chunk) against the plain finalize on the same two chunks: every
     output within FINALIZE_RTOL of its float32 terms' magnitudes (nu
     and the det term as 2e holds the factor), one launch of each a
     call, two calls bit-equal; Z and the route timed (CUDA graphs of 20
     calls) beside Z's bound and plain version and the composition Z
     replaced, and the host time a call of both;
  3. the CUDA fit against the CPU fit of the same small corpus from the
     same numpy beta (3 EM iterations, float32 Hessian);
  4. the fit at full width: the bench.py corpus recipe (K=100,
     V=10,000, N=8,192, 300 tokens a document) and configuration
     (batch 256, two-pass schedule with pass-1 cap 6 and straggler
     fraction 0.25), 2 cold and 3 two-pass EM iterations through
     ``STM.expectation_maximization``, with every kernel's launch count;
     4b. the first 2 EM iterations on the stage path, then each on both
     fused Newton paths from the same state, bounds against the stage
     path's;
     4c. two more fits of that configuration in this process with
     PyTorch's deterministic-algorithms flag off: bound, beta, sigma and
     eta bit-equal at every iteration;
  5. serving at full width: phase 4's model saved with ``save_model``,
     loaded by ``ThetaServer``, 2,048 new documents of the recipe served
     on the stage, fused-iteration and whole-loop paths (theta on the
     simplex, eta against the stage path's where both converge, launch
     counts), then requests
     of 1, 16, 256 and 2,048 documents timed on each;
     5b. the repo's wiki model (K=50, V=13,852) through the same server;
  6. spectral init at full width: ``spectral_init`` on the bench corpus
     (maxV=5000), its Gram / anchor / recovery stages timed, beta finite
     with rows on the simplex; the card's anchors against the CPU's on
     the same corpus (where they part, the gap between the two
     candidates' scores must be float32 rounding); then ``STM(docs,
     K=100, X=X)`` with every other argument at its default (spectral
     init, the two-pass schedule) for 3 EM iterations;
  7. the content model at full width: an A=2 content fit (``content=True``,
     ``beta_index`` the binary covariate, P=102) for 3 EM iterations from
     a random init, with the kappa solve's Newton counts and wall time;
     the bounds and kappa of the same kind of fit on the card against the
     CPU at a reduced size (default and weak kappa penalty); the saved model served by ``ThetaServer`` to 2,048 new
     documents with their ``beta_index``;
  8. heldout and resume: ``train_and_eval_heldout(fast=True)`` on an
     80/20 split of the bench corpus, ``eval_heldout_torch`` on the card
     against the float64 ``eval_heldout``; a fit of 4 iterations
     checkpointed at 2 and resumed against the uninterrupted fit, bit for
     bit, with no flag of PyTorch's;
  9. out-of-core fits at full width: (a) ``STM(docs, K=100, X=X,
     stream_parts=4)`` against phase 6's in-memory default fit (bounds,
     beta, both straggler overflows, B1-B3 launches of each; held to the
     tolerance on the cold iterations: the two-pass iteration's straggler
     budget is a share of one part there and of the corpus here; on that
     iteration the bound must rise and the overflow stay within the
     in-memory fit's plus one chunk), a two-pass pair with and without
     ``stream_parts=4`` whose budget of half the rows neither fit
     overflows, held likewise (the pair's in-memory fit equal to phase
     6's bit for bit on their shared cold iterations), and from that
     pair's in-memory state one single-pass and one two-pass EM iteration
     streamed against in memory (bound within 1e-5, beta within 1e-5, eta
     within 1e-4: over several iterations the streamed and in-memory sums'
     orders part the two fits); (b)
     ``StreamedEM`` driven directly with prefetch on against off (results
     equal bit for bit; wall and peak
     device memory of each beside the bytes of one part); (c) the bench
     corpus's padded arrays tiled 16 times on the host (N=131,072, 16
     parts of 8,192 from a ``provider(p)``), 2 EM iterations: bound
     finite, peak device memory against the resident state plus three
     parts, documents per second; (d) one streamed iteration on each
     fused Newton path from the stage path's state; (e) an A=2 content
     model with ``stream_parts=2`` against phase 7's in-memory bounds;
 10. post-fit analysis of phase 6's model: ``simulate_theta`` on the card
     (B1 in its float32 mode, one launch a chunk of 512 documents)
     against the same call on the CPU for the first 1,024 documents, each
     document within its own rounding bound (SIM_C below), B1
     against its plain version on that path's first chunk, timed beside
     its bound and the chunk's other steps,
     ``estimate_effect_composition``, ``label_topics``, ``topic_quality``,
     ``check_residuals``, ``topic_corr``, ``to_ldavis``, ``summary``; a fit
     with ``debug_checks=True``, and ``validate_state`` on a damaged state;
 11. raw text to theta at full width: (a) the bench corpus rendered as
     text (each word id a letters-only token, shuffled, with punctuation,
     digits and upper case mixed in), ``build_corpus`` on its native path
     (the ingest library built under ``build/native/``) and its Python
     path, both equal to the rendered corpus, docs/s of each; (b)
     ``pipeline.fit_model`` from that vocabulary (spectral, 3 EM
     iterations): artifact set with ``vocab.json`` and ``fit_config.json``;
     (c) 2,048 new documents as text, with tokens and two documents out of
     the vocabulary, through ``ThetaServer.infer_text``: equal bit for bit
     to ``infer(align_corpus(texts))``, the report's counts exact, eta
     against the CPU port's on 256 of them where both converge, requests
     of 1, 16, 256 and 2,048 texts timed with the host's encode apart from
     the card's infer; (d) the CLI in this process: ``fit`` from a .mm file
     read by the native reader (bounds and beta bit-equal to an
     in-process ``fit_model``'s), ``find-k``, ``search-k``, ``select``, ``synth`` and
     ``train-eval --fast`` at K=100, V=10,000, 8,192 documents, and
     ``python -m strutopy_tpu_torch.cli infer --text`` in a subprocess
     against (c); (e) ``select_model``'s peak device memory at 2 and 4
     runs (stage-1 states parked on the host); ``native/`` unchanged;
 12. the E-step options at the bench width: (a) B1, B3 and B4 in their
     bf16-beta_doc modes (``newton_bf16_beta``) against their plain
     versions given the same bf16 beta_doc, bf16 Hessian on and off, at
     phase 2's chunks and then at phase 2b's widths (L=201 takes the
     ragged copies), timed beside their bounds and, in turns, against
     their float32-beta_doc modes; (b) from one state after phase 4's 2
     cold iterations, one two-pass iteration with ``two_pass_fused`` and
     one without: eta and Newton counts bit-equal, overflow equal, bound
     and beta within 1e-5, walls printed; again with a straggler fraction
     of 0.01 and a pass-1 cap of 2, which overflow, so the fallback sweep
     runs; (c) from that
     state one iteration with ``newton_bf16_beta`` on the stage path and
     on B4 (bounds within 1e-4 of each other, only bf16-beta_doc modes
     launched), its bound gap to the float32 beta_doc's iteration, and on
     B5, which must equal B5 without the option bit for bit; (d) both
     options through ``STM.expectation_maximization`` on the stage path
     and on B4, 3 iterations each: the bf16-beta_doc modes' launches;
 13. multi-device fits (``strutopy_tpu_torch/parallel/``): (a) an NCCL
     world of one started by ``parallel.mesh.init_from_env``: the default
     configuration on ``make_mesh(1)`` (spectral init through the sharded
     Gram scan) and the bench configuration on ``make_mesh_2d(1, 1)``
     (every chunk's beta_doc through a vocab all-reduce), 3 EM iterations
     each, and 2,048 documents served on each mesh, against the same runs
     unmeshed: bounds, beta and theta bit-equal (a world of one reduces
     nothing), bounds within 1e-6 relative, served theta within 1e-5;
     (b) two ranks on the one card,
     started by this script (``--mesh-rank``): an NCCL probe first, gloo
     with CUDA tensors when NCCL refuses two ranks on one device; gates A
     (1-D mesh of 2), B (1 x 2 docs x vocab), C (two length buckets,
     two-pass), E and E2 (serving on each), G (the content model, 1 x 2)
     and H (resume, bit for bit) at K=100, V=10,000 and N cut to 2,048,
     each against its unmeshed twin run here afterwards: cold iterations
     within 2e-4, one iteration from the meshed fit's state within 1e-5,
     served theta within 1e-5; every rank's B1-B3 launches, walls and the
     backend printed.  Both ranks share one card: no scaling figure;
 14. the E-step against the float64 oracle at full width: phase 4's warm
     state (beta, sigma, and the mu and eta of its first 256 documents in
     document order), ``run_estep`` on the card (single pass, float32
     beta, B1-B3 launched) against ``utils/reference_numpy.e_step`` on the
     host: the summed bound, beta_ss and sigma_ss (relative Frobenius),
     eta and theta per document where both solves converged, the
     documents either leaves unconverged counted; the oracle's docs/s on
     the host's CPU and the port's on the card printed;
 15. the bench entry point: ``python -m strutopy_tpu_torch.cli bench`` in a
     subprocess whose working directory is a temporary directory outside
     the checkout, so the CLI must find bench_torch.py from the package
     (5 two-pass warm-up EM iterations of bench.py's configuration, then
     ``local_estep_stats`` timed 5 times, and the float64 oracle's docs/s
     on the host's CPU, measured unless cached for this CPU): return code
     0, standard output exactly one JSON line with bench.py's four keys,
     value and vs_baseline finite and positive, vs_baseline the value over
     the baseline printed on standard error, B1-B3 and the glue kernels
     launched in the timed calls, the baseline cache written with the
     configuration and the CPU's name.  The headline is not compared with phase 4 or 14: its
     beta is torch's draw, and phase 14 times one chunk.

The last three lines of standard output are the card line, one JSON
object of per-kernel results, and ``{"ok": true, "device": {...}}``.
It needs torch built for CUDA and nvcc; it imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

import bench_torch
from bench_torch import card_line, cpu_name, make_corpus

K_BENCH, V_BENCH, N_BENCH, WORDS_BENCH = (bench_torch.K, bench_torch.V, bench_torch.N,
                                          bench_torch.N_WORDS)
REPLACES = {
    "fgh": "strutopy_tpu/ops/pallas_stages.py:52",
    "cg": "strutopy_tpu/ops/pallas_stages.py:172",
    "ls": "strutopy_tpu/ops/pallas_stages.py:249",
    "iter": "strutopy_tpu/ops/pallas_stages.py:285",
    "newton": "strutopy_tpu/ops/pallas_estep.py:77",
    "gather": "strutopy_tpu/ops/pallas_stages.py:504",
    # the port's own kernel: its JAX twin is an ordered XLA scatter, no pallas_call
    "scatter": "strutopy_tpu/ops/estep.py:695",
    # the port's own kernels: their JAX twin is the Newton body's XLA glue
    "direction": "strutopy_tpu/ops/estep.py:426",
    "accept": "strutopy_tpu/ops/estep.py:443",
    # the port's own kernel: its JAX twin is the finalize's factor and cho_inverse
    "factor": "strutopy_tpu/ops/estep.py:590",
    # the port's own kernel: its JAX twin is the finalize's XLA math around the factor
    "finalize": "strutopy_tpu/ops/estep.py:573",
}
# the bf16-beta_doc modes of B1, B3 and B4 (newton_bf16_beta), each an
# entry of its own, replacing the same TPU kernel given a bf16 beta_doc
BETA_MODES = {"fgh_bf16_beta": "fgh", "ls_bf16_beta": "ls", "iter_bf16_beta": "iter"}
REPLACES.update({mode: REPLACES[base] for mode, base in BETA_MODES.items()})
SOURCES = {k: "strutopy_tpu_torch/csrc/"
           + ("stages.cu" if BETA_MODES.get(k, k) in ("fgh", "cg", "ls", "direction", "accept",
                                                      "finalize")
              else "scatter.cu" if k == "scatter" else "factor.cu" if k == "factor"
              else "newton.cu")
           for k in REPLACES}
FIT_KERNELS = ("fgh", "cg", "ls", "scatter")  # what every fit on the stage path launches
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
# where it should, fails.  A bf16-beta_doc mode is held to the plain
# version of the same bf16 beta_doc, and its error must not lean toward
# the float32 beta_doc's plain outputs: projected on their difference
# from plain, it is at most LEAN_MAX of that difference (1 for a kernel
# that reads the unrounded beta_doc, ~0 for float32 rounding noise, which
# is as large as that difference in the sweep's values; phase 12).
RTOL = {"fgh.f": 1e-5, "fgh.g": 1e-5, "fgh.H": 1e-5, "cg": 1e-4, "ls": 1e-5}
BF16_FLIPS = 4 * 2.0 ** -7
DISCRIMINATE = 0.05
LEAN_MAX = 0.5
FIT_RTOL = 1e-4  # CUDA vs CPU bound per EM iteration (the f64-oracle invariant)
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet,
# dense): device-memory bytes/s, and operations/s by type.
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
SMEM_LIMIT = 232_448  # bytes of shared memory one block may opt in to


def random_beta(K, V, seed):
    g = np.random.RandomState(seed).gamma(0.1, 1.0, (K, V))
    return g / np.maximum(g.sum(axis=1, keepdims=True), 1e-300)


CARD = ""  # the card line, set by main()


class Failures(list):
    def check(self, ok: bool, what: str):
        print(("  ok   " if ok else "  FAIL ") + what, flush=True)
        if not ok:
            self.append(what)


def worst_ratio(got, want, bound):
    """(max |got - want|, max of |got - want| / bound over the elements)."""
    err = (got - want).abs()
    return float(err.max()), float((err / bound).max())


def graphed(torch, fn, reps):
    """``fn`` called ``reps`` times, captured in one CUDA graph: replaying it
    runs the same launches without the host's per-call cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: the wrappers query the device (opt-in shared memory) as they launch
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return graph.replay


def time_pair(torch, kernel_fn, plain_fn, reps=20, graph=True):
    """ms per call of kernel and plain, timed in turns (plain, kernel,
    kernel, plain) with CUDA events; the median of each side's rounds.
    With ``graph`` each round replays a CUDA graph of ``reps`` calls, so
    the time is the device's; without it (a function that synchronises
    with the host) the calls are made one by one.  A ``plain_fn`` of None
    times ``kernel_fn`` alone (its plain time is then nan)."""
    fns = {"kernel": kernel_fn, "plain": plain_fn}
    fns = {k: f for k, f in fns.items() if f is not None}
    for _ in range(3):
        for f in fns.values():
            f()
    torch.cuda.synchronize()
    calls = reps
    if graph:
        fns = {k: graphed(torch, f, reps) for k, f in fns.items()}
        calls = 1
    times = {"kernel": [], "plain": []}
    for side in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        if side not in fns:
            continue
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fns[side]()
        end.record()
        torch.cuda.synchronize()
        times[side].append(start.elapsed_time(end) / reps)
    return (float(np.median(times["kernel"])),
            float(np.median(times["plain"])) if times["plain"] else float("nan"))


def roofline(n_bytes, ops):
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over their types' peaks."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def hessian_ops(K, L):
    """Operations of one document's B·Bᵀ: H is symmetric, so the function
    needs its (K-1)K/2 upper-triangle entries, a dot product of length L
    (2L operations) each."""
    return 2 * ((K - 1) * K // 2) * L


def stage_bounds(inputs, aux):
    """Each stage kernel's least time at phase 2's inputs: its inputs read
    once, its outputs written once; fgh's product B·Bᵀ in bf16 (H is
    symmetric: its (K-1)K/2 entries, 2L operations each, a document) and
    its s, phi and operand in float32 (~6KL); cg's matvecs
    (2(K-1)² a step); the sweep's T mixtures (2TKL) and prior terms
    (2T(K-1)²) in float32."""
    eta, bd, c, mu, siginv = inputs
    B, K, L = bd.shape
    Km1, T, it = K - 1, aux["ts"].shape[0], aux["iters"]
    out = {"fgh": roofline(nbytes(eta, bd, c, mu, siginv) + 4 * B * (1 + Km1 + Km1 * Km1),
                           {"bf16": B * hessian_ops(K, L), "f32": 6 * B * K * L}),
           "cg": roofline(nbytes(aux["H"], aux["g"]) + 4 * B * Km1,
                          {"f32": 2 * B * it * Km1 * Km1}),
           "ls": roofline(nbytes(eta, aux["p"], aux["ts"], bd, c, mu, siginv) + 4 * B * T,
                          {"f32": 2 * B * T * (K * L + Km1 * Km1)})}
    return out


def step_ops(B, K, L, T, cg_iters, fgh_only=0):
    """Operations of B full Newton steps (f/g/H, CG, sweep) and of
    ``fgh_only`` f/g/H evaluations that end a converged document's loop."""
    Km1 = K - 1
    return {"bf16": (B + fgh_only) * hessian_ops(K, L),
            "f32": (B + fgh_only) * 6 * K * L
            + B * (2 * cg_iters * Km1 * Km1 + 2 * T * (K * L + Km1 * Km1))}


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


def kernel_outputs(stages, inputs, aux, bf16, cg=True):
    """The kernels' outputs on the same chunk; cg and the sweep take the
    plain H, g and p, so each kernel's own error is measured.  Without
    ``cg``, B1 and B3 only (they read beta_doc; CG does not)."""
    eta, bd, c, mu, siginv = inputs
    f, g, H = stages.fgh(eta, bd, c, mu, siginv, bf16=bf16)
    out = {"fgh.f": f, "fgh.g": g, "fgh.H": H,
           "ls": stages.linesearch(eta, aux["p"], aux["ts"], bd, c, mu, siginv)}
    if cg:
        out["cg"] = stages.cg(aux["H"], aux["g"], aux["iters"], bf16=bf16)
    return out


def lean(torch, got, want, other):
    """How far ``got`` leans from ``want`` toward ``other``: the projection
    of got - want on other - want, in units of other - want."""
    d = (other - want).reshape(-1).double()
    e = (got - want).reshape(-1).double()
    return float(torch.dot(e, d) / torch.clamp_min(torch.dot(d, d), 1e-300))


def judge(torch, stages, inputs, got, want, aux, bf16):
    """Per output in ``got``: (max abs error, worst error / bound over its
    elements, every value finite).  Passing means worst <= 1 and finite.
    For H and cg the worst also covers the DISCRIMINATE check (as its
    ratio), and for every output in ``aux["other_beta"]`` (the float32
    beta_doc's plain outputs, against a bf16-beta_doc mode) the LEAN_MAX
    check.  ``inputs`` holds beta_doc in float32 (the rounded values of a
    bf16 one)."""
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
        if name not in got:
            continue
        abs_e, worst = worst_ratio(got[name], want[name], bound)
        if name in aux["other"]:
            gap = float(torch.linalg.vector_norm(aux["other"][name] - want[name]))
            err = float(torch.linalg.vector_norm(got[name] - want[name]))
            worst = max(worst, err / max(DISCRIMINATE * gap, 1e-30))
        if name in aux.get("other_beta", {}):
            worst = max(worst, abs(lean(torch, got[name], want[name],
                                        aux["other_beta"][name])) / LEAN_MAX)
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
    for name, (bound_ms, bound_by) in stage_bounds(inputs, aux).items():
        results[name].update(bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    print_times(results, "bf16 on, median of 3 rounds of a CUDA graph of 20 calls")
    return results, inputs, aux


def print_times(results, how):
    for name, r in results.items():
        print(f"  time {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), share of the bound "
              f"{r['bound_ms'] / r['ms']:.3f}"
              + (f", library {r['library_ms']:.4f} ms" if r["library_ms"] is not None else "")
              + f" ({how}) [{CARD}]")


WIDTHS = ((50, 200), (50, 201), (200, 256), (400, 256))  # (K, L) of phase 2b


def phase_widths(torch, stages, fails, B=32):
    """Phase 2b: the same checks where the kernels take their other
    branches: K=50 (K-1 = 49 rows, padded to 64 for the tensor cores) with
    an L that ends in a partial slab (200) and one that is not a multiple
    of 4 (201, 4-byte copies); K=200 and K=400, with fgh's tile groups,
    smaller ls slabs, cg's Hessian read from L2 (K=400) and shared memory
    above the 48 KB default."""
    rng = np.random.default_rng(5)
    for K, L in WIDTHS:
        words = np.stack([rng.choice(V_BENCH, L, replace=False)
                          for _ in range(B)]).astype(np.int32)
        counts = np.zeros((B, L), np.float32)
        live = min(200, L - 7)
        counts[:, :live] = rng.integers(1, 5, (B, live))
        print(f"phase 2b: kernels vs plain, B={B} K={K} L={L}")
        check_stages(torch, stages, fails, stage_inputs(torch, words, counts, K, seed=K),
                     f"K={K} L={L}")


def phase_determinism(torch, stages, fails, inputs, aux, seed=9):
    """fgh, cg (both bf16 modes), the sweep and the whole Newton loop (B5)
    on a permuted half of phase 2's chunk, and fgh, the sweep and one fused
    iteration (B4) in their bf16-beta_doc modes: each document's outputs
    must equal, bit for bit, its outputs in the whole chunk, since a
    document's results may depend on nothing but its own inputs (the
    two-pass schedule repacks documents into chunks, buckets and served
    requests are smaller chunks)."""
    eta, bd, c, mu, siginv = inputs
    B = eta.shape[0]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.randperm(B, generator=gen)[: B // 2].to(eta.device)
    sub = [t[idx].contiguous() for t in (eta, bd, c, mu)]
    p, H, g, ts = aux["p"], aux["H"], aux["g"], aux["ts"]

    def same_rows(what, whole, half):
        torch.cuda.synchronize()
        same = all(bool(torch.equal(w[idx], h)) for w, h in zip(whole, half))
        fails.check(same, f"{what} of {B // 2} permuted documents equal their values in the "
                          f"whole chunk bit for bit {same}")

    for bf16 in (False, True):
        same_rows(f"fgh bf16={bf16}: f, g, H", stages.fgh(eta, bd, c, mu, siginv, bf16=bf16),
                  stages.fgh(sub[0], sub[1], sub[2], sub[3], siginv, bf16=bf16))
        same_rows(f"cg bf16={bf16}: the direction",
                  (stages.cg(H, g, aux["iters"], bf16=bf16),),
                  (stages.cg(H[idx].contiguous(), g[idx].contiguous(), aux["iters"], bf16=bf16),))
        same_rows(f"newton bf16={bf16}: eta and the Newton count",
                  stages.newton_loop(bd, c, mu, eta, siginv, ts, LOOP_ITERS, GRAD_TOL,
                                     aux["iters"], bf16),
                  stages.newton_loop(sub[1], sub[2], sub[3], sub[0], siginv, ts, LOOP_ITERS,
                                     GRAD_TOL, aux["iters"], bf16))
    sub_p = p[idx].contiguous()
    same_rows("ls: the sweep", (stages.linesearch(eta, p, ts, bd, c, mu, siginv),),
              (stages.linesearch(sub[0], sub_p, ts, sub[1], sub[2], sub[3], siginv),))
    bd_b, sub_b = bd.to(torch.bfloat16), sub[1].to(torch.bfloat16)
    for bf16 in (False, True):
        same_rows(f"fgh bf16={bf16}, bf16 beta_doc: f, g, H",
                  stages.fgh(eta, bd_b, c, mu, siginv, bf16=bf16),
                  stages.fgh(sub[0], sub_b, sub[2], sub[3], siginv, bf16=bf16))
    same_rows("ls, bf16 beta_doc: the sweep", (stages.linesearch(eta, p, ts, bd_b, c, mu, siginv),),
              (stages.linesearch(sub[0], sub_p, ts, sub_b, sub[2], sub[3], siginv),))
    done = torch.zeros(eta.shape[0], dtype=torch.bool, device=eta.device)
    same_rows("iter, bf16 beta_doc: eta, done, advance",
              stages.newton_iter(eta, bd_b, c, mu, siginv, ts, done, GRAD_TOL, aux["iters"]),
              stages.newton_iter(sub[0], sub_b, sub[2], sub[3], siginv, ts, done[idx], GRAD_TOL,
                                 aux["iters"]))


# ---------------------------------------------------------------------------
# phase 2c: the ordered phi scatter
# ---------------------------------------------------------------------------

SCATTER_A = 2  # the content-model case's aspects


def scatter_cases(torch, words, counts, K, seed=13):
    """The scatter's inputs at the bench chunk, one case a kind of key:
    name -> (beta_ss before the chunk, words, aspects, vocab axis).
    beta_ss holds non-negative sums, as after earlier chunks; "vocab" is
    rank 1 of a vocab axis of 2 (its block of V/2 words); "permuted" maps
    every word id through one permutation of [0, V)."""
    from strutopy_tpu_torch.parallel.mesh import MeshAxis

    gen = torch.Generator(device="cpu").manual_seed(seed)
    V = V_BENCH

    def ss(*shape):
        return (50 * torch.rand(*shape, generator=gen)).cuda()

    w = torch.as_tensor(words, device="cuda")
    aspects = torch.randint(0, SCATTER_A, (w.shape[0],), generator=gen,
                            dtype=torch.int32).cuda()
    perm = torch.randperm(V, generator=gen).cuda()
    kv = ss(K, V)
    kv_permuted = torch.empty_like(kv)
    kv_permuted[:, perm] = kv  # word w's column at pi(w)
    return {"kv": (kv, w, None, None),
            "aspect": (ss(SCATTER_A, K, V), w, aspects, None),
            "vocab": (ss(K, V // 2), w, None, MeshAxis(None, 1, 2)),
            "permuted": (kv_permuted, perm.to(torch.int32)[w.long()], None, None)}, perm


def phase_scatter(torch, stages, fails, inputs, words, counts):
    """Phase 2c: the ordered phi scatter (``stages.scatter_phi``, the fit's
    ``estep._scatter_phi``) at the bench chunk, phi from the finalize of
    phase 2's inputs: the kernel against its plain version bit for bit for
    (K, V), aspect (A=2), vocab-local and permuted keys, the permuted
    case's columns equal to the (K, V) case's, then timed beside its plan,
    its bound, atomic ``index_add_`` and deterministic ``index_add_``."""
    from strutopy_tpu_torch.ops import estep

    eta, bd, c, mu, siginv = inputs
    B, K, L = bd.shape
    _, _, _, phi = estep._finalize_chunk(eta, bd, c, mu, torch.ones(B, device="cuda"), siginv,
                                         torch.zeros((), device="cuda"), torch.sum(c, dim=1))
    rows = phi.transpose(1, 2).reshape(B * L, K)
    fails.check(rows.data_ptr() == phi.data_ptr() and rows.is_contiguous(),
                "phase 2c: the finalize's phi reaches the scatter as entry-major rows, no copy")
    cases, perm = scatter_cases(torch, words, counts, K)
    print(f"phase 2c: ordered phi scatter, B={B} K={K} L={L} V={V_BENCH}, "
          f"{int((c > 0).sum())} live slots of {B * L}")
    outs, max_err, plans = {}, 0.0, {}
    for name, (ss0, w, asp, vocab) in cases.items():
        plan = estep._scatter_plan(ss0, w, asp, vocab, c)
        Vb = ss0.shape[-1]
        reset(stages)
        got = stages.scatter_phi(ss0.clone(), rows, plan, Vb)
        launched = stages.LAUNCHES["scatter"]
        want = stages.scatter_phi_plain(ss0.clone(), rows, plan, Vb)
        via = estep._scatter_phi(ss0.clone(), phi, w, asp, vocab, c)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        depth = plan.offsets[1:] - plan.offsets[:-1]
        fails.check(launched == 1 and torch.equal(got, want) and torch.equal(via, got)
                    and bool(torch.isfinite(got).all()),
                    f"scatter {name}: {launched} launch; kernel equals plain bit for bit "
                    f"{torch.equal(got, want)} (max |diff| {err:.3e}), estep._scatter_phi "
                    f"equals both {torch.equal(via, got)}; {int((depth > 0).sum())} keys of "
                    f"{depth.shape[0]} touched, deepest {int(depth.max())} entries")
        outs[name], plans[name] = got, plan
    same = torch.equal(outs["permuted"][:, perm], outs["kv"])
    fails.check(same, f"scatter permuted: column pi(w) of the permuted keys' result equals column "
                      f"w of the (K, V) result bit for bit {same}")

    # the layout the scatter reads costs the finalize this much over phi_hat's own
    phi_hat = stages.f_g_H_batched(eta, bd, c, mu, siginv, torch.sum(c, dim=1), False)[4]
    entry_major = torch.empty(B, L, K, device="cuda").transpose(1, 2)
    em_ms = time_pair(torch, lambda: torch.mul(phi_hat, c[:, None, :], out=entry_major), None)[0]
    own_ms = time_pair(torch, lambda: phi_hat * c[:, None, :], None)[0]
    print(f"  time the finalize's phi_hat * counts written entry-major {em_ms:.4f} ms, in "
          f"phi_hat's (B, K, L) layout {own_ms:.4f} ms [{CARD}]")
    del phi_hat, entry_major

    # times at the main path's case, (K, V): device times from CUDA graphs,
    # and call by call, as the fit makes them (host launches included)
    ss0, w, _, _ = cases["kv"]
    plan = plans["kv"]
    ss = ss0.clone()
    idx = w.reshape(-1).long()
    src = phi.permute(1, 0, 2).reshape(K, B * L)  # index_add_'s own layout, made once
    calls = {
        "kernel": lambda: stages.scatter_phi(ss, rows, plan, V_BENCH),
        "plan (sort, searchsorted)": lambda: estep._scatter_plan(ss0, w, None, None, c),
        "plan + kernel (estep._scatter_phi)": lambda: estep._scatter_phi(ss, phi, w, None,
                                                                         None, c),
        "atomic index_add_": lambda: ss.index_add_(1, idx, src),
        "deterministic index_add_": lambda: ss.index_add_(1, idx, src),
    }
    graph_ms, eager_ms = {}, {}
    for what, fn in calls.items():
        torch.use_deterministic_algorithms(what.startswith("deterministic"))
        try:
            graph_ms[what] = time_pair(torch, fn, None)[0]
            eager_ms[what] = time_pair(torch, fn, None, graph=False)[0]
        finally:
            torch.use_deterministic_algorithms(False)
        print(f"  time {what}: {graph_ms[what]:.4f} ms (graph), call by call "
              f"{eager_ms[what]:.4f} ms [{CARD}]")
    plain_ms = time_pair(torch, lambda: stages.scatter_phi_plain(ss, rows, plan, V_BENCH),
                         None, graph=False)[0]
    n_live = int(plan.offsets[-1])
    touched = int((plan.offsets[1:] > plan.offsets[:-1]).sum())
    bound_ms, bound_by = roofline(4 * (n_live * K + n_live + V_BENCH + 1) + 8 * touched * K,
                                  {"f32": n_live * K})
    result = {"max_abs_err": max_err, "ms": graph_ms["kernel"], "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": graph_ms["atomic index_add_"]}
    print_times({"scatter": result}, "(K, V) keys, a CUDA graph of 20 calls; plain call by "
                                     "call; library: atomic index_add_")
    print(f"  scatter bound: {n_live} live rows of {K} floats read, their perm and the "
          f"offsets, {touched} touched columns of beta_ss read and written")
    ours, det = "plan + kernel (estep._scatter_phi)", "deterministic index_add_"
    fails.check(eager_ms[ours] <= eager_ms[det] and graph_ms[ours] <= graph_ms[det],
                f"scatter: plan + kernel {eager_ms[ours]:.4f} ms call by call, "
                f"{graph_ms[ours]:.4f} ms graphed, no slower than deterministic index_add_ "
                f"{eager_ms[det]:.4f} / {graph_ms[det]:.4f} ms")
    return {"scatter": result}


STAGE_PLAN_FIELDS = ("bytes", "W", "stages", "blocks_per_sm", "siginv")
SIGINV_PLACES = ("L2", "ring")


def stage_plan(lib, which, K, bf16=True, beta_bf16=True):
    """The plan of B1 (``which`` "fgh") or B3 ("ls") at K: bytes a block,
    slab width W, ring depth, blocks an SM it is planned for, where its
    prior term reads siginv ("L2" or "ring", the ring's spare slabs);
    None where no plan fits."""
    import ctypes

    out = (ctypes.c_int * len(STAGE_PLAN_FIELDS))()
    if lib.stm_stage_plan(("fgh", "ls").index(which), K, int(bf16), int(beta_bf16), out) != 0:
        return None
    plan = dict(zip(STAGE_PLAN_FIELDS, out))
    plan["siginv"] = SIGINV_PLACES[plan["siginv"]]
    return plan


def check_beta_plans(fails, lib, K):
    """The bf16 beta_doc plans of B1 (bf16 Hessian on and off) and B3 at
    K: each within the shared memory of the blocks an SM it is planned
    for."""
    plans = {"fgh bf16": stage_plan(lib, "fgh", K), "fgh f32": stage_plan(lib, "fgh", K, False),
             "ls": stage_plan(lib, "ls", K)}
    fails.check(all(p is not None and 0 < p["bytes"] <= SMEM_LIMIT // p["blocks_per_sm"]
                    for p in plans.values()),
                f"K={K}: bf16 beta_doc plans {plans}")


def check_smem_plans(fails, lib, stages):
    """The kernels' shared memory per block at every K the port takes:
    within what a block may opt in to (it does not depend on L); and the
    fused kernels' (B4/B5) plan in each bf16 mode; with a bf16 beta_doc
    too (B1, B3, B4), and B1's and B3's bf16-β plans apart."""
    for K in (3, 10, 50, 100, 200, 400):
        plan = {"fgh bf16": lib.stm_fgh_smem(K, 1, 0), "fgh f32": lib.stm_fgh_smem(K, 0, 0),
                "ls": lib.stm_ls_smem(K, 0),
                "fgh bf16, bf16 beta": lib.stm_fgh_smem(K, 1, 1),
                "fgh f32, bf16 beta": lib.stm_fgh_smem(K, 0, 1),
                "ls bf16 beta": lib.stm_ls_smem(K, 1)}
        fused = {f"{what} {mode}": stages.newton_plan(K, 384, mode == "bf16", what == "newton")
                 for what in ("newton", "iter") for mode in ("bf16", "f32")}
        fused.update({f"iter {mode}, bf16 beta": stages.newton_plan(K, 384, mode == "bf16", False,
                                                                    beta_bf16=True)
                      for mode in ("bf16", "f32")})
        fails.check(all(0 < v <= SMEM_LIMIT for v in plan.values())
                    and all(f is not None and 0 < f["bytes"] <= SMEM_LIMIT
                            for f in fused.values()),
                    f"K={K}: shared memory per block {plan} bytes (<= {SMEM_LIMIT:,}); "
                    f"plans of the fused kernel at L=384 {fused}")
        check_beta_plans(fails, lib, K)


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


# ---------------------------------------------------------------------------
# B4 (one fused Newton iteration), B5 (the whole loop), B6 (row gather)
# ---------------------------------------------------------------------------
#
# B4 runs the bodies of B1-B3 and makes the step's discrete choices:
# converged or not (max|g| <= grad_tol), the -g fallback (gᵀp >= 0) and
# the largest step size that passes the Armijo test.  A document is ON
# THE MARGIN when rounding alone could flip one of them: |max|g| −
# grad_tol| within g's bound, |gᵀp| within its bound, or for some t at
# or above the chosen one |fs_t − (f + 1e-4·t·gᵀp)| within the sweep's
# bound (below it the test is at rounding level as t -> 0, but cannot
# change the choice).  On the margin only
# finiteness is required, and such documents are counted.  Off it, the
# flags must be equal, a done document must keep its eta bit for bit,
# and every eta element must lie within t · dir_bound + 2^-22 |eta| of
# plain, where dir_bound is the CG direction's own per-document bound:
# RTOL["cg"] · max|x| for CG's rounding plus, because B4's H may differ
# from plain's by the fgh bound (with its bf16 allowance), twice the
# largest move of the plain direction under two random symmetric
# perturbations of H of that size.  That bound is loose for one wrong
# rounding mode, so the eta of the stepping documents must besides sit
# far closer to plain than the other bf16 mode's plain step does
# (DISCRIMINATE, in Frobenius norm).
GRAD_TOL = 1e-5
N_STEPS = 12
# B5's whole loop against plain from the same eta0.  The two paths' etas
# follow trajectories that part by rounding, so the loop is held to
# their end points: f per document within LOOP_F_RTOL; no more documents
# left clearly unconverged, with max|g| above STALL_G, than plain leaves
# plus LOOP_STALL_FRAC of B (rounded up); and eta within LOOP_ETA_ATOL
# (tests/test_pallas.py:43's bound between two Newton paths) on every
# document both bring below STALL_G — where a path stops short of that,
# at the float32 floor or the iteration cap, its end point depends on
# the path (1.2e-2 apart at K=200 on the card with f equal to 1e-7).
# STALL_G is 10 grad_tol: grad_tol itself sits at the float32 floor of g
# (~1e-5 at Nd = 300), where each path leaves a few different documents
# just above it (ROADMAP Queue C), so a count at grad_tol is noise; a
# loop that stops early leaves most documents far above STALL_G.
LOOP_ETA_ATOL = 5e-3
LOOP_F_RTOL = 1e-5
STALL_G = 10 * GRAD_TOL
LOOP_STALL_FRAC = 0.01
# Newton counts per document are no check: at the float32 floor two paths
# hover for different numbers of steps (up to 19 apart on one document
# between the JAX kernel and plain, tests/test_torch_smoke_checks.py).
# But a loop that keeps stepping documents once they are done runs nearly
# every document to max_iters, so the documents that use the whole budget
# may exceed plain's by at most LOOP_CAP_FRAC of B (rounded up).
LOOP_CAP_FRAC = 0.5
LOOP_ITERS = 24


def step_sizes(torch, device):
    return torch.exp2(-torch.arange(N_STEPS, dtype=torch.float32, device=device))


def iter_plain_parts(torch, stages, inputs, done, bf16):
    """The plain Newton step's intermediate values and its result."""
    eta, bd, c, mu, siginv = inputs
    ts = step_sizes(torch, eta.device)
    cg_iters = min(6, bd.shape[1] - 1)
    f, g, H = stages.fgh_plain(eta, bd, c, mu, siginv, bf16=bf16)
    x = stages.cg_plain(H, g, cg_iters, bf16=bf16)
    gTx = torch.sum(g * x, 1)
    bad = gTx >= 0
    p = torch.where(bad[:, None], -g, x)
    gTp = torch.where(bad, -torch.sum(g * g, 1), gTx)
    fs = stages.linesearch_plain(eta, p, ts, bd, c, mu, siginv)
    rhs = f[:, None] + 1e-4 * ts[None, :] * gTp[:, None]
    t = torch.amax(torch.where(fs <= rhs, ts[None, :], 0.0), dim=1)
    want = stages.newton_iter_plain(eta, bd, c, mu, siginv, ts, done, GRAD_TOL, cg_iters, bf16)
    other = stages.newton_iter_plain(eta, bd, c, mu, siginv, ts, done, GRAD_TOL, cg_iters,
                                     not bf16)
    return dict(f=f, g=g, H=H, x=x, gTx=gTx, p=p, fs=fs, rhs=rhs, t=t, ts=ts,
                cg_iters=cg_iters, done=done, want=want, other=other, bf16=bf16)


def direction_bound(torch, stages, parts, H_bound):
    """RTOL["cg"] · max|x| plus twice the largest move of the plain CG
    direction under two random symmetric perturbations of H within
    ``H_bound``, per document (B,)."""
    H, g, x = parts["H"], parts["g"], parts["x"]
    move = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for seed in (1, 2):
        gen = torch.Generator(device=H.device).manual_seed(seed)
        E = (torch.rand(H.shape, generator=gen, device=H.device) * 2 - 1) * H_bound
        E = 0.5 * (E + E.transpose(1, 2))
        x2 = stages.cg_plain(H + E, g, parts["cg_iters"], bf16=parts["bf16"])
        move = torch.maximum(move, (x2 - x).abs().amax(1))
    return RTOL["cg"] * x.abs().amax(1) + 2 * move


def judge_iter(torch, stages, inputs, parts, got, lean_other=False):
    """B4 (or B5 after one step) against the plain step.  ``got`` is
    (eta, done, advance); done may be None (B5 reports no flags).
    Returns (worst error / bound, margin documents, flags equal off the
    margin, done documents unchanged, every value finite).  With
    ``lean_other`` the other bf16 mode's step is held off by LEAN_MAX in
    place of DISCRIMINATE (phase 12: a Frobenius norm over the chunk is
    set by its largest error, which one document sensitive to rounding can
    give within its own bound)."""
    eta, bd, c, mu, siginv = inputs
    eta_k, done_k, adv_k = got
    eta_p, done_p, adv_p = parts["want"]
    g, p, ts, t = parts["g"], parts["p"], parts["ts"], parts["t"]
    done0 = parts["done"]
    f_sc = f_scale(torch, eta[:, None, :], bd, c, mu, siginv)[:, 0]
    fs_sc = f_scale(torch, eta[:, None, :] + ts[None, :, None] * p[:, None, :], bd, c, mu, siginv)
    g_sc, H_sc, u = gh_scales(torch, stages, eta, bd, c, mu, siginv)
    H_bound = RTOL["fgh.H"] * H_sc
    if parts["bf16"]:
        H_bound = H_bound + BF16_FLIPS * u[:, :, None] * u[:, None, :]
    dir_b = direction_bound(torch, stages, parts, H_bound)
    g_b = RTOL["fgh.g"] * g_sc
    abs_g = g.abs()
    # the three discrete choices and the rounding each could see
    conv_m = (abs_g.amax(1) - GRAD_TOL).abs() <= g_b.amax(1)
    gTp_err = torch.sum(abs_g, 1) * dir_b + torch.sum(g_b * parts["x"].abs(), 1)
    bad_m = parts["gTx"].abs() <= gTp_err
    # a direction off by dir_b moves f(eta + t p) by about t g_tᵀΔp, g_t
    # the gradient at the candidate (small near the optimum)
    g1_t = torch.stack([
        torch.sum(stages.fgh_plain(eta + tt * p, bd, c, mu, siginv, bf16=False)[1].abs(), 1)
        for tt in ts.tolist()], dim=1)
    lhs_err = RTOL["ls"] * fs_sc + ts[None, :] * g1_t * dir_b[:, None]
    rhs_err = RTOL["fgh.f"] * f_sc[:, None] + 1e-4 * ts[None, :] * gTp_err[:, None]
    # only the test at the chosen step size and above decides the choice
    near = (parts["fs"] - parts["rhs"]).abs() <= lhs_err + rhs_err
    armijo_m = (near & (ts[None, :] >= t[:, None])).any(1)
    margin = (conv_m | bad_m | armijo_m) & ~done0
    off = ~margin & ~done0

    flags_ok = bool(torch.equal(adv_k[off], adv_p[off]))
    if done_k is not None:
        flags_ok = flags_ok and bool(torch.equal(done_k[off], done_p[off]))
        flags_ok = flags_ok and bool(done_k[done0].all()) and not bool(adv_k[done0].any())
    kept = bool(torch.equal(eta_k[done0], eta[done0]))
    bound = t[:, None] * dir_b[:, None] + 2.0 ** -22 * eta_p.abs()
    err = (eta_k - eta_p).abs()
    worst = float((err[off] / torch.clamp_min(bound[off], 1e-30)).max()) if off.any() else 0.0
    step = off & (t > 0) & adv_p & (parts["other"][0] != eta).any(1)
    if step.any() and lean_other:
        worst = max(worst, abs(lean(torch, eta_k[step], eta_p[step],
                                    parts["other"][0][step])) / LEAN_MAX)
    elif step.any():
        gap = float(torch.linalg.vector_norm(parts["other"][0][step] - eta_p[step]))
        e = float(torch.linalg.vector_norm(eta_k[step] - eta_p[step]))
        worst = max(worst, e / max(DISCRIMINATE * gap, 1e-30))
    # a bf16-beta_doc mode: no lean toward the float32 beta_doc's step
    if "other_beta" in parts and off.any():
        worst = max(worst, abs(lean(torch, eta_k[off], eta_p[off],
                                    parts["other_beta"][0][off])) / LEAN_MAX)
    finite = bool(torch.isfinite(eta_k).all())
    return worst, int(margin.sum()), flags_ok, kept, finite


def loop_stats(torch, stages, inputs_loop, eta):
    """f (B,) and max|g| (B,) at eta, float32 Hessian-free plain math."""
    bd, c, mu, siginv = inputs_loop
    f, g, _H = stages.fgh_plain(eta, bd, c, mu, siginv, bf16=False)
    return f, g.abs().amax(1)


def judge_loop(torch, stages, inputs_loop, got, want, max_iters=LOOP_ITERS):
    """B5's whole loop against plain from the same eta0: (max |Δeta| over
    the documents both converge, worst per-document |Δf| / (rtol |f|),
    documents above STALL_G kernel and plain, share of equal Newton
    counts, every value finite, documents that used all ``max_iters``
    kernel and plain)."""
    (eta_k, n_k), (eta_p, n_p) = got, want
    f_k, gm_k = loop_stats(torch, stages, inputs_loop, eta_k)
    f_p, gm_p = loop_stats(torch, stages, inputs_loop, eta_p)
    both = (gm_k <= STALL_G) & (gm_p <= STALL_G)
    d_eta = float((eta_k - eta_p)[both].abs().max()) if both.any() else 0.0
    f_ratio = float(((f_k - f_p).abs() / (LOOP_F_RTOL * f_p.abs())).max())
    stalls = (int((gm_k > STALL_G).sum()), int((gm_p > STALL_G).sum()))
    same_n = float((n_k == n_p).float().mean())
    capped = (int((n_k >= max_iters).sum()), int((n_p >= max_iters).sum()))
    return d_eta, f_ratio, stalls, same_n, bool(torch.isfinite(eta_k).all()), capped


def loop_ok(verdict, B):
    d_eta, f_ratio, (s_k, s_p), _same, finite, (c_k, c_p) = verdict
    return (finite and d_eta <= LOOP_ETA_ATOL and f_ratio <= 1.0
            and s_k <= s_p + math.ceil(LOOP_STALL_FRAC * B)
            and c_k <= c_p + math.ceil(LOOP_CAP_FRAC * B))


def dgp_chunk(torch, K, B, seed, device="cuda"):
    """B documents of the bench recipe (300 tokens) and the true beta they
    come from, padded to one bucket: (bd, counts, mu = 0, siginv = I),
    the prior the recipe draws eta from."""
    from strutopy_tpu_torch.corpus.bow import pad_corpus

    docs, _X, beta = make_corpus(K, V_BENCH, B, WORDS_BENCH, seed=seed, return_beta=True)
    return dgp_inputs(torch, pad_corpus(docs, V=V_BENCH), beta, device)


def dgp_inputs(torch, corpus, beta, device="cuda"):
    from strutopy_tpu_torch.ops.estep import _gather_beta

    dev = torch.device(device)
    K = beta.shape[0]
    bd = _gather_beta(torch.tensor(beta, dtype=torch.float32, device=dev),
                      torch.as_tensor(corpus.words, device=dev))
    c = torch.as_tensor(corpus.counts, device=dev)
    mu = torch.zeros(corpus.N, K - 1, dtype=torch.float32, device=dev)
    siginv = torch.eye(K - 1, dtype=torch.float32, device=dev)
    return bd, c, mu, siginv


def midway(torch, stages, inputs_loop, bf16, n_steps=2, every=7):
    """A Newton iterate part-way along plain's trajectory from mu, with
    every ``every``-th document also marked done: (eta, done)."""
    bd, c, mu, siginv = inputs_loop
    ts = step_sizes(torch, mu.device)
    eta, done = mu.clone(), torch.zeros(mu.shape[0], dtype=torch.bool, device=mu.device)
    for _ in range(n_steps):
        eta, done, _ = stages.newton_iter_plain(eta, bd, c, mu, siginv, ts, done, GRAD_TOL,
                                                min(6, bd.shape[1] - 1), bf16)
    done = done.clone()
    done[::every] = True
    return eta.contiguous(), done


def check_fused(torch, stages, fails, inputs_loop, label):
    """B4 and B5 against their plain versions on one chunk, bf16 off and
    on: B4 from a point part-way along the trajectory, B5 with one step
    (held to B4's check) and with the whole loop from eta0 = mu.  Returns
    max |kernel - plain| of each (bf16 on)."""
    bd, c, mu, siginv = inputs_loop
    B, K = mu.shape[0], bd.shape[1]
    ts = step_sizes(torch, mu.device)
    cg_iters = min(6, K - 1)
    errs = {}
    for bf16 in (False, True):
        eta, done = midway(torch, stages, inputs_loop, bf16)
        inputs = (eta, bd, c, mu, siginv)
        parts = iter_plain_parts(torch, stages, inputs, done, bf16)
        got = stages.newton_iter(eta, bd, c, mu, siginv, ts, done, GRAD_TOL, cg_iters, bf16)
        torch.cuda.synchronize()
        worst, n_margin, flags_ok, kept, finite = judge_iter(torch, stages, inputs, parts, got)
        fails.check(finite and flags_ok and kept and worst <= 1.0,
                    f"{label} iter bf16={bf16}: max_abs_err="
                    f"{float((got[0] - parts['want'][0]).abs().max()):.3e}, worst error/bound="
                    f"{worst:.3e}, flags equal off the margin {flags_ok}, done documents "
                    f"kept {kept}; {n_margin} of {B} documents on the margin")
        errs["iter"] = float((got[0] - parts["want"][0]).abs().max())

        inputs1 = (mu, bd, c, mu, siginv)
        no_done = torch.zeros(B, dtype=torch.bool, device=mu.device)
        parts1 = iter_plain_parts(torch, stages, inputs1, no_done, bf16)
        e1, n1 = stages.newton_loop(bd, c, mu, mu.clone(), siginv, ts, 1, GRAD_TOL, cg_iters, bf16)
        torch.cuda.synchronize()
        worst, n_margin, flags_ok, _kept, finite = judge_iter(
            torch, stages, inputs1, parts1, (e1, None, n1 > 0))
        same = bool(torch.equal(e1, stages.newton_iter(mu, bd, c, mu, siginv, ts, no_done,
                                                       GRAD_TOL, cg_iters, bf16)[0]))
        fails.check(finite and flags_ok and worst <= 1.0,
                    f"{label} newton max_iters=1 bf16={bf16}: worst error/bound {worst:.3e}, "
                    f"advance equal off the margin {flags_ok}; {n_margin} on the margin; "
                    f"eta bit-equal to iter's from the same start {same}")

        got5 = stages.newton_loop(bd, c, mu, mu.clone(), siginv, ts, LOOP_ITERS, GRAD_TOL,
                                  cg_iters, bf16)
        want5 = stages.newton_loop_plain(bd, c, mu, mu.clone(), siginv, ts, LOOP_ITERS, GRAD_TOL,
                                         cg_iters, bf16)
        torch.cuda.synchronize()
        v = judge_loop(torch, stages, inputs_loop, got5, want5)
        fails.check(loop_ok(v, B),
                    f"{label} newton bf16={bf16}: max |eta - plain| {v[0]:.3e} where both "
                    f"converge (tol "
                    f"{LOOP_ETA_ATOL:.0e}), worst |f - plain| / (rtol |f|) {v[1]:.3e} (<= 1), "
                    f"documents above {STALL_G:.0e} {v[2][0]} vs plain {v[2][1]} (at most "
                    f"{math.ceil(LOOP_STALL_FRAC * B)} more), equal Newton counts {v[3]:.3f}, "
                    f"documents using all {LOOP_ITERS} steps {v[5][0]} vs plain {v[5][1]} (at most "
                    f"{math.ceil(LOOP_CAP_FRAC * B)} more)")
        errs["newton"] = v[0]
    return errs


def phase_fused(torch, stages, fails, words, counts, beta_true):
    """Phase 2, B4-B6 at the main path's shapes: the bench chunk of
    documents with the bench recipe's true beta (mu = 0, sigma = I, the
    recipe's prior), then timed in turns."""
    from strutopy_tpu_torch.corpus.bow import PaddedCorpus
    from strutopy_tpu_torch.ops.estep import NewtonConfig, _batched_newton

    corpus = PaddedCorpus(words, counts, counts.sum(1) > 0, V_BENCH)
    inputs_loop = dgp_inputs(torch, corpus, beta_true)
    bd, c, mu, siginv = inputs_loop
    B, K, L = bd.shape
    print(f"phase 2: fused kernels vs plain, B={B} K={K} L={L} T={N_STEPS}, true beta")
    errs = check_fused(torch, stages, fails, inputs_loop, f"K={K}")

    beta_T = torch.tensor(beta_true.T.copy(), dtype=torch.float32, device="cuda")
    w = torch.as_tensor(words, device="cuda")
    got, want = stages.gather_rows(beta_T, w), stages.gather_rows_plain(beta_T, w)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want))
    fails.check(same, f"K={K} gather ({B}, {L}) rows of ({V_BENCH}, {K}): equal to "
                      f"index_select bit for bit {same}")
    errs["gather"] = float((got - want).abs().max())

    ts = step_sizes(torch, mu.device)
    eta, done = midway(torch, stages, inputs_loop, True)
    results = {k: {"max_abs_err": v, "library_ms": None} for k, v in errs.items()}
    # least times: inputs read once, outputs written once; the work of the
    # documents that step (B4), of every step the loop takes (B5, from its
    # Newton counts), and the distinct beta_T rows the gather reads (B6)
    T, Km1 = N_STEPS, K - 1
    io = nbytes(bd, c, mu, siginv, ts)
    adv = stages.newton_iter_plain(eta, bd, c, mu, siginv, ts, done, GRAD_TOL, 6, True)[2]
    n_step, n_conv = int(adv.sum()), int((~done & ~adv).sum())
    results["iter"]["bound_ms"], results["iter"]["bound_by"] = roofline(
        io + nbytes(eta, done) + B * (4 * Km1 + 2),
        step_ops(n_step, K, L, T, 6, fgh_only=n_conv))
    _eta, n_it = stages.newton_loop(bd, c, mu, mu, siginv, ts, LOOP_ITERS, GRAD_TOL, 6, True)
    torch.cuda.synchronize()
    n_total, n_short = int(n_it.sum()), int((n_it < LOOP_ITERS).sum())
    n_max = int(n_it.max())
    results["newton"]["bound_ms"], results["newton"]["bound_by"] = roofline(
        io + nbytes(mu) + B * 4 * (Km1 + 1), step_ops(n_total, K, L, T, 6, fgh_only=n_short))
    rows = int(torch.unique(w).numel())
    results["gather"]["bound_ms"], results["gather"]["bound_by"] = roofline(
        nbytes(w) + 4 * rows * K + 4 * B * L * K, {})
    print(f"  B5's loop takes {n_total} Newton steps on the chunk ({n_short} documents end "
          f"converged), its slowest document {n_max}; the gather reads {rows} distinct rows")
    ms, pms = time_pair(
        torch, lambda: stages.newton_iter(eta, bd, c, mu, siginv, ts, done, GRAD_TOL, 6, True),
        lambda: stages.newton_iter_plain(eta, bd, c, mu, siginv, ts, done, GRAD_TOL, 6, True))
    results["iter"].update(ms=ms, plain_ms=pms)
    ms, pms = time_pair(
        torch, lambda: stages.newton_loop(bd, c, mu, mu, siginv, ts, LOOP_ITERS, GRAD_TOL, 6, True),
        lambda: stages.newton_loop_plain(bd, c, mu, mu, siginv, ts, LOOP_ITERS, GRAD_TOL, 6, True),
        reps=3, graph=False)
    results["newton"].update(ms=ms, plain_ms=pms)
    # a loop is bound by its longest chain: the chunk takes about its
    # slowest document's steps, each one step of one block
    print(f"  newton: the chunk's {ms:.4f} ms over its slowest document's {n_max} steps is "
          f"{1e3 * ms / n_max:.2f} us a step of that chain (the bound's "
          f"{1e3 * results['newton']['bound_ms'] / n_max:.3f} us a step) [{CARD}]")
    ms, pms = time_pair(torch, lambda: stages.gather_rows(beta_T, w),
                        lambda: stages.gather_rows_plain(beta_T, w))
    results["gather"].update(ms=ms, plain_ms=pms)
    flat = w.reshape(-1).long()
    results["gather"]["library_ms"] = time_pair(
        torch, lambda: torch.index_select(beta_T, 0, flat), None)[0]
    print_times(results, "bf16 on; median of 3 rounds of a CUDA graph of 20 calls, newton's "
                         "of 3 calls one by one")
    # the default path's whole loop on the same chunk, for comparison with
    # newton: the stage kernels, the PyTorch glue and a host sync a step
    stage_ms, newton_ms = time_pair(
        torch, lambda: _batched_newton(bd, c, mu, mu, siginv, NewtonConfig()),
        lambda: stages.newton_loop(bd, c, mu, mu, siginv, ts, LOOP_ITERS, GRAD_TOL, 6, True),
        reps=3, graph=False)
    print(f"  time of the loop on the same chunk: stage kernels (estep._batched_newton) "
          f"{stage_ms:.4f} ms, newton {newton_ms:.4f} ms (timed in turns)")
    # the same bodies and the same step glue (newton_doc.cuh): B5's
    # documents against the stage path's loop, equality expected, not held
    eta_s, n_s, _done = _batched_newton(bd, c, mu, mu, siginv, NewtonConfig())
    eta5, n5 = stages.newton_loop(bd, c, mu, mu, siginv, ts, LOOP_ITERS, GRAD_TOL, 6, True)
    same = int(((eta5 == eta_s).all(1) & (n5 == n_s)).sum())
    print(f"  newton vs the stage path's loop: eta and the Newton count bit-equal on {same} of "
          f"{B} documents")
    return results


# ---------------------------------------------------------------------------
# phase 2d: the step's glue kernels
# ---------------------------------------------------------------------------

GLUE = ("direction", "accept")  # the stage path's glue kernels, one launch each a chunk step
GLUE_WIDTHS = ((6, 1), (400, 16))  # (K, T) beside the bench chunk's (K_BENCH, N_STEPS)
GLUE_ULPS = 4  # gTp: |kernel - plain| <= GLUE_ULPS · eps · Σ|g_i p_i| (another summation order)
GLUE_OTHER_OPS = 8  # kernels a Newton loop may launch besides the five a step (its set-up)


def glue_cases(torch, B, K, T, seed, device="cuda"):
    """Inputs of the step's glue for B >= 8 documents at K with T step
    sizes: (g, x, eta, f, ts, done), with each case the glue branches on
    planted: every 7th document done, document 1 a NaN in g, every 5th
    from 2 a direction x that does not descend (x = g), document 3
    converged (max|g| = GRAD_TOL / 2).  :func:`glue_sweep` makes the sweep
    values."""
    gen = torch.Generator().manual_seed(seed)
    Km1 = K - 1
    g = torch.randn(B, Km1, generator=gen)
    x = -g * (0.5 + torch.rand(B, Km1, generator=gen)) + 0.3 * torch.randn(B, Km1, generator=gen)
    x[2::5] = g[2::5]
    g[1, Km1 // 2] = float("nan")
    g[3] *= 0.5 * GRAD_TOL / g[3].abs().max()
    eta = torch.randn(B, Km1, generator=gen)
    f = torch.randn(B, generator=gen)
    ts = torch.exp2(-torch.arange(T, dtype=torch.float32))
    done = torch.zeros(B, dtype=torch.bool)
    done[::7] = True
    return tuple(t.to(device) for t in (g, x, eta, f, ts, done))


def glue_sweep(torch, f, gTp, ts, seed):
    """Sweep values about each step size's Armijo line: fs = f + 1e-4 · t ·
    gTp · w with w uniform on (-1, 3), so a step size passes where w >= 1
    (for gTp < 0) and the largest that passes varies; document 4 passes
    none (fs = inf)."""
    gen = torch.Generator().manual_seed(seed)
    w = (4 * torch.rand(f.shape[0], ts.shape[0], generator=gen) - 1).to(f.device)
    fs = f[:, None] + 1e-4 * ts[None, :] * gTp[:, None] * w
    fs[4] = float("inf")
    return fs


def same_bits(torch, a, b):
    """Equal bit for bit (NaN payloads and the sign of 0 included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def glue_verdict(torch, stages, g, x, eta, f, ts, done, seed, planted):
    """Both glue kernels against their plain versions on the same inputs,
    the sweep from :func:`glue_sweep` on plain's gTp, n_iters from 0..4,
    then the accept kernel on an all-done chunk: ({check: bool}, gTp's
    largest error in units of its bound, the launch deltas, {kernel: max
    |kernel - plain|}).  conv, p, every flag, eta, n_iters and all_done
    must be plain's bit for bit; gTp within GLUE_ULPS of its scale; with
    ``planted``, :func:`glue_cases`' documents take their branches."""
    n0 = dict(stages.LAUNCHES)
    p, gTp, conv = stages.newton_direction(g, x, GRAD_TOL)
    pw, gw, cw = stages.newton_direction_plain(g, x, GRAD_TOL)
    fs = glue_sweep(torch, f, gw, ts, seed)
    it = torch.arange(g.shape[0], dtype=torch.int32, device=g.device) % 5
    it_p = it.clone()
    got = stages.newton_accept(eta, pw, fs, f, gw, ts, done, cw, it)
    want = stages.newton_accept_plain(eta, pw, fs, f, gw, ts, done, cw, it_p)
    alld = stages.newton_accept(eta, pw, fs, f, gw, ts, torch.ones_like(done), cw)
    launched = {k: stages.LAUNCHES[k] - n0[k] for k in GLUE}
    torch.cuda.synchronize()
    scale = (g * pw).abs().sum(1)
    fin = torch.isfinite(gw)
    err = ((gTp - gw).abs() / (GLUE_ULPS * torch.finfo(torch.float32).eps * scale))[fin]
    worst = float(err.max()) if err.numel() else 0.0
    checks = {
        "conv": same_bits(torch, conv, cw), "p": same_bits(torch, p, pw),
        "gTp": worst <= 1.0 and bool(torch.isnan(gTp[~fin]).all()),
        "eta": same_bits(torch, got[0], want[0]),
        "flags": all(same_bits(torch, a, b) for a, b in zip(got[1:], want[1:])),
        "n_iters": same_bits(torch, it, it_p),
        "no step": bool(got[1][4]) and not bool(got[3][4]),
        "all done": bool(alld[4]) and same_bits(torch, alld[0], eta) and not bool(alld[2].any()),
    }
    if planted:
        checks["planted"] = (bool(cw[3]) and not bool(cw[1]) and not bool(fin[1])
                             and bool(torch.equal(pw[2::5], -g[2::5])))
    errs = {"direction": float((gTp - gw)[fin].abs().max()),
            "accept": float((got[0] - want[0]).abs().max())}
    return checks, worst, launched, errs


def glue_host_us(torch, fn, n=200):
    """Host microseconds a call of ``fn``, ``n`` calls with no sync between."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sec = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * sec / n


def loop_device_ops(torch, fn):
    """The CUDA kernels and device-to-host copies of ``fn()`` (a Newton
    loop) from a torch.profiler trace: ({kernel name: count}, copies)."""
    import tempfile

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    copies = sum(1 for e in events if e.get("cat") == "gpu_memcpy")
    return kernels, copies


def phase_glue(torch, stages, fails, words, counts, beta_true):
    """Phase 2d: the stage path's two glue kernels (``newton_direction``
    between B2 and B3, ``newton_accept`` after B3) against their plain
    versions, bit for bit but gTp (within GLUE_ULPS), at the bench chunk
    from a point part-way along its trajectory, then on planted inputs
    (a done document, a NaN in g, a direction that does not descend, a
    converged document, one with no passing step size, an all-done chunk)
    at the bench chunk's K and T and at GLUE_WIDTHS; one launch each a
    call.  Then a recorded stage-path Newton loop: each glue kernel
    launched once a chunk step, and not at all on the fused paths; the
    device ops of a stage-path loop by name; and the kernels' device and
    host times beside the PyTorch glue's."""
    from strutopy_tpu_torch.corpus.bow import PaddedCorpus
    from strutopy_tpu_torch.ops.estep import NewtonConfig, _batched_newton, _newton_loop
    from strutopy_tpu_torch.utils import trace

    inputs_loop = dgp_inputs(torch, PaddedCorpus(words, counts, counts.sum(1) > 0, V_BENCH),
                             beta_true)
    bd, c, mu, siginv = inputs_loop
    B, K, L = bd.shape
    ts = step_sizes(torch, mu.device)
    eta, done = midway(torch, stages, inputs_loop, True)
    f, g, H = stages.fgh(eta, bd, c, mu, siginv, bf16=True)
    x = stages.cg(H, g, 6, bf16=True)
    print(f"phase 2d: the step's glue kernels vs plain, B={B} K={K} T={N_STEPS}")
    results = {k: {"max_abs_err": 0.0, "library_ms": None} for k in GLUE}
    cases = [("bench chunk, midway", (g, x, eta, f, ts, done), False)]
    cases += [(f"planted K={k} T={t}", glue_cases(torch, B, k, t, seed=20 + k), True)
              for k, t in ((K, N_STEPS),) + GLUE_WIDTHS]
    for label, args, planted in cases:
        checks, worst, launched, errs = glue_verdict(torch, stages, *args, seed=7,
                                                     planted=planted)
        fails.check(all(checks.values()) and launched == {"direction": 1, "accept": 2},
                    f"{label}: {checks}, gTp's worst error / bound {worst:.3f}; launches "
                    f"{launched}")
        for k in GLUE:
            results[k]["max_abs_err"] = max(results[k]["max_abs_err"], errs[k])

    # the step on the card: a recorded stage-path loop, and the fused paths
    counters = {}
    for path, run in (("stage", lambda: _batched_newton(bd, c, mu, mu, siginv, NewtonConfig())),
                      ("iter", lambda: _batched_newton(bd, c, mu, mu, siginv,
                                                       NewtonConfig(pallas_iter=True))),
                      ("newton", lambda: _newton_loop(bd, c, mu, mu, siginv, NewtonConfig()))):
        with trace.recording(), trace.span("phase 2d") as rec:
            run()
        rec.resolve()
        counters[path] = {k: rec.counters.get(k) for k in
                          ("newton.chunk_steps", "launch.fgh", "launch.direction",
                           "launch.accept", "launch.iter", "launch.newton")}
    steps = counters["stage"]["newton.chunk_steps"]
    fails.check(steps > 0 and all(counters["stage"][f"launch.{k}"] == steps
                                  for k in ("fgh",) + GLUE)
                and all(counters[p][f"launch.{k}"] == 0 for p in ("iter", "newton")
                        for k in GLUE),
                f"recorded loops: launch.direction and launch.accept equal newton.chunk_steps "
                f"on the stage path, 0 on the fused paths: {counters}")
    kernels, copies = loop_device_ops(
        torch, lambda: _batched_newton(bd, c, mu, mu, siginv, NewtonConfig()))
    names = ("fgh_kernel", "cg_kernel", "step_direction_kernel", "ls_kernel",
             "step_accept_kernel")
    mine = {n: sum(v for k, v in kernels.items() if n in k) for n in names}
    steps = mine["fgh_kernel"]
    other = {k: v for k, v in kernels.items() if not any(n in k for n in names)}
    fails.check(steps > 0 and all(v == steps for v in mine.values())
                and sum(other.values()) <= GLUE_OTHER_OPS and copies <= steps + 1,
                f"a stage-path loop of {steps} steps launches each of B1, B2, the direction, "
                f"B3 and the accept kernel once a step {mine}, {sum(other.values())} other "
                f"kernels in all (at most {GLUE_OTHER_OPS}: {other}) and {copies} "
                f"device-to-host copies (at most one a step and one before)")

    # times: the device's (CUDA graphs) and the host's, beside the PyTorch glue
    pw, gw, cw = stages.newton_direction_plain(g, x, GRAD_TOL)
    fs = stages.linesearch(eta, pw, ts, bd, c, mu, siginv)
    it = torch.zeros(B, dtype=torch.int32, device=g.device)
    dir_k = lambda: stages.newton_direction(g, x, GRAD_TOL)  # noqa: E731
    dir_p = lambda: stages.newton_direction_plain(g, x, GRAD_TOL)  # noqa: E731
    acc_k = lambda: stages.newton_accept(eta, pw, fs, f, gw, ts, done, cw, it)  # noqa: E731
    acc_p = lambda: stages.newton_accept_plain(eta, pw, fs, f, gw, ts, done, cw,  # noqa: E731
                                               it.clone())
    for name, kfn, pfn, io in (
            ("direction", dir_k, dir_p, nbytes(g, x, pw, gw, cw)),
            ("accept", acc_k, acc_p, nbytes(eta, pw, fs, f, gw, ts, done, cw, it, it)
             + nbytes(eta, done, done, done) + 1)):
        ms, pms = time_pair(torch, kfn, pfn)
        results[name].update(ms=ms, plain_ms=pms)
        results[name]["bound_ms"], results[name]["bound_by"] = roofline(io, {})
        print(f"  {name}: host {glue_host_us(torch, kfn):.1f} us a call, the PyTorch glue's "
              f"{glue_host_us(torch, pfn):.1f} [{CARD}]")
    print_times(results, "median of 3 rounds of a CUDA graph of 20 calls")
    return results


FACTOR_MS_MAX = 0.25  # ms a chunk at B=256, P=99 (the kernel's target)
FACTOR_MS_MAX_BLOCKED = 6.0  # ... at B=256, P=399, the blocked plan (its predicted most)
FACTOR_L_RTOL = 1e-4  # L: |kernel - plain| <= this x the document's max|L|
FACTOR_NU_RTOL = 2e-3  # nu: likewise, x max|nu| (cond(H) x float32 rounding)
FACTOR_NU_VS_PLAIN = 2.0  # nu's error against float64, at most this x plain's
# 3x3 leading blocks taking rungs 1-4, each clearly on its side of every
# threshold: PD; indefinite but diagonally repairable; singular after the
# repair (a pivot of exactly 0; rung 3's 1e-5 gives one of ~2e-5); the same
# at scale 1e6, where 1e-5 is below float32 resolution and only rung 4's
# 1e-3 x 1e6 factors it; then an all-NaN matrix, which fails all four
FACTOR_BLOCKS = (
    [[2.1, 0.1, 0.1], [0.1, 2.1, 0.1], [0.1, 0.1, 2.1]],
    [[1.0, 2.0, 0.0], [2.0, 1.0, 0.5], [0.0, 0.5, 3.0]],
    [[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
    [[1e6, 1e6, 0.0], [1e6, 1e6, 0.0], [0.0, 0.0, 1e6]],
)
FACTOR_PLANTED_RUNGS = [1, 2, 3, 4, 4]


def factor_planted(torch, P, device="cuda"):
    """(5, P, P): each FACTOR_BLOCKS block on an identity, then all NaN."""
    H = np.tile(np.eye(P, dtype=np.float32), (5, 1, 1))
    for b, blk in enumerate(FACTOR_BLOCKS):
        H[b, :3, :3] = blk
    H[4] = np.nan
    return torch.tensor(H, device=device)


def chunk_finalize_args(torch, docs, beta, mu, eta, sigma, device="cuda"):
    """``_finalize_chunk``'s arguments for one chunk of ``docs`` at ``eta``
    (host arrays), as the E-step forms them: (eta, beta_doc, counts, mu,
    doc_w (ones), siginv, sigmaentropy, Nd)."""
    from strutopy_tpu_torch.corpus.bow import pad_corpus
    from strutopy_tpu_torch.ops.estep import _gather_beta
    from strutopy_tpu_torch.ops.linalg import precompute_sigma

    corpus = pad_corpus(docs, V=beta.shape[-1])
    dev = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=device).to(dt)  # noqa: E731
    bd = _gather_beta(dev(beta), dev(corpus.words, torch.int32))
    c = dev(corpus.counts)
    siginv, sigmaentropy = precompute_sigma(dev(sigma))
    return (dev(eta), bd, c, dev(mu), torch.ones(c.shape[0], device=device), siginv,
            sigmaentropy, c.sum(1))


def chunk_hessians(torch, stages, docs, beta, mu, eta, sigma, device="cuda"):
    """The finalize's float32 Hessians of one chunk of ``docs`` at ``eta``
    (host arrays), as ``_finalize_chunk``'s plain version forms them."""
    eta, bd, c, mu, _w, siginv, _se, Nd = chunk_finalize_args(torch, docs, beta, mu, eta, sigma,
                                                              device)
    return stages.f_g_H_batched(eta, bd, c, mu, siginv, Nd, bf16=False)[2]


def content_shaped_args(torch, B=256, K=20, V=12_139, words=158, seed=31, device="cuda"):
    """``_finalize_chunk``'s arguments for a chunk shaped like
    poliblog_content_fit's (K=20, ~158 tokens a document) from the bench
    recipe, at the stage path's Newton optimum from mu = 0 (sigma = I)."""
    from strutopy_tpu_torch.corpus.bow import pad_corpus
    from strutopy_tpu_torch.ops.estep import NewtonConfig, _batched_newton

    docs, _X, beta = make_corpus(K, V, B, words, seed=seed, return_beta=True)
    bd, c, mu, siginv = dgp_inputs(torch, pad_corpus(docs, V=V), beta, device)
    eta = _batched_newton(bd, c, mu, mu, siginv, NewtonConfig())[0]
    return (eta, bd, c, mu, torch.ones(B, device=device), siginv,
            torch.zeros((), device=device), c.sum(1))


def content_shaped_hessians(torch, stages, **kw):
    """The finalize's Hessians of :func:`content_shaped_args`' chunk (P=19)."""
    eta, bd, c, mu, _w, siginv, _se, Nd = content_shaped_args(torch, **kw)
    return stages.f_g_H_batched(eta, bd, c, mu, siginv, Nd, bf16=False)[2]


def factor_verdict(torch, stages, H):
    """The kernel on H against the plain version: ({check: bool}, {number})."""
    n0 = stages.LAUNCHES["factor"]
    L, nu, rung = stages.chol_pd_inverse(H)
    L2, nu2, rung2 = stages.chol_pd_inverse(H)
    Lf, nuf, rungf = stages.chol_pd_inverse(H, inverse=False)
    launched = stages.LAUNCHES["factor"] - n0
    Lp, nup, rungp = stages.chol_pd_inverse_plain(H)
    torch.cuda.synchronize()
    out, checks = {}, {"rungs": same_bits(torch, rung, rungp), "launches": launched == 3}
    for name, got, want, rtol in (("L", L, Lp, FACTOR_L_RTOL), ("nu", nu, nup, FACTOR_NU_RTOL)):
        nan = torch.isnan(want)
        checks[f"{name} NaN where plain's"] = bool(torch.equal(torch.isnan(got), nan))
        scale = torch.where(nan, 0.0, want).abs().amax(dim=(1, 2), keepdim=True)
        err = torch.where(nan, 0.0, (got - want).abs())
        out[f"{name} err / rtol"] = float((err / (rtol * scale).clamp_min(1e-30)).max())
        out[f"{name} max abs err"] = float(err.max())
        checks[f"{name} within rtol"] = out[f"{name} err / rtol"] <= 1.0
    checks["L lower"] = bool(torch.equal(torch.nan_to_num(L), torch.nan_to_num(L).tril()))
    checks["nu symmetric"] = same_bits(torch, nu, nu.transpose(1, 2).contiguous())
    checks["twice bit-equal"] = all(same_bits(torch, a.contiguous(), b.contiguous())
                                    for a, b in ((L, L2), (nu, nu2), (rung, rung2)))
    checks["factor only"] = (nuf is None and same_bits(torch, Lf.contiguous(), L.contiguous())
                             and same_bits(torch, rungf, rung))
    fin = (rung == 1) & (rungp == 1)  # nu is H's inverse, not a repaired matrix's
    if bool(fin.any()):
        want64 = torch.linalg.inv(H[fin].double())
        rel = lambda x: float(torch.linalg.norm(x[fin].double() - want64)  # noqa: E731
                              / torch.linalg.norm(want64))
        out["nu err vs f64"], out["plain nu err vs f64"] = rel(nu), rel(nup)
        checks["nu err <= 2x plain's"] = (out["nu err vs f64"]
                                          <= FACTOR_NU_VS_PLAIN * out["plain nu err vs f64"])
    out["rungs"] = torch.bincount(rung.long(), minlength=5)[1:].tolist()
    return checks, out


def k400_random_hessians(torch, stages, B=256, L=384, seed=400):
    """Z's Hessians (P=399) of a random K=400 chunk (finalize_inputs)."""
    eta, bd, c, mu, w, siginv, _se, Nd = finalize_inputs(torch, B, 400, L, seed)
    return stages.finalize_terms(eta, bd, c, mu, w, siginv, Nd)[1]


def phase_factor(torch, stages, fails, st):
    """Phase 2e (run once phase 4 has a fitted state ``st``, its
    oracle_inputs): the finalize's factor kernel against its plain version
    on the fit's chunk (P=99), a content-shaped chunk (P=19) and, on the
    blocked plan, a random K=400 chunk and a K=400 chunk at its Newton
    optimum (k400_fit's shape: V=50,000, 300 tokens a document), a planted
    batch at each width, then its times beside its bound, plain's and the
    library pair's, nu's float64 error beside the library pair's, and the
    wrapper's host time."""
    chunks = {"k100 fit chunk (phase 4's state)": chunk_hessians(
                  torch, stages, st["docs"], st["beta"], st["mu"], st["eta"], st["sigma"]),
              "content-shaped chunk (K=20)": content_shaped_hessians(torch, stages),
              "random K=400 chunk (L=384)": k400_random_hessians(torch, stages),
              "k400-shaped chunk at its Newton optimum (V=50,000, 300 tokens)":
                  content_shaped_hessians(torch, stages, K=400, V=50_000, words=300, seed=400)}
    result = {"max_abs_err": 0.0}
    for label, H in chunks.items():
        B, P, _ = H.shape
        print(f"phase 2e: the finalize's factor vs plain, {label}: B={B} P={P}, plan "
              f"{stages.factor_plan(P)}")
        rungs = errs = None
        for case, Hc in (("chunk", H), ("planted", factor_planted(torch, P))):
            checks, out = factor_verdict(torch, stages, Hc)
            rungs = rungs or out["rungs"]
            errs = errs or (out.get("nu err vs f64"), out.get("plain nu err vs f64"))
            if case == "planted":
                checks["planted rungs"] = out["rungs"] == [
                    FACTOR_PLANTED_RUNGS.count(r) for r in (1, 2, 3, 4)]
            fails.check(all(checks.values()), f"{label}, {case}: {checks}; {out}")
            if case == "chunk":
                result["max_abs_err"] = max(result["max_abs_err"], out["L max abs err"],
                                            out["nu max abs err"])
        kfn = lambda: stages.chol_pd_inverse(H)  # noqa: E731
        pfn = lambda: stages.chol_pd_inverse_plain(H)  # noqa: E731

        def lfn():
            L, _info = torch.linalg.cholesky_ex(H)
            return torch.cholesky_inverse(L)

        ms = time_pair(torch, kfn, None)[0]
        plain_ms, library_ms = time_pair(torch, pfn, lfn, graph=False)
        bound_ms, bound_by = roofline(3 * nbytes(H) + B, {"f32": B * P ** 3})
        host_us = glue_host_us(torch, kfn)
        print(f"  factor at P={P}: kernel {ms:.4f} ms (CUDA graph of 20 calls), bound "
              f"{bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f}; plain (the ladder, "
              f"its read, cholesky_inverse) {plain_ms:.4f} ms, library pair (cholesky_ex, "
              f"cholesky_inverse) {library_ms:.4f} ms, call by call; nu's error vs float64 "
              f"{errs[0]}, the library pair's {errs[1]}; wrapper host "
              f"{host_us:.1f} us a call; the chunk's rungs 1-4 {rungs}; plan "
              f"{'smem' if stages.factor_plan(P)['in_smem'] else 'blocked'} [{CARD}]")
        if not stages.factor_plan(P)["in_smem"]:
            fails.check(ms <= FACTOR_MS_MAX_BLOCKED, f"factor at B={B}, P={P}: {ms:.4f} ms a "
                        f"chunk (at most {FACTOR_MS_MAX_BLOCKED})")
            result.setdefault("blocked", {})[label] = {
                "ms": ms, "bound_ms": bound_ms, "share": bound_ms / ms, "library_ms": library_ms,
                "nu_err": errs[0], "library_nu_err": errs[1]}
        if P == K_BENCH - 1:
            fails.check(ms <= FACTOR_MS_MAX, f"factor at B={B}, P={P}: {ms:.4f} ms a chunk "
                        f"(at most {FACTOR_MS_MAX})")
            result.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
    return {"factor": result}


FINALIZE_RTOL = 1e-5  # Z: x each element's sum of |float32 terms| (PERF.md section 6)
FINALIZE_KEYS = ("finalize", "factor", "finalize_bound")  # _finalize_chunk's launches a call


def finalize_inputs(torch, B, K, L, seed, A=0, device="cuda"):
    """``_finalize_chunk``'s arguments (eta, beta_doc, counts, mu, doc_w,
    siginv, sigmaentropy, Nd) for a random chunk: beta_doc gathered
    (``_gather_beta``) from random_beta's (K, V) beta or, with ``A``, an
    (A, K, V) one and the documents' aspects; L distinct words a document,
    counts 1-4 with a quarter of the slots 0; the last document a padding
    row (no counts, weight 0) and every fifth weight 0; siginv and
    sigmaentropy from a random SPD sigma."""
    from strutopy_tpu_torch.ops.estep import _gather_beta
    from strutopy_tpu_torch.ops.linalg import precompute_sigma

    rng = np.random.default_rng(seed)
    V = max(4 * L, 200)
    beta = np.stack([random_beta(K, V, seed + a) for a in range(max(A, 1))])
    words = np.stack([rng.choice(V, L, replace=False) for _ in range(B)]).astype(np.int32)
    counts = rng.integers(1, 5, (B, L)) * (rng.random((B, L)) > 0.25)
    counts[-1] = 0
    doc_w = np.ones(B)
    doc_w[::5] = 0.0
    doc_w[-1] = 0.0
    mu = rng.normal(0, 0.5, (B, K - 1))
    eta = mu + rng.normal(0, 0.3, (B, K - 1))
    R = rng.normal(0, 1, (K - 1, 2 * K))
    sigma = R @ R.T / (2 * K) + 0.5 * np.eye(K - 1)
    T = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), device=device).to(dt)  # noqa: E731
    if A:
        bd = _gather_beta(T(beta), T(words, torch.int32), T(rng.integers(0, A, B), torch.int32))
    else:
        bd = _gather_beta(T(beta[0]), T(words, torch.int32))
    c = T(counts)
    siginv, sigmaentropy = precompute_sigma(T(sigma))
    return T(eta), bd, c, T(mu), T(doc_w), siginv, sigmaentropy, c.sum(1)


def finalize_plain(torch, stages, args):
    """The plain finalize on ``args``' device, ``_finalize_chunk``'s CPU
    route: the plain terms, the cholesky_ex ladder and cholesky_inverse,
    the plain bound.  ({theta, nu, bound, phi}, Z's {g, H, loglik, quad},
    nu before its weight, L)."""
    eta, bd, c, mu, w, siginv, se, Nd = args
    g, H, theta, phi, terms = stages.finalize_terms_plain(eta, bd, c, mu, w, siginv, Nd)
    L, nu1, _rung = stages.chol_pd_inverse_plain(H)
    nu, bound = stages.finalize_bound_plain(L, nu1, terms, se, w)
    return ({"theta": theta, "nu": nu, "bound": bound, "phi": phi},
            {"g": g, "H": H, "loglik": terms[:, 0], "quad": terms[:, 1]}, nu1, L)


def composed_finalize(torch, stages, args):
    """The finalize as the port composed it before Z, on the card: the
    plain terms (f_g_H_batched and ~30 ops), F, the plain bound."""
    eta, bd, c, mu, w, siginv, se, Nd = args
    g, H, theta, phi, terms = stages.finalize_terms_plain(eta, bd, c, mu, w, siginv, Nd)
    L, nu, _rung = stages.chol_pd_inverse(H)
    return stages.finalize_bound_plain(L, nu, terms, se, w)


def finalize_bounds(torch, stages, args, want, nu1, L):
    """Each output's allowance, element by element: FINALIZE_RTOL times the
    sum of the magnitudes of its float32 terms (theta and phi themselves,
    their sums of positive terms; g and H gh_scales'; loglik Σ_l c_l|log t_l
    + m|; quad ½|d|ᵀ|Σ⁻¹||d|); nu as phase 2e holds the factor (FACTOR_NU_RTOL
    x the document's max|nu|) plus H's allowance carried through the inverse
    (|nu| H_sc |nu|); the bound its terms' (loglik's, quad's, sigmaentropy's,
    each |log L_ii|, and H's carried into the det term, ½ Σ_ij |nu_ij|
    H_sc_ij) plus the factor's (FACTOR_L_RTOL x max|L| / L_ii a pivot); the
    weighted outputs times |doc_w|."""
    eta, bd, c, mu, w, siginv, se, Nd = args
    d = lambda x: x.double()  # noqa: E731
    g_sc, H_sc, _u = gh_scales(torch, stages, eta, bd, c, mu, siginv)
    theta = d(want["theta"])
    full = d(stages.pad_eta(eta))
    m = torch.amax(full, dim=1, keepdim=True)
    e = torch.exp(full - m)
    t_l = torch.clamp_min(torch.bmm((theta * e)[:, None, :], d(bd))[:, 0], 1e-35)
    ll_sc = torch.sum(torch.where(c > 0, d(c) * (torch.log(t_l) + m).abs(), 0.0), dim=1)
    diff = d(eta - mu).abs()
    quad_sc = 0.5 * torch.sum(diff * (diff @ d(siginv).abs()), dim=1)
    nu1, Hs, Ld = d(nu1).abs(), d(H_sc), d(torch.diagonal(L, dim1=1, dim2=2))
    carry_nu = torch.bmm(torch.bmm(nu1, Hs), nu1)
    carry_det = 0.5 * torch.sum(nu1 * Hs, dim=(1, 2))
    l_max = d(L).abs().amax(dim=(1, 2))
    factor_det = FACTOR_L_RTOL * l_max * torch.sum(1.0 / Ld, dim=1)
    aw = d(w).abs()
    return {
        "theta": FINALIZE_RTOL * theta.abs(), "phi": FINALIZE_RTOL * d(want["phi"]).abs(),
        "g": FINALIZE_RTOL * d(g_sc), "H": FINALIZE_RTOL * Hs,
        "loglik": FINALIZE_RTOL * ll_sc, "quad": FINALIZE_RTOL * quad_sc,
        "nu": aw[:, None, None] * (FACTOR_NU_RTOL * nu1.amax(dim=(1, 2), keepdim=True)
                                   + FINALIZE_RTOL * carry_nu),
        "bound": aw * (FINALIZE_RTOL * (ll_sc + quad_sc + d(se).abs()
                                        + torch.log(Ld).abs().sum(dim=1) + carry_det)
                       + factor_det)}


def finalize_verdict(torch, stages, estep, args):
    """``_finalize_chunk`` (on the card: Z, F, the epilogue) and Z alone
    against the plain finalize on ``args``: ({check: bool}, {number}).
    Each output within its allowance (:func:`finalize_bounds`) and NaN
    where plain's; one call launching each of FINALIZE_KEYS once; two
    calls bit-equal; phi entry-major."""
    eta, bd, c, mu, w, siginv, se, Nd = args
    n0 = {k: stages.LAUNCHES[k] for k in FINALIZE_KEYS}
    got = dict(zip(("theta", "nu", "bound", "phi"), estep._finalize_chunk(*args)))
    launched = {k: stages.LAUNCHES[k] - n0[k] for k in FINALIZE_KEYS}
    again = estep._finalize_chunk(*args)
    g, H, _theta, _phi, terms = stages.finalize_terms(eta, bd, c, mu, w, siginv, Nd)
    got.update(g=g, H=H, loglik=terms[:, 0], quad=terms[:, 1])
    want, z_want, nu1, L = finalize_plain(torch, stages, args)
    want.update(z_want)
    allow = finalize_bounds(torch, stages, args, want, nu1, L)
    checks = {"launches": launched == {k: 1 for k in FINALIZE_KEYS},
              "twice bit-equal": all(same_bits(torch, got[k], a)
                                     for k, a in zip(("theta", "nu", "bound", "phi"), again)),
              "phi entry-major": got["phi"].stride() == want["phi"].stride()}
    out = {"max_abs_err": 0.0}
    for name, bound in allow.items():
        nan = torch.isnan(want[name])
        err = torch.where(nan, 0.0, (got[name].double() - want[name].double()).abs())
        worst = float((err / bound.clamp_min(1e-30)).max())
        checks[f"{name} NaN where plain's"] = bool(torch.equal(torch.isnan(got[name]), nan))
        checks[f"{name} within its allowance"] = worst <= 1.0
        out[f"{name} err / allowance"] = round(worst, 4)
        out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
    return checks, out


def phase_finalize(torch, stages, fails, st):
    """Phase 2f (run once phase 4 has a fitted state ``st``, its
    oracle_inputs): the finalize's route on the card (``_finalize_chunk``:
    Z, F, the epilogue) against the plain finalize on the fit's chunk (K=100)
    and a content-shaped chunk (K=20) (:func:`finalize_verdict`), then Z
    alone and the whole route timed (CUDA graphs of 20 calls) beside Z's
    bound, Z's plain version and the composition Z replaced (the plain
    terms, F, the plain bound), and the host time a call of the route and
    of that composition.  First, Z's plan at every K of B1's default mode
    (bf16 operand, float32 beta_doc), the E-step's Newton limit, and the
    verdict at the largest such K (Z without its phi stage)."""
    from strutopy_tpu_torch.ops import build, estep

    lib = build.load()
    k_max = max(K for K in range(2, 1025) if lib.stm_fgh_smem(K, 1, 0) > 0)
    missing = [K for K in range(2, k_max + 1) if stages.finalize_plan(K) is None]
    fails.check(not missing, f"Z has no plan at K={missing[:5]} (B1's default mode runs "
                             f"up to K={k_max})")
    args = finalize_inputs(torch, 4, k_max, 64, seed=k_max)
    checks, out = finalize_verdict(torch, stages, estep, args)
    print(f"phase 2f: the finalize vs plain at B1's largest default K={k_max} (B=4, L=64), "
          f"Z's plan {stages.finalize_plan(k_max)}: {out}")
    fails.check(all(checks.values()), f"K={k_max}: {checks}; {out}")

    chunks = {"k100 fit chunk (phase 4's state)": chunk_finalize_args(
                  torch, st["docs"], st["beta"], st["mu"], st["eta"], st["sigma"]),
              "content-shaped chunk (K=20)": content_shaped_args(torch)}
    result = {"max_abs_err": 0.0, "library_ms": None}
    for label, args in chunks.items():
        eta, bd, c, mu, w, siginv, se, Nd = args
        B, K, L = bd.shape
        print(f"phase 2f: the finalize (Z, F, epilogue) vs plain, {label}: B={B} K={K} L={L}, "
              f"Z's plan {stages.finalize_plan(K)}")
        checks, out = finalize_verdict(torch, stages, estep, args)
        fails.check(all(checks.values()), f"{label}: {checks}; {out}")
        result["max_abs_err"] = max(result["max_abs_err"], out["max_abs_err"])
        zfn = lambda: stages.finalize_terms(eta, bd, c, mu, w, siginv, Nd)  # noqa: E731
        zpfn = lambda: stages.finalize_terms_plain(eta, bd, c, mu, w, siginv, Nd)  # noqa: E731
        rfn = lambda: estep._finalize_chunk(*args)  # noqa: E731
        cfn = lambda: composed_finalize(torch, stages, args)  # noqa: E731
        z_ms, zp_ms = time_pair(torch, zfn, zpfn)
        route_ms, composed_ms = time_pair(torch, rfn, cfn)
        out_bytes = 4 * B * ((K - 1) + (K - 1) ** 2 + K + L * K + 2)
        bound_ms, bound_by = roofline(nbytes(eta, bd, c, mu, w, siginv, Nd) + out_bytes,
                                      {"f32": B * (hessian_ops(K, L) + 8 * K * L)})
        host_route, host_composed = glue_host_us(torch, rfn), glue_host_us(torch, cfn)
        print(f"  Z at K={K}, L={L}: {z_ms:.4f} ms (CUDA graph of 20 calls), bound "
              f"{bound_ms:.4f} ms ({bound_by}), share {bound_ms / z_ms:.3f}; plain "
              f"{zp_ms:.4f} ms; the route (Z, F, epilogue) {route_ms:.4f} ms against the "
              f"composition it replaced (plain terms, F, plain bound) {composed_ms:.4f} ms; "
              f"host {host_route:.1f} against {host_composed:.1f} us a call [{CARD}]")
        if K == K_BENCH:
            result.update(ms=z_ms, plain_ms=zp_ms, bound_ms=bound_ms, bound_by=bound_by)
    return {"finalize": result}


def phase_fused_widths(torch, stages, fails, B=256):
    """Phase 2b: B4 and B5 at K=200 and K=400, their large-K branches
    (tile groups in turn, H in a shared region of its own at K=200 and in
    a global scratch at K=400), on a chunk of the bench recipe at that K
    as large as the main path's.  The loop check's stall allowance is
    LOOP_STALL_FRAC of B rounded up: at 32 documents that is one document,
    3% of the chunk, below the chunk-to-chunk spread of either path's
    stall count at K=400, where f ~ 2,750 and a stalled step's Armijo test
    sits within an ulp of f."""
    for K in (200, 400):
        inputs_loop = dgp_chunk(torch, K, B, seed=K)
        print(f"phase 2b: fused kernels vs plain, B={B} K={K} L={inputs_loop[0].shape[2]}, "
              f"true beta")
        check_fused(torch, stages, fails, inputs_loop, f"K={K}")


# ---------------------------------------------------------------------------
# phases 4b, 5, 5b: the fused paths in the fit, and serving
# ---------------------------------------------------------------------------

FUSED_PATHS = {  # Newton path -> STMConfig changes that select it
    "stage": {},
    "iter": {"pallas_iter": True},
    "newton": {"use_pallas": True, "newton_pass1_iters": 0},
}
# each Newton path's kernels, and the phi scatter every E-step's finalize launches
# every path finalizes through Z, the factor kernel and the epilogue
PATH_KERNELS = {"stage": FIT_KERNELS + GLUE + FINALIZE_KEYS,
                "iter": ("iter", "scatter") + FINALIZE_KEYS,
                "newton": ("newton", "scatter") + FINALIZE_KEYS}


def reset(stages):
    for k in stages.LAUNCHES:
        stages.LAUNCHES[k] = 0


def em_step_fn(model, it):
    """The EM step ``expectation_maximization`` runs at iteration ``it``."""
    cold = model._em_step_cold is not None and it < model.config.newton_warmup_iters
    return model._em_step_cold if cold else model._em_step


def phase_fused_fit(torch, fails, stages, docs, X, cfg, card):
    """Phase 4b: the first 2 EM iterations of the bench fit (both cold,
    single pass) on the stage path, then each on both fused paths from the
    same state, their bounds against the stage path's.  From the same
    state, because the paths are not bit-identical: a cold Newton solve
    leaves a few percent of documents stalled (no Armijo step passes),
    which ones depending on rounding, and a chained fit carries those
    differences through the M-step into every later bound."""
    from strutopy_tpu_torch import STM

    c = cfg.replace(max_em_iter=2)
    ref = STM(docs, K=K_BENCH, X=X, config=c, device="cuda")
    states = [ref._state]
    for it in range(2):
        states.append(em_step_fn(ref, it)(states[-1], ref._data))
    ref_b = np.array([float(st.bound) for st in states[1:]])
    print(f"phase 4b: stage EM 0, 1 bounds {ref_b.tolist()}")
    for path in ("iter", "newton"):
        model = STM(docs, K=K_BENCH, X=X, config=c.replace(**FUSED_PATHS[path]), device="cuda")
        reset(stages)
        b = []
        for it in range(2):
            torch.cuda.synchronize()
            t0 = time.time()
            out = em_step_fn(model, it)(states[it], model._data)
            torch.cuda.synchronize()
            sec = time.time() - t0
            b.append(float(out.bound))
            print(f"phase 4b: {path} EM {it} from the stage path's state: bound {b[-1]:.6f}, "
                  f"{sec:.4f} s, {model.N / sec:.1f} docs/s [{card}]")
        launches = {k: stages.LAUNCHES[k] for k in PATH_KERNELS[path]}
        glue = {k: stages.LAUNCHES[k] for k in GLUE}
        b = np.asarray(b)
        rel = np.abs(b - ref_b) / np.abs(ref_b)
        fails.check(bool(np.isfinite(b).all()) and float(rel.max()) <= FIT_RTOL
                    and all(v > 0 for v in launches.values())
                    and not any(glue.values()),
                    f"{path} fit: 2 bounds finite, max rel diff to the stage path from the "
                    f"same state {rel.max():.3e} (tol {FIT_RTOL:.0e}); launches {launches}, "
                    f"glue kernels none {glue}")


def recorded_fit(torch, model):
    """Run ``model.expectation_maximization()`` with each EM step's new
    state copied to the host as it comes: [(bound, beta, sigma, eta)] an
    iteration."""
    seen = []
    for attr in ("_em_step_cold", "_em_step"):
        step = getattr(model, attr)
        if step is None:
            continue

        def recording(state, data, step=step):
            out = step(state, data)
            seen.append((float(out.bound), out.beta.cpu(), out.sigma.cpu(), out.eta.cpu()))
            return out

        setattr(model, attr, recording)
    model.expectation_maximization()
    return seen


def phase_twins(torch, fails, docs, X, cfg, card):
    """Phase 4c: two fits of the bench configuration (phase 4's: 2 cold and
    3 two-pass EM iterations), one after the other in this process, with
    PyTorch's deterministic-algorithms flag off, as a user's fit runs:
    the bound, beta, sigma and eta of every iteration bit-equal.  Every
    kernel adds in a fixed order, the phi scatter too, so a fit is a
    function of its inputs."""
    from strutopy_tpu_torch import STM

    flag = torch.are_deterministic_algorithms_enabled()
    fails.check(not flag, f"phase 4c: torch.are_deterministic_algorithms_enabled() is {flag}")
    t0 = time.time()
    runs = [recorded_fit(torch, STM(docs, K=K_BENCH, X=X, config=cfg, device="cuda"))
            for _ in range(2)]
    sec = time.time() - t0
    (a, b), names = runs, ("bound", "beta", "sigma", "eta")
    unequal = [(it, name) for it, (x, y) in enumerate(zip(a, b))
               for name, u, v in zip(names, x, y)
               if not (u == v if name == "bound" else torch.equal(u, v))]
    gaps = [max(abs(x[0] - y[0]) / abs(y[0]), *(float((u - v).abs().max())
                                                   for u, v in zip(x[1:], y[1:])))
            for x, y in zip(a, b)]
    fails.check(len(a) == len(b) == cfg.max_em_iter and not unequal,
                f"phase 4c: two bench fits in one process, flag off: {len(a)} and {len(b)} "
                f"iterations, bound, beta, sigma and eta bit-equal at every one "
                f"{not unequal} (unequal: {unequal[:6]}; largest gap an iteration "
                f"{[f'{g:.2e}' for g in gaps]}); bounds {[x[0] for x in a]}; two fits "
                f"{sec:.1f} s [{card}]")


def simplex_ok(theta, n, K):
    return (theta.shape == (n, K) and bool(np.isfinite(theta).all())
            and bool((theta >= 0).all()) and bool(np.allclose(theta.sum(1), 1, atol=1e-4)))


def served_gmax(torch, stages, srv, docs, X, etas, chunk=256):
    """max|g| (float32 Hessian-free plain math) of each served document at
    each of ``etas`` (numpy (n, K-1) arrays in document order)."""
    from strutopy_tpu_torch.corpus.bow import pad_corpus
    from strutopy_tpu_torch.models.serving import _prior_means
    from strutopy_tpu_torch.ops.estep import _gather_beta
    from strutopy_tpu_torch.ops.linalg import precompute_sigma

    n = len(docs)
    mu = _prior_means(srv._gamma, srv._eta_mean, srv.cfg, srv.K, n, X, train=srv._train)
    corpus = pad_corpus(docs, V=srv.V)
    siginv, _ = precompute_sigma(srv._sigma.float())
    out = [[] for _ in etas]
    for lo in range(0, n, chunk):
        w = torch.as_tensor(corpus.words[lo:lo + chunk], device=srv.device)
        c = torch.as_tensor(corpus.counts[lo:lo + chunk], device=srv.device)
        bd = _gather_beta(srv._beta.float(), w)
        m = torch.as_tensor(mu[lo:lo + chunk], device=srv.device)
        for o, eta in zip(out, etas):
            e = torch.as_tensor(eta[lo:lo + chunk], device=srv.device)
            o.append(loop_stats(torch, stages, (bd, c, m, siginv), e)[1])
    return [torch.cat(o).cpu().numpy() for o in out]


def check_served(torch, stages, fails, srv, docs, X, path, eta, eta_stage):
    """A fused path's served eta against the stage path's, held as phase
    2's loop check holds B5 to plain: within LOOP_ETA_ATOL on every
    document both bring below STALL_G, and no more documents left above it
    than the stage path leaves plus LOOP_STALL_FRAC of them.  The paths are
    not bit-identical, and a document where no Armijo step passes stops
    where it is, which one depending on rounding."""
    gm, gm_s = served_gmax(torch, stages, srv, docs, X, (eta, eta_stage))
    both = (gm <= STALL_G) & (gm_s <= STALL_G)
    d = float(np.abs(eta - eta_stage)[both].max()) if both.any() else 0.0
    stalls, stalls_s = int((gm > STALL_G).sum()), int((gm_s > STALL_G).sum())
    allowed = math.ceil(LOOP_STALL_FRAC * len(docs))
    fails.check(d <= LOOP_ETA_ATOL and stalls <= stalls_s + allowed,
                f"serve {path}: max |eta - stage path's| {d:.3e} on the {int(both.sum())} "
                f"documents both bring below {STALL_G:.0e} (tol {LOOP_ETA_ATOL:.0e}); "
                f"above it {stalls} vs the stage path's {stalls_s} (at most {allowed} more); "
                f"max |eta - stage path's| over all {float(np.abs(eta - eta_stage).max()):.3e}")


def phase_serve(torch, stages, fails, model, card, n_docs=2048):
    """Phase 5: save phase 4's model, load it with ThetaServer and serve
    new documents of the bench recipe on the three Newton paths; then
    time requests of 1, 16, 256 and 2,048 documents on each.  Returns
    each fused kernel's launches on its path."""
    import tempfile

    from strutopy_tpu_torch import ThetaServer
    from strutopy_tpu_torch.ops import build

    docs, X = make_corpus(K_BENCH, V_BENCH, n_docs, WORDS_BENCH, seed=11)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as model_dir:
        model.save_model(model_dir)
        srv = ThetaServer(model_dir, device="cuda")
        saved = srv.cfg
        print(f"phase 5: serving {n_docs} new documents from {model_dir} (K={srv.K}, "
              f"V={srv.V}; saved config: pass-1 cap {saved.newton_pass1_iters}, batch "
              f"{saved.batch_size}); {card}")
        etas, launches = {}, {}
        for path, change in FUSED_PATHS.items():
            srv.cfg = saved.replace(**change)
            srv.warmup()
            reset(stages)
            theta, eta = srv.infer(docs, X=X)
            launches[path] = dict(stages.LAUNCHES)
            etas[path] = eta
            used = PATH_KERNELS[path]
            fails.check(simplex_ok(theta, n_docs, K_BENCH)
                        and all(launches[path][k] > 0 for k in used)
                        and all(v == 0 for k, v in launches[path].items() if k not in used),
                        f"serve {path}: theta finite on the simplex; launches {launches[path]}")
            if path != "stage":
                check_served(torch, stages, fails, srv, docs, X, path, eta, etas["stage"])
            for n in (1, 16, 256, n_docs):
                srv.infer(docs[:n], X=X[:n])  # warm this request's shapes
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    srv.infer(docs[:n], X=X[:n])
                    times.append(time.perf_counter() - t0)
                ms = 1e3 * float(np.median(times))
                print(f"  serve {path} {n} docs: {ms:.3f} ms, {1e3 * n / ms:.1f} docs/s "
                      f"(median of 3) [{card}]")
    # each fused kernel's launches on its own path; the gather is on none
    return {"iter": launches["iter"]["iter"], "newton": launches["newton"]["newton"],
            "gather": sum(n["gather"] for n in launches.values())}


def phase_wiki(torch, stages, fails, n_docs=64,
               model_dir="artifacts/wiki_reference_model/50"):
    """Phase 5b: the repo's wiki model (K=50, V=13,852), whose
    stm_config.json the port does not read (the foreign-config fallback),
    on documents drawn from its own beta."""
    from strutopy_tpu_torch import ThetaServer

    srv = ThetaServer(model_dir, device="cuda")
    beta = np.load(f"{model_dir}/beta_hat.npy").astype(np.float64)
    beta /= beta.sum(1, keepdims=True)
    rng = np.random.default_rng(50)
    docs = []
    for _ in range(n_docs):
        draw = rng.multinomial(200, rng.dirichlet(np.full(srv.K, 0.1)) @ beta)
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    X = rng.integers(0, 2, n_docs).astype(np.float64)
    reset(stages)
    theta, _eta = srv.infer(docs, X=X)
    print(f"phase 5b: {model_dir} (K={srv.K}, V={srv.V}, config "
          f"{'the fallback' if srv.cfg == type(srv.cfg)(K=srv.K) else 'read'}), "
          f"{n_docs} documents; launches {dict(stages.LAUNCHES)}")
    fails.check(simplex_ok(theta, n_docs, srv.K), "wiki model: theta finite on the simplex")


# ---------------------------------------------------------------------------
# phases 6, 7, 8: spectral init, the content model, heldout and resume
# ---------------------------------------------------------------------------

KAPPA_ATOL = 1e-3  # kappa after 3 EM iterations, card vs CPU (a float32 Newton solve's floor)
HELDOUT_ATOL = 1e-5  # eval_heldout_torch (float32, card) vs eval_heldout (float64), nats


def timed(torch, fn):
    """(result, seconds) of ``fn()`` between two device synchronizes."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def anchor_gap(torch, spectral, Q, anchors, step, a, b):
    """On Q's device, replay the first ``step`` anchor choices and return
    (score[a] - score[b]) / score[a] at that step."""
    Q = Q.clone()
    used = torch.zeros(Q.shape[0], dtype=Q.dtype, device=Q.device)
    for j in range(step):
        rss = spectral.anchor_rss(Q, used)
        spectral.anchor_step(Q, used, torch.tensor(int(anchors[j]), device=Q.device), rss)
    rss = spectral.anchor_rss(Q, used).double()
    return float((rss[a] - rss[b]) / rss[a])


def check_anchors(torch, spectral, fails, Q_card, Q_cpu, a_card, a_cpu):
    """The card's anchor chain against the CPU's.  The chain is K discrete
    choices (argmax of a float32 sum over Vp squares); the two devices sum
    in another order, so near a tie they may part, after which every later
    anchor differs.  Where they first part, each device's own scores of the
    two candidates must lie within float32 rounding of a Vp-term sum
    (Vp · 2^-24) of each other."""
    K, Vp = len(a_card), Q_card.shape[0]
    tol = Vp * 2.0 ** -24
    same = int(np.argmin(a_card == a_cpu)) if (a_card != a_cpu).any() else K
    if same == K:
        fails.check(True, f"anchors: all {K} equal to the CPU's, in order")
        return
    gc = anchor_gap(torch, spectral, Q_card, a_card, same, int(a_card[same]), int(a_cpu[same]))
    gh = anchor_gap(torch, spectral, Q_cpu, a_cpu, same, int(a_cpu[same]), int(a_card[same]))
    fails.check(0 <= gc <= tol and 0 <= gh <= tol,
                f"anchors: the first {same} of {K} equal to the CPU's; at step {same} the card "
                f"takes row {a_card[same]}, the CPU row {a_cpu[same]}: relative gap between the "
                f"two scores {gc:.3e} on the card, {gh:.3e} on the CPU (tol {tol:.1e}, float32 "
                f"rounding of a {Vp}-term sum)")


GC_EVENTS = []  # (start, seconds, generation) of each run of Python's cyclic collector


def watch_collector():
    """Record every run of Python's cyclic garbage collector: a full one
    walks the corpus (a list of lists of tuples) and lands inside whatever
    iteration happens to trigger it."""
    import gc

    began = []

    def on_gc(phase, info):
        if phase == "start":
            began.append(time.time())
        elif began:
            t = began.pop()
            GC_EVENTS.append((t, time.time() - t, info["generation"]))

    gc.callbacks.append(on_gc)


def run_fit(torch, stages, fails, model, n_iter, label, card):
    """``n_iter`` EM iterations through ``expectation_maximization`` with
    the launch counts of that run; bounds finite, B1-B3 and the scatter launched."""
    model.config = model.config.replace(max_em_iter=n_iter, convergence_threshold=0.0)
    reset(stages)
    t0 = time.time()
    model.expectation_maximization()
    launches = {k: stages.LAUNCHES[k] for k in FIT_KERNELS}
    for it, (b, sec) in enumerate(zip(model.last_bounds, model.iter_seconds)):
        print(f"  {label} EM {it}: bound {b:.6f}, {sec:.4f} s, {model.N / sec:.1f} docs/s "
              f"[{card}]")
    slow = [(round(t - t0, 3), round(d, 3), g) for t, d, g in GC_EVENTS if t >= t0 and d > 0.01]
    if slow:
        print(f"  {label}: the host's garbage collector ran for more than 10 ms at "
              f"(s into the fit, s, generation) {slow}")
    fails.check(len(model.last_bounds) == n_iter
                and bool(np.all(np.isfinite(model.last_bounds)))
                and all(v > 0 for v in launches.values()),
                f"{label}: {len(model.last_bounds)} EM iterations, every bound finite; "
                f"launches {launches}")
    return launches


def phase_spectral(torch, stages, fails, corpus, X, card):
    """Phase 6: spectral init on the card, its anchors against the CPU's,
    and the fit that ``STM`` runs with its default arguments."""
    from strutopy_tpu_torch import STM
    from strutopy_tpu_torch.ops import spectral

    t_phase = time.time()
    K, V = K_BENCH, V_BENCH
    t0 = time.time()
    wf, cf, keep, wprob, nc = spectral.filter_corpus(corpus, V, 5000)
    Vp = len(keep)
    t_host = time.time() - t0
    Qs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        w, c = torch.as_tensor(wf, device=dev), torch.as_tensor(cf, device=dev)
        (Q, _rows), secs[dev, "gram"] = timed(
            torch, lambda: spectral._gram_scan(w, c, nc, Vp))
        anchors, secs[dev, "anchors"] = timed(torch, lambda: spectral.fast_anchor(Q, K))
        Qs[dev] = (Q, anchors.cpu().numpy())
    Q, a_card = Qs["cuda"]
    wp = torch.as_tensor(wprob[keep], dtype=torch.float32, device="cuda")
    beta_p, t_rec = timed(torch, lambda: spectral.recover_l2(Q, torch.as_tensor(
        a_card, device="cuda"), wp))
    beta = spectral.expand_beta(beta_p.cpu().numpy(), keep, K, V)
    print(f"phase 6: spectral init, N={corpus.N} V={V} Vp={Vp} K={K}: host filter "
          f"{t_host:.3f} s; on the card Gram {secs['cuda', 'gram']:.3f} s, anchors "
          f"{secs['cuda', 'anchors']:.3f} s, recovery {t_rec:.3f} s; on the CPU Gram "
          f"{secs['cpu', 'gram']:.3f} s, anchors {secs['cpu', 'anchors']:.3f} s [{card}]")
    fails.check(beta.shape == (K, V) and bool(np.isfinite(beta).all()) and bool((beta > 0).all())
                and bool(np.allclose(beta.sum(1), 1, atol=1e-8)),
                "spectral beta (K, V) finite, positive, rows on the simplex")
    whole, t_whole = timed(torch, lambda: spectral.spectral_init(corpus, K, V, device="cuda"))
    fails.check(bool(np.array_equal(whole, beta)),
                f"spectral_init (the entry point, {t_whole:.3f} s) equals its three stages "
                f"run one by one")
    qd = float((Q.cpu() - Qs["cpu"][0]).abs().max() / Qs["cpu"][0].abs().max())
    fails.check(qd <= 1e-5, f"Gram on the card vs the CPU: max |diff| / max |Q| {qd:.3e} "
                            f"(tol 1e-5)")
    check_anchors(torch, spectral, fails, Q, Qs["cpu"][0], a_card, Qs["cpu"][1])
    del Qs, Q

    t0 = time.time()
    model = STM(corpus, K=K, X=X, device="cuda")
    torch.cuda.synchronize()
    cfg = model.config
    print(f"  STM(docs, K={K}, X=X) built in {time.time() - t0:.1f} s: init_type "
          f"{cfg.init_type}, pass-1 cap {cfg.newton_pass1_iters}, straggler fraction "
          f"{cfg.newton_straggler_frac}, warm-up {cfg.newton_warmup_iters}")
    fails.check(cfg.init_type == "spectral" and cfg.newton_pass1_iters == 6
                and bool(np.allclose(model.beta, beta.astype(np.float32), rtol=1e-6)),
                "the default STM starts from the spectral beta, two-pass schedule on")
    launches = run_fit(torch, stages, fails, model, 3, "default fit", card)
    print(f"phase 6 took {time.time() - t_phase:.1f} s [{card}]")
    return launches, model


def phase_content(torch, stages, fails, corpus, X, card, n_serve=2048):
    """Phase 7: the content model at full width, its first bound against
    the CPU at a reduced size, and its saved model served."""
    import tempfile

    from strutopy_tpu_torch import STM, STMConfig, ThetaServer
    from strutopy_tpu_torch.ops import build, mstep

    t_phase = time.time()
    K, V, A = K_BENCH, V_BENCH, 2
    bi = X.astype(np.int32)
    t0 = time.time()
    model = STM(corpus, K=K, X=X, content=True, beta_index=bi, init_type="random",
                max_em_iter=3, device="cuda")
    torch.cuda.synchronize()
    P = model._kappa_design.shape[1]
    print(f"phase 7: content fit A={A} K={K} V={V} N={corpus.N}, kappa design "
          f"{model._kappa_design.shape}, {mstep._kappa_vchunk(V, P)} words a chunk; built in "
          f"{time.time() - t0:.1f} s; {card}")
    # the kappa solve's Newton counts (one entry a chunk of words a call)
    # and the wall time of each content M-step
    counts, secs = [], []
    solve, update = mstep._poisson_newton_batch, mstep.update_beta_content

    def counting(*a, **kw):
        W, n_it = solve(*a, **kw)
        counts.append(n_it)
        return W, n_it

    def timing(*a, **kw):
        out, sec = timed(torch, lambda: update(*a, **kw))
        secs.append(sec)
        return out

    mstep._poisson_newton_batch, mstep.update_beta_content = counting, timing
    try:
        launches = run_fit(torch, stages, fails, model, 3, "content fit", card)
    finally:
        mstep._poisson_newton_batch, mstep.update_beta_content = solve, update
    per_it = np.asarray(counts).reshape(3, -1)
    for it, (row, sec) in enumerate(zip(per_it, secs)):
        print(f"  kappa solve EM {it} ({'cold' if it == 0 else 'warm'} start): Newton "
              f"iterations a chunk {row.tolist()}, {int(row.sum())} in all; "
              f"update_beta_content {sec:.4f} s [{card}]")
    beta, kappa = model.beta, model.kappa
    fails.check(beta.shape == (A, K, V) and bool(np.isfinite(beta).all())
                and bool((beta >= 0).all()) and bool(np.allclose(beta.sum(-1), 1, atol=1e-4))
                and kappa.shape == (P, V) and bool(np.isfinite(kappa).all())
                and P == K + A and bool(np.abs(kappa).max() > 0),
                f"beta {beta.shape} rows on the simplex, kappa {kappa.shape} finite, "
                f"max |kappa| {np.abs(kappa).max():.3f}")

    # the same kind of fit on the card and on the CPU, at a reduced size:
    # with the default penalty (250, which holds kappa near 0) and with a
    # weak one (1), under which the kappa solve iterates and shapes beta
    k, v, n = 10, 2000, 512
    docs_s, X_s = make_corpus(k, v, n, 100, seed=3)
    for l2 in (250.0, 1.0):
        cfg = STMConfig(K=k, content=True, A=A, lda_beta=False, init_type="random",
                        max_em_iter=3, convergence_threshold=0.0, newton_bf16_hessian=False,
                        batch_size=128, kappa_l2=l2)
        bounds, kappas = {}, {}
        for dev in ("cpu", "cuda"):
            m = STM(docs_s, K=k, X=X_s, config=cfg, beta_index=X_s.astype(np.int32),
                    init_beta=random_beta(k, v, seed=7), device=dev)
            m.expectation_maximization()
            bounds[dev], kappas[dev] = np.asarray(m.last_bounds), m.kappa
        rel = np.abs(bounds["cuda"] - bounds["cpu"]) / np.abs(bounds["cpu"])
        kd = float(np.abs(kappas["cuda"] - kappas["cpu"]).max())
        kmax = float(np.abs(kappas["cpu"]).max())
        print(f"  content fit K={k} V={v} N={n} kappa_l2={l2:g}: bounds cpu "
              f"{bounds['cpu'].tolist()}, cuda {bounds['cuda'].tolist()}")
        fails.check(bool(np.all(np.isfinite(bounds["cuda"]))) and float(rel.max()) <= FIT_RTOL
                    and kd <= KAPPA_ATOL * max(1.0, kmax),
                    f"content fit on the card vs the CPU, kappa_l2={l2:g}: bounds rel diff "
                    f"{rel.tolist()} (tol {FIT_RTOL:.0e}); max |kappa - CPU's| {kd:.3e} of "
                    f"max |kappa| {kmax:.3f} (tol {KAPPA_ATOL:.0e})")

    docs_new, X_new = make_corpus(K, V, n_serve, WORDS_BENCH, seed=11)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as model_dir:
        model.save_model(model_dir)
        srv = ThetaServer(model_dir, device="cuda")
        srv.warmup()
        reset(stages)
        (theta, _eta), sec = timed(
            torch, lambda: srv.infer(docs_new, X=X_new, beta_index=X_new.astype(np.int32)))
        served = {k_: stages.LAUNCHES[k_] for k_ in FIT_KERNELS}
        fails.check(srv.content and simplex_ok(theta, n_serve, K)
                    and all(v_ > 0 for v_ in served.values()),
                    f"content model served: {n_serve} documents in {sec:.3f} s, theta finite "
                    f"on the simplex; launches {served}")
        try:
            srv.infer(docs_new[:4], X=X_new[:4])
            refused = False
        except ValueError as e:
            refused = "beta_index" in str(e)
        fails.check(refused, "a content model refuses a request without beta_index")
    print(f"phase 7 took {time.time() - t_phase:.1f} s [{card}]")
    return launches, list(model.last_bounds)


def phase_heldout(torch, stages, fails, docs, corpus, X, card):
    """Phase 8: document-completion heldout likelihood of the bench corpus
    (80/20 split, the one-fit protocol), the device variant against the
    float64 anchor, and a resumed fit against the uninterrupted one."""
    import tempfile

    from strutopy_tpu_torch import STM, STMConfig
    from strutopy_tpu_torch.corpus.bow import pad_corpus
    from strutopy_tpu_torch.eval.heldout import cut_in_half, eval_heldout, eval_heldout_torch
    from strutopy_tpu_torch.ops import build
    from strutopy_tpu_torch.pipeline import train_and_eval_heldout

    t_phase = time.time()
    K = K_BENCH
    n_train = int(0.8 * len(docs))
    train, test = docs[:n_train], docs[n_train:]
    reset(stages)
    (ll, mb, _mt), sec = timed(torch, lambda: train_and_eval_heldout(
        train, test, K=K, X=X, max_em_iter=3, fast=True, device="cuda"))
    launches = {k: stages.LAUNCHES[k] for k in FIT_KERNELS}
    print(f"phase 8: train_and_eval_heldout(fast=True), {n_train} train + {len(test)} test "
          f"documents, K={K}, spectral init, 3 EM iterations: heldout {ll:.6f} nats a token "
          f"in {sec:.1f} s; bounds {mb.last_bounds}; launches {launches} [{card}]")
    fails.check(bool(np.isfinite(ll)) and ll < 0 and all(v > 0 for v in launches.values()),
                f"heldout likelihood finite and negative ({ll:.6f}), B1-B3 and the scatter "
                f"launched")
    test_1, test_2 = cut_in_half(test)
    theta, _ = mb.transform(test_1, X=X[n_train:])
    c2 = pad_corpus(test_2, V=mb.V)
    ll_card, sec_card = timed(torch, lambda: float(eval_heldout_torch(
        c2.words, c2.counts, c2.doc_ok, theta, mb._state.beta, device="cuda")))
    t0 = time.time()
    ll_64 = eval_heldout(test_2, theta, mb.beta)
    sec_64 = time.time() - t0
    fails.check(abs(ll_card - ll_64) <= HELDOUT_ATOL and abs(ll - ll_64) <= HELDOUT_ATOL,
                f"eval_heldout_torch on the card {ll_card:.7f} ({sec_card:.4f} s) vs float64 "
                f"eval_heldout {ll_64:.7f} ({sec_64:.3f} s): diff {abs(ll_card - ll_64):.2e} "
                f"(tol {HELDOUT_ATOL:.0e}); the pipeline's value differs by "
                f"{abs(ll - ll_64):.2e}")

    # resume, on the default path: every kernel of the fit adds in a fixed
    # order (the phi scatter too), so no flag of PyTorch's is set
    cfg = STMConfig(K=K, init_type="random", batch_size=256, max_em_iter=4,
                    convergence_threshold=0.0)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        ckpt = f"{d}/state.npz"
        t0 = time.time()
        full = STM(corpus, K=K, X=X, config=cfg, device="cuda").expectation_maximization()
        STM(corpus, K=K, X=X, config=cfg.replace(max_em_iter=2),
            device="cuda").expectation_maximization(checkpoint_path=ckpt)
        rest = STM(corpus, K=K, X=X, config=cfg, device="cuda")
        rest.expectation_maximization(checkpoint_path=ckpt, resume=True)
        torch.cuda.synchronize()
        sec = time.time() - t0
    same = (rest.last_bounds == full.last_bounds
            and bool(torch.equal(rest._state.beta, full._state.beta))
            and bool(torch.equal(rest._state.eta, full._state.eta)))
    fails.check(same and len(rest.last_bounds) == 4,
                f"a fit of 4 EM iterations checkpointed at 2 and resumed equals the "
                f"uninterrupted fit: bounds, beta and eta bit for bit {same} "
                f"(bounds {rest.last_bounds} vs {full.last_bounds}; three fits in {sec:.1f} s)")
    print(f"phase 8 took {time.time() - t_phase:.1f} s [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phases 9, 10: out-of-core fits and post-fit analysis
# ---------------------------------------------------------------------------

STREAM_RTOL = 2e-4  # streamed vs in-memory bounds (float32 summation order, per-part sort)
STREAM_BETA_ATOL = 2e-4
TWO_PASS_FRAC = 0.5  # a straggler budget that neither the corpus nor a part overflows
# one streamed EM iteration vs one in-memory iteration from the same state
STEP_RTOL = 1e-5  # the bound: float32 sums over the documents in another order
STEP_BETA_ATOL = 1e-5
STEP_ETA_ATOL = 1e-4  # per document the same arithmetic; nothing amplifies within one step
# simulate_theta's eta draws, card against CPU, document by document.  A
# draw is eta + x with x = L⁻ᵀz, L the Cholesky factor of the document's
# (repaired) Hessian LLᵀ.  The two devices form LLᵀ in float32 in other
# orders (B1's sums against PyTorch's, cuSOLVER's factor against
# LAPACK's), so their matrices part by a few units of 2⁻²⁴ relative, and
# to first order the solve moves x by up to κ₂(LLᵀ) times that, relative
# to x's size.  So each document is held to
#     SIM_C · κ₂(LLᵀ) · 2⁻²⁴ · max|x|   (max over its draws and coordinates).
# SIM_C = 8 units of rounding: on the default fit's first 1,024 documents
# on an H100 the worst document used 0.09 to 0.21 of its bound, and the
# bounds of the documents at or below the median κ₂ (~200) stayed under
# 1.4e-3.  Every run checks that those bounds stay within SIM_ETA_ATOL, so
# that no well-conditioned document is held more loosely than by a fixed
# 5e-3.
SIM_C = 8.0
SIM_ULP = 2.0 ** -24
SIM_ETA_ATOL = 5e-3


def tensor_bytes(*objs):
    """Bytes of the distinct tensors among the fields of the given states
    (dataclasses); a tensor that several states share counts once."""
    import dataclasses

    seen = {}
    for o in objs:
        for f in dataclasses.fields(o):
            t = getattr(o, f.name)
            seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values())


def run_streamed(torch, sem, shared, parts, n_iter):
    """``n_iter`` iterations of ``sem`` -> (shared, parts, bounds, seconds
    per iteration, peak device bytes above what was allocated before)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bounds, secs = [], []
    for _ in range(n_iter):
        (shared, parts), sec = timed(torch, lambda: sem.em_iteration(shared, parts))
        bounds.append(float(shared.bound))
        secs.append(sec)
    return shared, parts, bounds, secs, torch.cuda.max_memory_allocated() - base


def phase_streaming(torch, stages, fails, corpus, X, card, default_model, default_launches,
                    content_bounds):
    """Phase 9: the out-of-core fit on the card (see the module docstring)."""
    import dataclasses

    from strutopy_tpu_torch import STM, STMConfig, StreamedEM
    from strutopy_tpu_torch.corpus.bucketing import make_bucket_plan, split_corpus_by_plan
    from strutopy_tpu_torch.models.em import CorpusData, local_estep_stats
    from strutopy_tpu_torch.models.state import init_state
    from strutopy_tpu_torch.ops import mstep
    from strutopy_tpu_torch.utils.precision import float32_matmul

    t_phase = time.time()
    K, V = K_BENCH, V_BENCH

    # (a) STM(stream_parts=4) with default arguments against phase 6's fit
    t0 = time.time()
    ms = STM(corpus, K=K, X=X, stream_parts=4, device="cuda")
    torch.cuda.synchronize()
    print(f"phase 9a: STM(docs, K={K}, X=X, stream_parts=4) built in {time.time() - t0:.1f} s "
          f"(plan: one bucket of {ms._plan.n_storage} rows, L={ms._plan.Ls}); _data is "
          f"{ms._data}")
    launches = run_fit(torch, stages, fails, ms, 3, "streamed default fit", card)

    def gap(streamed, in_memory):
        b_s, b_m = np.asarray(streamed.last_bounds), np.asarray(in_memory.last_bounds)
        return (np.abs(b_s - b_m) / np.abs(b_m),
                float(np.abs(streamed.beta - in_memory.beta).max()),
                streamed.straggler_overflow, in_memory.straggler_overflow)

    # A streamed and an in-memory fit sum the same per-document results in
    # another order, and a cold Newton solve turns that rounding into other
    # step choices for a few documents: over three iterations two fits part
    # by as much as two runs of one fit do (their last bounds by up to 2e-4
    # with no straggler budget in play).  So each pair of fits is held to the
    # tolerance on its cold iterations, its last iteration is printed, and
    # the streamed step itself is held to a far tighter tolerance below,
    # from one and the same state.  The default fit's third iteration is
    # two-pass, its straggler budget a share of one part there and of the
    # corpus here: the documents beyond it are other documents.
    cold = ms.config.newton_warmup_iters
    rel, dbeta, ov_s, ov_m = gap(ms, default_model)
    fails.check(ms._data is None and float(rel[:cold].max()) <= STREAM_RTOL,
                f"streamed default fit vs the in-memory one (phase 6): bounds rel diff "
                f"{rel.tolist()}, the first {cold} (cold) within {STREAM_RTOL:.0e}; max |beta "
                f"diff| {dbeta:.3e} after the two-pass iteration; straggler overflow streamed "
                f"{ov_s}, in memory {ov_m}; launches streamed {launches}, in memory "
                f"{default_launches}")
    # its two-pass iteration: the bound goes on rising, and the per-part
    # budgets together leave no more documents over than the corpus's one
    # budget does, give or take one chunk
    fails.check(ms.last_bounds[cold] > ms.last_bounds[cold - 1]
                and ov_s <= ov_m + ms.config.batch_size,
                f"streamed default fit, two-pass iteration: bound {ms.last_bounds[cold]:.1f} "
                f"above the iteration before's {ms.last_bounds[cold - 1]:.1f}; straggler "
                f"overflow {ov_s} <= the in-memory fit's {ov_m} + one chunk "
                f"({ms.config.batch_size})")
    # a two-pass pair that neither fit overflows: a budget of half the rows
    # (1,024 a part) against the ~36% of documents that pass 1 leaves
    # unconverged here
    cfg_2p = STMConfig(K=K, newton_pass1_iters=6, newton_straggler_frac=TWO_PASS_FRAC,
                       max_em_iter=3, convergence_threshold=0.0)
    pair, launches_2p = {}, {}
    for n_parts in (0, 4):
        pair[n_parts] = STM(corpus, K=K, X=X, config=cfg_2p, stream_parts=n_parts, device="cuda")
        launches_2p[n_parts] = run_fit(torch, stages, fails, pair[n_parts], 3,
                                       f"two-pass fit, stream_parts={n_parts}", card)
    rel, dbeta, ov_s, ov_m = gap(pair[4], pair[0])
    fails.check(float(rel[:cold].max()) <= STREAM_RTOL and ov_s == 0 and ov_m == 0,
                f"streamed vs in-memory fit, two-pass with newton_straggler_frac="
                f"{TWO_PASS_FRAC}: bounds rel diff {rel.tolist()}, the first {cold} (cold) "
                f"within {STREAM_RTOL:.0e}; max |beta diff| {dbeta:.3e} after the two-pass "
                f"iteration; straggler overflow streamed {ov_s}, in memory {ov_m}; launches "
                f"streamed {launches_2p[4]}, in memory {launches_2p[0]}")
    # the two in-memory fits of this run are one configuration until then
    fails.check(default_model.last_bounds[:cold] == pair[0].last_bounds[:cold],
                f"phase 9a: the default fit (phase 6) and the two-pass fit here, one "
                f"configuration for their {cold} cold iterations, equal there bit for bit: "
                f"{default_model.last_bounds[:cold]} vs {pair[0].last_bounds[:cold]}")
    # the streamed step against the in-memory step from one state (the
    # in-memory fit's last): every document's eta is the same function of
    # that state in both, so only the order of the M-step's sums differs
    same_order = bool(np.array_equal(pair[0]._storage_index, pair[4]._storage_index))
    for which, kind in (("_em_step_cold", "single-pass"), ("_em_step", "two-pass")):
        state = pair[0]._state
        with float32_matmul():
            a = getattr(pair[0], which)(state, pair[0]._data)
        b = getattr(pair[4], which)(state, None)
        rel_b = abs(float(b.bound) - float(a.bound)) / abs(float(a.bound))
        d_beta = float((b.beta - a.beta).abs().max())
        d_eta = float((b.eta - a.eta).abs().max())
        ov = (int(b.straggler_overflow), int(a.straggler_overflow))
        fails.check(same_order and rel_b <= STEP_RTOL and d_beta <= STEP_BETA_ATOL
                    and d_eta <= STEP_ETA_ATOL and ov == (0, 0),
                    f"one {kind} EM iteration from the in-memory fit's state, streamed in 4 "
                    f"parts vs in memory: bound {float(b.bound):.1f} vs {float(a.bound):.1f}, "
                    f"rel diff {rel_b:.3e} (tol {STEP_RTOL:.0e}); max |beta diff| {d_beta:.3e} "
                    f"(tol {STEP_BETA_ATOL:.0e}); max |eta diff| {d_eta:.3e} (tol "
                    f"{STEP_ETA_ATOL:.0e}); straggler overflow {ov}; same storage order "
                    f"{same_order}")
    del pair, a, b, state
    th, _ = ms.transform(to_docs(corpus, 64), X=X[:64])
    fails.check(simplex_ok(th, 64, K), "the streamed model transforms 64 documents")

    # the bench corpus as one padded bucket on the host, and its design
    plan = make_bucket_plan(corpus, 256, n_devices=4, max_buckets=1)
    bucket = split_corpus_by_plan(corpus, plan)[0]
    Xs = np.zeros(plan.n_storage)
    Xs[plan.storage_index[: corpus.N]] = X
    D_np, design = mstep.make_prevalence_design(Xs, bucket.doc_ok, device="cuda")
    aspects = np.zeros(plan.n_storage, np.int32)
    n = plan.n_storage // 4

    def part_of(p, size=n):
        sl = slice(p * size, (p + 1) * size)
        return (bucket.words[sl], bucket.counts[sl], aspects[sl], bucket.doc_ok[sl], D_np[sl])

    part_bytes = sum(a.nbytes for a in part_of(0))
    cfg = STMConfig(K=K, init_type="random", batch_size=256)
    beta0 = random_beta(K, V, seed=5)

    def fresh(sem, n_rows):
        shared = init_state(None, K=K, V=V, N=n_rows, P=D_np.shape[1], beta_init=beta0,
                            device="cuda")
        return shared, sem.init_parts(None, K=K, V=V)

    # (b) prefetch on against off: equal results, wall, peak memory
    parts4 = [part_of(p) for p in range(4)]
    outs = {}
    for pf in (False, True):
        sem = StreamedEM(cfg, design, parts4, prefetch=pf, device="cuda")
        shared, pst, bounds, _secs, _peak = run_streamed(torch, sem, *fresh(sem, n), 2)
        outs[pf] = (bounds, shared.beta, shared.sigma, torch.cat([s.eta for s in pst]))
    same = (outs[True][0] == outs[False][0]
            and all(bool(torch.equal(a, b)) for a, b in zip(outs[True][1:], outs[False][1:])))
    fails.check(same, f"phase 9b: StreamedEM with prefetch on equals prefetch off bit for bit "
                      f"(bounds, beta, sigma, eta): bounds {outs[True][0]} vs {outs[False][0]}")
    del outs
    for pf in (False, True):
        sem = StreamedEM(cfg, design, parts4, prefetch=pf, device="cuda")
        reset(stages)
        _sh, _pst, bounds, secs, peak = run_streamed(torch, sem, *fresh(sem, n), 3)
        print(f"  prefetch {'on ' if pf else 'off'}: 3 iterations of 4 parts x {n} documents "
              f"{[round(s, 4) for s in secs]} s, bounds {bounds}; peak device memory "
              f"{peak / 1e6:.1f} MB above the {torch.cuda.memory_allocated() / 1e6:.1f} MB "
              f"allocated around the run; one part is {part_bytes / 1e6:.2f} MB; launches "
              f"{ {k: stages.LAUNCHES[k] for k in ('fgh', 'cg', 'ls')} } [{card}]")
        fails.check(bool(np.isfinite(bounds).all()) and sem.nonfinite_bound_count == 0,
                    f"prefetch {pf}: bounds finite")

    # (d) one streamed iteration on each fused path from the stage path's state
    sem = StreamedEM(cfg, design, parts4, device="cuda")
    s0, p0 = fresh(sem, n)
    s1, p1 = sem.em_iteration(s0, p0)
    s2, _ = sem.em_iteration(s1, p1)
    ref = float(s2.bound)
    for path in ("iter", "newton"):
        sem_f = StreamedEM(cfg.replace(**FUSED_PATHS[path]), design, parts4, device="cuda")
        reset(stages)
        (sf, _), sec = timed(torch, lambda: sem_f.em_iteration(s1, p1))
        got = {k: stages.LAUNCHES[k] for k in PATH_KERNELS[path]}
        rel_f = abs(float(sf.bound) - ref) / abs(ref)
        fails.check(rel_f <= FIT_RTOL and all(v > 0 for v in got.values())
                    and all(stages.LAUNCHES[k] == 0 for k in ("fgh", "cg", "ls")),
                    f"phase 9d: streamed iteration on the {path} path from the stage path's "
                    f"state: bound {float(sf.bound):.6f} vs {ref:.6f}, rel diff {rel_f:.3e} "
                    f"(tol {FIT_RTOL:.0e}), {sec:.4f} s; launches {got}")
    del s0, p0, s1, p1, s2, sf

    # (c) a corpus 16 times the bench corpus, tiled on the host
    reps = 16
    N_big = reps * plan.n_storage
    W = np.tile(bucket.words, (reps, 1))
    C = np.tile(bucket.counts, (reps, 1))
    OK = np.tile(bucket.doc_ok, reps)
    A_big = np.zeros(N_big, np.int32)
    D_big, design_big = mstep.make_prevalence_design(np.tile(Xs, reps), OK, device="cuda")
    n_big = plan.n_storage

    def provider(p):
        sl = slice(p * n_big, (p + 1) * n_big)
        return (W[sl], C[sl], A_big[sl], OK[sl], D_big[sl])

    big_part = sum(a.nbytes for a in provider(0))
    corpus_bytes = W.nbytes + C.nbytes + A_big.nbytes + OK.nbytes + D_big.nbytes
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    sem = StreamedEM(cfg, design_big, provider, n_parts=reps, device="cuda")
    shared, pst = fresh(sem, n_big)
    state_bytes = tensor_bytes(shared, *pst)
    # what one part's E-step needs beside the part itself
    d0 = CorpusData(*((torch.as_tensor(a, device="cuda"),) for a in provider(0)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a0 = torch.cuda.memory_allocated()
    local_estep_stats(dataclasses.replace(pst[0], beta=shared.beta), d0, cfg)
    torch.cuda.synchronize()
    work = torch.cuda.max_memory_allocated() - a0
    del d0
    reset(stages)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bounds, secs = [], []
    for _ in range(2):
        # each iteration's states replace its input's here, so that within an
        # iteration only the states it reads and the states it makes are alive
        (shared, pst), sec = timed(torch, lambda: sem.em_iteration(shared, pst))
        bounds.append(float(shared.bound))
        secs.append(sec)
    peak = torch.cuda.max_memory_allocated() - base
    limit = 2 * state_bytes + work + 3 * big_part
    big_launches = {k: stages.LAUNCHES[k] for k in FIT_KERNELS}
    print(f"phase 9c: N={N_big} in {reps} parts of {n_big} from a provider, 2 EM iterations "
          f"{[round(s, 3) for s in secs]} s = {[round(N_big / s, 1) for s in secs]} docs/s, "
          f"bounds {bounds}; launches {big_launches} [{card}]")
    fails.check(bool(np.isfinite(bounds).all()) and sem.nonfinite_bound_count == 0
                and peak <= limit and all(v > 0 for v in big_launches.values()),
                f"phase 9c: bounds finite; peak device memory {peak / 1e6:.1f} MB above the "
                f"{base / 1e6:.1f} MB held before, limit {limit / 1e6:.1f} MB = 2 x state "
                f"{state_bytes / 1e6:.1f} (an iteration's input and output) + one part's "
                f"E-step workspace {work / 1e6:.1f} + 3 parts of {big_part / 1e6:.2f}; the "
                f"corpus itself is "
                f"{corpus_bytes / 1e6:.1f} MB on the host [{card}]")
    del shared, pst, sem, W, C

    # (e) the content model, streamed
    bi = X.astype(np.int32)
    mc = STM(corpus, K=K, X=X, content=True, beta_index=bi, init_type="random",
             max_em_iter=2, stream_parts=2, device="cuda")
    run_fit(torch, stages, fails, mc, 2, "streamed content fit", card)
    b_c, b_ref = np.asarray(mc.last_bounds), np.asarray(content_bounds[:2])
    rel_c = np.abs(b_c - b_ref) / np.abs(b_ref)
    fails.check(float(rel_c.max()) <= STREAM_RTOL and mc.beta.shape == (2, K, V),
                f"phase 9e: streamed content fit (stream_parts=2) vs phase 7's in-memory "
                f"bounds: rel diff {rel_c.tolist()} (tol {STREAM_RTOL:.0e})")
    print(f"phase 9 took {time.time() - t_phase:.1f} s [{card}]")
    return launches


def to_docs(corpus, n):
    """The first ``n`` documents of a padded corpus as BoW lists."""
    return [[(int(w), int(c)) for w, c in zip(corpus.words[d], corpus.counts[d]) if c > 0]
            for d in range(n)]


def sim_chunk_check(torch, stages, fails, model, card, chunk=512, n_draws=8):
    """B1 where ``simulate_theta`` calls it: the fitted model's first chunk
    of 512 documents in float32 mode, against its plain version and beside
    its bound; and where the rest of that chunk's time goes."""
    from strutopy_tpu_torch.ops.estep import _gather_beta

    c_np = model._corpus
    K, L = model.K, c_np.words.shape[1]
    Km1 = K - 1

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a[:chunk]), dtype=dt, device="cuda")

    words, c = put(c_np.words, torch.int32), put(c_np.counts, torch.float32)
    eta, mu = put(model.eta, torch.float32), put(model.mu, torch.float32)
    asp = put(model.betaindex, torch.int32)
    B = words.shape[0]
    siginv = torch.as_tensor(np.linalg.inv(np.asarray(model.sigma, np.float64)),
                             dtype=torch.float32, device="cuda")
    beta_full = torch.as_tensor(model.beta[None], device="cuda")
    bd, t_gather = timed(torch, lambda: _gather_beta(beta_full, words, asp))
    got = stages.fgh(eta, bd, c, mu, siginv, bf16=False)
    want = stages.fgh_plain(eta, bd, c, mu, siginv, bf16=False)
    torch.cuda.synchronize()
    g_sc, H_sc, _u = gh_scales(torch, stages, eta, bd, c, mu, siginv)
    scales = {"f": f_scale(torch, eta[:, None, :], bd, c, mu, siginv)[:, 0], "g": g_sc,
              "H": H_sc}
    for (name, sc), g_, w_ in zip(scales.items(), got, want):
        abs_e, worst = worst_ratio(g_, w_, RTOL["fgh." + name] * sc)
        fails.check(bool(torch.isfinite(g_).all()) and worst <= 1.0,
                    f"simulate_theta's chunk (B={B} K={K} L={L}, fitted model) fgh.{name} "
                    f"bf16=False: max_abs_err={abs_e:.3e}, worst error/bound={worst:.3e} "
                    f"(must be <= 1)")
    ms, pms = time_pair(torch, lambda: stages.fgh(eta, bd, c, mu, siginv, bf16=False),
                        lambda: stages.fgh_plain(eta, bd, c, mu, siginv, bf16=False))
    bound_ms, by = roofline(nbytes(eta, bd, c, mu, siginv) + 4 * B * (1 + Km1 + Km1 * Km1),
                            {"f32": B * hessian_ops(K, L) + 6 * B * K * L})
    H = got[2]
    (Lc, _nu, _), t_chol = timed(torch, lambda: stages.chol_pd_inverse(H, inverse=False))
    z = torch.randn(B, Km1, n_draws, device="cuda")
    _, t_solve = timed(torch, lambda: torch.linalg.solve_triangular(Lc.mT, z, upper=True))
    print(f"  one chunk of simulate_theta: B1 float32 mode {ms:.4f} ms (plain {pms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {by}, share {bound_ms / ms:.3f}; CUDA graph of 20 "
          f"calls); by the host's clock the aspect gather {1e3 * t_gather:.2f} ms, "
          f"{B} Cholesky factorizations {1e3 * t_chol:.2f} ms, the triangular solve of "
          f"{n_draws} draws {1e3 * t_solve:.2f} ms [{card}]")


def sim_factors(torch, stages, model, n, device, chunk=512):
    """The Cholesky factors (n, K-1, K-1) that ``simulate_theta`` draws the
    first n documents' eta from: the float32 Hessian of the plain version
    of B1, repaired as simulate_theta repairs it, on ``device``."""
    from strutopy_tpu_torch.ops.estep import _gather_beta

    c_np = model._corpus
    siginv = torch.as_tensor(np.linalg.inv(np.asarray(model.sigma, np.float64)),
                             dtype=torch.float32, device=device)
    beta = np.asarray(model.beta, np.float32)
    beta_full = torch.as_tensor(beta if beta.ndim == 3 else beta[None], device=device)
    out = []
    for lo in range(0, n, chunk):
        sl = slice(lo, min(n, lo + chunk))

        def put(a, dt):
            return torch.as_tensor(np.ascontiguousarray(np.asarray(a)[sl]), dtype=dt,
                                   device=device)

        bd = _gather_beta(beta_full, put(c_np.words, torch.int32),
                          put(model.betaindex, torch.int32))
        H = stages.fgh_plain(put(model.eta, torch.float32), bd, put(c_np.counts, torch.float32),
                             put(model.mu, torch.float32), siginv, bf16=False)[2]
        out.append(stages.chol_pd_inverse(H, inverse=False)[0])
    return torch.cat(out)


def sim_bounds(torch, factors, x):
    """Per document, from its factor L and its draws' offsets x (S, n, K-1)
    from eta: (κ₂(LLᵀ), max|x|, the bound SIM_C · κ₂ · 2⁻²⁴ · max|x|)."""
    s = torch.linalg.svdvals(factors.double())
    kappa = ((s[:, 0] / s[:, -1]) ** 2).cpu().numpy()
    size = np.abs(x).max(axis=(0, 2))
    return kappa, size, SIM_C * kappa * SIM_ULP * size


def sim_verdict(kappa, bound, diff, conv):
    """Two devices' eta draws, per document: every converged document's
    max |diff| within its bound, and every bound of a document at or below
    the median κ₂ within SIM_ETA_ATOL.  Returns (ok, the worst converged
    document's index)."""
    ratio = np.where(conv, diff / bound, -np.inf)
    worst = int(np.argmax(ratio))
    calm = kappa <= np.median(kappa)
    ok = (bool(np.isfinite(bound).all() and np.isfinite(diff).all()) and conv.any()
          and float(ratio[worst]) <= 1.0 and float(bound[calm].max()) <= SIM_ETA_ATOL)
    return ok, worst


def phase_analysis(torch, stages, fails, model, corpus, X, card, n_cpu=1024):
    """Phase 10: post-fit analysis of the card's model (see the module
    docstring)."""
    import dataclasses
    import types

    from strutopy_tpu_torch import STM, STMConfig
    from strutopy_tpu_torch.eval import estimate_effect_composition, simulate_theta
    from strutopy_tpu_torch.utils.debug import NumericalCheckError, validate_state

    t_phase = time.time()
    K, N = K_BENCH, corpus.N
    n_chunks = -(-N // 512)
    reset(stages)
    eta_card, sec = timed(torch, lambda: simulate_theta(model, n_draws=8, seed=0,
                                                        return_eta=True))
    fgh_launches = stages.LAUNCHES["fgh"]
    print(f"phase 10: simulate_theta(n_draws=8) on {N} documents: {sec:.3f} s, "
          f"{1e3 * sec / n_chunks:.3f} ms a chunk of 512, B1 launched {fgh_launches} times in "
          f"its float32 mode [{card}]")
    cpu_model = types.SimpleNamespace(
        device=torch.device("cpu"), beta=model.beta, eta=model.eta[:n_cpu],
        mu=model.mu[:n_cpu], sigma=model.sigma, betaindex=model.betaindex[:n_cpu],
        _corpus=corpus.take(np.arange(n_cpu)))
    eta_cpu = simulate_theta(cpu_model, n_draws=8, seed=0, return_eta=True)
    conv = (model._state.opt_iters.cpu().numpy()[model._storage_index][:n_cpu]
            < model.config.newton_max_iters)
    diff = np.abs(eta_card[:, :n_cpu] - eta_cpu).max(axis=(0, 2))
    kappa, size, bound = sim_bounds(torch, sim_factors(torch, stages, model, n_cpu, "cuda"),
                                    eta_cpu - np.asarray(model.eta, np.float32)[None, :n_cpu])
    ok, w = sim_verdict(kappa, bound, diff, conv)
    calm = kappa <= np.median(kappa)
    fails.check(fgh_launches == n_chunks and eta_card.shape == (8, N, K - 1)
                and bool(np.isfinite(eta_card).all()) and ok,
                f"simulate_theta on the card vs the CPU, first {n_cpu} documents: each of the "
                f"{int(conv.sum())} whose Newton solve converged within SIM_C · κ₂ · 2^-24 · "
                f"max|x|; the worst at {diff[w] / bound[w]:.3f} of its bound (document {w}: "
                f"κ₂ {kappa[w]:.1f}, max|x| {size[w]:.2f}, diff {diff[w]:.3e}, bound "
                f"{bound[w]:.3e}); κ₂ median {np.median(kappa):.1f}, max {kappa.max():.1f}; "
                f"bounds at or below the median κ₂ at most {bound[calm].max():.3e} (<= "
                f"{SIM_ETA_ATOL:.0e}); max |eta draw diff| {diff[conv].max():.3e} converged, "
                f"{diff.max():.3e} over all; B1 launches {fgh_launches} = chunks {n_chunks}")
    sim_chunk_check(torch, stages, fails, model, card)
    theta_s = simulate_theta(model, n_draws=2, seed=1)
    fails.check(theta_s.shape == (2, N, K) and bool(np.isfinite(theta_s).all())
                and bool(np.allclose(theta_s.sum(-1), 1, atol=1e-4)) and bool((theta_s >= 0).all()),
                "simulate_theta's theta draws finite on the simplex")
    eff, sec = timed(torch, lambda: estimate_effect_composition(model, n_draws=4))
    fails.check(eff["coef"].shape == (K, 2) and all(
        bool(np.isfinite(eff[k]).all()) for k in ("coef", "se", "ci", "within", "between")),
        f"estimate_effect_composition: coef {eff['coef'].shape} finite ({sec:.2f} s)")

    prob, frex = model.label_topics(n=5)
    tq = model.topic_quality()
    res = model.check_residuals()
    adj, edges = model.topic_corr("simple")
    vis = model.to_ldavis(R=10)
    text = model.summary(print_summary=False)
    fails.check(len(prob) == K and len(frex) == K and all(len(r) == 5 for r in prob)
                and all(np.asarray(tq[k]).shape == (K,) and bool(np.isfinite(tq[k]).all())
                        for k in ("semantic_coherence", "exclusivity"))
                and bool(np.isfinite(res["dispersion"])) and adj.shape == (K, K)
                and bool(np.isfinite(np.asarray(vis["mdsDat"]["x"])).all())
                and len(vis["mdsDat"]["x"]) == K and text.count("\n") >= K,
                f"label_topics, topic_quality, check_residuals (dispersion "
                f"{res['dispersion']:.4f}), topic_corr ({len(edges)} edges), to_ldavis and "
                f"summary return finite values of the right shapes")

    cfg = STMConfig(K=K, init_type="random", batch_size=256, max_em_iter=2,
                    convergence_threshold=0.0, debug_checks=True)
    checked = STM(corpus, K=K, X=X, config=cfg, device="cuda").expectation_maximization()
    bad = dataclasses.replace(checked._state, beta=checked._state.beta.clone())
    bad.beta[3, 7] = -1e-3
    try:
        validate_state(bad, 2)
        raised = ""
    except NumericalCheckError as e:
        raised = str(e)
    fails.check(len(checked.last_bounds) == 2 and "beta has negative entries" in raised,
                f"a 2-iteration fit with debug_checks=True passes validate_state; a state with "
                f"one negative beta entry raises NumericalCheckError ({raised!r})")
    print(f"phase 10 took {time.time() - t_phase:.1f} s [{card}]")
    return {"fgh": fgh_launches}


# ---------------------------------------------------------------------------
# phase 11: raw text to theta, the corpus readers, the pipeline and the CLI
# ---------------------------------------------------------------------------

FIT_ARTIFACTS = {"beta_hat.npy", "theta_hat.npy", "sigma_hat.npy", "eta_hat.npy",
                 "mu_hat.npy", "gamma_hat.npy", "X.npy", "lower_bound.pickle",
                 "fit_health.json", "stm_config.json", "vocab.json", "fit_config.json"}
TEXT_ETA_ATOL = 5e-3  # card vs CPU, and the CLI subprocess vs in-process, where converged
# more documents a serve may leave above STALL_G than its reference: the
# slack tests/test_torch_estep.py::_check_iters gives the port against JAX.
# Which documents stall moves with the model: 18 to 28 of 256 stalled in
# one serve or the other over four card runs of phase 11c, while the fit
# still added phi with atomics in no fixed order
TEXT_STALL_FRAC = 0.05
OOV_WORDS = ("zzoovx", "zzoovy", "zzoovz")  # letters only, in no vocabulary


def native_listing(root):
    """(name, size, mtime) of every file under ``native/``: the port builds
    its ingest library under ``build/native/`` and must change nothing here."""
    from pathlib import Path

    return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                  for p in (Path(root) / "native").iterdir())


def token_names(V):
    """Word id -> "q" + base-26 letters of fixed width: letters only, kept by
    ``tokenize``, in no stopword list, and sorted as the ids are."""
    width = 1
    while 26 ** width < V:
        width += 1
    ids = np.arange(V)
    letters = [np.array(list("abcdefghijklmnopqrstuvwxyz"))[(ids // 26 ** k) % 26]
               for k in range(width - 1, -1, -1)]
    return np.array(["q" + "".join(t) for t in zip(*letters)])


def render_texts(docs, names, seed):
    """Each BoW document as text: its tokens shuffled, some upper-cased,
    joined by spaces, punctuation, digits, tabs and newlines."""
    rng = np.random.default_rng(seed)
    upper = np.char.upper(names)
    seps = np.array([" ", " ", " ", ", ", ". ", "; ", " - ", " (", ") ", " 42 ", "7", "!\n",
                     "\t", "'s "])
    texts = []
    for doc in docs:
        if not doc:
            texts.append("")
            continue
        ids, cnt = (np.array(x) for x in zip(*doc))
        toks = rng.permutation(np.repeat(ids, cnt))
        words = np.where(rng.random(len(toks)) < 0.1, upper[toks], names[toks])
        gaps = seps[rng.integers(0, len(seps), len(toks))]
        texts.append("".join(np.column_stack([words, gaps]).ravel().tolist()))
    return texts


def expected_encoding(docs, names, vocab):
    """What encoding ``docs``' texts against ``vocab`` must give: each
    document's (vocabulary id, count) pairs, and its word ids outside it."""
    index = {t: i for i, t in enumerate(vocab)}
    bow, oov = [], []
    for doc in docs:
        bow.append(sorted((index[names[w]], int(c)) for w, c in doc if names[w] in index))
        oov.append([(int(w), int(c)) for w, c in doc if names[w] not in index])
    return bow, oov


def text_requests(docs, names, vocab, seed=12):
    """``docs`` rendered as texts, the first 16 with out-of-vocabulary words
    appended and the last two replaced by such words and stopwords only;
    with the encoding and the report that ``align_corpus`` must give
    against ``vocab``: (texts, bow, report)."""
    docs = list(docs[:-2]) + [[], []]
    texts = render_texts(docs, names, seed)
    for d in range(16):
        texts[d] += " " + " ".join([OOV_WORDS[d % 3]] * (d % 3 + 1))
    texts[-2:] = ["zzoovx, the and! 12", "ZZOOVY zzoovz of"]
    bow, oov = expected_encoding(docs, names, vocab)
    report = {
        "tokens_dropped": sum(c for doc in oov for _, c in doc)
        + sum(d % 3 + 1 for d in range(16)) + 3,
        "oov_types": len({names[w] for doc in oov for w, _ in doc} | set(OOV_WORDS)),
        "docs_emptied": 2 + sum(1 for doc, b in zip(docs[:-2], bow) if doc and not b),
    }
    return texts, bow, report


def check_text_corpus(fails, native_out, python_out, docs, names):
    """11a: the native and Python paths of ``build_corpus`` give the same
    vocabulary and documents, and those are the rendered corpus's: the
    tokens of the ids that occur, in id order, each document's counts."""
    (bow_n, vocab_n), (bow_p, vocab_p) = native_out, python_out
    used = sorted({w for doc in docs for w, _ in doc})
    want_vocab = [str(names[w]) for w in used]
    want_bow, _ = expected_encoding(docs, names, want_vocab)
    same = list(vocab_n) == list(vocab_p) and bow_n == bow_p
    fails.check(same and list(vocab_n) == want_vocab and bow_n == want_bow,
                f"build_corpus: native and Python paths identical ({same}); vocabulary of "
                f"{len(vocab_n)} tokens, {len(bow_n)} documents, equal to the rendered corpus's "
                f"({len(want_vocab)} tokens)")


def check_fit_artifacts(fails, files, bounds, launches, label):
    """11b / 11d: the artifact set with ``vocab.json`` and ``fit_config.json``,
    every bound finite, B1-B3 launched."""
    missing = sorted(FIT_ARTIFACTS - set(files))
    fails.check(not missing and len(bounds) > 0 and bool(np.all(np.isfinite(bounds)))
                and all(launches.get(k, 0) > 0 for k in ("fgh", "cg", "ls")),
                f"{label}: artifact set complete (missing {missing}), {len(bounds)} bounds "
                f"finite, launches {launches}")


def check_infer_text(fails, got, via_align, want_bow, want_report, K):
    """11c: ``infer_text`` is ``align_corpus`` then ``infer``, exactly; its
    report carries the encoded BoW and the right out-of-vocabulary counts."""
    theta, eta, report = got
    theta2, eta2, bow2 = via_align
    counts = {k: report.get(k) for k in ("tokens_dropped", "oov_types", "docs_emptied")}
    fails.check(report.get("bow") == bow2 == want_bow and counts == want_report
                and np.array_equal(theta, theta2) and np.array_equal(eta, eta2)
                and simplex_ok(theta, len(want_bow), K),
                f"infer_text({len(want_bow)} texts) equals infer(align_corpus(texts)) bit for bit; "
                f"report {counts} (want {want_report}), report['bow'] the expected encoding")


def check_parking(fails, peaks, state_bytes):
    """11e: select_model parks stage-1 states on the host: its peak device
    memory grows by less than one state from runs=2 to runs=4."""
    grow = peaks[4] - peaks[2]
    fails.check(grow < state_bytes,
                f"select_model peak device memory above base: runs=2 {peaks[2] / 1e6:.2f} MB, "
                f"runs=4 {peaks[4] / 1e6:.2f} MB, growth {grow / 1e6:.2f} MB < one state "
                f"{state_bytes / 1e6:.2f} MB")


def check_eta_where_converged(fails, gm, gm_ref, eta, eta_ref, label):
    """Two serves of the same documents: eta within TEXT_ETA_ATOL on every
    document both bring below STALL_G (a document stalled at the float32
    floor stops where its path took it), and no more documents left above
    STALL_G than the reference leaves plus TEXT_STALL_FRAC of them, as
    check_served holds a fused path to the stage path."""
    both = (gm <= STALL_G) & (gm_ref <= STALL_G)
    d = float(np.abs(eta - eta_ref)[both].max()) if both.any() else float("inf")
    stalls, stalls_ref = int((gm > STALL_G).sum()), int((gm_ref > STALL_G).sum())
    allowed = math.ceil(TEXT_STALL_FRAC * len(gm))
    fails.check(d <= TEXT_ETA_ATOL and stalls <= stalls_ref + allowed,
                f"{label}: max |diff| {d:.3e} on the {int(both.sum())} of {len(gm)} documents "
                f"both bring below {STALL_G:.0e} (tol {TEXT_ETA_ATOL:.0e}); above it {stalls} "
                f"vs the reference's {stalls_ref} (at most {allowed} more); over all "
                f"{float(np.abs(eta - eta_ref).max()):.3e}")


def state_nbytes(state):
    import dataclasses

    return sum(getattr(state, f.name).numel() * getattr(state, f.name).element_size()
               for f in dataclasses.fields(state))


def run_cli(stages, argv):
    """``cli.main(argv)`` in this process (so launches are counted):
    (standard output, seconds, B1-B3 launches)."""
    import contextlib
    import io

    from strutopy_tpu_torch import cli

    reset(stages)
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue(), time.time() - t0, {k: stages.LAUNCHES[k] for k in FIT_KERNELS}


def phase_text_fit(torch, stages, fails, docs, X, card, model_dir):
    """11a and 11b: the bench corpus rendered as text, encoded on both paths
    of ``build_corpus``, then fitted from its vocabulary with ``fit_model``.
    Returns (names, bow, vocab, model, B1-B3 launches of the fit)."""
    from strutopy_tpu_torch.corpus import native
    from strutopy_tpu_torch.corpus.preprocess import build_corpus
    from strutopy_tpu_torch.pipeline import fit_model

    t0 = time.time()
    names = token_names(V_BENCH)
    texts = render_texts(docs, names, seed=21)
    t_render = time.time() - t0
    t0 = time.time()
    built = native.available()  # compiles the library at first use: outside the timed calls
    t_build = time.time() - t0
    lib = native.LIB_PATH
    fails.check(built and lib.exists() and lib.parent.parts[-2:] == ("build", "native"),
                f"native ingest library at {lib}, ready in {t_build:.2f} s")
    walls = {}
    outs = {}
    for path, use_native in (("native", True), ("python", False)):
        t0 = time.time()
        outs[path] = build_corpus(texts, use_native=use_native)
        walls[path] = time.time() - t0
    n_tok = sum(c for doc in docs for _, c in doc)
    print(f"phase 11a: {len(texts)} texts ({n_tok} tokens, {sum(map(len, texts))} characters) "
          f"rendered in {t_render:.2f} s; build_corpus native {walls['native']:.3f} s = "
          f"{len(texts) / walls['native']:.1f} docs/s, Python {walls['python']:.3f} s = "
          f"{len(texts) / walls['python']:.1f} docs/s [{card}]")
    check_text_corpus(fails, outs["native"], outs["python"], docs, names)
    bow, vocab = outs["native"]

    reset(stages)
    model, sec = timed(torch, lambda: fit_model(
        bow, K=K_BENCH, X=X, dictionary=vocab, init_type="spectral", max_em_iter=3,
        output_dir=model_dir, device="cuda"))
    launches = {k: stages.LAUNCHES[k] for k in FIT_KERNELS}
    print(f"phase 11b: fit_model(bow, K={K_BENCH}, dictionary=vocab, spectral, 3 EM) {sec:.2f} s: "
          f"bounds {[round(b, 2) for b in model.last_bounds]}, per iteration "
          f"{[round(s, 4) for s in model.iter_seconds]} s [{card}]")
    check_fit_artifacts(fails, os.listdir(model_dir), model.last_bounds, launches,
                        "fit_model from text")
    return names, bow, vocab, model, launches


def phase_text_serve(torch, stages, fails, model_dir, names, card, n_docs=2048, n_cpu=256):
    """11c: 2,048 new documents of the recipe as text, served from the
    text-built model by ``ThetaServer.infer_text``; some tokens and two
    whole documents out of the vocabulary.  Returns (texts, X, theta, max|g|
    of each served document, B1-B3 launches of the request)."""
    from strutopy_tpu_torch import ThetaServer
    from strutopy_tpu_torch.corpus.preprocess import align_corpus

    new_docs, Xn = make_corpus(K_BENCH, V_BENCH, n_docs, WORDS_BENCH, seed=11)
    srv = ThetaServer(model_dir, device="cuda")
    texts, want_bow, want_report = text_requests(new_docs, names, srv.vocab)

    srv.warmup()
    reset(stages)
    got, sec = timed(torch, lambda: srv.infer_text(texts, X=Xn))
    launches = {k: stages.LAUNCHES[k] for k in FIT_KERNELS}
    bow, _rep = align_corpus(texts, srv.vocab)
    theta2, eta2 = srv.infer(bow, X=Xn)
    print(f"phase 11c: infer_text({n_docs} texts) {sec:.3f} s, launches {launches} [{card}]")
    check_infer_text(fails, got, (theta2, eta2, bow), want_bow, want_report, K_BENCH)
    theta, eta, _report = got

    srv_cpu = ThetaServer(model_dir, device="cpu")
    (_t, eta_cpu, rep_cpu), sec_cpu = timed(torch, lambda: srv_cpu.infer_text(
        texts[:n_cpu], X=Xn[:n_cpu]))
    gm, gm_cpu = served_gmax(torch, stages, srv, bow[:n_cpu], Xn[:n_cpu],
                             (eta[:n_cpu], eta_cpu))
    fails.check(rep_cpu["bow"] == bow[:n_cpu], f"the CPU port encodes the first {n_cpu} texts "
                                                f"as the card's server does")
    check_eta_where_converged(fails, gm, gm_cpu, eta[:n_cpu], eta_cpu,
                              f"infer_text eta, card vs CPU ({sec_cpu:.1f} s), {n_cpu} texts")
    gmax = served_gmax(torch, stages, srv, bow, Xn, (eta,))[0]

    for n in (1, 16, 256, n_docs):
        srv.infer_text(texts[:n], X=Xn[:n])  # warm this request's shapes
        enc, inf = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            b, _ = align_corpus(texts[:n], srv.vocab)
            t1 = time.perf_counter()
            srv.infer(b, X=Xn[:n])
            enc.append(t1 - t0)
            inf.append(time.perf_counter() - t1)
        e, i = 1e3 * float(np.median(enc)), 1e3 * float(np.median(inf))
        print(f"  infer_text {n} texts: encode (host) {e:.3f} ms + infer (card) {i:.3f} ms = "
              f"{1e3 * n / (e + i):.1f} docs/s (median of 3) [{card}]")
    return texts, Xn, theta, gmax, launches


def phase_cli(torch, stages, fails, work, bow, vocab, X, texts, Xn, theta_text, gmax, card):
    """11d: the CLI in this process on the default device: fit from a .mm
    file read natively, find-k, search-k, select, synth and train-eval; then
    ``infer --text`` in a subprocess.  Returns each call's B1-B3 launches."""
    import pickle

    from strutopy_tpu_torch.cli import _load_corpus
    from strutopy_tpu_torch.corpus.bow import PaddedCorpus, pad_corpus, to_bow
    from strutopy_tpu_torch.corpus.io import write_mm
    from strutopy_tpu_torch.pipeline import fit_model

    launches = {}
    pc = pad_corpus(bow, V=len(vocab))
    mm, Xp = os.path.join(work, "bench.mm"), os.path.join(work, "X.npy")
    t0 = time.time()
    write_mm(mm, pc)
    t_write = time.time() - t0
    np.save(Xp, X)
    loaded, t_read = timed(torch, lambda: _load_corpus(mm))
    same = (isinstance(loaded, PaddedCorpus) and loaded.V == pc.V
            and [sorted(d) for d in to_bow(loaded)] == [sorted(d) for d in to_bow(pc)])
    fails.check(same, f"write_mm ({t_write:.2f} s, {os.path.getsize(mm) / 1e6:.1f} MB) and the "
                      f"native .mm reader ({t_read:.3f} s): the same documents and V={loaded.V}")

    out_dir = os.path.join(work, "cli_fit")
    text, sec, launches["fit"] = run_cli(stages, ["fit", "--corpus", mm, "--X", Xp, "--K",
                                                  str(K_BENCH), "--max-em-iter", "3",
                                                  "--out", out_dir])
    with open(os.path.join(out_dir, "lower_bound.pickle"), "rb") as f:
        bounds = pickle.load(f)
    check_fit_artifacts(fails, os.listdir(out_dir), bounds, launches["fit"], "CLI fit")
    ref = fit_model(pc, K=K_BENCH, X=X, init_type="spectral", max_em_iter=3, device="cuda")
    rel = [abs(a - b) / abs(b) for a, b in zip(bounds, ref.last_bounds)]
    print(f"phase 11d: CLI fit {sec:.2f} s: bounds {[round(b, 2) for b in bounds]}; in-process "
          f"fit_model on the same PaddedCorpus {[round(b, 2) for b in ref.last_bounds]}; "
          f"relative gaps {[f'{r:.2e}' for r in rel]} [{card}]")
    # the .mm round trip gives the same padded arrays, so the same fit: the
    # same bits, every iteration (the scatter adds in a fixed order)
    beta_cli = np.load(os.path.join(out_dir, "beta_hat.npy"))
    fails.check(len(bounds) == 3 and list(bounds) == list(ref.last_bounds)
                and np.array_equal(beta_cli, ref.beta),
                f"CLI fit vs in-process fit: all 3 bounds and beta bit-equal "
                f"{list(bounds) == list(ref.last_bounds)}, {np.array_equal(beta_cli, ref.beta)} "
                f"(largest relative bound gap {max(rel):.2e})")
    del ref

    ks = [str(K_BENCH // 2), str(K_BENCH)]
    text, sec, launches["find-k"] = run_cli(stages, ["find-k", "--corpus", mm, "--K", *ks,
                                                     "--fast", "--max-em-iter", "3"])
    res = json.loads(text[text.index("{"):])["STM"]
    print(f"  CLI find-k {sec:.2f} s: {res}; launches {launches['find-k']} [{card}]")
    fails.check(set(res) == set(ks) and all(np.isfinite(v) for v in res.values()),
                "CLI find-k: a finite heldout value at each K")

    text, sec, launches["search-k"] = run_cli(stages, ["search-k", "--corpus", mm, "--K",
                                                       str(K_BENCH), "--max-em-iter", "3"])
    row = json.loads(text[text.index("{"):])[str(K_BENCH)]
    print(f"  CLI search-k {sec:.2f} s: {row} [{card}]")
    fails.check(all(np.isfinite(row[k]) for k in ("heldout", "bound", "coherence",
                                                  "exclusivity", "dispersion")),
                "CLI search-k: heldout, bound, coherence, exclusivity, dispersion finite")

    text, sec, launches["select"] = run_cli(stages, [
        "select", "--corpus", mm, "--K", str(K_BENCH), "--runs", "4", "--cast-iters", "2",
        "--keep", "2", "--max-em-iter", "4"])
    res = json.loads(text[text.index("{"):])
    print(f"  CLI select {sec:.2f} s: cast bounds {[round(r['cast_bound'], 2) for r in res['runs']]}, "
          f"kept {res['kept']}, selected {res['selected']}; launches {launches['select']} [{card}]")
    fails.check(len(res["runs"]) == 4 and len(res["kept"]) == 2 and res["selected"] in res["kept"]
                and all(np.isfinite(res["runs"][r]["bound"]) for r in res["kept"]),
                "CLI select: 4 runs cast, 2 kept and run on, the selected one among them")

    synth = os.path.join(work, "synth")
    _text, sec, _ = run_cli(stages, ["synth", "--K", str(K_BENCH), "--n-corpora", "1",
                                     "--n-docs", str(N_BENCH), "--n-words", str(WORDS_BENCH),
                                     "--V", str(V_BENCH), "--gamma-factors", "1", "--out", synth])
    print(f"  CLI synth ({N_BENCH} documents) {sec:.2f} s [{card}]")
    text, sec, launches["train-eval"] = run_cli(stages, [
        "train-eval", "--corpus-dir", os.path.join(synth, f"K{K_BENCH}_gf1.0", "0"),
        "--K", str(K_BENCH), "--fast", "--max-em-iter", "3"])
    ll = float(text.split("heldout log-likelihood:")[1].split()[0])
    print(f"  CLI train-eval --fast {sec:.2f} s: heldout {ll:.6f}; launches "
          f"{launches['train-eval']} [{card}]")
    fails.check(bool(np.isfinite(ll)) and ll < 0, f"CLI train-eval: heldout {ll:.6f} finite")

    req, Xnp, out = (os.path.join(work, n) for n in ("requests.json", "Xn.npy", "theta.npy"))
    with open(req, "w") as f:
        json.dump([{"text": t} for t in texts], f)
    np.save(Xnp, Xn)
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "strutopy_tpu_torch.cli", "infer",
                           "--model-dir", os.path.join(work, "text_model"), "--text", req,
                           "--X", Xnp, "--out", out], cwd=root, capture_output=True, text=True,
                          timeout=600)
    sec = time.time() - t0
    ok = proc.returncode == 0 and os.path.exists(out)
    theta_sub = np.load(out) if ok else np.full_like(theta_text, np.nan)
    print(f"  python -m strutopy_tpu_torch.cli infer --text ({len(texts)} texts) in a subprocess: "
          f"{sec:.2f} s, rc {proc.returncode}; {proc.stdout.strip().splitlines()[:1]} [{card}]")
    if not ok:
        print(proc.stderr[-2000:])
    conv = gmax <= STALL_G
    d = float(np.abs(theta_sub - theta_text)[conv].max()) if conv.any() else float("inf")
    fails.check(ok and d <= TEXT_ETA_ATOL,
                f"CLI infer --text in a subprocess vs infer_text in this one: max |theta diff| "
                f"{d:.3e} on the {int(conv.sum())} converged documents (tol {TEXT_ETA_ATOL:.0e})")
    return launches


def phase_parking(torch, fails, corpus, state_bytes, card):
    """11e: select_model's peak device memory at runs=2 and runs=4."""
    import gc

    from strutopy_tpu_torch.pipeline import select_model

    peaks = {}
    for runs in (2, 4):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, sec = timed(torch, lambda: select_model(corpus, K=K_BENCH, runs=runs, cast_iters=1,
                                                   keep=1, max_em_iter=2, return_models=False,
                                                   device="cuda"))
        peaks[runs] = torch.cuda.max_memory_allocated() - base
        print(f"phase 11e: select_model(runs={runs}, cast 1, keep 1, 2 EM) {sec:.2f} s, peak "
              f"{peaks[runs] / 1e6:.2f} MB above base [{card}]")
    check_parking(fails, peaks, state_bytes)


def phase_text_cli(torch, stages, fails, docs, corpus, X, card, native_before):
    """Phase 11 (see the module docstring).  Returns B1-B3 launches by path."""
    import tempfile

    from strutopy_tpu_torch.ops import build

    t_phase = time.time()
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as work:
        model_dir = os.path.join(work, "text_model")
        names, bow, vocab, model, fit_launches = phase_text_fit(
            torch, stages, fails, docs, X, card, model_dir)
        state_bytes = state_nbytes(model._state)
        del model
        texts, Xn, theta, gmax, serve_launches = phase_text_serve(
            torch, stages, fails, model_dir, names, card)
        cli_launches = phase_cli(torch, stages, fails, work, bow, vocab, X, texts, Xn, theta,
                                 gmax, card)
    phase_parking(torch, fails, corpus, state_bytes, card)
    after = native_listing(os.path.dirname(os.path.abspath(__file__)))
    fails.check(after == native_before, f"native/ unchanged: {after}")
    print(f"phase 11 took {time.time() - t_phase:.1f} s [{card}]")
    return {"text fit (phase 11)": fit_launches, "infer_text (phase 11)": serve_launches,
            "CLI fit (phase 11)": cli_launches["fit"], "select (phase 11)": cli_launches["select"],
            "CLI find-k, train-eval (phase 11)": {
                k: cli_launches["find-k"][k] + cli_launches["train-eval"][k]
                for k in FIT_KERNELS}}

# ---------------------------------------------------------------------------
# phase 12: the E-step options (two_pass_fused, newton_bf16_beta)
# ---------------------------------------------------------------------------
#
# newton_bf16_beta runs the Newton search on beta_doc rounded to bf16:
# B1, B3 and B4 in their bf16-input modes, each held to its plain version
# given the same bf16 beta_doc (the float32 function of the rounded
# values: the same bounds as phase 2), and to DISCRIMINATE against the
# float32 beta_doc's plain outputs.  two_pass_fused moves the finalize
# into passes 1 and 2; its Newton trajectories are the unfused schedule's
# bit for bit, only the statistics' float32 summation order differs.


def beta_plain(torch, stages, inputs, bf16):
    """A chunk's inputs with beta_doc rounded to bf16, the plain outputs
    on them, and the float32 beta_doc's plain f, g, H and sweep in
    ``aux["other_beta"]``: (bf16 inputs, the same in float32 for judge,
    want, aux)."""
    eta, bd, c, mu, siginv = inputs
    bd_b = bd.to(torch.bfloat16)
    inputs_b = (eta, bd_b, c, mu, siginv)
    want, aux = plain_outputs(torch, stages, inputs_b, bf16)
    f, g, H = stages.fgh_plain(eta, bd, c, mu, siginv, bf16=bf16)
    aux["other_beta"] = {"fgh.f": f, "fgh.g": g, "fgh.H": H, "ls": stages.linesearch_plain(
        eta, aux["p"], aux["ts"], bd, c, mu, siginv)}
    return inputs_b, (eta, bd_b.float(), c, mu, siginv), want, aux


def check_stages_beta(torch, stages, fails, inputs, label):
    """B1 and B3 on the bf16 rounding of the chunk's beta_doc, bf16
    Hessian off and on.  Returns each mode's max abs error (bf16 Hessian
    on), the bf16 inputs and the plain step's values."""
    for bf16 in (False, True):
        inputs_b, inputs_r, want, aux = beta_plain(torch, stages, inputs, bf16)
        got = kernel_outputs(stages, inputs_b, aux, bf16, cg=False)
        torch.cuda.synchronize()
        errs = judge(torch, stages, inputs_r, got, want, aux, bf16)
        for name, (abs_e, worst, finite) in errs.items():
            fails.check(finite and worst <= 1.0,
                        f"{label} {name} bf16 beta_doc, bf16={bf16}: max_abs_err={abs_e:.3e}, "
                        f"worst error/bound={worst:.3e} (must be <= 1)")
    max_abs = {"fgh_bf16_beta": max(errs[k][0] for k in ("fgh.f", "fgh.g", "fgh.H")),
               "ls_bf16_beta": errs["ls"][0]}
    return max_abs, inputs_b, aux


def beta_iter_parts(torch, stages, inputs_loop, bf16):
    """The plain step on a chunk's beta_doc rounded to bf16 from a point
    part-way along its trajectory, with the float32 beta_doc's step in
    ``parts["other_beta"]``: (the step's bf16 inputs, the same in float32
    for judge_iter, parts)."""
    bd, c, mu, siginv = inputs_loop
    bd_b = bd.to(torch.bfloat16)
    eta, done = midway(torch, stages, (bd_b, c, mu, siginv), bf16)
    inputs_r = (eta, bd_b.float(), c, mu, siginv)
    parts = iter_plain_parts(torch, stages, inputs_r, done, bf16)
    parts["other_beta"] = stages.newton_iter_plain(eta, bd, c, mu, siginv, parts["ts"], done,
                                                   GRAD_TOL, parts["cg_iters"], bf16)
    return (eta, bd_b, c, mu, siginv), inputs_r, parts


def check_iter_beta(torch, stages, fails, inputs_loop, label):
    """B4 on the bf16 rounding of the chunk's beta_doc against the plain
    step on the same bf16 beta_doc, from a point part-way along the
    trajectory, bf16 Hessian off and on: phase 2's iteration check, with
    LEAN_MAX against the other bf16 mode's step and the float32 beta_doc's.
    Prints how many documents B4 steps as the stage path's iteration does
    (B1 and B3 in their bf16-beta_doc modes, B2, the PyTorch glue) bit for
    bit: the same bodies, gᵀp summed in another order.  Returns max
    |kernel - plain| (bf16 Hessian on)."""
    B = inputs_loop[2].shape[0]
    for bf16 in (False, True):
        (eta, bd_b, c, mu, siginv), inputs_r, parts = beta_iter_parts(torch, stages, inputs_loop,
                                                                      bf16)
        args = (eta, bd_b, c, mu, siginv, parts["ts"], parts["done"], GRAD_TOL,
                parts["cg_iters"], bf16)
        got = stages.newton_iter(*args)
        stage = stages.stage_step(*args[:7], None, *args[7:])[:3]
        torch.cuda.synchronize()
        worst, n_margin, flags_ok, kept, finite = judge_iter(torch, stages, inputs_r, parts, got,
                                                             lean_other=True)
        err = float((got[0] - parts["want"][0]).abs().max())
        same = int((got[0] == stage[0]).all(1).sum())
        fails.check(finite and flags_ok and kept and worst <= 1.0,
                    f"{label} iter bf16 beta_doc, bf16={bf16}: max_abs_err={err:.3e}, worst "
                    f"error/bound={worst:.3e}, flags equal off the margin {flags_ok}, done "
                    f"documents kept {kept}; {n_margin} of {B} documents on the margin; eta "
                    f"bit-equal to the stage path's iteration on {same} of {B}")
    return err


def time_beta_modes(torch, stages, results, name, bf16_fn, plain_fn, f32_fn):
    """A bf16-beta_doc mode's time and its plain version's, timed in turns;
    then the mode against the same kernel's float32-beta_doc mode, in
    turns."""
    ms, pms = time_pair(torch, bf16_fn, plain_fn)
    ms2, f32_ms = time_pair(torch, bf16_fn, f32_fn)
    results[name].update(ms=ms, plain_ms=pms, library_ms=None)
    print(f"  {name} in turns with the float32 beta_doc mode: {ms2:.4f} vs {f32_ms:.4f} ms "
          f"[{CARD}]")


def phase_beta_kernels(torch, stages, fails, words, counts, beta_true):
    """Phase 12a: B1, B3 and B4 in their bf16-beta_doc modes at the main
    path's shapes (B1/B3 on phase 2's random chunk, B4 on the bench chunk
    with the true beta), timed beside their bounds and their float32-beta_doc
    modes; then at phase 2b's widths."""
    from strutopy_tpu_torch.corpus.bow import PaddedCorpus

    inputs = stage_inputs(torch, words, counts, K_BENCH, seed=1)
    B, L = words.shape
    print(f"phase 12a: bf16 beta_doc modes vs plain, B={B} K={K_BENCH} L={L} T=12")
    max_abs, inputs_b, aux = check_stages_beta(torch, stages, fails, inputs, f"K={K_BENCH}")
    corpus = PaddedCorpus(words, counts, counts.sum(1) > 0, V_BENCH)
    inputs_loop = dgp_inputs(torch, corpus, beta_true)
    max_abs["iter_bf16_beta"] = check_iter_beta(torch, stages, fails, inputs_loop,
                                                f"K={K_BENCH}")
    results = {k: {"max_abs_err": v} for k, v in max_abs.items()}

    eta, bd, c, mu, siginv = inputs
    bd_b = inputs_b[1]
    p, ts = aux["p"], aux["ts"]
    time_beta_modes(torch, stages, results, "fgh_bf16_beta",
                    lambda: stages.fgh(eta, bd_b, c, mu, siginv, bf16=True),
                    lambda: stages.fgh_plain(eta, bd_b, c, mu, siginv, bf16=True),
                    lambda: stages.fgh(eta, bd, c, mu, siginv, bf16=True))
    time_beta_modes(torch, stages, results, "ls_bf16_beta",
                    lambda: stages.linesearch(eta, p, ts, bd_b, c, mu, siginv),
                    lambda: stages.linesearch_plain(eta, p, ts, bd_b, c, mu, siginv),
                    lambda: stages.linesearch(eta, p, ts, bd, c, mu, siginv))
    bounds = stage_bounds(inputs_b, aux)
    for mode in ("fgh_bf16_beta", "ls_bf16_beta"):
        b_ms, b_by = bounds[BETA_MODES[mode]]
        results[mode].update(bound_ms=b_ms, bound_by=b_by)

    lbd, lc, lmu, lsig = inputs_loop
    lbd_b = lbd.to(torch.bfloat16)
    lts = step_sizes(torch, lmu.device)
    leta, ldone = midway(torch, stages, (lbd_b, lc, lmu, lsig), True)
    Km1 = K_BENCH - 1
    adv = stages.newton_iter_plain(leta, lbd_b, lc, lmu, lsig, lts, ldone, GRAD_TOL, 6, True)[2]
    n_step, n_conv = int(adv.sum()), int((~ldone & ~adv).sum())
    results["iter_bf16_beta"]["bound_ms"], results["iter_bf16_beta"]["bound_by"] = roofline(
        nbytes(lbd_b, lc, lmu, lsig, lts, leta, ldone) + B * (4 * Km1 + 2),
        step_ops(n_step, K_BENCH, L, N_STEPS, 6, fgh_only=n_conv))
    time_beta_modes(
        torch, stages, results, "iter_bf16_beta",
        lambda: stages.newton_iter(leta, lbd_b, lc, lmu, lsig, lts, ldone, GRAD_TOL, 6, True),
        lambda: stages.newton_iter_plain(leta, lbd_b, lc, lmu, lsig, lts, ldone, GRAD_TOL, 6,
                                         True),
        lambda: stages.newton_iter(leta, lbd, lc, lmu, lsig, lts, ldone, GRAD_TOL, 6, True))
    print_times(results, "bf16 Hessian on, bf16 beta_doc; median of 3 rounds of a CUDA graph "
                         "of 20 calls")
    # each mode against its float32 mode given the rounded values: every read
    # of the ring gives the float32 path the same numbers, so the two part
    # only where the plans sum in another order.  B1 and B4 keep the float32
    # slab plans and sum order (B1 pairs its B·Bᵀ tiles with bf16 slabs,
    # which leaves each tile's sums as they were), so they should be
    # bit-equal; B3's bf16 plan of its own (128-slot slabs at this width)
    # gives each thread other word slots, so the sweep's sums part by
    # rounding.  A print, not a check: the checks above hold each mode to
    # the plain version on the same bf16 beta_doc.
    pairs = {
        "fgh_bf16_beta": (stages.fgh(eta, bd_b, c, mu, siginv),
                          stages.fgh(eta, bd_b.float(), c, mu, siginv)),
        "ls_bf16_beta": ((stages.linesearch(eta, p, ts, bd_b, c, mu, siginv),),
                         (stages.linesearch(eta, p, ts, bd_b.float(), c, mu, siginv),)),
        "iter_bf16_beta": (
            stages.newton_iter(leta, lbd_b, lc, lmu, lsig, lts, ldone, GRAD_TOL, 6, True),
            stages.newton_iter(leta, lbd_b.float(), lc, lmu, lsig, lts, ldone, GRAD_TOL, 6,
                               True))}
    same = {k: (all(bool(torch.equal(x, y)) for x, y in zip(a, b)),
                f"{max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b)):.3e}")
            for k, (a, b) in pairs.items()}
    print(f"  bf16 beta_doc modes vs their float32 modes given the same rounded values (bit-equal, "
          f"max |diff|; apart by the plans' order of sums): {same}")

    rng = np.random.default_rng(5)
    for K, L in WIDTHS:
        wb = np.stack([rng.choice(V_BENCH, L, replace=False) for _ in range(32)]).astype(np.int32)
        cb = np.zeros((32, L), np.float32)
        live = min(200, L - 7)
        cb[:, :live] = rng.integers(1, 5, (32, live))
        print(f"phase 12a: bf16 beta_doc modes vs plain, B=32 K={K} L={L}")
        check_stages_beta(torch, stages, fails, stage_inputs(torch, wb, cb, K, seed=K),
                          f"K={K} L={L}")
        cw = PaddedCorpus(wb, cb, cb.sum(1) > 0, V_BENCH)
        check_iter_beta(torch, stages, fails,
                        dgp_inputs(torch, cw, random_beta(K, V_BENCH, seed=K)), f"K={K} L={L}")
    return results


def one_iteration(torch, model, state, cfg):
    """One EM iteration of ``cfg`` from ``state`` on ``model``'s corpus
    (the step ``expectation_maximization`` builds for that configuration):
    (new state, wall s)."""
    from strutopy_tpu_torch.models.em import make_em_step

    step = make_em_step(cfg, model._design, None, None,
                        bucket_batches=model._plan.batch_sizes)
    torch.cuda.synchronize()
    t0 = time.time()
    out = step(state, model._data)
    torch.cuda.synchronize()
    return out, time.time() - t0


def step_gap(a, b):
    """(rel bound diff, max |beta diff|, max |eta diff|) of two EM states."""
    rel = abs(float(a.bound) - float(b.bound)) / abs(float(b.bound))
    return rel, float((a.beta - b.beta).abs().max()), float((a.eta - b.eta).abs().max())


BETA_FIT_RTOL = FIT_RTOL  # bf16 beta_doc on the stage path vs on B4, one iteration
# (straggler fraction, pass-1 cap) of phase 12b's second pair: a budget of
# one chunk against most of the corpus unconverged after 2 steps
OVERFLOW = (0.01, 2)


def phase_options(torch, stages, fails, docs, X, cfg, card, words, counts, beta_true,
                  bench_bounds):
    """Phase 12: the two E-step options at the bench width (see the module
    docstring).  Returns the bf16-beta_doc modes' kernel results and their
    launches on the fits that drive them."""
    from strutopy_tpu_torch import STM

    t_phase = time.time()
    results = phase_beta_kernels(torch, stages, fails, words, counts, beta_true)

    # (b), (c): from one state after phase 4's 2 cold iterations
    base = STM(docs, K=K_BENCH, X=X, config=cfg.replace(max_em_iter=2), device="cuda")
    state = base._state
    for it in range(2):
        state = em_step_fn(base, it)(state, base._data)
    for frac, cap in ((cfg.newton_straggler_frac, cfg.newton_pass1_iters), OVERFLOW):
        c = cfg.replace(newton_straggler_frac=frac, newton_pass1_iters=cap)
        (two, sec2), (fused, secf) = (one_iteration(torch, base, state, c.replace(
            two_pass_fused=f)) for f in (False, True))
        rel, d_beta, _ = step_gap(fused, two)
        same = (bool(torch.equal(fused.eta, two.eta))
                and bool(torch.equal(fused.opt_iters, two.opt_iters)))
        ov = (int(two.straggler_overflow), int(fused.straggler_overflow))
        fails.check(same and ov[0] == ov[1] and (ov[0] > 0 or (frac, cap) != OVERFLOW)
                    and rel <= STEP_RTOL and d_beta <= STEP_BETA_ATOL,
                    f"phase 12b: two-pass iteration from one state, straggler fraction {frac}, "
                    f"pass-1 cap {cap}: "
                    f"fused vs unfused eta and Newton counts bit-equal {same}, overflow "
                    f"{ov[1]} vs {ov[0]}, bound rel diff {rel:.3e} (tol {STEP_RTOL:.0e}), max "
                    f"|beta diff| {d_beta:.3e} (tol {STEP_BETA_ATOL:.0e}); wall fused {secf:.4f} "
                    f"s, unfused {sec2:.4f} s [{card}]")
        if frac == cfg.newton_straggler_frac:
            ref, ref_sec = two, sec2

    paths = {}
    for path, extra in (("stage", {}), ("iter", {"pallas_iter": True}),
                        ("newton", {"use_pallas": True, "newton_pass1_iters": 0})):
        reset(stages)
        out, sec = one_iteration(torch, base, state, cfg.replace(newton_bf16_beta=True, **extra))
        paths[path] = (out, sec, {k: v for k, v in stages.LAUNCHES.items() if v})
    rel, d_beta, d_eta = step_gap(paths["stage"][0], ref)
    print(f"phase 12c: bf16 beta_doc, stage path, one two-pass iteration: bound "
          f"{float(paths['stage'][0].bound):.6f} vs float32 beta_doc {float(ref.bound):.6f} (rel "
          f"gap {rel:.3e}), max |beta diff| {d_beta:.3e}, max |eta diff| {d_eta:.3e}; "
          f"{paths['stage'][1]:.4f} s vs {ref_sec:.4f} s [{card}]")
    rel, _, _ = step_gap(paths["iter"][0], paths["stage"][0])
    launches = {p: v[2] for p, v in paths.items()}
    fails.check(rel <= BETA_FIT_RTOL and launches["iter"].get("iter_bf16_beta", 0) > 0
                and "iter" not in launches["iter"]
                and launches["stage"].get("fgh_bf16_beta", 0) > 0
                and launches["stage"].get("ls_bf16_beta", 0) > 0
                and not {"fgh", "ls"} & set(launches["stage"]),
                f"phase 12c: bf16 beta_doc on B4 vs the stage path from one state: bound rel "
                f"diff {rel:.3e} (tol {BETA_FIT_RTOL:.0e}); launches {launches['stage']} / "
                f"{launches['iter']}; {paths['iter'][1]:.4f} s [{card}]")
    f32, _sec = one_iteration(torch, base, state, cfg.replace(use_pallas=True,
                                                               newton_pass1_iters=0))
    b5 = paths["newton"][0]
    same = all(bool(torch.equal(getattr(b5, f), getattr(f32, f)))
               for f in ("eta", "opt_iters", "theta", "bound", "sigma"))
    fails.check(same and not any(k.endswith("bf16_beta") for k in launches["newton"]),
                f"phase 12c: B5 with newton_bf16_beta equals B5 without it bit for bit {same} "
                f"(eta, Newton counts, theta, bound, sigma); launches {launches['newton']}")
    del base, state, paths, ref, f32, b5

    # (d) both options through STM.expectation_maximization, on the stage
    # path and on B4: the bf16-beta_doc modes' main paths
    counted = {}
    for path, extra, modes in (("stage", {}, ("fgh_bf16_beta", "ls_bf16_beta")),
                               ("iter", {"pallas_iter": True}, ("iter_bf16_beta",))):
        c = cfg.replace(max_em_iter=3, two_pass_fused=True, newton_bf16_beta=True, **extra)
        model = STM(docs, K=K_BENCH, X=X, config=c, device="cuda")
        reset(stages)
        model.expectation_maximization()
        got = {k: v for k, v in stages.LAUNCHES.items() if v}
        counted.update({m: got.get(m, 0) for m in modes})
        b = np.asarray(model.last_bounds)
        gap = np.abs(b - bench_bounds[:3]) / np.abs(bench_bounds[:3])
        fails.check(len(b) == 3 and bool(np.isfinite(b).all())
                    and all(got.get(m, 0) > 0 for m in modes)
                    and not {BETA_MODES[m] for m in modes} & set(got),
                    f"phase 12d: fit with both options on the {path} path, 3 EM iterations: "
                    f"bounds {b.tolist()} (rel gap to phase 4's {gap.tolist()}), "
                    f"{[round(s, 4) for s in model.iter_seconds]} s; launches {got} [{card}]")
        del model
    print(f"phase 12 took {time.time() - t_phase:.1f} s [{card}]")
    return results, counted


# ---------------------------------------------------------------------------
# phase 13: multi-device fits (strutopy_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

MESH_N = 2_048  # 13b's documents: the bench corpus cut to fit the phase's time
MESH_RANK_TIMEOUT = 240  # s a 13b world may take, each rank's start included
MESH_COLD_RTOL = 2e-4  # meshed vs one device, cold single-pass iterations (as phase 9a)
MESH_STEP_RTOL = 1e-5  # one EM iteration from one state: the bound, relative
MESH_STEP_ATOL = 1e-5  # ... and that iteration's new beta and kappa, absolute
MESH_SERVE_ATOL = 1e-5  # served theta, meshed vs one device
MESH_BITS_RTOL = 1e-6  # 13a: a world of one reduces nothing


def free_port() -> int:
    """A free TCP port on localhost for the process group's store."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for one rank on card 0."""
    return dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                MASTER_ADDR="localhost", MASTER_PORT=str(port))


def mesh_corpus(n=MESH_N):
    """13b's corpora: the bench corpus cut to ``n`` documents, and for gate
    C the same plus ``n // 4`` documents of 60 tokens, which the plan puts
    in a second length bucket (L=128)."""
    docs, X = make_corpus(K_BENCH, V_BENCH, N_BENCH, WORDS_BENCH)
    short, Xs = make_corpus(K_BENCH, V_BENCH, n // 4, 60, seed=5)
    return (docs[:n], X[:n]), (docs[:n] + short, np.concatenate([X[:n], Xs]))


def mesh_gates(cfg_bench):
    """13b's fit gates: name -> (corpus index, STM keyword arguments, mesh
    shape, EM iterations).  A and H: the bench configuration on a 1-D
    mesh of 2; B: on a 1 x 2 (docs, vocab) mesh; C: two length buckets and
    the two-pass schedule from the first iteration (straggler fraction 1,
    so no budget overflows); G: phase 7's content model (A=2, kappa design
    of 102 columns) on the 1 x 2 mesh."""
    c = cfg_bench.replace(max_em_iter=2)
    cfg_c = cfg_bench.replace(max_em_iter=2, newton_warmup_iters=0,
                              newton_straggler_frac=1.0)
    return {"A": (0, dict(config=c), (2,)), "B": (0, dict(config=c), (1, 2)),
            "C": (1, dict(config=cfg_c), (2,)),
            "G": (0, dict(config=c.replace(content=True, A=2, lda_beta=False)), (1, 2))}


def mesh_rank_main(rank: int, world: int, out_dir: str, backend: str, port: int) -> None:
    """One rank of phase 13b (``chip_smoke.py --mesh-rank R WORLD DIR
    BACKEND PORT``): both ranks on card 0, the gates of ``mesh_gates``,
    serving (E, E2) from gate A's saved model, and H; the results go to
    ``DIR/rank{R}.pkl``.  With ``BACKEND`` ``nccl-probe`` it only tries one
    NCCL all-reduce between the two ranks."""
    import datetime
    import pickle

    import torch

    from strutopy_tpu_torch import STM, STMConfig, ThetaServer
    from strutopy_tpu_torch.ops import stages
    from strutopy_tpu_torch.parallel.mesh import init_from_env, make_mesh, make_mesh_2d
    from strutopy_tpu_torch.parallel.sharding import gather_state
    from strutopy_tpu_torch.utils.checkpoint import save_checkpoint

    os.environ.update(torchrun_env(rank, world, port))
    probe = backend == "nccl-probe"
    dev = init_from_env("nccl" if probe else backend, "cuda",
                        timeout=datetime.timedelta(seconds=MESH_RANK_TIMEOUT))
    if probe:
        import torch.distributed as dist

        t = torch.ones(1, device=dev)
        dist.all_reduce(t)
        print(f"rank {rank}: NCCL all-reduce of two ranks on one card gave {t.item()}")
        dist.destroy_process_group()
        return
    (docs, X), (docs_c, X_c) = mesh_corpus()
    cfg = STMConfig(K=K_BENCH, init_type="random", batch_size=256, newton_pass1_iters=6,
                    newton_straggler_frac=0.25, convergence_threshold=0.0)
    meshes = {(2,): make_mesh(2), (1, 2): make_mesh_2d(1, 2)}
    out = {"backend": backend}
    model_dir = os.path.join(out_dir, "model_A")
    for gate, (ci, kw, shape) in mesh_gates(cfg).items():
        d, x = ((docs, X), (docs_c, X_c))[ci]
        extra = dict(beta_index=x.astype(np.int32)) if kw["config"].content else {}
        t0 = time.time()
        m = STM(d, K=K_BENCH, X=x, mesh=meshes[shape], device=dev, **kw, **extra)
        built = time.time() - t0
        reset(stages)
        m.expectation_maximization()
        launches = {k: stages.LAUNCHES[k] for k in FIT_KERNELS}
        whole = m._whole()
        if rank == 0:
            save_checkpoint(os.path.join(out_dir, f"state_{gate}.npz"), whole,
                            m.last_bounds, len(m.last_bounds))
        # one iteration from that state, on the step a cold iteration runs
        m._set_state(whole)
        step = m._em_step_cold or m._em_step
        torch.cuda.synchronize()
        t0 = time.time()
        new = gather_state(meshes[shape], step(m._state, m._data), m.config.content)
        torch.cuda.synchronize()
        out[gate] = dict(bounds=list(m.last_bounds), walls=list(m.iter_seconds), built=built,
                         launches=launches, step_bound=float(new.bound),
                         step_wall=time.time() - t0,
                         step_beta=new.beta.cpu().numpy() if rank == 0 else None,
                         step_kappa=new.kappa.cpu().numpy() if rank == 0 else None,
                         local_beta=tuple(m._state.beta.shape))
        if gate == "A":
            m.save_model(model_dir)
        del m, whole, new
    req, Xr = make_corpus(K_BENCH, V_BENCH, 2_048, WORDS_BENCH, seed=11)
    for gate, shape in (("E", (2,)), ("E2", (1, 2))):
        srv = ThetaServer(model_dir, mesh=meshes[shape], device=dev)
        srv.infer(req[:16], X=Xr[:16])  # warm
        reset(stages)
        torch.cuda.synchronize()
        t0 = time.time()
        theta, _eta = srv.infer(req, X=Xr)
        torch.cuda.synchronize()
        out[gate] = dict(theta=theta if rank == 0 else None, wall=time.time() - t0,
                         launches={k: stages.LAUNCHES[k] for k in FIT_KERNELS},
                         theta_sha=hashlib.sha256(theta.tobytes()).hexdigest())
    # H: checkpoint and resume on the 1-D mesh, bit for bit, with no flag
    # of PyTorch's (as phase 8)
    ckpt = os.path.join(out_dir, "resume.npz")
    kw = dict(K=K_BENCH, X=X, mesh=meshes[(2,)], device=dev)
    t0 = time.time()
    reset(stages)
    full = STM(docs, config=cfg.replace(max_em_iter=4), **kw)
    full.expectation_maximization()
    STM(docs, config=cfg.replace(max_em_iter=2), **kw).expectation_maximization(
        checkpoint_path=ckpt)
    rest = STM(docs, config=cfg.replace(max_em_iter=4), **kw)
    rest.expectation_maximization(checkpoint_path=ckpt, resume=True)
    out["H"] = dict(full=list(full.last_bounds), resumed=list(rest.last_bounds),
                    beta_equal=bool(np.array_equal(full.beta, rest.beta)),
                    theta_equal=bool(np.array_equal(full.theta, rest.theta)),
                    wall=time.time() - t0, flag=torch.are_deterministic_algorithms_enabled(),
                    launches={k: stages.LAUNCHES[k] for k in FIT_KERNELS})
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def restorage(state, model, n_doc_shards):
    """A whole state of a fit on ``n_doc_shards`` document shards, its rows
    moved to ``model``'s (unmeshed) storage order: both plans map user
    document i to a row (``storage_index``); padding rows start afresh."""
    import dataclasses

    import torch

    from strutopy_tpu_torch.corpus.bucketing import make_bucket_plan

    cfg = model.config
    src = make_bucket_plan(model._corpus, cfg.batch_size, n_devices=n_doc_shards,
                           max_buckets=cfg.max_buckets if cfg.auto_bucket else 1)
    src = torch.as_tensor(src.storage_index[:model._corpus.N], device=state.eta.device)
    dst = torch.as_tensor(model._storage_index, device=state.eta.device)
    n = model._plan.n_storage
    out = {}
    for f in ("mu", "eta", "theta", "opt_iters"):
        x = getattr(state, f)
        y = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        if f == "theta":
            y.fill_(1.0 / cfg.K)
        y[dst] = x[src]
        out[f] = y
    return dataclasses.replace(state, **out)


def run_ranks(fails, out_dir, backend, label, timeout=MESH_RANK_TIMEOUT):
    """Start two ranks of ``mesh_rank_main``; wait for both, ending the
    other at the first failure or at the deadline.  -> rcs, wall s."""
    port = free_port()
    t0 = time.time()
    procs = []
    for r in range(2):
        with open(os.path.join(out_dir, f"{backend}.log{r}"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                           "--mesh-rank", str(r), "2", out_dir, backend,
                                           str(port)], stdout=log, stderr=subprocess.STDOUT))
    while time.time() - t0 < timeout:
        rcs = [p.poll() for p in procs]
        if any(rc not in (None, 0) for rc in rcs) or all(rc == 0 for rc in rcs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
    rcs = [p.wait() for p in procs]
    wall = time.time() - t0
    if backend != "nccl-probe":
        fails.check(rcs == [0, 0], f"{label}: ranks exited {rcs} in {wall:.1f} s "
                                   f"(limit {timeout} s)")
        if rcs != [0, 0]:
            for r in range(2):
                with open(os.path.join(out_dir, f"{backend}.log{r}")) as f:
                    print(f"  rank {r}'s log, last lines:\n" + f.read()[-3000:])
    return rcs, wall


def phase_mesh_one(torch, stages, fails, corpus, X, card):
    """Phase 13a: an NCCL world of one on the card, through the port's own
    ``init_from_env``: the default configuration on ``make_mesh(1)``
    (spectral init through the sharded Gram scan) and the bench
    configuration on ``make_mesh_2d(1, 1)`` (random init, every chunk's
    beta_doc through a vocab all-reduce), 3 EM iterations each, and 2,048
    documents served on each mesh, against the same runs unmeshed, with no
    flag of PyTorch's.  A world of one reduces nothing and every kernel
    adds in a fixed order, so each fit's bounds, beta and theta must be
    bit-equal (and its bounds within ``MESH_BITS_RTOL``)."""
    import tempfile

    import torch.distributed as dist

    from strutopy_tpu_torch import STM, STMConfig, ThetaServer
    from strutopy_tpu_torch.ops import build, spectral
    from strutopy_tpu_torch.parallel.mesh import init_from_env, make_mesh, make_mesh_2d

    t_phase = time.time()
    os.environ.update(torchrun_env(0, 1, free_port()))
    init_from_env("nccl", "cuda")
    backend = dist.get_backend()
    print(f"phase 13a: a world of one over {backend} on the card; K={K_BENCH} V={V_BENCH} "
          f"N={corpus.N}; {card}")
    sharded_gram = [0]
    scan = spectral._gram_scan_sharded

    def counted(*a, **k):
        sharded_gram[0] += 1
        return scan(*a, **k)

    bench = STMConfig(K=K_BENCH, init_type="random", batch_size=256, newton_pass1_iters=6,
                      newton_straggler_frac=0.25, max_em_iter=3, convergence_threshold=0.0)
    req, Xr = make_corpus(K_BENCH, V_BENCH, 2_048, WORDS_BENCH, seed=11)
    spectral._gram_scan_sharded = counted
    try:
        for label, kw, mesh in (
                ("default configuration, make_mesh(1)", dict(max_em_iter=3), make_mesh(1)),
                ("bench configuration, make_mesh_2d(1, 1)", dict(config=bench),
                 make_mesh_2d(1, 1))):
            fits = {}
            for which, m_ in (("unmeshed", None), ("meshed", mesh)):
                reset(stages)
                t0 = time.time()
                m = STM(corpus, K=K_BENCH, X=X, mesh=m_, device="cuda", **kw)
                m.expectation_maximization()
                torch.cuda.synchronize()
                fits[which] = (m, time.time() - t0,
                               {k: stages.LAUNCHES[k] for k in FIT_KERNELS})
            (m0, w0, l0), (m1, w1, l1) = fits["unmeshed"], fits["meshed"]
            b0, b1 = np.asarray(m0.last_bounds), np.asarray(m1.last_bounds)
            rel = float(np.max(np.abs(b1 - b0) / np.abs(b0)))
            bits = (np.array_equal(b0, b1) and np.array_equal(m0.beta, m1.beta)
                    and np.array_equal(m0.theta, m1.theta))
            fails.check(len(b1) == 3 and rel <= MESH_BITS_RTOL and bits
                        and all(v > 0 for v in l1.values()),
                        f"13a {label}: bounds {b1.tolist()} vs unmeshed {b0.tolist()}: max rel "
                        f"gap {rel:.3e} (tol {MESH_BITS_RTOL:.0e}); bounds, beta and theta "
                        f"bit-equal (held): {bits}; walls {w1:.2f} vs {w0:.2f} s (build, init, 3 "
                        f"iterations); iterations {[round(s, 4) for s in m1.iter_seconds]} vs "
                        f"{[round(s, 4) for s in m0.iter_seconds]} s; launches {l1} vs {l0} "
                        f"[{card}]")
            with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
                m1.save_model(d)
                served = {}
                for which, m_ in (("unmeshed", None), ("meshed", mesh)):
                    srv = ThetaServer(d, mesh=m_, device="cuda")
                    srv.infer(req[:16], X=Xr[:16])
                    torch.cuda.synchronize()
                    t0 = time.time()
                    served[which] = (srv.infer(req, X=Xr)[0], time.time() - t0)
            (t_0, s0), (t_1, s1) = served["unmeshed"], served["meshed"]
            gap = float(np.abs(t_1 - t_0).max())
            fails.check(gap <= MESH_SERVE_ATOL and simplex_ok(t_1, len(req), K_BENCH),
                        f"13a {label}: 2,048 documents served, max |theta gap| {gap:.3e} "
                        f"(tol {MESH_SERVE_ATOL:.0e}), bit-equal {np.array_equal(t_0, t_1)}; "
                        f"{1e3 * s1:.1f} vs {1e3 * s0:.1f} ms [{card}]")
            del fits, m0, m1
    finally:
        spectral._gram_scan_sharded = scan
        dist.destroy_process_group()
    fails.check(sharded_gram[0] == 1, f"13a: the meshed default fit's spectral init ran the "
                                      f"sharded Gram scan ({sharded_gram[0]} call)")
    print(f"phase 13a took {time.time() - t_phase:.1f} s [{card}]")


def phase_mesh_two(torch, stages, fails, card):
    """Phase 13b: two ranks on the one card (``mesh_rank_main``), then each
    gate's unmeshed twin in this process: the cold iterations within
    ``MESH_COLD_RTOL``, one iteration from the meshed fit's state within
    ``MESH_STEP_RTOL``, served theta within ``MESH_SERVE_ATOL``, the
    resumed fit bit for bit.  The two ranks share one card: no scaling."""
    import pickle
    import tempfile

    from strutopy_tpu_torch import STM, STMConfig, ThetaServer
    from strutopy_tpu_torch.ops import build
    from strutopy_tpu_torch.utils.checkpoint import load_checkpoint

    t_phase = time.time()
    print(f"phase 13b: two ranks on the one card; K={K_BENCH} V={V_BENCH}, N cut from "
          f"{N_BENCH:,} to {MESH_N:,} (gate C: {MESH_N:,} + {MESH_N // 4:,} short documents) "
          f"to fit the phase's time; {card}")
    print("  both ranks run on card 0, so the walls below are no scaling figure: the card's "
          "machine has one device, and scaling across cards is not measured")
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as d:
        rcs, wall = run_ranks(fails, d, "nccl-probe", "13b NCCL probe", timeout=60)
        backend = "nccl" if rcs == [0, 0] else "gloo"
        if backend == "nccl":
            print(f"  NCCL accepted two ranks on one card ({wall:.1f} s): 13b runs on NCCL")
        else:
            with open(os.path.join(d, "nccl-probe.log0")) as f:
                lines = f.read().splitlines()
            # NCCL names the fault on the line after "Last error:"
            why = [lines[i + 1] for i, ln in enumerate(lines[:-1]) if "Last error:" in ln]
            why = why or [ln for ln in lines if "NCCL error" in ln]
            print(f"  NCCL refused two ranks on one card (ranks exited {rcs} in {wall:.1f} s: "
                  f"{why[:2]}); 13b runs on gloo with CUDA tensors")
        rcs, wall = run_ranks(fails, d, backend, f"13b world of two over {backend}")
        if rcs != [0, 0]:
            return
        ranks = []
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        (docs, X), (docs_c, X_c) = mesh_corpus()
        cfg = STMConfig(K=K_BENCH, init_type="random", batch_size=256, newton_pass1_iters=6,
                        newton_straggler_frac=0.25, convergence_threshold=0.0)
        for gate, (ci, kw, shape) in mesh_gates(cfg).items():
            dd, x = ((docs, X), (docs_c, X_c))[ci]
            extra = dict(beta_index=x.astype(np.int32)) if kw["config"].content else {}
            reset(stages)
            m = STM(dd, K=K_BENCH, X=x, device="cuda", **kw, **extra)
            m.expectation_maximization()
            one = {k: stages.LAUNCHES[k] for k in FIT_KERNELS}
            b0, b1 = np.asarray(m.last_bounds), np.asarray(ranks[0][gate]["bounds"])
            cold = float(np.max(np.abs(b1 - b0) / np.abs(b0)))
            state, *_ = load_checkpoint(os.path.join(d, f"state_{gate}.npz"), device="cuda")
            state = restorage(state, m, shape[0])
            step = m._em_step_cold or m._em_step
            new = step(state, m._data)
            sb = ranks[0][gate]["step_bound"]
            srel = abs(sb - float(new.bound)) / abs(float(new.bound))
            # the new beta (and a content model's kappa) come out of the
            # vocab-sharded M-step: hold them directly, not only through
            # the next iteration's bound
            sbeta = float(np.abs(ranks[0][gate]["step_beta"] - new.beta.cpu().numpy()).max())
            kgap = np.abs(ranks[0][gate]["step_kappa"] - new.kappa.cpu().numpy())
            skappa = float(kgap.max()) if kgap.size else 0.0
            same = ranks[1][gate]["bounds"] == ranks[0][gate]["bounds"]
            fails.check(
                cold <= MESH_COLD_RTOL and srel <= MESH_STEP_RTOL and same
                and sbeta <= MESH_STEP_ATOL and skappa <= MESH_STEP_ATOL
                and all(all(v > 0 for v in r[gate]["launches"].values()) for r in ranks),
                f"13b gate {gate}, mesh {shape} over {backend}: cold bounds {b1.tolist()} vs one "
                f"device {b0.tolist()}, max rel gap {cold:.3e} (tol {MESH_COLD_RTOL:.0e}); one "
                f"iteration from the meshed state: bound rel gap {srel:.3e} (tol "
                f"{MESH_STEP_RTOL:.0e}), max |beta gap| {sbeta:.3e}, max |kappa gap| "
                f"{skappa:.3e} (tol {MESH_STEP_ATOL:.0e}); both ranks' bounds "
                f"equal {same}; local beta {ranks[0][gate]['local_beta']}; walls: build "
                f"{ranks[0][gate]['built']:.2f} s, iterations "
                f"{[round(s, 4) for s in ranks[0][gate]['walls']]} s, step "
                f"{ranks[0][gate]['step_wall']:.4f} s (one device: "
                f"{[round(s, 4) for s in m.iter_seconds]} s); B1-B3 launches by rank "
                f"{[r[gate]['launches'] for r in ranks]}, one device {one} [{card}]")
            del m, state, new
        req, Xr = make_corpus(K_BENCH, V_BENCH, 2_048, WORDS_BENCH, seed=11)
        srv = ThetaServer(os.path.join(d, "model_A"), device="cuda")
        srv.infer(req[:16], X=Xr[:16])
        torch.cuda.synchronize()
        t0 = time.time()
        theta = srv.infer(req, X=Xr)[0]
        wall1 = time.time() - t0
        for gate in ("E", "E2"):
            got = ranks[0][gate]
            gap = float(np.abs(got["theta"] - theta).max())
            fails.check(gap <= MESH_SERVE_ATOL and got["theta_sha"] == ranks[1][gate]["theta_sha"]
                        and all(all(v > 0 for v in r[gate]["launches"].values()) for r in ranks),
                        f"13b gate {gate} over {backend}: 2,048 documents served, max |theta gap| "
                        f"{gap:.3e} (tol {MESH_SERVE_ATOL:.0e}), both ranks' theta equal; "
                        f"{1e3 * got['wall']:.1f} ms (one device {1e3 * wall1:.1f} ms); B1-B3 "
                        f"launches by rank {[r[gate]['launches'] for r in ranks]} [{card}]")
        h = ranks[0]["H"]
        fails.check(h["full"] == h["resumed"] and h["beta_equal"] and h["theta_equal"]
                    and len(h["full"]) == 4 and not any(r["H"]["flag"] for r in ranks)
                    and all(all(v > 0 for v in r["H"]["launches"].values()) for r in ranks),
                    f"13b gate H over {backend}: 4 EM iterations on the 1-D mesh checkpointed at "
                    f"2 and resumed equal the uninterrupted fit bit for bit, the deterministic "
                    f"flag off on both ranks (bounds {[float(b) for b in h['resumed']]} vs "
                    f"{h['full']}; beta {h['beta_equal']}, theta {h['theta_equal']}); three "
                    f"fits {h['wall']:.1f} s; B1-B3 and scatter launches by rank "
                    f"{[r['H']['launches'] for r in ranks]} [{card}]")
    print(f"phase 13b took {time.time() - t_phase:.1f} s (the world {wall:.1f} s) [{card}]")


# ---------------------------------------------------------------------------
# phase 14: the card's E-step against the float64 oracle at full width
# ---------------------------------------------------------------------------

ORACLE_N = 256  # phase 4's first documents: one chunk of the bench batch
# The card's float32 E-step (run_estep, single pass, B1-B3) against
# reference_numpy.e_step (float64, scipy BFGS a document) on the same
# documents from the same warm state.  Each tolerance is about ten times
# the largest of three runs on an H100 (NVIDIA H100 80GB HBM3, 700 W;
# K=100, V=10,000; measured while the phi scatter still added with
# atomics, so the warm state moved run to run):
#   the summed bound (256 per-document bounds of ~-2,500 nats, each with
#   the log-determinant of a float32 Cholesky factor) 5.5e-8, 1.7e-8 and
#   1.8e-7 relative -> 2e-6, 250 times under the 5e-4 that full-width fits
#   of the two packages need after several iterations;
#   beta_ss 6.5e-7, 1.0e-6 and 2.0e-6, sigma_ss 6.5e-6, 6.1e-6 and 6.4e-6,
#   relative Frobenius norm -> 2e-5 and 1e-4 (sigma_ss sums the inverses
#   of float32 Hessians);
#   eta and theta per document (max over coordinates) where both solves
#   converged, i.e. the float64 gradient at each one's eta has max |g| <=
#   ORACLE_G: eta 3.1e-5, 5.7e-5 and 1.2e-5, theta 6.1e-7, 9.4e-7 and
#   1.9e-7 -> 5e-4 and 1e-5.  A float32 Newton solve stops at max |g| <=
#   1e-5 or where no Armijo step passes (the float32 floor), so 10
#   grad_tol, as STALL_G, marks one that got there; a document stopped at
#   max |g| = 1.7e-4 lay 1.5e-4 from the oracle's eta.  The documents the
#   port leaves above ORACLE_G (2, 4 and 4 of 256) are counted and
#   printed, and at most ORACLE_STALL_FRAC of them may be, the slack a
#   serve has (TEXT_STALL_FRAC).
ORACLE_BOUND_RTOL = 2e-6
ORACLE_SS_RTOL = {"beta_ss": 2e-5, "sigma_ss": 1e-4}
ORACLE_ETA_ATOL = 5e-4
ORACLE_THETA_ATOL = 1e-5
ORACLE_G = STALL_G
ORACLE_STALL_FRAC = TEXT_STALL_FRAC


def oracle_inputs(model, docs, n=ORACLE_N):
    """A fitted model's warm state for its first ``n`` documents, float64
    on the host: beta, sigma, and each document's mu and eta (the warm
    start), mapped out of the bucketed storage through the plan."""
    state = model._whole()
    rows = model._plan.storage_index[:n]

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    return {"docs": docs[:n], "beta": host(state.beta), "sigma": host(state.sigma),
            "mu": host(state.mu)[rows], "eta": host(state.eta)[rows]}


def oracle_estep(ref, st):
    """reference_numpy.e_step on ``st`` -> (its outputs, seconds)."""
    t0 = time.perf_counter()
    beta_ss, sigma_ss, bound, eta, theta = ref.e_step(st["docs"], st["beta"], st["mu"],
                                                      st["eta"], st["sigma"])
    sec = time.perf_counter() - t0
    return {"beta_ss": beta_ss, "sigma_ss": sigma_ss, "bound": float(bound), "eta": eta,
            "theta": theta}, sec


def port_estep(torch, st, device):
    """The port's E-step on ``st``'s documents and state: a function that
    runs ``run_estep`` (one chunk, single pass, float32 beta, the default
    NewtonConfig) and returns its EStepResult."""
    from strutopy_tpu_torch.corpus.bow import pad_corpus
    from strutopy_tpu_torch.ops import precompute_sigma, run_estep
    from strutopy_tpu_torch.ops.estep import NewtonConfig

    corpus = pad_corpus(st["docs"], V=st["beta"].shape[-1])

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    siginv, sigmaentropy = precompute_sigma(dev(st["sigma"]))
    args = (dev(st["beta"]), dev(st["mu"]), dev(st["eta"]), siginv, sigmaentropy,
            dev(corpus.words, torch.int32), dev(corpus.counts),
            torch.zeros(corpus.N, dtype=torch.int32, device=device),
            dev(corpus.doc_ok, torch.bool))
    return lambda: run_estep(*args, NewtonConfig(), corpus.N)


def port_outputs(res) -> dict:
    return {"beta_ss": res.beta_ss.double().cpu().numpy(),
            "sigma_ss": res.sigma_ss.double().cpu().numpy(),
            "bound": float(res.bound), "eta": res.eta.double().cpu().numpy(),
            "theta": res.theta.double().cpu().numpy()}


def doc_gmax(ref, st, eta):
    """max |gradient| of each document's objective at ``eta``, in float64
    (the oracle's doc_grad, with its siginv)."""
    Linv = np.linalg.inv(np.linalg.cholesky(st["sigma"]))
    siginv = Linv.T @ Linv
    out = np.empty(len(st["docs"]))
    for i, doc in enumerate(st["docs"]):
        ids = np.asarray([w for w, _ in doc], np.int64)
        c = np.asarray([ct for _, ct in doc], np.float64)
        g = ref.doc_grad(eta[i], c, st["beta"][:, ids], st["mu"][i], siginv)
        out[i] = np.abs(g).max()
    return out


def oracle_gaps(ref, st, port, oracle) -> dict:
    """The port's E-step outputs against the oracle's on the same state."""
    g_port, g_oracle = doc_gmax(ref, st, port["eta"]), doc_gmax(ref, st, oracle["eta"])
    both = (g_port <= ORACLE_G) & (g_oracle <= ORACLE_G)

    def rel_fro(name):
        return float(np.linalg.norm(port[name] - oracle[name]) / np.linalg.norm(oracle[name]))

    def per_doc(name):
        d = np.abs(port[name] - oracle[name]).max(axis=1)[both]
        return float(d.max()) if d.size else 0.0

    return {"bound": abs(port["bound"] - oracle["bound"]) / abs(oracle["bound"]),
            "beta_ss": rel_fro("beta_ss"), "sigma_ss": rel_fro("sigma_ss"),
            "eta": per_doc("eta"), "theta": per_doc("theta"),
            "port_unconverged": int(np.sum(g_port > ORACLE_G)),
            "oracle_unconverged": int(np.sum(g_oracle > ORACLE_G)),
            "compared": int(both.sum()), "n": len(st["docs"])}


def judge_oracle(fails, gaps, label):
    n = gaps["n"]
    fails.check(gaps["bound"] <= ORACLE_BOUND_RTOL,
                f"{label}: summed bound within {ORACLE_BOUND_RTOL} relative of the oracle's "
                f"({gaps['bound']:.3e})")
    for name, tol in ORACLE_SS_RTOL.items():
        fails.check(gaps[name] <= tol, f"{label}: {name} within {tol} relative (Frobenius) "
                    f"of the oracle's ({gaps[name]:.3e})")
    fails.check(gaps["port_unconverged"] <= math.ceil(ORACLE_STALL_FRAC * n),
                f"{label}: {gaps['port_unconverged']} of {n} documents left above max|g| "
                f"{ORACLE_G:g} by the port (oracle: {gaps['oracle_unconverged']}); at most "
                f"{math.ceil(ORACLE_STALL_FRAC * n)}")
    fails.check(gaps["eta"] <= ORACLE_ETA_ATOL and gaps["theta"] <= ORACLE_THETA_ATOL,
                f"{label}: on the {gaps['compared']} documents both converged, eta within "
                f"{ORACLE_ETA_ATOL} ({gaps['eta']:.3e}) and theta within {ORACLE_THETA_ATOL} "
                f"({gaps['theta']:.3e}) of the oracle's")


def phase_oracle(torch, stages, fails, st, card):
    """Phase 14: the card's E-step against the float64 oracle on phase 4's
    warm state, and both one's docs/s (printed, not compared)."""
    from strutopy_tpu_torch.utils import reference_numpy as ref

    n = len(st["docs"])
    K, V = st["beta"].shape
    print(f"phase 14: run_estep on the card against reference_numpy.e_step (float64), "
          f"{n} documents of phase 4's warm state, K={K} V={V}; {card}")
    oracle, sec_oracle = oracle_estep(ref, st)
    print(f"  oracle (serial scipy BFGS, float64): {sec_oracle:.3f} s, "
          f"{n / sec_oracle:.2f} docs/s on the host's {cpu_name()} [{card}]")
    call = port_estep(torch, st, "cuda")
    reset(stages)
    res = call()
    torch.cuda.synchronize()
    launches = {k: stages.LAUNCHES[k] for k in FIT_KERNELS}
    fails.check(all(v > 0 for v in launches.values()),
                f"phase 14: run_estep launched B1-B3 {launches}")
    port = port_outputs(res)
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    sec_port = float(np.median(secs))
    print(f"  port (run_estep, float32, B1-B3): {sec_port * 1e3:.3f} ms (median of 3), "
          f"{n / sec_port:.1f} docs/s on the card [{card}]")
    gaps = oracle_gaps(ref, st, port, oracle)
    print(f"  gaps to the oracle: {gaps}")
    judge_oracle(fails, gaps, "phase 14")


# ---------------------------------------------------------------------------
# phase 15: the bench entry point on the card
# ---------------------------------------------------------------------------

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}  # bench.py's result line
BENCH_BASELINE = re.compile(r"^baseline: (\S+) docs/s on (.+) \((from the cache|measured), ",
                            re.M)
BENCH_LAUNCHES = re.compile(r"^launches during the timed calls: (\{.*\})$", re.M)
BENCH_TIMEOUT = 600  # s; the run takes about a minute, the oracle's 4 e_steps most of it


def bench_figures(err: str) -> dict:
    """The figures phase 15 reads from bench_torch.py's standard error:
    the baseline's docs/s, its CPU, whether it came from the cache, and
    B1-B3's launches during the timed calls (None where a line is missing)."""
    base, launches = BENCH_BASELINE.search(err), BENCH_LAUNCHES.search(err)
    return {"baseline": float(base.group(1)) if base else None,
            "cpu": base.group(2) if base else None,
            "cached": base.group(3) == "from the cache" if base else None,
            "launches": json.loads(launches.group(1)) if launches else None}


def check_bench(fails, rc, out, err, cache, cpu):
    """Phase 15's checks on one run of the bench entry point: its return
    code; its standard output exactly one line, JSON with bench.py's four
    keys and no others, a finite positive value and ratio; the ratio the
    value over the baseline on its standard error to within the rounding
    of both; B1-B3 and the glue kernels launched in the timed calls;
    ``cache`` (the baseline cache's JSON after the run, or None) holding
    the configuration, the host CPU's name ``cpu`` and that baseline.  Returns the headline."""
    fails.check(rc == 0, f"phase 15: bench exits with 0 (rc {rc})")
    lines = out.splitlines()
    fails.check(len(lines) == 1, f"phase 15: standard output is one line ({len(lines)})")
    try:
        head = json.loads(lines[0]) if lines else {}
    except json.JSONDecodeError:
        head = {}
    head = head if isinstance(head, dict) else {}
    fails.check(set(head) == BENCH_KEYS,
                f"phase 15: the line is JSON with the keys {sorted(BENCH_KEYS)}: {lines[:1]}")
    fails.check(head.get("metric") == bench_torch.METRIC and head.get("unit") == "docs/s",
                f"phase 15: metric {head.get('metric')!r}, unit {head.get('unit')!r}")
    value, ratio = head.get("value"), head.get("vs_baseline")
    finite = all(isinstance(x, (int, float)) and math.isfinite(x) and x > 0
                 for x in (value, ratio))
    fails.check(finite, f"phase 15: value {value} and vs_baseline {ratio} finite and > 0")
    fig = bench_figures(err)
    base = fig["baseline"]
    # value is rounded to 0.1 docs/s and vs_baseline to 0.01
    fails.check(finite and base is not None and base > 0
                and abs(ratio - value / base) <= 0.005 + 0.05 / base + 1e-9,
                f"phase 15: vs_baseline {ratio} is value / baseline ({value} / {base}) to "
                f"within the rounding")
    launches = fig["launches"] or {}
    fails.check(all(launches.get(k, 0) > 0 for k in bench_torch.NEWTON_KERNELS),
                f"phase 15: B1-B3 and the glue kernels launched in the timed calls {launches}")
    cache = cache or {}
    want = [bench_torch.K, bench_torch.V, bench_torch.N_WORDS]
    fails.check(cache.get("config") == want and cache.get("cpu") == cpu
                and cache.get("docs_per_sec") == base,
                f"phase 15: the baseline cache holds config {cache.get('config')} (want {want}), "
                f"CPU {cache.get('cpu')!r} (want {cpu!r}) and {cache.get('docs_per_sec')} docs/s")
    return head


def phase_bench(fails, card):
    """Phase 15: ``python -m strutopy_tpu_torch.cli bench`` in a subprocess
    whose working directory is a temporary directory outside the
    checkout (the CLI finds bench_torch.py from the package), on the
    kernels phase 1 built."""
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    print(f"phase 15: python -m strutopy_tpu_torch.cli bench, from a temporary directory; {card}")
    t0 = time.time()
    with tempfile.TemporaryDirectory() as work:
        try:
            proc = subprocess.run([sys.executable, "-m", "strutopy_tpu_torch.cli", "bench"],
                                  cwd=work, env=env, capture_output=True, text=True,
                                  timeout=BENCH_TIMEOUT)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, out, err = "timeout", e.stdout or "", e.stderr or ""
            out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
    sec = time.time() - t0
    for line in err.strip().splitlines()[-20:]:
        print(f"  bench: {line} [{card}]")
    cache = None
    if os.path.exists(bench_torch.BASELINE_PATH):
        with open(bench_torch.BASELINE_PATH) as f:
            cache = json.load(f)
    head = check_bench(fails, rc, out, err, cache, cpu_name())
    print(f"  headline: {json.dumps(head)} [{card}]; the run took {sec:.1f} s")


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

    global CARD
    native_before = native_listing(os.path.dirname(os.path.abspath(__file__)))
    watch_collector()
    fails = Failures()
    card = CARD = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"phase 1: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} device(s), using 1")
    t0 = time.time()
    lib_path = build.build()
    build.load()
    print(f"  built {lib_path.name} in {time.time() - t0:.1f} s (nvcc, one process a source, "
          f"in parallel); ptxas:")
    print("\n".join("    " + ln for ln in build.ptxas_report().strip().splitlines()))
    check_smem_plans(fails, build.load(), stages)

    t0 = time.time()
    docs, X, beta_true = make_corpus(K_BENCH, V_BENCH, N_BENCH, WORDS_BENCH, return_beta=True)
    corpus = pad_corpus(docs, V=V_BENCH)
    plan = make_bucket_plan(corpus, 256)
    buckets = split_corpus_by_plan(corpus, plan)
    big = max(range(plan.n_buckets), key=lambda b: len(plan.doc_ids[b]))
    print(f"bench corpus in {time.time() - t0:.1f} s: buckets L={plan.Ls} "
          f"docs={[len(i) for i in plan.doc_ids]} batch={plan.batch_sizes}")

    words, counts = buckets[big].words[:256], buckets[big].counts[:256]
    kernels, inputs, aux = phase_kernels(torch, stages, fails, words, counts, K_BENCH)
    phase_determinism(torch, stages, fails, inputs, aux)
    kernels.update(phase_scatter(torch, stages, fails, inputs, words, counts))
    kernels.update(phase_fused(torch, stages, fails, words, counts, beta_true))
    kernels.update(phase_glue(torch, stages, fails, words, counts, beta_true))
    phase_widths(torch, stages, fails)
    phase_fused_widths(torch, stages, fails)
    phase_small_fit(torch, fails)

    # ----- phase 4: the fit at full width -----
    cfg = STMConfig(K=K_BENCH, init_type="random", batch_size=256, newton_pass1_iters=6,
                    newton_straggler_frac=0.25, max_em_iter=5, convergence_threshold=0.0)
    t0 = time.time()
    model = STM(docs, K=K_BENCH, X=X, config=cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"phase 4: K={K_BENCH} V={V_BENCH} N={N_BENCH}, STM built in "
          f"{time.time() - t0:.1f} s; {card}")
    reset(stages)
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
    for k in FIT_KERNELS:
        fails.check(launches[k] > 0, f"main path launched {k} {launches[k]} times")
    fails.check(all(launches[k] == launches["fgh"] for k in GLUE),
                f"main path launched each glue kernel once a B1 launch: "
                f"{ {k: launches[k] for k in ('fgh',) + GLUE} }")
    fails.check(launches["finalize"] > 0
                and all(launches[k] == launches["finalize"] for k in FINALIZE_KEYS),
                f"main path finalized through Z, F and the epilogue, once each a chunk: "
                f"{ {k: launches[k] for k in FINALIZE_KEYS} }")
    theta, beta = model.theta, model.beta
    bench_bounds = np.asarray(model.last_bounds)
    fails.check(theta.shape == (N_BENCH, K_BENCH) and beta.shape == (K_BENCH, V_BENCH)
                and bool(np.isfinite(theta).all() and np.isfinite(beta).all())
                and np.allclose(theta.sum(1), 1, atol=1e-4)
                and np.allclose(beta.sum(1), 1, atol=1e-4),
                "theta (N, K) and beta (K, V) finite, rows on the simplex")
    oracle_state = oracle_inputs(model, docs)
    kernels.update(phase_factor(torch, stages, fails, oracle_state))
    kernels.update(phase_finalize(torch, stages, fails, oracle_state))
    phase_fused_fit(torch, fails, stages, docs, X, cfg, card)
    phase_twins(torch, fails, docs, X, cfg, card)

    # ----- phase 5: serving -----
    launches.update(phase_serve(torch, stages, fails, model, card))
    phase_wiki(torch, stages, fails)

    # ----- phases 6-8: the default fit, the content model, evaluation -----
    default_launches, default_model = phase_spectral(torch, stages, fails, corpus, X, card)
    content_launches, content_bounds = phase_content(torch, stages, fails, corpus, X, card)
    paths = {"bench fit (phase 4)": {k: launches[k] for k in FIT_KERNELS},
             "default spectral fit (phase 6)": default_launches,
             "content fit (phase 7)": content_launches,
             "heldout fit (phase 8)": phase_heldout(torch, stages, fails, docs, corpus,
                                                    X, card)}

    # ----- phases 9-10: out-of-core fits, post-fit analysis -----
    del model
    paths["streamed default fit (phase 9a)"] = phase_streaming(
        torch, stages, fails, corpus, X, card, default_model, default_launches, content_bounds)
    paths["simulate_theta (phase 10)"] = phase_analysis(
        torch, stages, fails, default_model, corpus, X, card)
    del default_model

    # ----- phase 11: raw text to theta, the corpus readers, the pipeline and the CLI -----
    text_paths = phase_text_cli(torch, stages, fails, docs, corpus, X, card, native_before)
    paths.update(text_paths)
    for path in ("CLI fit (phase 11)", "select (phase 11)", "infer_text (phase 11)"):
        fails.check(all(text_paths[path][k] > 0 for k in FIT_KERNELS),
                    f"{path}: B1-B3 and the scatter launched {text_paths[path]}")
    print(f"launches of B1-B3 and the scatter by path: {paths}")

    # ----- phase 12: the E-step options -----
    beta_kernels, beta_launches = phase_options(torch, stages, fails, docs, X, cfg, card, words,
                                                counts, beta_true, bench_bounds)
    kernels.update(beta_kernels)
    launches.update(beta_launches)

    # ----- phase 13: multi-device fits -----
    phase_mesh_one(torch, stages, fails, corpus, X, card)
    torch.cuda.empty_cache()
    phase_mesh_two(torch, stages, fails, card)

    # ----- phase 14: the E-step against the float64 oracle -----
    phase_oracle(torch, stages, fails, oracle_state, card)

    # ----- phase 15: the bench entry point -----
    phase_bench(fails, card)

    print(f"total {time.time() - t_start:.1f} s")
    if fails:
        print(f"chip_smoke: {len(fails)} check(s) failed: {fails}", file=sys.stderr)
        return 1
    print(card_line())
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": kernels[k]["max_abs_err"],
         "ms": kernels[k]["ms"], "plain_ms": kernels[k]["plain_ms"],
         "bound_ms": kernels[k]["bound_ms"], "bound_by": kernels[k]["bound_by"],
         "library_ms": kernels[k]["library_ms"]}
        for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":
        mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                       int(sys.argv[6]))
        sys.exit(0)
    sys.exit(main())
