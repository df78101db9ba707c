#!/usr/bin/env python3
"""Readings that the limits of a content cell (``drivers/fit_content.py``)
are set from.

    python3 perfbench/calibrate_content.py --workload poliblog_content_fit \
        --seeds 11 12 ... --judge 5 8 14 24 38 54 74 --faults 3 \
        --out build/perfbench/calib_poliblog_content_fit.jsonl

For each seed, in one process: the cell's set-up as the driver makes it,
then the fit's iterations from the kept state to its last once (the
window's first cycle), and for each iteration named in ``--judge`` the
numbers ``correct`` compares, for the program and, on the first
``--faults`` seeds, for the control (the reference in TF32 in the
program's place) and for each fault: the state returned unchanged; half
of the documents left out and the sums taken as twice the rest; one eta
altered by 1; kappa left at its input (and beta with it).  One JSON line
a judged iteration goes to ``--out``; each number's limit, from the
largest program reading and the least control and fault readings
(:func:`limits`), to standard output.  ``--summarize`` prints the limits
of lines written before, from any number of files:

    python3 perfbench/calibrate_content.py --summarize calib_a.jsonl calib_b.jsonl

Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import spec  # noqa: E402
from perfbench.reference import content_ref, stm_ref  # noqa: E402

TF32 = stm_ref.Prec("tf32")
F64 = stm_ref.Prec("float64")
FAULTS = ("fault.unchanged", "fault.half", "fault.altered", "fault.kappa", "control")


def half_batch(fit, inp, device):
    """The reference in the program's place with the first half of the
    documents alone and its sums doubled; the rest keep their input eta."""
    import torch

    from perfbench.drivers import fit_content as C

    h = len(fit.docs) // 2
    e = content_ref.e_step(fit.docs.take(range(h)), fit.aspects[:h], inp["beta"],
                           inp["mu"][:h], inp["eta"][:h], inp["sigma"], F64, device=device)
    eta = np.asarray(inp["eta"], np.float64).copy()
    eta[:h] = e["eta"].cpu().numpy()
    est = {"eta": torch.as_tensor(eta, device=device), "sigma_ss": 2 * e["sigma_ss"],
           "beta_ss": 2 * e["beta_ss"]}
    m = content_ref.m_step(est, fit.D, fit.wcounts, fit.Xd, fit.cfg.kappa_l2, F64,
                           kappa0=inp["kappa"])
    return dict(C.as_outputs(dict(est, bound=e["bound"]), m), bound=2 * float(e["bound"].sum()))


def judge_one(fit, inp, out, faults: bool, device) -> dict:
    from perfbench.drivers import fit_content as C

    outs, names = [out], ["program"]
    if faults:
        altered = dict(out, eta=out["eta"].copy())
        altered["eta"][0, 0] += 1.0
        outs += [inp, half_batch(fit, inp, device), altered,
                 dict(out, kappa=inp["kappa"], beta=inp["beta"])]
        names += list(FAULTS[:-1]) + ["control"]
    nums = C.reference_numbers(fit, inp, outs, device, prec=TF32 if faults else None)
    return {name: {"last." + k: v for k, v in n.items()} for name, n in zip(names, nums)}


def fit_seed(cell, seed, judge, faults, device, toy, log):
    from perfbench.drivers import fit_content as C

    t0 = time.perf_counter()
    fit = C.setup(cell, seed, device, toy)
    set_up_s = time.perf_counter() - t0
    recs = []
    for it in range(fit.first, fit.cfg.max_em_iter):
        prev = fit.model._state
        fit.iterate()
        if it not in judge:
            continue
        t1 = time.perf_counter()
        (_p, inp, out), = fit.judged(prev, fit.model._state)
        rec = {"seed": seed, "it": it, "set_up_s": set_up_s}
        rec.update(judge_one(fit, inp, out, faults, device))
        rec["seconds"] = time.perf_counter() - t1
        recs.append(rec)
        log(rec)
    return recs


def limits(recs: list) -> dict:
    """Each number's limit by the rule of ``calibrate.py``'s cell: lower =
    the largest program reading; upper = the control's least reading if it
    is at least 3x the lower, else the least fault reading at least 10x
    it; the limit 0.6 of the way from lower to upper in log scale, to two
    digits, or 10x the lower where there is no upper -> {number: {lower,
    lower_at (seed, it), upper, upper_of, each control and fault's least
    reading, limit}}."""
    out = {}
    for key in recs[0]["program"]:
        lower, seed, it = max((r["program"][key], r["seed"], r["it"]) for r in recs)
        row = {"lower": lower, "lower_at": [seed, it]}
        for name in FAULTS:
            vals = [r[name][key] for r in recs if name in r]
            if vals:
                row[name + "_min"] = min(vals)
        upper = None
        if row.get("control_min", 0.0) >= 3 * lower:
            upper = ("control", row["control_min"])
        else:
            far = [(v, n[:-4]) for n, v in row.items()
                   if n.startswith("fault.") and v >= 10 * lower]
            if far:
                upper = min(far)[::-1]
        if upper is None:
            row["limit"] = float(f"{10 * lower:.2g}")
        else:
            row["upper_of"], row["upper"] = upper
            row["limit"] = float(f"{lower * (upper[1] / lower) ** 0.6:.2g}")
        out[key] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds", type=int, nargs="+")
    ap.add_argument("--judge", type=int, nargs="+")
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out")
    ap.add_argument("--summarize", nargs="+", metavar="JSONL",
                    help="print the limits from these files' lines and run nothing")
    args = ap.parse_args(argv)
    if args.summarize:
        recs = [json.loads(line) for p in args.summarize for line in open(p) if line.strip()]
        print(json.dumps(limits(recs), indent=1))
        return 0
    if not (args.workload and args.seeds and args.judge and args.out):
        ap.error("--workload, --seeds, --judge and --out are needed to run")
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate_content: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    recs = []
    with open(args.out, "a") as f:
        def log(rec):
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(json.dumps(rec), file=sys.stderr, flush=True)

        for i, seed in enumerate(args.seeds):
            recs += fit_seed(cell, seed, set(args.judge), i < args.faults, args.device,
                             args.device == "cpu", log)
    print(json.dumps(limits(recs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
