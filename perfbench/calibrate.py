#!/usr/bin/env python3
"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        --seconds 51 --faults 3 --out build/perfbench/calib_<cell>.jsonl

For each seed, in one process: the cell's set-up and window as
``drivers/fit.py`` makes them for ``run.py``, then the numbers
``correct`` compares for the program, and for the first ``--faults``
seeds also for the control (the reference in TF32 put in the program's
place) and for each fault the cell can have (the state returned
unchanged; half of the batch left out and the mean taken over the rest;
one answer altered where it is produced).  One JSON line a seed goes to
``--out``; a summary (the largest program reading and the smallest
control and fault readings of each number) to standard output.  Not run
by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import compare, spec  # noqa: E402
from perfbench.reference import stm_ref  # noqa: E402

TF32 = stm_ref.Prec("tf32")
FAULTS = ("fault.unchanged", "fault.half", "fault.altered", "control")


def fit_seed(cell, seed, seconds, faults, device, toy):
    import torch

    from perfbench import run
    from perfbench.drivers import fit as F

    fit = F.setup(cell, seed, device, toy)
    _window, walls, prev, state = fit.window(seconds, run.Clock())
    overflow = fit.model.straggler_overflow
    started, judged = fit.started, fit.judged(prev, state)
    fit.free()
    del prev, state
    if device != "cpu":
        torch.cuda.empty_cache()
    rec = {"seed": seed, "iters": len(walls), "overflow": overflow,
           "program": {"init." + k: v for k, v in compare.start_numbers(fit.start, started).items()}}
    for prefix, inp, out in judged:
        outs = [out]
        if faults:
            altered = dict(out, eta=out["eta"].copy())
            altered["eta"][0, 0] += 1.0
            outs += [inp, half_batch(fit, inp, device), altered]
        nums = F.reference_numbers(fit, inp, outs, device, prec=TF32 if faults else None)
        names = ["program"] + (list(FAULTS) if faults else [])
        for name, nm in zip(names, nums):
            rec.setdefault(name, {}).update({prefix + k: v for k, v in nm.items()})
    return rec


def half_batch(fit, inp, device):
    """The reference in the program's place with half of the documents
    left out and the sums taken as twice the mean over the rest; the
    left-out documents keep their input eta."""
    import torch

    h = len(fit.docs) // 2
    e = stm_ref.e_step(fit.docs.take(range(h)), inp["beta"], inp["mu"][:h], inp["eta"][:h],
                       inp["sigma"], stm_ref.Prec("float64"), device=device)
    eta = np.asarray(inp["eta"], np.float64).copy()
    eta[:h] = e["eta"].cpu().numpy()
    est = {"eta": torch.as_tensor(eta, device=device),
           "sigma_ss": 2 * e["sigma_ss"], "beta_ss": 2 * e["beta_ss"]}
    m = fit.ref_mstep(est)
    return {"eta": eta, "beta": m["beta"], "sigma": m["sigma"], "gamma": m["gamma"],
            "bound": 2 * float(e["bound"].sum())}


def summary(recs: list) -> dict:
    out = {}
    for key in recs[0]["program"]:
        row = {"program_max": max(r["program"][key] for r in recs)}
        for name in FAULTS:
            vals = [r[name][key] for r in recs if key in r.get(name, {})]
            if vals:
                row[name + "_min"] = min(vals)
        out[key] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    recs = []
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for i, seed in enumerate(args.seeds):
            t0 = time.perf_counter()
            rec = fit_seed(cell, seed, args.seconds, i < args.faults, args.device,
                           args.device == "cpu")
            rec["seconds"] = time.perf_counter() - t0
            recs.append(rec)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(json.dumps(rec), file=sys.stderr, flush=True)
    print(json.dumps(summary(recs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
