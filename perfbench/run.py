#!/usr/bin/env python3
"""Run one cell of the benchmark of ``strutopy_tpu_torch`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  Set-up makes the cell's inputs from ``--seed`` and warms up
every shape its traffic uses; the window measures for ``--seconds``; the
plain reference then decides ``correct``.  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, which are also the last
lines of standard error.

``--device cpu`` is the rehearsal: the same control flow at the
configuration's toy sizes on the program's plain PyTorch kernels, with
no device metric (its result has ``metrics`` empty and the host's
numbers under ``rehearsal``).  Without ``--device cpu`` a run with no
CUDA card, or fewer than the cell asks for, exits 2 and prints no result.
"""

from __future__ import annotations

import os
import time

T_TOP = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started, from /proc (0 where absent)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_TOP = process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# the caches of what the program builds or compiles, at fixed paths inside
# the checkout (the program keeps its nvcc build in build/kernels/ itself)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "strutopy_tpu")


class Clock:
    """perf_counter, with the process's start on the same scale."""

    def __init__(self):
        self.start = T_TOP - AGE_AT_TOP

    @staticmethod
    def now() -> float:
        return time.perf_counter()


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="perfbench/run.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the rehearsal at toy sizes (never the benchmark)")
    args = ap.parse_args(argv)
    args.toy = args.device == "cpu"
    return args


def device_info(torch, chips: int, peak: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak}


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import compare, spec, trace

    cell = spec.load_cell(args.workload)
    import torch

    if not args.toy:
        if not torch.cuda.is_available():
            say("perfbench: no CUDA device (torch.cuda.is_available() is False); no result")
            return 2
        if torch.cuda.device_count() < cell.chips:
            say(f"perfbench: {cell.name} needs {cell.chips} CUDA devices, "
                f"{torch.cuda.device_count()} present; no result")
            return 2
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    clock = Clock()
    say(f"cell {cell.name}: seed {args.seed}, {args.seconds} s, trace {args.trace}, "
        f"device {torch.cuda.get_device_name(0) if not args.toy else 'cpu (rehearsal)'}; "
        f"torch {torch.__version__}")
    res = cell.driver().run(cell, args, clock, say)

    correct, checks = compare.judge(res["numbers"], cell.limits)
    correct = correct and res["failed"] == 0
    metrics = {}
    for m in cell.end_to_end:
        v = res["setup_s"] if m["name"] == "setup_s" else res["e2e"].get(m["name"])
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"]}
    ctx = res.get("ctx")
    tr = ctx.get("trace") if ctx else None
    if args.trace:
        layer = {}
        for name, read in cell.readers().items():
            v = read(ctx)
            if v is not None:
                unit = next(m["unit"] for m in cell.per_layer if m["name"] == name)
                layer[name] = {"value": v, "unit": unit}
        metrics = layer
    if args.toy:
        out.update(metrics={}, rehearsal={k: v["value"] for k, v in metrics.items()},
                   device={"platform": "cpu", "kind": "cpu (rehearsal)", "count": 0,
                           "memory_peak_bytes": 0})
    else:
        out.update(metrics=metrics,
                   device=device_info(torch, cell.chips, res["memory_peak_bytes"]))
        if args.trace and tr is not None:
            out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
            out["breakdown"] = trace.breakdown(tr)
    out["checks"] = checks

    bad = loaded_forbidden()
    if bad:
        say(f"perfbench: the run loaded {bad}; no result")
        return 3
    for k, v in res["numbers"].items():
        if k not in checks:
            say(f"reading {k}: {v!r} (not compared)")
    for line in compare.check_lines(checks):
        say(line)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
