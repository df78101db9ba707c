"""The traced run's readings: a ``torch.profiler`` window, its device
events grouped by kernel, the device's busy time (the union of kernel
and copy intervals, ``profile_torch.py``'s arithmetic, copied), the idle
gaps with what the host was doing in them, and the shapes of the Newton
stage kernels' calls recorded from the benchmark's side."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

# kernel-name fragments (lower case) -> group, first match wins (a copy of
# profile_torch.py's GROUPS)
GROUPS = (
    ("fgh kernel (B1)", ("fgh_kernel",)),
    ("ls kernel (B3)", ("ls_kernel",)),
    ("cg kernel (B2)", ("cg_kernel",)),
    ("newton kernel (B4 and B5)", ("newton_kernel",)),
    ("Cholesky / cholesky_inverse", ("potrf", "trsm", "magma", "cholesky", "zdisplace",
                                     "syrk", "trmm", "lauum", "cusolver")),
    ("gemm / bmm (cuBLAS)", ("gemm", "xmma", "cutlass", "cublas")),
    ("ordered phi scatter", ("scatter_phi_kernel",)),
    ("sorts, searchsorted", ("sort", "searchsorted")),
    ("gather / scatter / index", ("index", "gather", "scatter")),
    ("reductions", ("reduce_kernel",)),
)
OTHER = "other elementwise (Newton glue, finalize math)"
COPIES = "memcpy / memset"
NEWTON_GROUPS = ("fgh kernel (B1)", "ls kernel (B3)", "cg kernel (B2)")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def group_of(event: dict) -> str:
    if event["cat"] != "kernel":
        return COPIES
    name = event["name"].lower()
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return OTHER


def union(intervals):
    """(length of the union of [start, stop] intervals, the merged list)."""
    merged = []
    for start, stop in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return sum(b - a for a, b in merged), merged


class Trace:
    """Device and host events of one profiled window (times in s)."""

    def __init__(self, events: list, wall_s: float):
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e]
        self.wall_s = wall_s
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in self.device + self.host]
        self.t0 = min((a for a, _ in spans), default=0.0)
        self.t1 = max((b for _, b in spans), default=0.0)
        busy, self.merged = union((e["ts"], e["ts"] + e["dur"]) for e in self.device)
        self.busy_s = busy / 1e6

    @property
    def window_s(self) -> float:
        """The traced window: from its first event to its last, host or
        device."""
        return (self.t1 - self.t0) / 1e6

    def by_group(self) -> dict:
        """group -> (seconds, launches)."""
        out: dict = {}
        for e in self.device:
            s, n = out.get(group_of(e), (0.0, 0))
            out[group_of(e)] = (s + e["dur"] / 1e6, n + 1)
        return out

    def gaps(self):
        """The device's idle intervals inside the window, (start, stop) us."""
        out, t = [], self.t0
        for a, b in self.merged:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def idle_by_host(self) -> dict:
        """Idle seconds by what the host was doing: the host event (torch
        op or CUDA runtime call) that covers most of each gap, "python
        between ops" where none does."""
        host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in self.host)
        out: dict = {}
        j = 0
        for a, b in self.gaps():
            while j < len(host) and host[j][1] < a:
                j += 1
            best, name = 0.0, "python between ops"
            k = j
            while k < len(host) and host[k][0] < b:
                ov = min(b, host[k][1]) - max(a, host[k][0])
                if ov > best:
                    best, name = ov, host[k][2]
                k += 1
            out[name] = out.get(name, 0.0) + (b - a) / 1e6
        return out


def profile(fn, sync) -> Trace:
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activities),
    ended by ``sync()``; the chrome trace goes through a temporary file
    under ``TMPDIR`` that is removed once read."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="perfbench_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events, wall)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The contract's ``breakdown``: the device groups that took most
    time and the longest idle time by what the host was doing."""
    ops = sorted(((g, s) for g, (s, _n) in tr.by_group().items()), key=lambda x: -x[1])
    idle = sorted(tr.idle_by_host().items(), key=lambda x: -x[1])
    return {"device_ops": [[g, s] for g, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in idle[:top]]}


@contextlib.contextmanager
def recorded_calls(module, names, log: list):
    """Wrap ``module.<name>`` for each name so that every call appends
    (name, its tensor arguments' shapes and dtypes, its other arguments)
    to ``log``; the functions are put back on exit."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(n, fn):
        def recording(*args, **kwargs):
            log.append((n, [(tuple(a.shape), str(a.dtype)) if hasattr(a, "shape") else a
                            for a in args], kwargs))
            return fn(*args, **kwargs)
        return recording

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield log
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)
