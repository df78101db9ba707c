"""The frozen count functions, and the roofline share's ceiling."""

import importlib.util

import pytest

from perfbench import roofline, spec, trace


def _reader(name):
    s = importlib.util.spec_from_file_location(name, spec.HERE / "metrics" / f"{name}.py")
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m.read


def test_bounds_at_the_bench_chunk():
    B, K, L, T, it = 256, 100, 384, 12, 6
    us = {"fgh": roofline.least_s(*roofline.fgh(B, K, L))[0],
          "cg": roofline.least_s(*roofline.cg(B, K - 1, it))[0],
          "ls": roofline.least_s(*roofline.ls(B, K, L, T))[0]}
    assert round(us["fgh"] * 1e6, 2) == 14.95
    assert round(us["cg"] * 1e6, 2) == 3.06
    assert round(us["ls"] * 1e6, 2) == 11.96
    for k in ("fgh", "cg", "ls"):
        n_bytes, ops = {"fgh": roofline.fgh(B, K, L), "cg": roofline.cg(B, K - 1, it),
                        "ls": roofline.ls(B, K, L, T)}[k]
        assert roofline.least_s(n_bytes, ops)[1] == "bytes"


def _calls(n, B=256, K=100, L=384, T=12):
    one = [("fgh", [((B, K - 1), "f32"), ((B, K, L), "torch.float32")], {"bf16": True}),
           ("cg", [((B, K - 1, K - 1), "f32"), ((B, K - 1), "f32"), 6], {"bf16": True}),
           ("linesearch", [((B, K - 1), ""), ((B, K - 1), ""), ((T,), ""), ((B, K, L), "torch.float32")], {})]
    return one * n


def _trace(durations_us):
    events, t = [], 0.0
    for name, dur in durations_us:
        events.append({"cat": "kernel", "name": name, "ts": t, "dur": dur})
        t += dur + 5.0
    events.append({"cat": "cpu_op", "name": "aten::item", "ts": 0.0, "dur": t})
    return trace.Trace(events, t / 1e6)


def test_roofline_share_cannot_pass_100():
    read = _reader("newton_roofline.fit")
    calls = _calls(3)
    least = {n: roofline.least_s(*roofline.call_cost(n, a, k))[0] * 1e6 for n, a, k in calls[:3]}
    kern = {"fgh": "fgh_kernel<float>", "cg": "cg_kernel", "linesearch": "ls_kernel<float>"}
    exact = _trace([(kern[n], least[n]) for n, _a, _k in calls])
    assert read({"kind": "fit", "trace": exact, "calls": calls}) == pytest.approx(100.0)
    # any kernel at or above its least time keeps the share at or below 100%
    for scale in (1.0, 1.3, 4.0):
        slow = _trace([(kern[n], least[n] * scale) for n, _a, _k in calls])
        assert read({"kind": "fit", "trace": slow, "calls": calls}) <= 100.0 + 1e-9
    assert read({"kind": "fit", "trace": None, "calls": calls}) is None


def test_idle_share_and_breakdown():
    tr = _trace([("fgh_kernel", 10.0), ("potrf_kernel", 30.0), ("elementwise", 20.0)])
    idle = _reader("device_idle_share.fit")({"kind": "fit", "trace": tr})
    assert idle == pytest.approx(100 * (1 - 60.0 / 75.0))
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0] == "Cholesky / cholesky_inverse"
    assert b["idle_gaps"][0][0] == "aten::item"
    mfu = _reader("em_iter_mfu")({"kind": "fit", "trace": tr, "calls": _calls(1),
                                  "iter_walls": [1.0]})
    assert 0 < mfu < 100
