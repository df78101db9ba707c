"""Spans and counters of the fit and of serving, recorded only when asked.

Recording is on

* while a ``torch.profiler`` session is active,
* inside :func:`recording`, and
* under ``STM.expectation_maximization(profile_dir=...)``, which opens both.

Off, :func:`span` is one call and a flag test that returns a shared null
context, :func:`read` calls its function and returns what it returns, and
:func:`count` returns: the program launches, syncs and computes what it
does without this module.

A span is an entry of the open :class:`Record`: its name, its parent, its
host start and end (``time.perf_counter_ns``) and its attributes; under a
profiler it is also a ``torch.profiler.record_function`` range, so it sits
on the kernels' timeline in the chrome trace.  A span given a CUDA
``device`` also records a CUDA event on that device's current stream at
its start and at its end: its device interval, read the first time it is
asked for, and the host times just before and just after each event
record (the record's ``marks``), which line the record up with the event
record calls of a profiler trace.

The outermost span opens a record: one an EM iteration
(``fit.iteration``), one a served request (``serve.request``).  A record
holds its spans and its counters:

* ``launch.<kernel>``: the record's deltas of ``ops.stages.LAUNCHES``;
* the Newton, straggler and finalize counts (``newton.*``, ``estep.*``,
  ``finalize.*``); a count that a path cannot give is None;
* ``syncs``: site -> (blocking device-to-host reads there, host seconds
  they blocked).

A record made inside :func:`recording` is ``full``.  Under a profiler
alone a record keeps only what the benchmark's readers of it need, so
that a traced run times the program rather than its tracer: the spans,
the syncs, the host's counts, the Newton loops' document steps, and the
CUDA events of the iteration, the Newton passes and the finalize.
Callers make every other device-side count, and the events of other
spans, only under :func:`full`.  Device-side counts stay on the device,
as the tensors they are counted from, until the record is resolved: then
a few kernels a counter and one copy of all of them, neither counted as
a sync.

:func:`records` gives the records of the last recording session: a
:func:`recording` context, or, under a profiler alone, one call of an entry
point (:func:`session`: ``STM.expectation_maximization``, ``infer_theta``).
A record opened outside any session is a session of its own.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

_profiling = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()

_forced = 0  # depth of recording() contexts
_sessions = 0  # depth of session() contexts
_records: list = []  # the last session's records
_open: Optional["Record"] = None  # the record being made


def on() -> bool:
    """Whether spans record now."""
    return bool(_forced) or _profiling()


def active() -> Optional["Record"]:
    """The record being made, or None (always None while recording is off)."""
    return _open


def full() -> bool:
    """Whether the record being made counts everything (it was opened
    inside :func:`recording`)."""
    return _open is not None and _open.full


class Span:
    """One span, its own context manager (:func:`span`) and, entered, an
    entry of the open record: times in host ``perf_counter`` ns; ``device``
    (seconds from the record's first event: start, end) for a span given a
    CUDA device, else None."""

    __slots__ = ("name", "parent", "attrs", "t0", "t1", "_interval", "_dev", "_ev", "_first",
                 "_rec", "_root", "_rf")

    def __init__(self, name: str, device: Optional[torch.device] = None,
                 attrs: Optional[dict] = None):
        self.name, self._dev, self.attrs = name, device, attrs or {}
        self.parent = self._interval = self._ev = self._first = None
        self.t0 = self.t1 = 0

    def __enter__(self) -> "Record":
        global _open
        self._rf = torch.profiler.record_function(self.name) if _profiling() else None
        if self._rf is not None:
            self._rf.__enter__()
        self._root = _open is None
        if self._root:
            if not _sessions:
                _records.clear()
            _open = Record(self.name, self.attrs)
            _records.append(_open)
        self._rec = rec = _open
        self.parent = rec._stack[-1] if rec._stack else None
        rec._stack.append(len(rec.spans))
        rec.spans.append(self)
        if self._dev is not None and self._dev.type == "cuda":
            self._ev = rec._mark(self._dev)
            self._first = rec._first
        self.t0 = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        global _open
        rec = self._rec
        self.t1 = time.perf_counter_ns()
        if self._ev is not None:
            self._ev = (self._ev, rec._mark(self._dev))
        rec._stack.pop()
        if self._root:
            rec._finish()
            _open = None
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._rec = self._rf = None  # no cycle from the record back to itself
        return False

    @property
    def device(self) -> Optional[tuple]:
        """The span's device interval, read from its events once they are
        done (the first read waits on its end event)."""
        if self._interval is None and isinstance(self._ev, tuple):
            start, end = self._ev
            end.synchronize()
            self._interval = (self._first.elapsed_time(start) / 1e3,
                              self._first.elapsed_time(end) / 1e3)
        return self._interval


class Record:
    """What one outermost span recorded (see the module's docstring)."""

    def __init__(self, name: str, attrs: Optional[dict]):
        from strutopy_tpu_torch.ops import stages

        self.name, self.attrs = name, dict(attrs or {})
        self.profiled = _profiling()  # made under a torch.profiler session
        self.full = bool(_forced)  # made inside recording()
        self.spans: list = []
        self.counters: dict = {}
        self.syncs: dict = {}
        self.marks: list = []  # perf_counter ns (before, after) each event record
        self._first = None  # the record's first CUDA event
        self._pending: dict = {}  # counter -> (op, [tensors of each call])
        self._streams: dict = {}  # device -> the stream its events go on
        self._stack: list = []
        self._launch0 = dict(stages.LAUNCHES)

    def _mark(self, device) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = torch.cuda.current_stream(device)
        t0 = time.perf_counter_ns()
        ev.record(stream)
        self.marks.append((t0, time.perf_counter_ns()))
        if self._first is None:
            self._first = ev
        return ev

    def _finish(self) -> None:
        from strutopy_tpu_torch.ops import stages

        for k, v in stages.LAUNCHES.items():
            self.counters[f"launch.{k}"] = v - self._launch0.get(k, 0)

    def add(self, name: str, value, *more, op=None) -> None:
        """Add to counter ``name`` (see :func:`count`)."""
        if value is None:
            self.counters[name] = None
            self._pending.pop(name, None)
        elif name in self.counters and self.counters[name] is None:
            return
        elif isinstance(value, torch.Tensor):
            self._pending.setdefault(name, (op, []))[1].append((value,) + more)
            self.counters.setdefault(name, 0)
        else:
            self.counters[name] = self.counters.get(name, 0) + value

    def resolve(self) -> "Record":
        """Count the device-side counts (once)."""
        if self._pending:
            sums = []
            for op, calls in self._pending.values():
                cols = [torch.cat([t.reshape(1) if t.dim() == 0 else t for t in col])
                        for col in zip(*calls)]
                sums.append((op(*cols) if op else cols[0]).sum(0, dtype=torch.int64))
            flat = torch.cat([x.reshape(-1) for x in sums]).tolist()
            i = 0
            for name, x in zip(self._pending, sums):
                host = self.counters[name]
                if x.dim():
                    got = flat[i:i + x.numel()]
                    self.counters[name] = [host + v for v in got] if host else got
                else:
                    self.counters[name] = host + flat[i]
                i += x.numel()
            self._pending = {}
        return self

    @property
    def n_syncs(self) -> int:
        return sum(n for n, _s in self.syncs.values())

    def summary(self) -> str:
        """The fit's INFO line; a record made under a profiler alone gives
        its host syncs and leaves its device-side counts unread."""
        if not self.full:
            return f"{self.n_syncs} host syncs"
        c = self.resolve().counters
        return (f"{self.n_syncs} host syncs, {c.get('newton.stalled')} stalled, "
                f"{c.get('newton.capped')} capped, {c.get('finalize.unconverged')} "
                f"unconverged, {c.get('finalize.repair_chunks')} repair chunks")


def span(name: str, device: Optional[torch.device] = None, attrs: Optional[dict] = None):
    """A span ``name`` with ``attrs``; with a CUDA ``device``, also a CUDA
    event at each end.  Entered, it gives the open record (None while
    recording is off)."""
    if not (_forced or _profiling()):
        return _NULL
    return Span(name, device, attrs)


def read(site: str, fn, *args):
    """``fn(*args)``, a blocking device-to-host read at ``site``: counted in
    the open record under ``site`` with the host time it took."""
    rec = _open
    if rec is None:
        return fn(*args)
    t0 = time.perf_counter_ns()
    out = fn(*args)
    n, s = rec.syncs.get(site, (0, 0.0))
    rec.syncs[site] = (n + 1, s + (time.perf_counter_ns() - t0) / 1e9)
    return out


def count(name: str, value, *more, op=None) -> None:
    """Add to counter ``name`` of the open record, if any: a host number;
    None (the path cannot count it, which sticks); or device tensors, held
    as they are until the record is resolved, which counts ``op(value,
    *more)`` (``value`` without ``op``) summed over its first axis, every
    call's tensors joined along that axis first: a mask counts its True
    rows, an (n, m) result gives m counts.  So a count launches nothing
    where it is made."""
    rec = _open
    if rec is not None:
        rec.add(name, value, *more, op=op)


@contextlib.contextmanager
def session():
    """An entry point's call: its records replace the last session's when
    recording is on, unless an outer session holds them."""
    global _sessions
    if not _sessions and on():
        _records.clear()
    _sessions += 1
    try:
        yield
    finally:
        _sessions -= 1


@contextlib.contextmanager
def recording():
    """Record spans and counters inside this context (one session)."""
    global _forced
    _forced += 1
    try:
        with session():
            yield
    finally:
        _forced -= 1


def records() -> list:
    """The records of the last recording session, resolved."""
    return [r.resolve() for r in _records if r is not _open]
