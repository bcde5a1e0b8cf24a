"""Spans around calls into the program, and the reading of a profiler
trace over a bounded slice of the measured window.

``Spans`` wraps named functions of the program's modules for the traced
slice: each call runs inside a ``record_function`` range named
``bench:<function>`` and, on a card, between two CUDA events recorded on
the current stream, so a call's device time is the work it queued,
whatever kernels implement it (on the CPU, used only by the tests, the
host clock stands in).  ``Tracer`` runs ``torch.profiler`` over the slice
and reduces it to a ``TraceView``: the slice's length, the union of the
device's kernel and copy intervals (a frozen copy of the interval
arithmetic of the port's ``utils/profiling.py:profile_summary``), the
device's own span (its first interval's start to its last one's end), the
device operations by time, and the idle gaps by what the host was doing.
The per-layer metric readers under ``metrics/`` read the view.
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

TOP = 10              # entries of each breakdown list
LABELLED_GAPS = 200   # the longest idle gaps are named; the rest are summed
NAME_CHARS = 160      # a device operation's name is cut to this length


@dataclasses.dataclass
class Call:
    """One call inside a span: its device seconds and its tensor
    arguments' shapes."""
    shapes: List[Tuple[int, ...]]
    device_s: float = 0.0
    ev: Optional[Tuple] = None


class Spans:
    """While entered, ``module.name`` for each (module, name) target is
    wrapped; the calls of each name land in ``calls[name]``."""

    def __init__(self, targets: Sequence[Tuple[str, str]], cuda: bool):
        self.targets = sorted(set(targets))
        self.cuda = cuda
        self.calls: Dict[str, List[Call]] = {name: [] for _, name in self.targets}
        self._saved = []

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            rec = Call([tuple(a.shape) for a in args if isinstance(a, torch.Tensor)])
            with torch.profiler.record_function(f"bench:{name}"):
                if self.cuda:
                    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    ev[0].record()
                    out = fn(*args, **kwargs)
                    ev[1].record()
                    rec.ev = ev
                else:
                    t0 = time.perf_counter()
                    out = fn(*args, **kwargs)
                    rec.device_s = time.perf_counter() - t0
            self.calls[name].append(rec)
            return out
        return call

    def __enter__(self):
        for mod_name, name in self.targets:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []

    def resolve(self) -> None:
        """Read the CUDA events (after a synchronize)."""
        for calls in self.calls.values():
            for c in calls:
                if c.ev is not None:
                    c.device_s = c.ev[0].elapsed_time(c.ev[1]) / 1e3
                    c.ev = None


@dataclasses.dataclass
class TraceView:
    """What a traced slice says; the input of every per-layer reader."""
    units: int                      # steps or views inside the slice
    unit_flops: float               # the model's least operations of one unit
    window_s: float                 # the slice, host clock of the trace
    busy_s: float                   # union of device intervals inside it
    span_s: float                   # first device interval's start to last one's end
    model: Dict                     # the configuration's model group
    arch: object                    # its network's plain reference and counts
    calls: Dict[str, List[Call]]
    device_ops: List[List]          # [[name, seconds], ...] by total time
    idle_gaps: List[List]           # [[what the host did, seconds], ...]


def union_s(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def _gaps(intervals, lo, hi):
    """Idle (start, end) stretches of [lo, hi] outside the intervals."""
    gaps, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


def _host_label(cpu, t):
    """Name of what the host thread ran at time t: the outermost bench
    span and the innermost operation around t."""
    around = [e for e in cpu if e.time_range.start <= t < e.time_range.end]
    if not around:
        return "host: between operations"
    inner = max(around, key=lambda e: e.time_range.start).name
    spans = [e for e in around if e.name.startswith("bench:")]
    outer = min(spans, key=lambda e: e.time_range.start).name if spans else None
    return f"{outer} / {inner}" if outer and outer != inner else inner


class Tracer:
    """Profiles one slice: ``start`` before its first unit, ``stop`` after
    its last; ``view`` reduces the trace."""

    def __init__(self, span_targets, cuda: bool):
        self.cuda = cuda
        self.spans = Spans(span_targets, cuda)
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.spans.__enter__()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._mark = torch.profiler.record_function("bench:traced")
        self._mark.__enter__()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.spans.__exit__(None, None, None)
        self.spans.resolve()

    def view(self, units: int, unit_flops: float, model: Dict, arch) -> TraceView:
        from torch.autograd import DeviceType

        events = [e for e in self.prof.events() if e.time_range.end > e.time_range.start]
        mark = next(e for e in events if e.name == "bench:traced")
        lo, hi = mark.time_range.start, mark.time_range.end
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        if self.cuda and not dev:
            raise RuntimeError("the trace holds no device time: CUPTI recorded no kernel")
        cpu = [e for e in events if e.device_type == DeviceType.CPU
               and e.thread == mark.thread and e.name != "bench:traced"]
        iv = [(max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in dev
              if e.time_range.end > lo and e.time_range.start < hi]
        by_name: Dict[str, float] = {}
        for e in dev:
            by_name[e.name[:NAME_CHARS]] = (by_name.get(e.name[:NAME_CHARS], 0.0)
                                            + (e.time_range.end - e.time_range.start) / 1e6)
        idle: Dict[str, float] = {}
        gaps = sorted(_gaps(iv, lo, hi), key=lambda g: g[0] - g[1])
        for i, (a, b) in enumerate(gaps):
            label = _host_label(cpu, a) if i < LABELLED_GAPS else "shorter gaps, not named"
            idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        span = (max(b for _, b in iv) - min(a for a, _ in iv)) / 1e6 if iv else 0.0
        return TraceView(units=units, unit_flops=unit_flops, window_s=(hi - lo) / 1e6,
                         busy_s=union_s(iv) / 1e6, span_s=span, model=model, arch=arch,
                         calls=self.spans.calls,
                         device_ops=top(by_name), idle_gaps=top(idle))
