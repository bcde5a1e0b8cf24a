"""Profiling and tracing hooks, the counterpart of
sfm_nerf_tpu/utils/profiling.py: a trace of arbitrary code, a step timer
that keeps the first (building, warming) call apart from steady state,
device memory telemetry, ``profile_summary``, which reads a trace into
the device's busy and idle share and its kernels by time, and the
program's own spans and counters.

Spans and counters.  ``span(name)`` marks a stretch of the program (a
training step, one launch class of a kernel, an upload) and ``count(name,
n)`` adds to a named counter.  Both record only while recording is on:
while a ``torch.profiler`` profile is active (so ``trace`` and any other
profile of the program turn it on) or inside ``recording()``.  A span then
opens a ``record_function`` range named ``sfm:<name>``, on the profiler's
timeline beside the device's kernels and copies; takes the device time of
the work it queued, by a pair of CUDA events on the current stream (the
host clock where no card is visible); and keeps in memory its name, host
start and end, its parent and the root span it belongs to (``train.step``
n, ``render.view`` n).  The record holds the latest recording window: it
is cleared when a span or counter first finds recording on after finding
it off, and when ``recording()`` is entered.  ``summary()`` reads it, after
the caller has synchronized the device.  Off, a span costs one test of
the profiler's flag and returns a shared no-op context: no range, no
event, no allocation, no synchronize.  Spans are recorded from the thread
that drives the work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from sfm_nerf_tpu_torch import DEFAULT_DEVICE


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """A ``torch.profiler.profile`` of the block, CPU and (where a card is
    visible) CUDA activities; on exit its Chrome trace is written to
    ``log_dir/trace.json`` (Perfetto or chrome://tracing read it).  Yields
    the profile for ``profile_summary``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Step statistics that keep the first call (kernel builds, warm-up)
    apart from the steady ones.  The first call is timed on the host clock
    to the device's end (a ``synchronize`` on a card); the steady calls by
    CUDA events on a card, read once in ``summary``, so timing them adds no
    host wait, and by the host clock on the CPU.  A card asked for and not
    visible is an error."""

    def __init__(self, device=DEFAULT_DEVICE):
        self.cuda = torch.device(device).type == "cuda"
        if self.cuda and not torch.cuda.is_available():
            raise RuntimeError("StepTimer on cuda: no CUDA device is visible")
        self.first_s: Optional[float] = None
        self.times: List[float] = []
        self._events: list = []
        self._t0: Optional[float] = None

    def __enter__(self):
        if self.first_s is None or not self.cuda:
            if self.cuda:
                torch.cuda.synchronize()
            self._t0 = time.perf_counter()
        else:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events.append([start, None])
        return self

    def __exit__(self, *exc):
        if self.first_s is not None and self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events[-1][1] = end
            return
        if self.cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        if self.first_s is None:
            self.first_s = dt
        else:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        if self._events:
            torch.cuda.synchronize()
            self.times += [a.elapsed_time(b) / 1e3 for a, b in self._events]
            self._events = []
        steady = np.asarray(self.times) if self.times else None
        return {
            "compile_call_s": self.first_s or 0.0,
            "steady_mean_s": float(steady.mean()) if steady is not None else 0.0,
            "steady_p50_s": float(np.median(steady)) if steady is not None else 0.0,
            "n_steady": len(self.times),
        }


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per CUDA device: ``bytes_in_use`` and ``peak_bytes_in_use`` (the
    caching allocator's allocated bytes, now and at peak) and
    ``bytes_limit`` (the card's total memory).  With no card: ``{'cpu':
    {}}``, an empty dict per device as the JAX function gives a backend
    without statistics."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(s.get("allocated_bytes.all.current", -1)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", -1)),
            "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
        }
    return out


def _union_us(intervals: List[tuple]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def profile_summary(prof, top: int = 10) -> dict:
    """What a trace says about the device over its window: ``window_ms``
    (first to last event, host and device), ``device_busy_ms`` (the union
    of the kernel and copy intervals), ``busy_share`` and ``idle_share`` of
    the window, ``device_ms`` (their plain sum), ``n_device_events`` and
    ``top_kernels``: the ``top`` names by total device time, each with its
    launches and ms.  A trace that ran with CUDA activity but holds no
    device time fails: a host clock is no stand-in for it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    events = [e for e in prof.events() if e.time_range.end > e.time_range.start]
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if ProfilerActivity.CUDA in prof.activities and not dev:
        raise RuntimeError("the profile holds no device time: CUPTI recorded no kernel "
                           "on the card")
    window = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
              if events else 0.0)
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in dev])
    by_name: Dict[str, list] = {}
    for e in dev:
        row = by_name.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += e.time_range.end - e.time_range.start
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    share = busy / window if window > 0 else 0.0
    return {
        "window_ms": window / 1e3,
        "device_busy_ms": busy / 1e3,
        "busy_share": share,
        "idle_share": 1.0 - share,
        "device_ms": sum(r[1] for r in by_name.values()) / 1e3,
        "n_device_events": len(dev),
        "top_kernels": [{"name": name, "launches": n, "ms": us / 1e3}
                        for name, (n, us) in ranked],
    }


# ---------------------------------------------------------------------------
# spans and counters inside the program
# ---------------------------------------------------------------------------

_profiler_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class SpanRecord:
    """One span of the recording window."""
    name: str
    parent: Optional[int]           # index of the enclosing span in the window's record
    root: Tuple[str, int]           # the root span's name and its index among that name's roots
    start_ns: int                   # host clock (perf_counter_ns)
    end_ns: int = 0                 # 0 while the span is open
    events: Optional[tuple] = None  # (start, end) CUDA events where a card is visible


class _Window:
    """The latest recording window: the spans in the order they opened,
    the counters, the spans open now and the roots of each name."""

    def __init__(self):
        self.forced = 0       # depth of recording() blocks
        self.live = False     # recording was found on since it was last found off
        self.spans: List[SpanRecord] = []
        self.counters: Dict[str, int] = {}
        self.open: List[int] = []
        self.roots: Dict[str, int] = {}
        self.cuda = False

    def begin(self) -> None:
        self.spans, self.counters, self.open, self.roots = [], {}, [], {}
        self.cuda = torch.cuda.is_available()
        self.live = True


_WINDOW = _Window()


class _Span:
    __slots__ = ("name", "rec", "spans", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        w = _WINDOW
        if not w.live:
            w.begin()
        parent = w.open[-1] if w.open else None
        if parent is None:
            n = w.roots.get(self.name, 0)
            w.roots[self.name] = n + 1
            root = (self.name, n)
        else:
            root = w.spans[parent].root
        self.rf = torch.profiler.record_function("sfm:" + self.name)
        self.rf.__enter__()
        rec = SpanRecord(self.name, parent, root, time.perf_counter_ns())
        if w.cuda:
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        self.rec, self.spans = rec, w.spans
        w.open.append(len(w.spans))
        w.spans.append(rec)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record()
        rec.end_ns = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        w = _WINDOW
        if w.spans is self.spans and w.open:
            w.open.pop()
        return False


def span(name: str):
    """A context manager that records the block as span ``name`` while
    recording is on, and does nothing otherwise."""
    w = _WINDOW
    if not (w.forced or _profiler_enabled()):
        w.live = False
        return _OFF
    return _Span(name)


def count(name: str, n: int) -> None:
    """Adds ``n`` to the counter ``name`` while recording is on."""
    w = _WINDOW
    if not (w.forced or _profiler_enabled()):
        w.live = False
        return
    if not w.live:
        w.begin()
    w.counters[name] = w.counters.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Records spans and counters inside the block, with or without a
    profiler; the record is cleared on entry and kept after the block."""
    w = _WINDOW
    w.begin()
    w.forced += 1
    try:
        yield
    finally:
        w.forced -= 1
        w.live = False


def records() -> List[SpanRecord]:
    """The closed spans of the latest recording window, in the order they
    opened."""
    return [r for r in _WINDOW.spans if r.end_ns]


def summary() -> Dict[str, Dict]:
    """The latest recording window: ``spans``, by name, ``calls``,
    ``host_ms``, ``self_host_ms`` (the spans less their children's host
    time), ``device_ms`` (the work they queued, or the host clock where no
    card is visible) and ``roots`` (how many root spans they ran under);
    ``counters`` by name.  Call it after synchronizing the device: it
    raises where a recorded event has not completed, and never waits."""
    spans = _WINDOW.spans
    child_ns = [0] * len(spans)
    for r in spans:
        if r.end_ns and r.parent is not None:
            child_ns[r.parent] += r.end_ns - r.start_ns
    out: Dict[str, Dict] = {}
    roots: Dict[str, set] = {}
    for i, r in enumerate(spans):
        if not r.end_ns:
            continue
        host_ns = r.end_ns - r.start_ns
        if r.events is None:
            device_ms = host_ns / 1e6
        elif not r.events[1].query():
            raise RuntimeError(f"span {r.name}: the device has not finished its work; "
                               "synchronize before summary()")
        else:
            device_ms = r.events[0].elapsed_time(r.events[1])
        row = out.setdefault(r.name, {"calls": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                                      "device_ms": 0.0, "roots": 0})
        row["calls"] += 1
        row["host_ms"] += host_ns / 1e6
        row["self_host_ms"] += (host_ns - child_ns[i]) / 1e6
        row["device_ms"] += device_ms
        roots.setdefault(r.name, set()).add(r.root)
    for name, row in out.items():
        row["roots"] = len(roots[name])
    return {"spans": out, "counters": dict(_WINDOW.counters)}
