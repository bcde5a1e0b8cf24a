"""Profiling and tracing hooks, the counterpart of
sfm_nerf_tpu/utils/profiling.py: a trace of arbitrary code, a step timer
that keeps the first (building, warming) call apart from steady state,
device memory telemetry, and ``profile_summary``, which reads a trace into
the device's busy and idle share and its kernels by time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional

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
