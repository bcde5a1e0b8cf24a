"""One run of one cell: find its pieces by name, set up, measure, check.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``: the
model, render, train and data groups, and under ``reference`` the file of
its network's plain reference and counts) and a traffic mix
(``traffic/<name>.json``: which loop drives the window, that loop's
parameters, and overrides of the configuration's groups).  Its limits are
``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py`` (a ``SPANS`` list of the program's functions to
wrap and a ``read(view)`` that returns a number or None).  A new cell,
configuration, network, mix or metric is new files and entries; nothing
here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = ("model", "render", "train", "data")
FORBIDDEN = ("jax", "jaxlib", "flax", "sfm_nerf_tpu")


class NoCard(RuntimeError):
    """No CUDA card, or fewer than the cell asks for: nothing is measured."""


def manifest(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: str, name: str):
    """The module of the file at ``path``, under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(cell_name: str, root: str = ROOT) -> Dict:
    """Everything a run of ``cell_name`` needs, found by name.  A per-layer
    metric without a ``workloads`` list belongs to every cell that reports
    the end-to-end metric it moves."""
    man = manifest(root)
    cell = _by_name(man["workloads"], cell_name, "workload")
    config = _load_json(os.path.join(root, _by_name(man["configs"], cell["config"],
                                                    "config")["file"]))
    arch = load_module(os.path.join(root, config["reference"]),
                       "benchmark_network_" + cell["config"].replace("-", "_").replace(".", "_"))
    traffic = _load_json(os.path.join(root, "benchmark", "traffic", cell["traffic"] + ".json"))
    groups = {g: {**config.get(g, {}), **traffic.get(g, {})} for g in GROUPS}
    end_to_end = [m for m in man["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in man["per_layer"]
                 if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return {"cell": cell, "groups": groups, "arch": arch, "traffic": traffic,
            "end_to_end": end_to_end, "per_layer": per_layer,
            "limits": _load_json(os.path.join(root, "benchmark", "limits", cell_name + ".json"))}


def load_reader(name: str, root: str = ROOT):
    """The reader module ``metrics/<name>.py``."""
    return load_module(os.path.join(root, "benchmark", "metrics", name + ".py"),
                       "benchmark_metric_" + name.replace(".", "_").replace("-", "_"))


def make_loop(spec: Dict, seed: int, device):
    mod = importlib.import_module(f"benchmark.loops.{spec['traffic']['loop']}")
    return mod.Loop(spec, seed, device)


def require_cuda(chips: int) -> str:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("no CUDA device is visible: the benchmark measures only on a card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, {torch.cuda.device_count()} visible")
    return "cuda"


def measure(loop, seconds: float, tracer, trace_units: int, cuda: bool):
    """The window: units back to back for ``seconds`` (and at least the
    traced slice), from the first unit's enqueue to a synchronize after
    the last.  Returns (units, seconds, each unit's host seconds)."""
    import torch

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    unit_s: List[float] = []
    t0 = time.perf_counter()
    if tracer is not None:
        tracer.start()
    while True:
        u0 = time.perf_counter()
        loop.run_unit()
        unit_s.append(time.perf_counter() - u0)
        if tracer is not None and len(unit_s) == trace_units:
            tracer.stop()
        if time.perf_counter() - t0 >= seconds and (tracer is None or len(unit_s) >= trace_units):
            break
    sync()
    return len(unit_s), time.perf_counter() - t0, unit_s


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the runs may not load."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def _device_info(cuda: bool) -> Dict:
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def _power_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    return f"card: {out}"


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
        root: str = ROOT, device: Optional[str] = None,
        overrides: Optional[Dict] = None) -> Tuple[Dict, List[str]]:
    """One run: (the result line's object, the lines for standard error).
    ``device`` None measures on the card and refuses to run without one;
    the tests pass 'cpu' and, in ``overrides`` ({group or 'traffic':
    {key: value}}), small sizes."""
    import torch

    spec = resolve(cell_name, root)
    for g, over in (overrides or {}).items():
        (spec["traffic"] if g == "traffic" else spec["groups"][g]).update(over)
    t_imported = time.perf_counter()
    if device is None:
        device = require_cuda(spec["cell"]["chips"])
    cuda = device == "cuda"
    if cuda:
        torch.zeros(1, device=device)
    t_context = time.perf_counter()
    loop = make_loop(spec, seed, device)
    loop.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    setup_parts = (f"set-up: imports {t_imported - t_start:.3f} s, device context "
                   f"{t_context - t_imported:.3f} s, the cell's set-up "
                   f"{t_start + setup_s - t_context:.3f} s")
    tracer = None
    if trace:
        from benchmark.tracing import Tracer

        readers = {m["name"]: load_reader(m["name"], root) for m in spec["per_layer"]}
        tracer = Tracer([s for r in readers.values() for s in r.SPANS], cuda)
    traffic = spec["traffic"]
    units, window_s, unit_s = measure(loop, seconds, tracer, traffic["trace_units"], cuda)
    device_info = _device_info(cuda)
    metrics: Dict[str, Dict] = {}
    result: Dict = {}
    if trace:
        view = tracer.view(traffic["trace_units"], loop.unit_flops(), spec["groups"]["model"],
                           spec["arch"])
        for m in spec["per_layer"]:
            value = readers[m["name"]].read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=view.busy_s, window_s=view.window_s)
        result["breakdown"] = {"device_ops": view.device_ops, "idle_gaps": view.idle_gaps}
    else:
        values = {"setup_s": setup_s, **loop.end_to_end(units, window_s, unit_s)}
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    loop.release()
    numbers = loop.check()
    limits = spec["limits"]["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    failed = sum(not (math.isfinite(c["value"]) and c["value"] <= c["limit"])
                 for c in checks.values())
    lines = [_power_line() if cuda else "card: none (a test run on the CPU)",
             setup_parts, f"window: {units} {loop.unit}s in {window_s:.3f} s, set-up {setup_s:.3f} s"]
    lines += [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    result = {"correct": failed == 0, "attempted": units, "failed": failed,
              "metrics": metrics, "device": device_info, **result, "checks": checks}
    return result, lines
