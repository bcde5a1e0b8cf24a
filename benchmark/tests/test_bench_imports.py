"""What a run loads: no top-level jax, jaxlib, flax or sfm_nerf_tpu
(compared by whole top-level names: the port's own name begins with the
JAX package's), and a reference that loads nothing of the program."""

import json
import os
import subprocess
import sys

from benchmark import harness

PROBE = r"""
import json, sys, time
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(body: str):
    code = PROBE.format(root=harness.ROOT, body=body)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_cpu_run_loads_no_jax():
    """Every module of the harness, every loop and reader, the program's
    modules the loops call, through a run of each cell at small sizes."""
    body = (
        "from benchmark import harness, calibrate, tracing\n"
        "from benchmark.tests import tiny\n"
        "for cell in ('flat-train', 'hier-train', 'flat-train-wrapper', 'flat-render'):\n"
        "    tiny.run(cell, trace=True, seconds=0.1)\n"
        "found = harness.forbidden_modules()\n"
        "assert not found, found\n")
    names = _top_level(body)
    assert "sfm_nerf_tpu_torch" in names and "torch" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level("from benchmark.reference import active, nerf\n"
                       "from benchmark import counts, compare, inputs")
    assert not names & {"sfm_nerf_tpu_torch", *harness.FORBIDDEN}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sfm_nerf_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sfm_nerf_tpu.io", sys)
    assert harness.forbidden_modules() == ["sfm_nerf_tpu.io"]
