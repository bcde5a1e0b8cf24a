"""The command refuses to measure without a card, and without the
program beside it: a non-zero exit and no result line."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness

ARGS = ["--workload", "flat-train", "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible here: this checks the refusal without one")
    out = _run(harness.ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "no CUDA device" in out.stderr


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert not out.stdout.strip()
    # with the card's look passed, the run stops where it needs the program
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import harness, run; "
            "harness.require_cuda = lambda chips: 'cpu'; sys.exit(run.main(%r))" % ARGS)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "No module named 'sfm_nerf_tpu_torch'" in out.stderr


def test_cuda_required(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(harness.NoCard):
        harness.require_cuda(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(harness.NoCard):
        harness.require_cuda(4)
