"""The readers of the program's ``gemm_bytes`` counter (``gemm_bytes.train``,
``gemm_bytes.mip``): their arithmetic on a hand-made record, and nothing read
from a program without the counter or without a step."""

import pytest

from benchmark import harness

READERS = ["gemm_bytes.train", "gemm_bytes.mip"]
ROW = {"calls": 4, "host_ms": 90.0, "self_host_ms": 90.0, "device_ms": 80.0, "roots": 4}


def _record(counters):
    return {"spans": {"train.step": dict(ROW)}, "counters": counters}


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_bytes_a_step(name, monkeypatch):
    from sfm_nerf_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "summary",
                        lambda: _record({"gemm_bytes": 4 * 753_664 * 4096, "upload_bytes": 1}))
    assert harness.load_reader(name).read(None) == 753_664 * 4096


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_program_without_the_counter_reads_none(name, monkeypatch):
    """The parent of this metric's program counts uploads but not the GEMM's
    bytes: the reader reads nothing, and does not read 0."""
    from sfm_nerf_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "summary", lambda: _record({"upload_bytes": 5_319_680}))
    assert harness.load_reader(name).read(None) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_a_step_or_spans(name, monkeypatch):
    from sfm_nerf_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "summary",
                        lambda: {"spans": {}, "counters": {"gemm_bytes": 10}})
    assert harness.load_reader(name).read(None) is None
    monkeypatch.delattr(profiling, "summary")
    assert harness.load_reader(name).read(None) is None


def test_the_manifest_lists_them_on_the_training_cells():
    man = harness.manifest()
    got = {m["name"]: m for m in man["per_layer"] if m["name"] in READERS}
    assert got["gemm_bytes.train"]["workloads"] == ["flat-train", "hier-train"]
    assert got["gemm_bytes.mip"]["workloads"] == ["mip-train"]
    for m in got.values():
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
            "B", "lower", "program_counter", "kernels", "train_rays_per_s")
