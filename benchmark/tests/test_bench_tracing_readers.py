"""The readers of the program's own spans and counters (``stash_ms``,
``walk_ms``, ``gemm_ms``, ``upload_bytes``, ``host_ms``, ``backward_ms``,
all ``.train``): what a traced CPU run of each training cell reports, and
each reader's arithmetic on a hand-made record."""

import pytest

from benchmark import harness
from benchmark.tests import tiny

KERNEL_CLASSES = {"stash_ms.train": "k2.stash", "walk_ms.train": "k2.walk",
                  "gemm_ms.train": "k2.gemm"}
READERS = [*KERNEL_CLASSES, "upload_bytes.train", "host_ms.train", "backward_ms.train"]


def _row(calls, host_ms, device_ms, roots):
    return {"calls": calls, "host_ms": host_ms, "self_host_ms": host_ms,
            "device_ms": device_ms, "roots": roots}


RECORD = {"spans": {"train.step": _row(4, 300.0, 280.0, 4),
                    "train.backward": _row(4, 2.0, 640.0, 4),
                    "k2.stash": _row(64, 6.0, 24.0, 4),
                    "k2.walk": _row(64, 7.0, 208.0, 4),
                    "k2.gemm": _row(64, 9.0, 40.0, 4)},
           "counters": {"upload_bytes": 4 * 5_319_680}}
WANT = {"stash_ms.train": 6.0, "walk_ms.train": 52.0, "gemm_ms.train": 10.0,
        "upload_bytes.train": 5_319_680.0, "host_ms.train": 75.0, "backward_ms.train": 160.0}


@pytest.mark.parametrize("cell", ["flat-train", "hier-train", "flat-train-wrapper"])
def test_a_traced_run_reports_the_program_spans(cell):
    res, _ = tiny.run(cell, trace=True)
    assert res["correct"], res["checks"]
    metrics = res["metrics"]
    assert metrics["host_ms.train"]["value"] > 0
    assert metrics["host_ms.train"]["unit"] == "ms"
    assert ("backward_ms.train" in metrics) == (cell == "flat-train-wrapper")
    for name in KERNEL_CLASSES:       # the split step runs only on a card
        assert name not in metrics
    if cell != "flat-train-wrapper":
        # the plain versions upload nothing; the reading is a count
        assert metrics["upload_bytes.train"]["value"] == 0


def test_an_untraced_run_reports_none_of_them():
    res, _ = tiny.run("flat-train-wrapper")
    assert not set(READERS) & set(res["metrics"])


@pytest.mark.parametrize("name", READERS)
def test_reader_arithmetic_on_a_hand_made_record(name, monkeypatch):
    from sfm_nerf_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "summary", lambda: RECORD)
    assert harness.load_reader(name).read(None) == WANT[name]


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_without_a_step(name, monkeypatch):
    from sfm_nerf_tpu_torch.utils import profiling

    spans = {k: v for k, v in RECORD["spans"].items() if k != "train.step"}
    monkeypatch.setattr(profiling, "summary", lambda: {"spans": spans,
                                                       "counters": RECORD["counters"]})
    assert harness.load_reader(name).read(None) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_program_without_spans_reads_none(name, monkeypatch):
    """The parent of this metric's program has no ``summary``."""
    from sfm_nerf_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "summary")
    assert harness.load_reader(name).read(None) is None


@pytest.mark.parametrize("name", sorted(KERNEL_CLASSES))
def test_kernel_class_reader_reads_none_where_its_class_did_not_run(name, monkeypatch):
    from sfm_nerf_tpu_torch.utils import profiling

    spans = {k: v for k, v in RECORD["spans"].items() if k != KERNEL_CLASSES[name]}
    monkeypatch.setattr(profiling, "summary", lambda: {"spans": spans, "counters": {}})
    assert harness.load_reader(name).read(None) is None
