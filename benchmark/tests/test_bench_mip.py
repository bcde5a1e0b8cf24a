"""The mip-train cell (mip-NeRF on the port, loops/mip_train.py): a sound
run on the CPU comes out ``correct``; each fault underneath does not
(unchanged state, half of each batch, the loss 10% high where the cone
kernels produce it); the float8 control does not; a program without cone
casting is refused at set-up.  The cell's own small sizes (hidden 32, 64
rays x 8 intervals, 16 x 16 views); the readings at the cell's size are
the card's (the ``gpu`` test at the end, ``calibrate.train_readings``)."""

import copy
import time

import pytest
import torch

from benchmark import calibrate, compare, harness
from benchmark.loops import mip_train

CELL = "mip-train"
SEED = 2**31 + 11
SMALL = {"model": {"hidden": 32}, "render": {"n_sample": 8},
         "train": {"n_rays_batch": 64, "log_every": 5},
         "data": {"n_images": 3, "height": 16, "width": 16}, "traffic": {"trace_units": 3}}
NT = "sfm_nerf_tpu_torch.train.nerf_trainer"


def _run(trace=False, seed=SEED):
    return harness.run(CELL, seed, 0.3, trace, time.perf_counter(), device="cpu",
                       overrides=copy.deepcopy(SMALL))


def _loop():
    spec = harness.resolve(CELL)
    for g, over in copy.deepcopy(SMALL).items():
        (spec["traffic"] if g == "traffic" else spec["groups"][g]).update(over)
    lp = harness.make_loop(spec, SEED, "cpu")
    lp.setup()
    return spec, lp


def _nt():
    import importlib

    return importlib.import_module(NT)


def _half(t):
    return t[: t.shape[0] // 2]


def unchanged_state(monkeypatch):
    nt = _nt()

    def make_train_step(cfg, optimizer, scheduler, guard=None):
        loss_fn = nt.make_loss_fn(cfg)

        def step(model, generator, images, poses, K):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(model, generator, images, poses, K)
            loss.backward()
            return loss.detach()
        return step
    monkeypatch.setattr(nt, "make_train_step", make_train_step)


def half_batch(monkeypatch):
    nt = _nt()
    k2, k4 = nt.fused_mse_loss_cones, nt.fused_mse_loss_cones_weights
    monkeypatch.setattr(nt, "fused_mse_loss_cones", lambda pk, o, d, c, t, y, r: k2(
        pk, _half(o), _half(d), _half(c), _half(t), _half(y), r))
    monkeypatch.setattr(nt, "fused_mse_loss_cones_weights", lambda pk, o, d, c, t, y, r: (
        k4(pk, _half(o), _half(d), _half(c), _half(t), _half(y), r)[0],
        k4(pk, o, d, c, t, y, r)[1]))


def altered_loss(monkeypatch):
    nt = _nt()
    k2, k4 = nt.fused_mse_loss_cones, nt.fused_mse_loss_cones_weights
    monkeypatch.setattr(nt, "fused_mse_loss_cones", lambda *a: 1.1 * k2(*a))

    def k4_altered(*a):
        loss, w = k4(*a)
        return 1.1 * loss, w
    monkeypatch.setattr(nt, "fused_mse_loss_cones_weights", k4_altered)


def test_sound_run_is_correct():
    res, lines = _run()
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert set(res["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert lines[-len(res["checks"]):] == [
        f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in res["checks"].items()]


def test_traced_run_reports_the_cells_metrics():
    """A traced run on the CPU reads the cell's program metrics (mfu.mip
    reads the device's trace, which a CPU run has not), ipe_points.mip
    exactly rays x intervals x two levels."""
    res, _ = _run(trace=True)
    got = res["metrics"]
    assert {"mip_roofline", "resample_ms.mip", "ipe_points.mip", "host_ms.mip"} <= set(got)
    assert got["ipe_points.mip"]["value"] == 2 * 64 * 8
    assert got["host_ms.mip"]["value"] > 0
    # the plain versions upload nothing; the split step's spans exist only on a card
    assert got["upload_bytes.mip"]["value"] == 0
    assert not {"stash_ms.mip", "walk_ms.mip", "gemm_ms.mip"} & set(got)


@pytest.mark.parametrize("name", ["stash_ms", "walk_ms", "gemm_ms", "upload_bytes", "host_ms",
                                  "idle_share"])
def test_reader_reads_as_its_train_reader(name, monkeypatch):
    """Each .mip reader of the split step's spans, the uploads, the host's
    time and the idle share reads what its .train reader reads, on a
    hand-made record and a hand-made trace view."""
    import types

    from sfm_nerf_tpu_torch.utils import profiling

    row = {"calls": 8, "host_ms": 90.0, "self_host_ms": 90.0, "device_ms": 40.0, "roots": 4}
    record = {"spans": {k: dict(row) for k in ("train.step", "k2.stash", "k2.walk", "k2.gemm")},
              "counters": {"upload_bytes": 4 * 1000}}
    monkeypatch.setattr(profiling, "summary", lambda: record)
    view = types.SimpleNamespace(window_s=2.0, busy_s=1.5)
    mip, train = (harness.load_reader(f"{name}.{kind}") for kind in ("mip", "train"))
    assert mip.SPANS == train.SPANS
    assert mip.read(view) == train.read(view) is not None


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, altered_loss],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res, _ = _run()
    assert not res["correct"] and res["failed"] >= 1, res["checks"]


def test_control_is_not_correct():
    """float8 in place of bf16: the reference at float8 against the
    reference fails a limit."""
    spec, lp = _loop()
    lp.release()
    numbers = compare.train_numbers(lp.reference_readings("fp8"), lp.reference_readings())
    assert any(numbers[k] > v for k, v in spec["limits"]["limits"].items()), numbers


def test_program_without_cone_casting_is_refused(monkeypatch):
    """A program without the mip arch, or without the log-linear
    schedule's fields (the parent of this cell has neither), fails at
    set-up, before anything is built."""
    import dataclasses

    from sfm_nerf_tpu_torch import config
    from sfm_nerf_tpu_torch.models import nerf

    mip_train.require_cone_casting()

    def old_shapes(cfg):
        raise ValueError(f"unknown arch {cfg.arch!r}")
    with monkeypatch.context() as m:
        m.setattr(nerf, "layer_shapes", old_shapes)
        with pytest.raises(RuntimeError, match="no cone casting.*unknown arch"):
            mip_train.require_cone_casting()

    @dataclasses.dataclass(frozen=True)
    class OldTrain:
        lrate: float = 5e-4
    monkeypatch.setattr(config, "TrainConfig", OldTrain)
    with pytest.raises(RuntimeError, match="no cone casting.*lr_schedule"):
        mip_train.require_cone_casting()


@pytest.mark.gpu
def test_control_at_the_cells_size():
    """On the card, at the cell's own size, three seeds: the program within
    every limit, the control and the half-batch fault outside at least one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the readings at the cell's own size")
    spec = harness.resolve(CELL)
    limits, control = spec["limits"]["limits"], spec["limits"]["control"]
    for row in calibrate.train_readings(spec, [2**31 + 21, 2**31 + 22, 2**31 + 23], "cuda"):
        assert not any(row["program"][k] > v for k, v in limits.items()), row
        assert any(row[control][k] > v for k, v in limits.items()), row
        assert any(row["half"][k] > v for k, v in limits.items()), row


def test_network_file_imports_nothing_of_the_program():
    """reference/mipnerf.py, the configuration's network file and method,
    loads nothing of the program, of JAX or of the JAX package."""
    import subprocess
    import sys

    probe = ("import benchmark.reference.mipnerf, sys; "
             "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
             "('jax', 'jaxlib', 'sfm_nerf_tpu', 'sfm_nerf_tpu_torch')); "
             "assert not bad, bad")
    subprocess.run([sys.executable, "-c", probe], check=True, cwd=harness.ROOT)
